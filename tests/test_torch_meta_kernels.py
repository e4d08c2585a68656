"""The kernel wrappers on the ``meta`` device, the dry run's path
(``repro_torch.launch.dryrun``): each of the 16 wrappers in
``kernels.KERNELS`` returns outputs of the kernel's shapes and dtypes (those
its plain version gives for the same CPU operands), counts one call in
``meta_calls`` where its CUDA branch counts one launch, leaves ``launches``
(real launches only) at 0, and runs neither the kernel nor its plain version
(no arithmetic reaches the dispatcher beyond allocating the outputs and the
scalar bias corrections some wrappers form first)."""
from __future__ import annotations

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import kernels
from repro_torch.kernels import fused_adam as fa, megaplan as mp, paged_attention as pa, slim_update as su
from repro_torch.kernels import snr_stats as sn, ssm_scan as ss

# operations any plain twin needs and an output allocation does not
WORK = ("sum", "mean", "amax", "sqrt", "exp", "mm", "bmm", "einsum", "where", "isfinite", "addcmul")


def _f(*shape):
    return torch.rand(shape) + 0.5


def _cases():
    g3, line = _f(2, 4, 8), _f(2, 4, 1)
    col = _f(2, 1, 8)
    ssm = (_f(1, 5, 4), _f(1, 5, 4), -_f(4, 3), _f(1, 5, 3), _f(1, 5, 3), _f(4), _f(1, 4, 3))
    return {
        "mega_adam_update": (mp.mega_adam_update, (_f(8, 16), _f(8, 16), _f(8, 16), _f(8, 1), _f(8, 1)),
                             dict(with_health=True)),
        "mega_slim_update_batched": (mp.mega_slim_update_batched, (g3, g3.clone(), line, line.clone(), line.clone()),
                                     dict(axis=1, with_snr=True, with_health=True)),
        "adam_precond": (fa.adam_precond, (_f(4, 8), _f(4, 8), _f(4, 8)), dict(count=2, with_health=True)),
        "slim_precond_batched": (su.slim_precond_batched, (g3, g3.clone(), col), dict(axis=0, with_snr=True,
                                                                                      with_health=True)),
        "snr_stats_centered_batched": (sn.snr_stats_centered_batched, (g3,), dict(axis=1)),
        "paged_attention": (pa.paged_attention, (_f(2, 1, 4, 16), _f(4, 4, 4, 16),
                                                 torch.tensor([[1, 2], [3, 0]], dtype=torch.int32),
                                                 torch.tensor([6, 3], dtype=torch.int32)), {}),
        "snr_stats_centered_partial_batched": (sn.snr_stats_centered_partial_batched, (g3,), dict(axis=0)),
        "slim_partial_stats_batched": (su.slim_partial_stats_batched, (g3, g3.clone()),
                                       dict(axis=1, with_snr=True, with_health=True)),
        "slim_finalize_batched": (su.slim_finalize_batched, (g3, line), dict(axis=1, ek=line.clone(), count=3)),
        "mega_slim_partial_stats_batched": (mp.mega_slim_partial_stats_batched, (g3, g3.clone()),
                                            dict(axis=0, with_snr=True, with_health=True)),
        "mega_slim_finalize_batched": (mp.mega_slim_finalize_batched, (g3, line, line.clone(), line.clone()),
                                       dict(axis=1)),
        "fused_adam": (fa.fused_adam, (_f(3, 5), _f(3, 5), _f(3, 5), _f(3, 5)), dict(lr=1e-3, count=2)),
        "slim_update_batched": (su.slim_update_batched, (g3, g3.clone(), g3.clone(), line), dict(axis=1, lr=1e-3)),
        "snr_stats_batched": (sn.snr_stats_batched, (g3,), dict(axis=0)),
        "ssm_scan": (ss.ssm_scan, ssm, dict(keep_bounds=True)),
        "ssm_scan_bwd": (ss.ssm_scan_bwd, ssm + (_f(1, 5, 4),), {}),
    }


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func.__name__)
        return func(*args, **(kwargs or {}))


def _flat(out):
    return [t for t in (out if isinstance(out, tuple) else (out,)) if t is not None]


def test_every_wrapper_has_a_case():
    assert sorted(_cases()) == sorted(fn.__name__ for fn in kernels.KERNELS)


@pytest.mark.parametrize("name", sorted(_cases()))
def test_wrapper_on_meta_gives_the_kernels_outputs_and_counts_a_call_not_a_launch(name):
    fn, args, kw = _cases()[name]
    want = _flat(fn(*args, **kw))
    meta_args = tuple(a.to("meta") for a in args)
    meta_kw = {k: v.to("meta") if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
    if name == "ssm_scan_bwd":
        # the kernel replays from the tile states the forward kept
        meta_kw["states"] = ss.ssm_scan(*meta_args[:7], keep_bounds=True)[2]
    kernels.reset_launch_counts()
    ops = _Ops()
    with ops:
        got = _flat(fn(*meta_args, **meta_kw))
    if name == "ssm_scan":
        assert tuple(got[2].shape) == ss.kept_states_shape(1, 5, 4, 3)   # the kept tile states (None on the CPU)
        got = got[:2]
    assert [(tuple(t.shape), t.dtype) for t in got] == [(tuple(t.shape), t.dtype) for t in want]
    assert all(t.device.type == "meta" for t in got)
    assert kernels.meta_call_counts() == {n: int(n == name) for n in kernels.meta_call_counts()}
    assert not any(kernels.launch_counts().values())       # nothing was launched
    assert not [op for op in ops.names if any(w in op for w in WORK)], ops.names
