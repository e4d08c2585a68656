"""The port's CUDA kernels against their plain PyTorch twins on the card.

Needs a CUDA GPU (marked ``cuda``; skips elsewhere) and imports no JAX, so
it runs on a machine without the JAX package:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances, relative to each output's largest magnitude: 1e-6 for outputs
computed elementwise in the same operation order (m', and u and m', v' of
dense Adam and of the psum pair's finalize), 1e-5 for outputs that depend on
a line sum (summation order differs), and so for paged attention with f32
queries; with bf16 queries
the output is bf16, and the two versions may round one step apart (2^-7
relative). Non-finite counts (the ``with_health`` outputs) must be equal,
on gradients seeded with a known number of NaN and +-Inf entries. The
parameter-writing kernels' f32 p' rounds in the twin's order (1e-6); a bf16
p' may round one bf16 step apart where the f32 values straddle a rounding
boundary (2^-8 of the largest |p|). The selective scan's y and final state
compose chunks of the sequence and take exp2 of dt*a*log2(e), where the
twin steps in order with exp (1e-5), and so do the gradients of its
backward kernel, whose replayed states equal the forward's bit for bit;
both forms rerun bit for bit, as do the backward and
the split walks of the line sums and of B1, B4, B7, B10 and B12. The line sums
of g^2 on long heavy-tailed lines (B1's, B4's and B7's v', B12's partial
sums) hold to an f64 reference at 1e-6. The MoE layer (plain PyTorch on
the card) runs twice bit for bit, forward and backward, and its bf16
output holds to the f32 CPU layer at 3e-2 of max|y|. The serving fault drill
runs through the engine on the card and holds benchmarks/serve_drill.py's
gates exactly, with B14's launches counted against the steps not degraded.
"""
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import snr_along_dims
from repro_torch.kernels import fused_adam, megaplan, paged_attention as pa, slim_update, snr_stats, ssm_scan

pytestmark = pytest.mark.cuda

ELEMENTWISE = 1e-6
LINE_SUMS = 1e-5
KW = dict(b1=0.9, b2=0.95, eps=1e-8)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def _close(a, b, tol):
    scale = float(b.abs().max()) if b.numel() else 0.0
    err = float((a.double() - b.double()).abs().max()) if b.numel() else 0.0
    assert err <= tol * max(scale, 1e-30), (err, scale, tol)


def _inputs(dev, shape, line, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = torch.randn(shape, generator=gen, device=dev)
    m = 0.1 * torch.randn(shape, generator=gen, device=dev)
    v = 0.01 * torch.rand(line, generator=gen, device=dev)
    bc1 = 0.05 + torch.rand(line, generator=gen, device=dev)
    bc2 = 0.05 + torch.rand(line, generator=gen, device=dev)
    return g, m, v, bc1, bc2


@pytest.mark.parametrize("rows,cols", [(300, 512), (17, 12), (1, 4)])
def test_mega_adam_update(dev, rows, cols):
    g, m, _, bc1, bc2 = _inputs(dev, (rows, cols), (rows, 1), rows)
    v = 0.01 * torch.rand((rows, cols), device=dev)
    before = megaplan.mega_adam_update.launches
    got = megaplan.mega_adam_update(g, m, v, bc1, bc2, **KW)
    want = megaplan.mega_adam_update_plain(g, m, v, bc1, bc2, **KW)
    torch.cuda.synchronize()
    assert megaplan.mega_adam_update.launches == before + 1
    for a, b in zip(got, want):
        _close(a, b, ELEMENTWISE)


@pytest.mark.parametrize("b,r,c,axis", [(1, 1, 1 << 24, 1), (1, 1 << 20, 32, 0), (1, 3, 1 << 22, 1),
                                        (2, 1 << 18, 128, 0)])
def test_mega_slim_long_heavy_tailed_lines(dev, b, r, c, axis):
    """Lines of 16 M and 4 M (minor) and 1 M and 256 K (major) elements
    whose first 1 % are 1.0 and the rest 1e-3: each thread's running sum
    reaches ~650 before the small squares come, each below half an f32 ulp
    of it. The line sums of g^2 (B1's, B4's and B7's v' and B12's partial
    sums, all on their split walk) keep them, as an f64 reference does."""
    red = 2 if axis == 1 else 1
    line = (b, r, 1) if axis == 1 else (b, 1, c)
    plan = megaplan.plan_slim(b, r, c, axis, sms=torch.cuda.get_device_properties(dev).multi_processor_count,
                              aligned=True)
    assert plan.form == (megaplan.FORM_SPLIT if axis == 1 else megaplan.FORM_MAJOR) and plan.nseg > 1
    g = torch.full((b, r, c), 1e-3, device=dev)
    g.narrow(red, 0, g.shape[red] // 100).fill_(1.0)
    m = torch.zeros_like(g)
    ones = torch.ones(line, device=dev)
    want = (g.double() ** 2).sum(dim=red, keepdim=True)
    got = megaplan.mega_slim_update_batched(g, m, torch.zeros(line, device=dev), ones, ones, axis=axis, **KW)
    per_leaf = slim_update.slim_precond_batched(g, m, torch.zeros(line, device=dev), axis=axis, with_health=True,
                                                **KW)
    part = megaplan.mega_slim_partial_stats_batched(g, m, axis=axis, b1=0.9)[1]
    written = slim_update.slim_update_batched(torch.zeros_like(g), g, m, torch.zeros(line, device=dev), axis=axis,
                                              lr=1e-3, count=1, **KW)
    torch.cuda.synchronize()
    _close(got[2], (1 - KW["b2"]) * want / g.shape[red], ELEMENTWISE)
    _close(per_leaf[2], (1 - KW["b2"]) * want / g.shape[red], ELEMENTWISE)
    _close(per_leaf[3][1:], want.sum().reshape(1), ELEMENTWISE)
    _close(written[2], (1 - KW["b2"]) * want / g.shape[red], ELEMENTWISE)
    _close(part.reshape(line), want, ELEMENTWISE)


@pytest.mark.parametrize("b,r,c,axis", [(1, 300, 768, 1), (2, 7, 33, 1), (1, 40, 70, 0), (3, 200, 100, 0)])
def test_mega_slim_update_batched(dev, b, r, c, axis):
    line = (b, r, 1) if axis == 1 else (b, 1, c)
    inputs = _inputs(dev, (b, r, c), line, b * r * c)
    got = megaplan.mega_slim_update_batched(*inputs, axis=axis, **KW)
    want = megaplan.mega_slim_update_batched_plain(*inputs, axis=axis, **KW)
    torch.cuda.synchronize()
    _close(got[0], want[0], LINE_SUMS)
    _close(got[1], want[1], ELEMENTWISE)
    _close(got[2], want[2], LINE_SUMS)


# The centered SNR stats' split walk (B5, B9): the main path's long views
# (gpt_small's embed K=both line, embed fan_in, the w_up/w_down K=both lines,
# w_down fan_in), lines at the warp form's limit and at segment boundaries
# +-1 (SEG_MAX is one segment of a long line), inner sizes not a multiple
# of 4, and ragged small views.
SPLIT_SHAPES = [(1, 1, 38633472, 1), (1, 50304, 768, 0), (1, 12, 2359296, 1), (12, 3072, 768, 0),
                (2, 3, snr_stats.WARP_LINE_MAX + 1, 1), (1, 2, snr_stats.SEG_MAX - 1, 1),
                (1, 2, 3 * snr_stats.SEG_MAX + 1, 1), (2, 513, 768, 0), (1, 1025, 33, 0), (1, 3, 100003, 1)]


@pytest.mark.parametrize("b,r,c,axis", [(1, 300, 768, 1), (1, 1, 100003, 1), (2, 7, 33, 1), (3, 200, 100, 0)]
                         + SPLIT_SHAPES)
@pytest.mark.parametrize("near_constant", [False, True])
def test_snr_stats_centered_batched(dev, b, r, c, axis, near_constant):
    gen = torch.Generator(device=dev).manual_seed(b * r + c)
    x = torch.randn((b, r, c), generator=gen, device=dev)
    v = 5.0 + 1e-4 * x if near_constant else x * x
    before = snr_stats.snr_stats_centered_batched.launches
    got = snr_stats.snr_stats_centered_batched(v, axis=axis)
    want = snr_stats.snr_stats_centered_batched_plain(v, axis=axis)
    torch.cuda.synchronize()
    assert snr_stats.snr_stats_centered_batched.launches == before + 1
    for a, w in zip(got, want):
        _close(a, w, LINE_SUMS)


def _offset_view(v):
    """A contiguous copy of v that starts one element (4 bytes for f32, 2 for
    bf16) past a 16-byte boundary."""
    buf = torch.empty(v.numel() + 1, device=v.device, dtype=v.dtype)
    out = buf[1:].view(v.shape)
    out.copy_(v)
    return out


@pytest.mark.parametrize("b,r,c,axis", [(1, 2, 3 * snr_stats.SEG_MAX + 4, 1), (1, 50, 768, 1), (2, 513, 768, 0),
                                        (1, 300, 20, 0)])
@pytest.mark.parametrize("partial", [False, True])
def test_snr_stats_centered_unaligned(dev, b, r, c, axis, partial):
    """A view 4 bytes off a 16-byte boundary takes the 4-byte loads."""
    gen = torch.Generator(device=dev).manual_seed(r + c)
    v = _offset_view(5.0 + 1e-4 * torch.randn((b, r, c), generator=gen, device=dev))
    assert v.data_ptr() % 16 == 4
    fn = snr_stats.snr_stats_centered_partial_batched if partial else snr_stats.snr_stats_centered_batched
    plain = (snr_stats.snr_stats_centered_partial_batched_plain if partial
             else snr_stats.snr_stats_centered_batched_plain)
    got, want = fn(v, axis=axis), plain(v, axis=axis)
    torch.cuda.synchronize()
    for a, w in zip(got[:3], want[:3]):
        _close(a, w, LINE_SUMS)
    if partial:
        assert torch.equal(got[3], want[3])


@pytest.mark.parametrize("b,r,c,axis", [(1, 1, 38633472, 1), (1, 50304, 768, 0), (1, 9216, 768, 1)])
@pytest.mark.parametrize("partial", [False, True])
def test_snr_stats_centered_is_deterministic(dev, b, r, c, axis, partial):
    """Split lines combine their shares in a fixed order: two launches on
    one input agree bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(c)
    v = torch.rand((b, r, c), generator=gen, device=dev)
    fn = snr_stats.snr_stats_centered_partial_batched if partial else snr_stats.snr_stats_centered_batched
    first, second = fn(v, axis=axis), fn(v, axis=axis)
    torch.cuda.synchronize()
    for a, w in zip(first, second):
        assert torch.equal(a, w)


def test_mega_adam_update_rejects_unaligned_operands(dev):
    bc = torch.ones(4, 1, device=dev)
    g = torch.zeros(4 * 8 + 1, device=dev)[1:].view(4, 8)   # contiguous, 4 bytes off
    with pytest.raises(ValueError):
        megaplan.mega_adam_update(g, g, g, bc, bc)
    h = torch.zeros(4, 6, device=dev)
    with pytest.raises(ValueError):
        megaplan.mega_adam_update(h, h, h, bc, bc)


@pytest.mark.parametrize("dims,per_dim", [((1, 3), None), ((1, 3), 2), ((1,), 0), ((0, 3), None)])
def test_fused_snr_runs_every_view_in_the_kernel(dev, dims, per_dim):
    """Transposing views and the per-remaining-dim form launch the kernel
    and agree with the plain two-pass math on the card."""
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((4, 96, 6, 32), generator=gen, device=dev)
    v = 1e-4 * torch.exp(x) * (1.0 + torch.arange(6, device=dev)[:, None])
    before = snr_stats.snr_stats_centered_batched.launches
    got = snr_along_dims(v, dims, per_remaining_dim=per_dim, backend="fused")
    assert snr_stats.snr_stats_centered_batched.launches == before + 1
    want = snr_along_dims(v, dims, per_remaining_dim=per_dim, backend="jnp")
    torch.testing.assert_close(got, want, rtol=1e-4, atol=0)


def test_wrapper_rejects_mixed_devices(dev):
    g = torch.zeros(4, 8, device=dev)
    with pytest.raises(ValueError):
        megaplan.mega_adam_update(g, g, g.cpu(), torch.ones(4, 1, device=dev), torch.ones(4, 1, device=dev))


def test_counts_reset(dev):
    snr_stats.snr_stats_centered_batched(torch.rand(1, 3, 8, device=dev), axis=1)
    kernels.reset_launch_counts()
    assert set(kernels.launch_counts().values()) == {0}
    np.testing.assert_equal(len(kernels.KERNELS), 16)


def _poison(g, n_bad, seed):
    """Set ``n_bad`` distinct entries of g to NaN, +Inf and -Inf in turn (in
    place); returns g."""
    flat = g.view(-1)
    idx = torch.randperm(flat.numel(), generator=torch.Generator().manual_seed(seed))[:n_bad].to(g.device)
    vals = torch.tensor([float("nan"), float("inf"), float("-inf")], device=g.device, dtype=g.dtype)
    flat[idx] = vals[torch.arange(n_bad, device=g.device) % 3]
    return g


def _close_finite(a, b, tol):
    """Equal non-finite positions, and the finite entries within tol."""
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    assert torch.equal(fa, fb)
    _close(torch.where(fa, a, 0.0), torch.where(fb, b, 0.0), tol)


def _trace(fn, traces=20):
    """The names of the device kernels one call of ``fn`` (after a warm-up
    call) runs, from a torch.profiler trace. Each trace starts with a short
    spin kernel: a trace that kept it saw the device from before the call's
    first kernel and is the answer (the spin left out); a trace that lost
    it is taken again, up to ``traces`` times. The profiler's own
    ``ProfilerStep*`` range, which a trace can list as a device event, is
    no kernel and is left out too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA and not e.name.startswith("ProfilerStep")]
        if any("spin_kernel" in n for n in names):
            return [n for n in names if "spin_kernel" not in n]
    raise AssertionError(f"none of {traces} torch.profiler traces kept its first device kernel")


# The calls whose device kernels a test reads from a trace: (builder, its
# arguments); each builder makes its inputs on the card and returns the call.
def _b1_call(b, r, c, axis):
    inputs = _inputs(torch.device("cuda"), (b, r, c), (b, r, 1) if axis == 1 else (b, 1, c), 3)
    return lambda: megaplan.mega_slim_update_batched(*inputs, axis=axis, **KW)


def _write_partial_call(kernel, b, r, c, axis):
    line = (b, r, 1) if axis == 1 else (b, 1, c)
    g, m, v, _, _ = _inputs(torch.device("cuda"), (b, r, c), line, 5)
    p = 1e-2 * g
    if kernel == "B7":
        return lambda: slim_update.slim_update_batched(p, g, m, v, axis=axis, lr=1e-3, **KW)
    return lambda: megaplan.mega_slim_partial_stats_batched(g, m, axis=axis, b1=0.9)


def _b10_call(b, r, c, axis, bf16):
    g, m, _, _, _ = _inputs(torch.device("cuda"), (b, r, c), (b, r, 1) if axis == 1 else (b, 1, c), 9)
    g = g.to(torch.bfloat16) if bf16 else g
    return lambda: slim_update.slim_partial_stats_batched(g, m, axis=axis, b1=0.9)


def _finalize_call(kernel, form):
    line = (12, 1, 384)
    _, m, v, ek, bc1 = _inputs(torch.device("cuda"), (12, 384, 384), line, 11)
    ek = ek if form == "ek" else None
    if kernel == "B13":
        bc2 = bc1 + 0.5
        return lambda: megaplan.mega_slim_finalize_batched(m, v, bc1, bc2, axis=0, ek=ek, b2=0.95, eps=1e-8)
    count = torch.tensor(3, dtype=torch.int32, device="cuda")
    return lambda: slim_update.slim_finalize_batched(m, v, axis=0, ek=ek, count=count, **KW)


SLIM_FORM_KERNELS = [
    (1, 2, 40000, 1, ("slim_split_sum", "slim_split_apply")),
    (1, 2000, 256, 0, ("slim_major_sum", "slim_major_apply")),
    (1, 300, 768, 1, ("slim_minor_kernel",)),
    (12, 768, 1536, 0, ("slim_major_kernel",)),
]
WRITE_PARTIAL_KERNELS = [
    (1, 2, 40000, 1, {"B7": ("slim_split_sum", "slim_split_apply"), "B12": ("slim_split_sum",
                                                                           "slim_partial_combine")}),
    (1, 2000, 256, 0, {"B7": ("slim_major_sum", "slim_major_apply"), "B12": ("slim_major_sum",
                                                                            "slim_partial_combine")}),
    (1, 300, 768, 1, {"B7": ("slim_minor_kernel",), "B12": ("slim_minor_kernel",)}),
    (12, 768, 1536, 0, {"B7": ("slim_major_kernel",), "B12": ("slim_major_kernel",)}),
]
TRACED_CALLS = ([("_b1_call", v[:4]) for v in SLIM_FORM_KERNELS]
                + [("_write_partial_call", (k,) + v[:4]) for v in WRITE_PARTIAL_KERNELS for k in ("B7", "B12")]
                + [("_b10_call", v[:4] + (bf16,)) for v in WRITE_PARTIAL_KERNELS for bf16 in (False, True)]
                + [("_finalize_call", (k, f)) for k in ("B11", "B13") for f in ("ek", "owner")])
_TRACE_MAIN = """
import json, sys
sys.path[:0] = sys.argv[1:3]
import test_torch_cuda as t
print(json.dumps([t._trace(getattr(t, name)(*args)) for name, args in json.loads(sys.argv[3])]))
"""


@pytest.fixture(scope="module")
def traced():
    """{(builder, arguments): device kernel names} of every call in
    TRACED_CALLS, traced in one fresh process. In this file's long pytest
    process on the H100 machine (torch 2.11, CUDA 12.8), traces taken after
    many tests lost device kernels, at times all of a call's and in 20
    traces in a row, while in a fresh process 300 traces of a call in a row
    all kept the call's kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    here = Path(__file__).resolve().parent
    args = [sys.executable, "-c", _TRACE_MAIN, str(here), str(here.parent / "src"), json.dumps(TRACED_CALLS)]
    done = subprocess.run(args, capture_output=True, text=True, timeout=900)
    if done.returncode != 0:
        raise AssertionError(f"the tracing process failed:\n{done.stderr[-4000:]}")
    names = json.loads(done.stdout.strip().splitlines()[-1])
    return {(name, tuple(a)): found for (name, a), found in zip(TRACED_CALLS, names)}


@pytest.mark.parametrize("rows,cols,n_bad", [(300, 512, 0), (300, 512, 37), (17, 12, 5)])
def test_mega_adam_update_health(dev, rows, cols, n_bad):
    g, m, _, bc1, bc2 = _inputs(dev, (rows, cols), (rows, 1), rows + n_bad)
    _poison(g, n_bad, rows)
    v = 0.01 * torch.rand((rows, cols), device=dev)
    got = megaplan.mega_adam_update(g, m, v, bc1, bc2, with_health=True, **KW)
    want = megaplan.mega_adam_update_plain(g, m, v, bc1, bc2, with_health=True, **KW)
    torch.cuda.synchronize()
    for a, b in zip(got[:3], want[:3]):
        _close_finite(a, b, ELEMENTWISE)
    assert torch.equal(got[3], want[3]) and float(got[3].sum()) == n_bad
    _close(got[4], want[4], LINE_SUMS)


@pytest.mark.parametrize("b,r,c,axis", [(1, 300, 768, 1), (2, 7, 33, 1), (1, 40, 70, 0), (12, 64, 100, 0)])
@pytest.mark.parametrize("with_snr,with_health", [(True, False), (False, True), (True, True)])
def test_mega_slim_update_batched_flags(dev, b, r, c, axis, with_snr, with_health):
    line = (b, r, 1) if axis == 1 else (b, 1, c)
    inputs = _inputs(dev, (b, r, c), line, b * r * c)
    n_bad = 11 if with_health else 0
    _poison(inputs[0], n_bad, c)
    flags = dict(with_snr=with_snr, with_health=with_health)
    got = megaplan.mega_slim_update_batched(*inputs, axis=axis, **flags, **KW)
    want = megaplan.mega_slim_update_batched_plain(*inputs, axis=axis, **flags, **KW)
    torch.cuda.synchronize()
    assert len(got) == len(want) == 3 + 2 * with_snr + 2 * with_health
    _close_finite(got[1], want[1], ELEMENTWISE)
    for a, w in zip(got[:3] + got[3:3 + 2 * with_snr], want[:3] + want[3:3 + 2 * with_snr]):
        _close_finite(a, w, LINE_SUMS)
    if with_health:
        assert torch.equal(got[-2], want[-2]) and float(got[-2].sum()) == n_bad
        _close(got[-1], want[-1], LINE_SUMS)


@pytest.mark.parametrize("shape", [(300, 512), (37, 129), (1, 9), (3000, 777)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_health", [False, True])
def test_adam_precond(dev, shape, dtype, with_health):
    g, m, _, _, _ = _inputs(dev, shape, shape, shape[0] * shape[1])
    g = _poison(g, 7 if with_health else 0, 3).to(dtype)
    v = 0.01 * torch.rand(shape, device=dev)
    count = torch.tensor(5, dtype=torch.int32, device=dev)
    before = fused_adam.adam_precond.launches
    got = fused_adam.adam_precond(g, m, v, count=count, with_health=with_health, **KW)
    bc1, bc2 = fused_adam.bias_corrections(0.9, 0.95, count)
    want = fused_adam.adam_precond_plain(g, m, v, bc1, bc2, with_health=with_health, **KW)
    torch.cuda.synchronize()
    assert fused_adam.adam_precond.launches == before + 1
    for a, b in zip(got[:3], want[:3]):
        _close_finite(a, b, ELEMENTWISE)
    if with_health:
        again = fused_adam.adam_precond(g, m, v, count=count, with_health=True, **KW)[3]
        assert float(got[3][0]) == float(want[3][0]) == 7
        _close(got[3][1:], want[3][1:], LINE_SUMS)
        assert torch.equal(got[3], again)      # fixed-order reduction: deterministic


@pytest.mark.parametrize("b,r,c,axis", [(1, 300, 768, 1), (12, 768, 64, 0), (1, 50, 33, 0), (3, 7, 130, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_snr,with_health", [(False, False), (True, True)])
def test_slim_precond_batched(dev, b, r, c, axis, dtype, with_snr, with_health):
    line = (b, r, 1) if axis == 1 else (b, 1, c)
    g, m, v, _, _ = _inputs(dev, (b, r, c), line, b + r + c)
    g = _poison(g, 5 if with_health else 0, 1).to(dtype)
    count = torch.tensor(2, dtype=torch.int32, device=dev)
    flags = dict(with_snr=with_snr, with_health=with_health)
    got = slim_update.slim_precond_batched(g, m, v, axis=axis, count=count, **flags, **KW)
    bc1, bc2 = fused_adam.bias_corrections(0.9, 0.95, count)
    want = slim_update.slim_precond_batched_plain(g, m, v, bc1, bc2, axis=axis, **flags, **KW)
    torch.cuda.synchronize()
    assert len(got) == len(want)
    _close_finite(got[1], want[1], ELEMENTWISE)
    for a, w in zip(got[:3] + got[3:3 + 2 * with_snr], want[:3] + want[3:3 + 2 * with_snr]):
        _close_finite(a, w, LINE_SUMS)
    if with_health:
        assert float(got[-1][0]) == float(want[-1][0]) == 5
        _close(got[-1][1:], want[-1][1:], LINE_SUMS)


def test_slim_precond_2d_wrappers(dev):
    g, m, _, _, _ = _inputs(dev, (40, 96), (40, 1), 4)
    for fn, v in ((slim_update.slim_precond, 0.01 * torch.rand(40, 1, device=dev)),
                  (slim_update.slim_precond_major, 0.01 * torch.rand(1, 96, device=dev))):
        got = fn(g, m, v, with_snr=True, with_health=True, **KW)
        assert [tuple(o.shape) for o in got] == [(40, 96), (40, 96)] + [tuple(v.shape)] * 3 + [(2,)]


# B1 and B4 on their split walk (megaplan.plan_slim on the H100's 132 SMs):
# SPLIT lines with float4 and 4-byte loads, MAJOR column tiles of 128 and 32
# columns, B > 1, and AdaLayer's and ResNet-18's shapes at full size.
SLIM_SPLIT_SHAPES = [(1, 2, 40000, 1), (2, 3, 30001, 1), (1, 1, 786432, 1), (1, 2000, 256, 0), (1, 1000, 130, 0),
                     (3, 600, 100, 0), (1, 4608, 1536, 0), (12, 3072, 768, 0)]


def _split_plan(dev, b, r, c, axis):
    plan = megaplan.plan_slim(b, r, c, axis, sms=torch.cuda.get_device_properties(dev).multi_processor_count,
                              aligned=True)
    assert plan.form == (megaplan.FORM_SPLIT if axis == 1 else megaplan.FORM_MAJOR) and plan.nseg > 1, plan
    return plan


def _hold_slim(got, want, n_bad, with_snr, with_health, per_leaf=False):
    """B1's or B4's outputs against the twin's: m' elementwise, the line
    values and u at LINE_SUMS, non-finite counts equal."""
    assert len(got) == len(want)
    _close_finite(got[1], want[1], ELEMENTWISE)
    for a, w in zip(got[:3] + got[3:3 + 2 * with_snr], want[:3] + want[3:3 + 2 * with_snr]):
        _close_finite(a, w, LINE_SUMS)
    if with_health and per_leaf:
        assert float(got[-1][0]) == float(want[-1][0]) == n_bad
        _close(got[-1][1:], want[-1][1:], LINE_SUMS)
    elif with_health:
        assert torch.equal(got[-2], want[-2]) and float(got[-2].sum()) == n_bad
        _close(got[-1], want[-1], LINE_SUMS)


@pytest.mark.parametrize("b,r,c,axis", SLIM_SPLIT_SHAPES)
@pytest.mark.parametrize("with_snr,with_health", [(False, False), (True, False), (False, True), (True, True)])
def test_mega_slim_split_forms(dev, b, r, c, axis, with_snr, with_health):
    """B1's SPLIT and MAJOR forms against the twin, with each flag, and two
    launches on one input bit-identical (fixed-order combine)."""
    _split_plan(dev, b, r, c, axis)
    line = (b, r, 1) if axis == 1 else (b, 1, c)
    inputs = _inputs(dev, (b, r, c), line, b * r * c)
    n_bad = 13 if with_health else 0
    _poison(inputs[0], n_bad, c)
    flags = dict(with_snr=with_snr, with_health=with_health)
    before = megaplan.mega_slim_update_batched.launches
    got = megaplan.mega_slim_update_batched(*inputs, axis=axis, **flags, **KW)
    again = megaplan.mega_slim_update_batched(*inputs, axis=axis, **flags, **KW)
    want = megaplan.mega_slim_update_batched_plain(*inputs, axis=axis, **flags, **KW)
    torch.cuda.synchronize()
    assert megaplan.mega_slim_update_batched.launches == before + 2
    _hold_slim(got, want, n_bad, with_snr, with_health)
    for a, a2 in zip(got, again):
        assert torch.equal(a.nan_to_num(), a2.nan_to_num()) and torch.equal(a.isnan(), a2.isnan())


@pytest.mark.parametrize("b,r,c,axis", SLIM_SPLIT_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_snr,with_health", [(False, False), (True, True)])
def test_slim_precond_split_forms(dev, b, r, c, axis, dtype, with_snr, with_health):
    """B4 on the same walk, f32 and bf16 g (four bf16 a load), its (2,)
    health reduced from the split lines; two launches bit-identical."""
    _split_plan(dev, b, r, c, axis)
    line = (b, r, 1) if axis == 1 else (b, 1, c)
    g, m, v, _, _ = _inputs(dev, (b, r, c), line, b + r + c)
    n_bad = 9 if with_health else 0
    g = _poison(g, n_bad, 2).to(dtype)
    count = torch.tensor(3, dtype=torch.int32, device=dev)
    flags = dict(with_snr=with_snr, with_health=with_health)
    before = slim_update.slim_precond_batched.launches
    got = slim_update.slim_precond_batched(g, m, v, axis=axis, count=count, **flags, **KW)
    again = slim_update.slim_precond_batched(g, m, v, axis=axis, count=count, **flags, **KW)
    bc1, bc2 = fused_adam.bias_corrections(0.9, 0.95, count)
    want = slim_update.slim_precond_batched_plain(g, m, v, bc1, bc2, axis=axis, **flags, **KW)
    torch.cuda.synchronize()
    assert slim_update.slim_precond_batched.launches == before + 2
    _hold_slim(got, want, n_bad, with_snr, with_health, per_leaf=True)
    for a, a2 in zip(got, again):
        assert torch.equal(a.nan_to_num(), a2.nan_to_num()) and torch.equal(a.isnan(), a2.isnan())


@pytest.mark.parametrize("b,r,c,axis", [(1, 2, 40000, 1), (1, 2000, 256, 0)])
@pytest.mark.parametrize("per_leaf", [False, True])
def test_slim_split_unaligned(dev, b, r, c, axis, per_leaf):
    """g 4 bytes off a 16-byte boundary takes the split walk's 4-byte loads."""
    line = (b, r, 1) if axis == 1 else (b, 1, c)
    g, m, v, bc1, bc2 = _inputs(dev, (b, r, c), line, r)
    g = _offset_view(g)
    plan = megaplan.plan_slim(b, r, c, axis, sms=torch.cuda.get_device_properties(dev).multi_processor_count,
                              aligned=False)
    assert plan.nseg > 1 and not plan.vec
    if per_leaf:
        got = slim_update.slim_precond_batched(g, m, v, axis=axis, count=2, **KW)
        c1, c2 = fused_adam.host_bias_corrections(0.9, 0.95, 2)
        want = megaplan.mega_slim_update_batched_plain(g, m, v, c1, c2, axis=axis, **KW)
    else:
        got = megaplan.mega_slim_update_batched(g, m, v, bc1, bc2, axis=axis, **KW)
        want = megaplan.mega_slim_update_batched_plain(g, m, v, bc1, bc2, axis=axis, **KW)
    torch.cuda.synchronize()
    _hold_slim(got, want, 0, False, False)


@pytest.mark.parametrize("per_leaf", [False, True])
def test_slim_embedding_line(dev, per_leaf):
    """AdaLayer's embedding as one 38,633,472-element line (SPLIT, 2358
    segments on an H100): B1 and B4 against the twin, and bit-equal reruns."""
    b, r, c, axis = 1, 1, 50304 * 768, 1
    assert _split_plan(dev, b, r, c, axis).nseg >= 4 * 132
    g, m, v, bc1, bc2 = _inputs(dev, (b, r, c), (b, r, 1), 7)
    g = 1e-3 * g
    if per_leaf:
        run = lambda: slim_update.slim_precond_batched(g, m, v, axis=axis, count=5, **KW)   # noqa: E731
        c1, c2 = fused_adam.host_bias_corrections(0.9, 0.95, 5)
        want = megaplan.mega_slim_update_batched_plain(g, m, v, c1, c2, axis=axis, **KW)
    else:
        run = lambda: megaplan.mega_slim_update_batched(g, m, v, bc1, bc2, axis=axis, **KW)  # noqa: E731
        want = megaplan.mega_slim_update_batched_plain(g, m, v, bc1, bc2, axis=axis, **KW)
    got, again = run(), run()
    torch.cuda.synchronize()
    _hold_slim(got, want, 0, False, False)
    assert all(torch.equal(a, a2) for a, a2 in zip(got, again))


@pytest.mark.parametrize("b,r,c,axis,names", SLIM_FORM_KERNELS)
def test_slim_forms_run_their_device_kernels(traced, dev, b, r, c, axis, names):
    """A split view runs pass 1 then pass 2 (two device kernels); Table 3's
    views keep the ROWS form's one kernel."""
    kernels = traced[("_b1_call", (b, r, c, axis))]
    assert len(kernels) == len(names) and all(n in k for n, k in zip(names, kernels)), kernels


# B7 and B12 on the same walk: the split shapes above, and views that keep
# ROWS on both axes.
WRITE_PARTIAL_SHAPES = SLIM_SPLIT_SHAPES + [(1, 300, 768, 1), (12, 768, 1536, 0)]
P_G_DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
              (torch.bfloat16, torch.float32)]


def _form(dev, b, r, c, axis, aligned=True):
    return megaplan.plan_slim(b, r, c, axis, sms=torch.cuda.get_device_properties(dev).multi_processor_count,
                              aligned=aligned)


def _bit_equal(got, again):
    for a, a2 in zip(got, again):
        assert torch.equal(a.float().nan_to_num(), a2.float().nan_to_num()) and torch.equal(a.isnan(), a2.isnan())


@pytest.mark.parametrize("b,r,c,axis", WRITE_PARTIAL_SHAPES)
@pytest.mark.parametrize("p_dtype,g_dtype", P_G_DTYPES)
@pytest.mark.parametrize("unaligned", [False, True])
def test_slim_update_split_forms(dev, b, r, c, axis, p_dtype, g_dtype, unaligned):
    """B7 on SPLIT, MAJOR and ROWS against its twin, the four (p, g) dtype
    pairs, aligned and one element off (the 4-byte walk), two launches
    bit-identical; p' against B4's u and the same step."""
    p, g, m, gen = _param_inputs(dev, (b, r, c), b + r + c + axis, p_dtype, g_dtype)
    line = (b, r, 1) if axis == 1 else (b, 1, c)
    v = 1e-4 * torch.rand(line, generator=gen, device=dev)
    if unaligned:
        p, g = _offset_view(p), _offset_view(g)
    plan = _form(dev, b, r, c, axis, aligned=not unaligned)
    assert plan.vec == (not unaligned and c % 4 == 0)
    kw = dict(lr=1e-3, wd=0.1, **KW)
    before = slim_update.slim_update_batched.launches
    got = slim_update.slim_update_batched(p, g, m, v, axis=axis, count=3, **kw)
    again = slim_update.slim_update_batched(p, g, m, v, axis=axis, count=3, **kw)
    bc1, bc2 = fused_adam.host_bias_corrections(0.9, 0.95, 3)
    want = slim_update.slim_update_batched_plain(p, g, m, v, axis=axis, bc1=bc1, bc2=bc2, **kw)
    u = slim_update.slim_precond_batched(g, m, v, axis=axis, count=3, **KW)[0]
    torch.cuda.synchronize()
    assert slim_update.slim_update_batched.launches == before + 2
    assert got[0].dtype == p_dtype
    _close(got[0].float(), want[0].float(), max(_p_tol(got[0]), LINE_SUMS))
    _close(got[1], want[1], ELEMENTWISE)
    _close(got[2], want[2], LINE_SUMS)
    _close(got[0].float(), fused_adam.param_step(p, u, lr=1e-3, wd=0.1).float(), _p_tol(got[0]))
    _bit_equal(got, again)


@pytest.mark.parametrize("b,r,c,axis", WRITE_PARTIAL_SHAPES)
@pytest.mark.parametrize("with_snr,with_health", [(False, False), (True, False), (False, True), (True, True)])
@pytest.mark.parametrize("unaligned", [False, True])
def test_mega_slim_partial_split_forms(dev, b, r, c, axis, with_snr, with_health, unaligned):
    """B12 on SPLIT, MAJOR and ROWS against its twin, with each flag, aligned
    and 4 bytes off (the 4-byte walk), two launches bit-identical (the
    combine adds each line's shares in a fixed order)."""
    line = (b, r, 1) if axis == 1 else (b, 1, c)
    g, m, _, _, _ = _inputs(dev, (b, r, c), line, r + c)
    n_bad = 11 if with_health else 0
    _poison(g, n_bad, 7)
    if unaligned:
        g = _offset_view(g)
    plan = _form(dev, b, r, c, axis, aligned=not unaligned)
    assert plan.vec == (not unaligned and c % 4 == 0)
    flags = dict(with_snr=with_snr, with_health=with_health)
    before = megaplan.mega_slim_partial_stats_batched.launches
    got = megaplan.mega_slim_partial_stats_batched(g, m, axis=axis, b1=0.9, **flags)
    again = megaplan.mega_slim_partial_stats_batched(g, m, axis=axis, b1=0.9, **flags)
    want = megaplan.mega_slim_partial_stats_batched_plain(g, m, axis=axis, b1=0.9, **flags)
    torch.cuda.synchronize()
    assert megaplan.mega_slim_partial_stats_batched.launches == before + 2
    assert len(got) == len(want) == 2 + 3 * with_snr + 2 * with_health
    _close_finite(got[0], want[0], ELEMENTWISE)
    for a, w in zip(got[1:2] + got[2:4 if with_snr else 2], want[1:2] + want[2:4 if with_snr else 2]):
        _close_finite(a, w, LINE_SUMS)
    if with_snr:
        assert torch.equal(got[4].nan_to_num(), want[4].nan_to_num())
    if with_health:
        assert torch.equal(got[-2], want[-2]) and float(got[-2].sum()) == n_bad
        _close(got[-1], want[-1], LINE_SUMS)
    _bit_equal(got, again)


@pytest.mark.parametrize("kernel", ["B7", "B12"])
@pytest.mark.parametrize("b,r,c,axis,names", WRITE_PARTIAL_KERNELS)
def test_write_partial_forms_run_their_device_kernels(traced, dev, kernel, b, r, c, axis, names):
    """B7 on a split view runs B4's pass 1 and its pass 2; B12 its pass 1
    (with the m' write) and the combine; the ROWS views one kernel each."""
    found = traced[("_write_partial_call", (kernel, b, r, c, axis))]
    want = names[kernel]
    assert len(found) == len(want) and all(n in k for n, k in zip(want, found)), found


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("b,r,c,axis,names", WRITE_PARTIAL_KERNELS)
def test_slim_partial_stats_forms_run_their_device_kernels(traced, dev, b, r, c, axis, names, bf16):
    """B10 (the per-leaf psum pass 1), f32 and bf16 g, runs B12's device
    kernels on each form: SPLIT and MAJOR their pass 1 and the combine,
    the ROWS views one kernel."""
    found = traced[("_b10_call", (b, r, c, axis, bf16))]
    want = names["B12"]
    assert len(found) == len(want) and all(n in k for n, k in zip(want, found)), found


@pytest.mark.parametrize("b,r,c,axis", WRITE_PARTIAL_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_snr,with_health", [(False, False), (True, False), (False, True), (True, True)])
@pytest.mark.parametrize("unaligned", [False, True])
def test_slim_partial_stats_split_forms(dev, b, r, c, axis, dtype, with_snr, with_health, unaligned):
    """B10 on SPLIT, MAJOR and ROWS against its twin, f32 and bf16 g (four
    bf16 a load), with each flag, aligned and one element off, its (2,)
    health reduced from the combined lines; two launches bit-identical, and
    with f32 g bit-equal to B12 on the same operands (the same plan and
    kernels)."""
    line = (b, r, 1) if axis == 1 else (b, 1, c)
    g, m, _, _, _ = _inputs(dev, (b, r, c), line, r + c + 1)
    n_bad = 11 if with_health else 0
    g = _poison(g, n_bad, 3).to(dtype)
    if unaligned:
        g = _offset_view(g)
    plan = _form(dev, b, r, c, axis, aligned=not unaligned)
    flags = dict(with_snr=with_snr, with_health=with_health)
    before = slim_update.slim_partial_stats_batched.launches
    got = slim_update.slim_partial_stats_batched(g, m, axis=axis, b1=0.9, **flags)
    assert megaplan.last_plans["slim_partial_stats_batched"] == plan
    again = slim_update.slim_partial_stats_batched(g, m, axis=axis, b1=0.9, **flags)
    want = slim_update.slim_partial_stats_batched_plain(g, m, axis=axis, b1=0.9, **flags)
    torch.cuda.synchronize()
    assert slim_update.slim_partial_stats_batched.launches == before + 2
    assert len(got) == len(want) == 2 + 3 * with_snr + with_health
    _close_finite(got[0], want[0], ELEMENTWISE)
    for a, w in zip(got[1:2] + got[2:4 if with_snr else 2], want[1:2] + want[2:4 if with_snr else 2]):
        _close_finite(a, w, LINE_SUMS)
    if with_snr:
        assert torch.equal(got[4].nan_to_num(), want[4].nan_to_num())
    if with_health:
        assert float(got[-1][0]) == float(want[-1][0]) == n_bad
        _close(got[-1][1:], want[-1][1:], LINE_SUMS)
    _bit_equal(got, again)
    if dtype == torch.float32:
        grouped = megaplan.mega_slim_partial_stats_batched(g, m, axis=axis, b1=0.9, **flags)
        _bit_equal(got[:len(got) - with_health], grouped[:len(got) - with_health])


# The sharded psum kernels at the local shard shapes of gpt_small on a
# (data=2, model=2) mesh (batched major wq/wk, minor wo/wv/w_down/embed
# lines of 384, w_up lines of 1536) and ragged ones.
PSUM_SHAPES = [(12, 384, 384, 0), (1, 4608, 1536, 1), (1, 300, 33, 1), (3, 50, 130, 0)]


@pytest.mark.parametrize("b,r,c,axis", [(1, 300, 768, 1), (1, 1, 100003, 1), (12, 384, 384, 0), (3, 50, 130, 0),
                                        (1, 1, 9658368, 1), (1, 25152, 384, 0)] + SPLIT_SHAPES)
def test_snr_stats_centered_partial_batched(dev, b, r, c, axis):
    v = 1.0 + 1e-3 * torch.rand((b, r, c), generator=torch.Generator(device=dev).manual_seed(c), device=dev)
    before = snr_stats.snr_stats_centered_partial_batched.launches
    got = snr_stats.snr_stats_centered_partial_batched(v, axis=axis)
    want = snr_stats.snr_stats_centered_partial_batched_plain(v, axis=axis)
    torch.cuda.synchronize()
    assert snr_stats.snr_stats_centered_partial_batched.launches == before + 1
    for a, w in zip(got[:3], want[:3]):
        _close(a, w, LINE_SUMS)
    assert torch.equal(got[3], want[3])


@pytest.mark.parametrize("b,r,c,axis", PSUM_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_snr,with_health", [(False, False), (True, False), (False, True), (True, True)])
def test_slim_partial_stats_batched(dev, b, r, c, axis, dtype, with_snr, with_health):
    line = (b, r, 1) if axis == 1 else (b, 1, c)
    g, m, _, _, _ = _inputs(dev, (b, r, c), line, r + c)
    g = _poison(g, 5 if with_health else 0, 2).to(dtype)
    flags = dict(with_snr=with_snr, with_health=with_health)
    before = slim_update.slim_partial_stats_batched.launches
    got = slim_update.slim_partial_stats_batched(g, m, axis=axis, b1=0.9, **flags)
    want = slim_update.slim_partial_stats_batched_plain(g, m, axis=axis, b1=0.9, **flags)
    torch.cuda.synchronize()
    assert slim_update.slim_partial_stats_batched.launches == before + 1
    assert len(got) == len(want) == 2 + 3 * with_snr + with_health
    _close_finite(got[0], want[0], ELEMENTWISE)
    for a, w in zip(got[1:2] + got[2:4 if with_snr else 2], want[1:2] + want[2:4 if with_snr else 2]):
        _close_finite(a, w, LINE_SUMS)
    if with_snr:
        assert torch.equal(got[4], want[4])
    if with_health:
        assert float(got[-1][0]) == float(want[-1][0]) == 5
        _close(got[-1][1:], want[-1][1:], LINE_SUMS)


@pytest.mark.parametrize("b,r,c,axis", PSUM_SHAPES)
@pytest.mark.parametrize("form", ["ek", "owner"])
def test_slim_finalize_batched(dev, b, r, c, axis, form):
    line = (b, r, 1) if axis == 1 else (b, 1, c)
    _, m, v, ek, _ = _inputs(dev, (b, r, c), line, 3 * c)
    ek = ek if form == "ek" else None
    count = torch.tensor(4, dtype=torch.int32, device=dev)
    before = slim_update.slim_finalize_batched.launches
    got = slim_update.slim_finalize_batched(m, v, axis=axis, ek=ek, count=count, **KW)
    bc1, bc2 = fused_adam.bias_corrections(0.9, 0.95, count)
    want = slim_update.slim_finalize_batched_plain(m, v, bc1, bc2, b2=0.95, eps=1e-8, ek=ek)
    torch.cuda.synchronize()
    assert slim_update.slim_finalize_batched.launches == before + 1
    for a, w in zip(got if ek is not None else (got,), want if ek is not None else (want,)):
        _close(a, w, ELEMENTWISE)


@pytest.mark.parametrize("b,r,c,axis", PSUM_SHAPES)
@pytest.mark.parametrize("form", ["ek", "owner"])
@pytest.mark.parametrize("count", [1, 3, 10**4, 10**6])
def test_slim_finalize_count_forms(dev, b, r, c, axis, form, count):
    """B11 with the count as a 0-d int32 and int64 tensor on the card (the
    kernel forms 1 - b^t with powf) equals the twin given torch's bias
    corrections of the same tensor on the card bit for bit; with the count
    as a Python int (host-rounded corrections) it equals the twin given
    those as 0-d tensors on the card (torch on the card divides by a Python
    float as a product with its reciprocal); a second run equals the
    first."""
    line = (b, r, 1) if axis == 1 else (b, 1, c)
    _, m, v, ek, _ = _inputs(dev, (b, r, c), line, count % 101 + c)
    ek = ek if form == "ek" else None
    cases = [(torch.tensor(count, dtype=dt, device=dev), fused_adam.bias_corrections(0.9, 0.95, torch.tensor(
        count, dtype=dt, device=dev))) for dt in (torch.int32, torch.int64)]
    cases.append((count, tuple(torch.tensor(x, device=dev) for x in fused_adam.host_bias_corrections(0.9, 0.95,
                                                                                                       count))))
    for cnt, (bc1, bc2) in cases:
        before = slim_update.slim_finalize_batched.launches
        got = slim_update.slim_finalize_batched(m, v, axis=axis, ek=ek, count=cnt, **KW)
        again = slim_update.slim_finalize_batched(m, v, axis=axis, ek=ek, count=cnt, **KW)
        want = slim_update.slim_finalize_batched_plain(m, v, bc1, bc2, b2=0.95, eps=1e-8, ek=ek)
        torch.cuda.synchronize()
        assert slim_update.slim_finalize_batched.launches == before + 2
        for a, a2, w in zip(*((x,) if ek is None else x for x in (got, again, want))):
            assert torch.equal(a, w), (type(cnt), float((a - w).abs().max()))
            assert torch.equal(a, a2)


@pytest.mark.parametrize("b,r,c,axis", PSUM_SHAPES)
@pytest.mark.parametrize("form", ["ek", "owner"])
def test_slim_finalize_other_plans(dev, b, r, c, axis, form):
    """Every instantiation of the flat walk on one view: scalar loads where
    the planner takes float4, 64-bit indices, and a grid of a single block
    walking every tile, each bit-equal to the twin."""
    line = (b, r, 1) if axis == 1 else (b, 1, c)
    _, m, v, ek, _ = _inputs(dev, (b, r, c), line, 7 * r)
    ek = ek if form == "ek" else None
    count = torch.tensor(5, dtype=torch.int32, device=dev)
    want = slim_update.slim_finalize_batched_plain(m, v, *fused_adam.bias_corrections(0.9, 0.95, count), b2=0.95,
                                                   eps=1e-8, ek=ek)
    base = slim_update.plan_finalize(b, r, c, axis, torch.cuda.get_device_properties(dev).multi_processor_count)
    plans = [base, dataclasses.replace(base, vec=1), dataclasses.replace(base, wide=True),
             dataclasses.replace(base, blocks=1)]
    for plan in plans:
        got = slim_update.launch_finalize_flat(plan, m, v, ek, count, **KW)
        torch.cuda.synchronize()
        for a, w in zip(*((x,) if ek is None else x for x in (got, want))):
            assert torch.equal(a, w), plan


@pytest.mark.parametrize("form", ["ek", "owner"])
@pytest.mark.parametrize("kernel", ["B11", "B13"])
def test_slim_finalize_is_one_device_kernel(traced, dev, kernel, form):
    """One B11 or B13 call is one CUDA kernel in a torch.profiler trace, the
    flat walk's: B11's bias corrections are formed inside it, B13's read a
    line, not by torch operations around it."""
    kernels = traced[("_finalize_call", (kernel, form))]
    assert len(kernels) == 1 and "finalize_flat_kernel" in kernels[0], kernels


@pytest.mark.parametrize("b,r,c,axis", PSUM_SHAPES)
@pytest.mark.parametrize("with_snr,with_health", [(False, False), (True, False), (False, True), (True, True)])
def test_mega_slim_partial_stats_batched(dev, b, r, c, axis, with_snr, with_health):
    line = (b, r, 1) if axis == 1 else (b, 1, c)
    g, m, _, _, _ = _inputs(dev, (b, r, c), line, r * c)
    _poison(g, 9 if with_health else 0, 5)
    flags = dict(with_snr=with_snr, with_health=with_health)
    before = megaplan.mega_slim_partial_stats_batched.launches
    got = megaplan.mega_slim_partial_stats_batched(g, m, axis=axis, b1=0.9, **flags)
    want = megaplan.mega_slim_partial_stats_batched_plain(g, m, axis=axis, b1=0.9, **flags)
    torch.cuda.synchronize()
    assert megaplan.mega_slim_partial_stats_batched.launches == before + 1
    assert len(got) == len(want) == 2 + 3 * with_snr + 2 * with_health
    _close_finite(got[0], want[0], ELEMENTWISE)
    for a, w in zip(got[1:2] + got[2:4 if with_snr else 2], want[1:2] + want[2:4 if with_snr else 2]):
        _close_finite(a, w, LINE_SUMS)
    if with_snr:
        assert torch.equal(got[4], want[4])
    if with_health:
        assert torch.equal(got[-2], want[-2]) and float(got[-2].sum()) == 9
        _close(got[-1], want[-1], LINE_SUMS)


@pytest.mark.parametrize("b,r,c,axis", PSUM_SHAPES)
@pytest.mark.parametrize("form", ["ek", "owner"])
def test_mega_slim_finalize_batched(dev, b, r, c, axis, form):
    line = (b, r, 1) if axis == 1 else (b, 1, c)
    _, m, v, bc1, bc2 = _inputs(dev, (b, r, c), line, 5 * r)
    ek = 0.01 * torch.rand(line, device=dev) if form == "ek" else None
    before = megaplan.mega_slim_finalize_batched.launches
    got = megaplan.mega_slim_finalize_batched(m, v, bc1, bc2, axis=axis, ek=ek, b2=0.95, eps=1e-8)
    want = slim_update.slim_finalize_batched_plain(m, v, bc1, bc2, b2=0.95, eps=1e-8, ek=ek)
    torch.cuda.synchronize()
    assert megaplan.mega_slim_finalize_batched.launches == before + 1
    for a, w in zip(got if ek is not None else (got,), want if ek is not None else (want,)):
        _close(a, w, ELEMENTWISE)


@pytest.mark.parametrize("b,r,c,axis", PSUM_SHAPES)
@pytest.mark.parametrize("form", ["ek", "owner"])
def test_mega_slim_finalize_other_plans(dev, b, r, c, axis, form):
    """B13 on every instantiation of the flat walk with bias corrections a
    line (distinct values): the planner's grid, scalar loads, 64-bit
    indices, a single block walking every tile, and lines one element off
    a 16-byte boundary (which the planner walks with scalar loads on axis
    0); each bit-equal to the twin, two runs bit-equal."""
    line = (b, r, 1) if axis == 1 else (b, 1, c)
    _, m, v, bc1, bc2 = _inputs(dev, (b, r, c), line, 9 * r + c)
    ek = 0.01 * torch.rand(line, device=dev) if form == "ek" else None
    want = slim_update.slim_finalize_batched_plain(m, v, bc1, bc2, b2=0.95, eps=1e-8, ek=ek)
    base = slim_update.plan_finalize(b, r, c, axis, torch.cuda.get_device_properties(dev).multi_processor_count)
    plans = [base, dataclasses.replace(base, vec=1), dataclasses.replace(base, wide=True),
             dataclasses.replace(base, blocks=1)]
    for plan in plans:
        got = slim_update.launch_finalize_flat(plan, m, v, ek, None, b1=0.0, b2=0.95, eps=1e-8, bc_lines=(bc1, bc2))
        torch.cuda.synchronize()
        for a, w in zip(*((x,) if ek is None else x for x in (got, want))):
            assert torch.equal(a, w), plan
    l1, l2 = _offset_view(bc1), _offset_view(bc2)
    assert slim_update.finalize_plan(m, axis, (v, ek, l1, l2)).vec == (1 if axis == 0 or c % 4 else 4)
    got = megaplan.mega_slim_finalize_batched(m, v, l1, l2, axis=axis, ek=ek, b2=0.95, eps=1e-8)
    again = megaplan.mega_slim_finalize_batched(m, v, l1, l2, axis=axis, ek=ek, b2=0.95, eps=1e-8)
    torch.cuda.synchronize()
    for a, a2, w in zip(*((x,) if ek is None else x for x in (got, again, want))):
        assert torch.equal(a, w) and torch.equal(a, a2)


@pytest.mark.parametrize("b,r,c,axis", PSUM_SHAPES + [(1, 1, 25152 * 384, 1)])
def test_psum_pair_per_leaf_equals_grouped(dev, b, r, c, axis):
    """The per-leaf kernels (B10, B11) and the group kernels (B12, B13) run
    the same line walk: equal bits on the same operands."""
    line = (b, r, 1) if axis == 1 else (b, 1, c)
    g, m, v, _, _ = _inputs(dev, (b, r, c), line, b + c)
    per_leaf = slim_update.slim_partial_stats_batched(g, m, axis=axis, b1=0.9, with_snr=True)
    grouped = megaplan.mega_slim_partial_stats_batched(g, m, axis=axis, b1=0.9, with_snr=True)
    for a, w in zip(per_leaf, grouped):
        assert torch.equal(a, w)
    count = torch.tensor(3, dtype=torch.int32, device=dev)
    bc1, bc2 = fused_adam.bias_corrections(0.9, 0.95, count)
    ek = per_leaf[1] / (c if axis == 1 else r)
    a = slim_update.slim_finalize_batched(per_leaf[0], v, axis=axis, ek=ek, count=count, **KW)
    w = megaplan.mega_slim_finalize_batched(grouped[0], v, bc1.expand(line).contiguous(),
                                            bc2.expand(line).contiguous(), axis=axis, ek=ek, b2=0.95, eps=1e-8)
    torch.cuda.synchronize()
    assert torch.equal(a[0], w[0]) and torch.equal(a[1], w[1])


def _paged_case(dev, *, c, kv, rep, hd, page, pool_dtype, q_dtype, b=5, max_pages=6, seed=0):
    """Pool, distinct tables (row 2 padded with the null page), ragged
    lengths. Decode: a full row, one a position into its second page, an
    inactive row, one mid-page, one of a single position. Chunk: a full
    row, a prefill from 0, one at pos0 = 2 pages, one whose padded length
    passes the row's pages, one past the table's reach."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    pool = torch.randn((b * max_pages + 1, page, 2 * kv, hd), generator=gen, device=dev).to(pool_dtype)
    table = (1 + torch.arange(b * max_pages, dtype=torch.int32, device=dev)).reshape(b, max_pages)
    table[2, 3:] = 0
    reach = max_pages * page
    lengths = ([reach, page + 1, 0, 3 * page - 2, 1] if c == 1
               else [reach, c, 2 * page + c, 3 * page + c, reach + c - 1])
    q = torch.randn((b, c, kv * rep, hd), generator=gen, device=dev).to(q_dtype)
    return q, pool, table, torch.tensor(lengths, dtype=torch.int32, device=dev)


@pytest.mark.parametrize("hd,kv,rep", [(64, 3, 3), (16, 1, 3), (32, 3, 1), (128, 2, 4), (64, 1, 32)])
@pytest.mark.parametrize("c", [1, 11, 128])
@pytest.mark.parametrize("page", [4, 16, 64])
@pytest.mark.parametrize("pool_dtype", [torch.float32, torch.bfloat16])
def test_paged_attention(dev, hd, kv, rep, c, page, pool_dtype):
    q, pool, table, lengths = _paged_case(dev, c=c, kv=kv, rep=rep, hd=hd, page=page, pool_dtype=pool_dtype,
                                          q_dtype=torch.float32)
    before = pa.paged_attention.launches
    got = pa.paged_attention(q, pool, table, lengths)
    want = pa.paged_attention_plain(q, pool, table, lengths)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 1
    _close(got, want, LINE_SUMS)
    if c == 1:
        assert not got[2].any(), "an inactive row is exactly 0"


@pytest.mark.parametrize("c", [1, 128])
def test_paged_attention_bf16_queries(dev, c):
    q, pool, table, lengths = _paged_case(dev, c=c, kv=3, rep=3, hd=64, page=16, pool_dtype=torch.bfloat16,
                                          q_dtype=torch.bfloat16)
    got = pa.paged_attention(q, pool, table, lengths)
    want = pa.paged_attention_plain(q, pool, table, lengths)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    _close(got, want, 2.0**-7)


def _main_path_case(dev, *, c, lengths, alloc, q_dtype, max_pages=128, page=16, seed=0):
    """chip_smoke's phase-4 operands: full-width smollm_135m attention (9
    query heads over 3 KV groups, hd 64), a bf16 pool holding the pages
    that ``alloc`` positions of each row need, 128-page table rows."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    table = torch.zeros((len(alloc), max_pages), dtype=torch.int32)
    first = 1
    for i, n in enumerate(-(-int(x) // page) for x in alloc):
        table[i, :n] = torch.arange(first, first + n, dtype=torch.int32)
        first += n
    pool = torch.randn((first, page, 6, 64), generator=gen, device=dev).to(torch.bfloat16)
    q = torch.randn((len(alloc), c, 9, 64), generator=gen, device=dev).to(q_dtype)
    return q, pool, table.to(dev), torch.tensor([int(x) for x in lengths], dtype=torch.int32, device=dev)


_DECODE = np.random.default_rng(0).integers(1, 2049, 16)
_DECODE[0], _DECODE[1] = 0, 16 * 37 + 5
MAIN_PATH = {"decode": dict(c=1, lengths=_DECODE, alloc=_DECODE),
             "prefill_pos0_1024": dict(c=128, lengths=[1024 + 128], alloc=[1024 + 100])}


@pytest.mark.parametrize("case", list(MAIN_PATH))
def test_paged_attention_bf16_queries_main_path(dev, case):
    """The serving path's types at the main path's shapes: the prefill
    chunk takes the tensor-core form (bf16 products, f32 sums)."""
    args = _main_path_case(dev, q_dtype=torch.bfloat16, **MAIN_PATH[case])
    plan = pa.plan_of(*args)
    assert plan.form == (pa.FORM_MMA if case != "decode" else pa.FORM_CORES) and plan.pieces > 1
    got = pa.paged_attention(*args)
    want = pa.paged_attention_plain(*args)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    _close(got, want, 2.0**-7)
    if case == "decode":
        assert not got[0].any(), "the inactive row is exactly 0"


@pytest.mark.parametrize("case", list(MAIN_PATH) + ["card"])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_is_deterministic(dev, case, q_dtype):
    """The split walk's combine runs in piece order: two runs are equal bit
    for bit."""
    if case == "card":
        args = _paged_case(dev, c=11, kv=3, rep=3, hd=64, page=64, pool_dtype=torch.bfloat16, q_dtype=q_dtype)
    else:
        args = _main_path_case(dev, q_dtype=q_dtype, **MAIN_PATH[case])
    first = pa.paged_attention(*args)
    second = pa.paged_attention(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("c", [1, 11, 128])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_long_table(dev, c, q_dtype):
    """Table rows far longer than any live length: at least half the pieces
    of every row start past its keys and exit at once."""
    lengths = [100, c, 0, 37 + c, 16 * 40 + 3] if c == 1 else [100 + c, c, 37 + c, 16 * 40 + 3, 2 * c]
    args = _main_path_case(dev, c=c, lengths=lengths, alloc=[max(n, 1) for n in lengths], q_dtype=q_dtype)
    plan = pa.plan_of(*args)
    assert plan.pieces >= 2 * -(-max(lengths) // (16 * plan.pages))
    got = pa.paged_attention(*args)
    want = pa.paged_attention_plain(*args)
    torch.cuda.synchronize()
    _close(got, want, LINE_SUMS if q_dtype == torch.float32 else 2.0**-7)
    if c == 1:
        assert not got[2].any(), "the inactive row is exactly 0"


def test_paged_attention_rejects_unsupported_geometry(dev):
    """Geometry the kernel does not take raises; it never runs the twin."""
    before = pa.paged_attention.launches
    q, pool, table, lengths = _paged_case(dev, c=1, kv=1, rep=3, hd=48, page=4, pool_dtype=torch.float32,
                                          q_dtype=torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_attention(q, pool, table, lengths)
    q, pool, table, lengths = _paged_case(dev, c=1, kv=1, rep=33, hd=16, page=4, pool_dtype=torch.float32,
                                          q_dtype=torch.float32)
    with pytest.raises(ValueError, match="per KV group"):
        pa.paged_attention(q, pool, table, lengths)
    q, pool, table, lengths = _paged_case(dev, c=1, kv=1, rep=3, hd=16, page=4, pool_dtype=torch.float32,
                                          q_dtype=torch.float32)
    shifted = torch.empty(pool.numel() + 1, device=dev)[1:].view(pool.shape)   # 4 bytes off
    with pytest.raises(ValueError, match="16-byte"):
        pa.paged_attention(q, shifted, table, lengths)
    shifted_q = torch.empty(q.numel() + 1, device=dev)[1:].view(q.shape)
    with pytest.raises(ValueError, match="16-byte"):
        pa.paged_attention(shifted_q, pool, table, lengths)
    with pytest.raises(TypeError):
        pa.paged_attention(q, pool, table.long(), lengths)
    assert pa.paged_attention.launches == before


@pytest.mark.parametrize("kv,rep", [(16, 1), (4, 8)])
@pytest.mark.parametrize("c", [1, 128])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_moe_geometry(dev, kv, rep, c, q_dtype):
    """The MoE models' attention: olmoe_1b_7b's 16 heads of 128 over 16 KV
    groups (one query head a group) and qwen3_moe_30b_a3b's 4 groups of 8
    heads of 128 (its 32 heads), pages of 16 over a bf16 pool; two runs
    bit-equal."""
    q, pool, table, lengths = _paged_case(dev, c=c, kv=kv, rep=rep, hd=128, page=16, pool_dtype=torch.bfloat16,
                                          q_dtype=q_dtype, max_pages=12)
    before = pa.paged_attention.launches
    got = pa.paged_attention(q, pool, table, lengths)
    again = pa.paged_attention(q, pool, table, lengths)
    want = pa.paged_attention_plain(q, pool, table, lengths)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 2
    assert torch.equal(got, again)
    _close(got, want, LINE_SUMS if q_dtype == torch.float32 else 2.0**-7)
    if c == 1:
        assert not got[2].any(), "an inactive row is exactly 0"


@pytest.mark.parametrize("kv,rep", [(40, 1), (8, 8)])
@pytest.mark.parametrize("c", [1, 128])
@pytest.mark.parametrize("q_dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_dense_zoo_geometry(dev, kv, rep, c, q_dtype):
    """The dense zoo's attention: qwen15_32b's 40 heads of 128 over 40 KV
    groups, and command_r_35b's and deepseek_67b's 64 heads of 128 over 8
    groups of 8, pages of 16 over a bf16 pool; two runs bit-equal."""
    q, pool, table, lengths = _paged_case(dev, c=c, kv=kv, rep=rep, hd=128, page=16, pool_dtype=torch.bfloat16,
                                          q_dtype=q_dtype, max_pages=12)
    before = pa.paged_attention.launches
    got = pa.paged_attention(q, pool, table, lengths)
    again = pa.paged_attention(q, pool, table, lengths)
    want = pa.paged_attention_plain(q, pool, table, lengths)
    torch.cuda.synchronize()
    assert pa.paged_attention.launches == before + 2
    assert torch.equal(got, again)
    _close(got, want, LINE_SUMS if q_dtype == torch.float32 else 2.0**-7)
    if c == 1:
        assert not got[2].any(), "an inactive row is exactly 0"


# ---------------------------------------------------------------------------
# The MoE layer on the card (plain PyTorch: bmm experts, a gather combine)
# ---------------------------------------------------------------------------

MOE_BF16 = 3e-2   # bf16 activations through three expert matmuls against the f32 CPU layer, of max|y|


def _moe_case(seed=0, e=8, k=2, d=256, f=512, b=2, s=64, capacity_factor=1.25):
    from repro_torch.models.mlp_moe import MoEConfig

    gen = torch.Generator().manual_seed(seed)
    p = {"router": torch.randn((d, e), generator=gen) / d**0.5,
         "w_up": torch.randn((e, d, f), generator=gen) / d**0.5,
         "w_gate": torch.randn((e, d, f), generator=gen) / d**0.5,
         "w_down": torch.randn((e, f, d), generator=gen) / f**0.5}
    x = torch.randn((b, s, d), generator=gen).to(torch.bfloat16)
    return MoEConfig(n_experts=e, top_k=k, d_model=d, d_ff=f, capacity_factor=capacity_factor), p, x


@pytest.mark.parametrize("s", [64, 1024])     # dropless (n*k <= 16 E), then half the capacity: drops
def test_moe_forward_bf16_is_deterministic_and_near_f32(dev, s):
    from repro_torch.models.mlp_moe import count_drops, moe_forward

    cfg, p, x = _moe_case(s=s, capacity_factor=1.25 if s == 64 else 0.5)
    want, want_aux = moe_forward(p, x.float(), cfg)
    pd = {k: v.to(dev).requires_grad_(True) for k, v in p.items()}
    runs = []
    for _ in range(2):
        xd = x.to(dev).requires_grad_(True)
        with count_drops() as drops:
            y, aux = moe_forward(pd, xd, cfg)
        (y.float().square().sum() + aux).backward()
        runs.append((y.detach(), aux.detach(), xd.grad, [t.grad.clone() for t in pd.values()], int(drops[0])))
        for t in pd.values():
            t.grad = None
    torch.cuda.synchronize()
    (y, aux, gx, gp, dropped), again = runs
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32
    assert torch.equal(y, again[0]) and torch.equal(aux, again[1]) and torch.equal(gx, again[2])
    assert all(torch.equal(a, b) for a, b in zip(gp, again[3]))
    assert (dropped > 0) == (s == 1024) and dropped == again[4]
    _close(y.float().cpu(), want, MOE_BF16)
    assert abs(float(aux) - float(want_aux)) <= 1e-3 * abs(float(want_aux))


# ---------------------------------------------------------------------------
# The parameter-writing kernels (B6, B7), the plain line stats (B8) and the
# selective scan (B15)
# ---------------------------------------------------------------------------

BF16_STEP = 2.0**-8


def _param_inputs(dev, shape, seed, p_dtype, g_dtype):
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = torch.randn(shape, generator=gen, device=dev).to(p_dtype)
    g = (1e-2 * torch.randn(shape, generator=gen, device=dev)).to(g_dtype)
    m = 1e-3 * torch.randn(shape, generator=gen, device=dev)
    return p, g, m, gen


def _p_tol(p):
    return ELEMENTWISE if p.dtype == torch.float32 else BF16_STEP


@pytest.mark.parametrize("shape", [(4096, 512), (37, 129), (1, 9), (300, 768)])
@pytest.mark.parametrize("p_dtype,g_dtype", [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                                             (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_fused_adam(dev, shape, p_dtype, g_dtype, wd):
    p, g, m, gen = _param_inputs(dev, shape, shape[0] + shape[1], p_dtype, g_dtype)
    v = 1e-4 * torch.rand(shape, generator=gen, device=dev)
    kw = dict(lr=1e-3, wd=wd, **KW)
    before = fused_adam.fused_adam.launches
    got = fused_adam.fused_adam(p, g, m, v, count=7, **kw)
    bc1, bc2 = fused_adam.host_bias_corrections(0.9, 0.95, 7)
    want = fused_adam.fused_adam_plain(p, g, m, v, bc1=bc1, bc2=bc2, **kw)
    torch.cuda.synchronize()
    assert fused_adam.fused_adam.launches == before + 1
    assert got[0].dtype == p_dtype
    _close(got[0].float(), want[0].float(), _p_tol(p))
    _close(got[1], want[1], ELEMENTWISE)
    _close(got[2], want[2], ELEMENTWISE)


def test_fused_adam_equals_adam_precond_then_the_step(dev):
    """p' from B6 against B3's u followed by the same parameter step."""
    p, g, m, gen = _param_inputs(dev, (513, 260), 3, torch.float32, torch.float32)
    v = 1e-4 * torch.rand(p.shape, generator=gen, device=dev)
    got = fused_adam.fused_adam(p, g, m, v, lr=1e-3, wd=0.1, count=3, **KW)
    u, m_new, v_new = fused_adam.adam_precond(g, m, v, count=3, **KW)
    torch.cuda.synchronize()
    _close(got[0], fused_adam.param_step(p, u, lr=1e-3, wd=0.1), ELEMENTWISE)
    assert torch.equal(got[1], m_new) and torch.equal(got[2], v_new)


@pytest.mark.parametrize("b,r,c,axis", [(1, 300, 768, 1), (12, 768, 64, 0), (1, 50, 33, 0), (3, 7, 130, 1),
                                        (1, 4096, 8192, 1)])
@pytest.mark.parametrize("p_dtype,g_dtype", [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                                             (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_slim_update_batched(dev, b, r, c, axis, p_dtype, g_dtype, wd):
    p, g, m, gen = _param_inputs(dev, (b, r, c), b + r + c, p_dtype, g_dtype)
    line = (b, r, 1) if axis == 1 else (b, 1, c)
    v = 1e-4 * torch.rand(line, generator=gen, device=dev)
    kw = dict(lr=1e-3, wd=wd, **KW)
    before = slim_update.slim_update_batched.launches
    got = slim_update.slim_update_batched(p, g, m, v, axis=axis, count=4, **kw)
    bc1, bc2 = fused_adam.host_bias_corrections(0.9, 0.95, 4)
    want = slim_update.slim_update_batched_plain(p, g, m, v, axis=axis, bc1=bc1, bc2=bc2, **kw)
    torch.cuda.synchronize()
    assert slim_update.slim_update_batched.launches == before + 1
    assert got[0].dtype == p_dtype
    _close(got[0].float(), want[0].float(), max(_p_tol(p), LINE_SUMS))
    _close(got[1], want[1], ELEMENTWISE)
    _close(got[2], want[2], LINE_SUMS)
    # p' against B4's u followed by the same parameter step
    u, m4, v4 = slim_update.slim_precond_batched(g, m, v, axis=axis, count=4, **KW)
    _close(got[0].float(), fused_adam.param_step(p, u, lr=1e-3, wd=wd).float(), _p_tol(p))
    assert torch.equal(got[1], m4) and torch.equal(got[2], v4)


@pytest.mark.parametrize("b,r,c,axis", [(1, 300, 768, 1), (1, 1, 100003, 1), (12, 384, 384, 0), (3, 50, 130, 0)])
def test_snr_stats_batched(dev, b, r, c, axis):
    v = torch.rand((b, r, c), generator=torch.Generator(device=dev).manual_seed(c), device=dev)
    before = snr_stats.snr_stats_batched.launches
    got = snr_stats.snr_stats_batched(v, axis=axis)
    want = snr_stats.snr_stats_batched_plain(v, axis=axis)
    torch.cuda.synchronize()
    assert snr_stats.snr_stats_batched.launches == before + 1
    for a, w in zip(got, want):
        _close(a, w, LINE_SUMS)
    s1, s2 = snr_stats.snr_stats(v[0])         # the 2-D wrapper: row sums of (R, C)
    assert s1.shape == s2.shape == (v.shape[1],)


# B8 on views that take each form of the split walk: gpt_small's embedding
# as one 38.6 M-element line (SPLIT), a thin strip of 4 columns (MAJOR, its
# rows split across blocks), 64-element lines (WARP, 4 lanes a line), inner
# sizes that force 4-byte loads, and B > 1.
B8_SPLIT_VIEWS = [(1, 1, 38633472, 1, True), (1, 50304, 4, 0, True), (1, 50304, 768, 0, True), (1, 110592, 64, 1, True),
                  (3, 5, 70001, 1, True), (4, 300, 37, 0, True), (2, 9, 1027, 1, True), (1, 2, 3 * 65536 + 4, 1, False),
                  (2, 513, 768, 0, False), (3, 7, 33, 1, False)]


@pytest.mark.parametrize("b,r,c,axis,aligned", B8_SPLIT_VIEWS)
def test_snr_stats_batched_split_forms(dev, b, r, c, axis, aligned):
    """Every form of B8's walk within LINE_SUMS of the twin, and two
    launches on one input bit-identical (fixed-order combine)."""
    gen = torch.Generator(device=dev).manual_seed(c)
    flat = torch.rand(b * r * c + 1, generator=gen, device=dev)
    v = (flat[:-1] if aligned else flat[1:]).view(b, r, c)      # contiguous; 4 bytes off when unaligned
    assert (v.data_ptr() % 16 == 0) == aligned
    plan = snr_stats.plan_split(b, r, c, axis, sms=torch.cuda.get_device_properties(dev).multi_processor_count,
                                aligned=aligned)
    assert plan.vec == (aligned and c % 4 == 0)
    first, second = snr_stats.snr_stats_batched(v, axis=axis), snr_stats.snr_stats_batched(v, axis=axis)
    want = snr_stats.snr_stats_batched_plain(v, axis=axis)
    torch.cuda.synchronize()
    for a, a2, w in zip(first, second, want):
        assert torch.equal(a, a2)
        _close(a, w, LINE_SUMS)


def test_snr_stats_batched_views_cover_every_form(dev):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    forms = {snr_stats.plan_split(b, r, c, axis, sms=sms, aligned=al).form for b, r, c, axis, al in B8_SPLIT_VIEWS}
    assert forms == {snr_stats.FORM_WARP, snr_stats.FORM_SPLIT, snr_stats.FORM_MAJOR}


def _scan_inputs(dev, b, s, d, n, dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, s, d), generator=gen, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((b, s, d), generator=gen, device=dev))
    a = -torch.exp(0.3 * torch.randn((d, n), generator=gen, device=dev))
    b_t = torch.randn((b, s, n), generator=gen, device=dev).to(dtype)
    c_t = torch.randn((b, s, n), generator=gen, device=dev).to(dtype)
    d_skip = torch.randn((d,), generator=gen, device=dev)
    h0 = torch.randn((b, d, n), generator=gen, device=dev)
    return x, dt, a, b_t, c_t, d_skip, h0


@pytest.mark.parametrize("b,s,d,n", [(2, 24, 8, 4), (1, 64, 16, 16), (2, 32, 10, 3), (4, 1, 8192, 16),
                                     (1, 300, 200, 16), (3, 17, 65, 8), (1, 2048, 512, 16), (2, 1000, 96, 16),
                                     (3, 1, 37, 9), (2, 1, 300, 13), (4, 1, 8192, 15)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_scan(dev, b, s, d, n, dtype):
    args = _scan_inputs(dev, b, s, d, n, dtype, b * s + d)
    before = ssm_scan.ssm_scan.launches
    y, h = ssm_scan.ssm_scan(*args)
    y_w, h_w = ssm_scan.ssm_scan_plain(*args)
    torch.cuda.synchronize()
    assert ssm_scan.ssm_scan.launches == before + 1
    assert y.dtype == h.dtype == torch.float32
    _close(y, y_w, LINE_SUMS)
    _close(h, h_w, LINE_SUMS)


# Both forms at phase 7's full-width shapes (eval 1 x 2048, decode 4 rows),
# sequences of several chunks at narrow widths, and one-token steps whose
# rows of N states are not 16-byte aligned (N = 9, 13, 15), f32 and bf16.
@pytest.mark.parametrize("b,s,d,n", [(1, 2048, 8192, 16), (4, 1, 8192, 16), (1, 2048, 512, 16), (2, 1000, 96, 16),
                                     (4, 1, 13, 3), (4, 1, 64, 9), (2, 1, 300, 13), (3, 1, 37, 15)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_scan_is_deterministic(dev, b, s, d, n, dtype):
    """The chunks' carries compose in a fixed order: two calls on one input
    agree bit for bit."""
    args = _scan_inputs(dev, b, s, d, n, dtype, 7)
    (y1, h1), (y2, h2) = ssm_scan.ssm_scan(*args), ssm_scan.ssm_scan(*args)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(h1, h2)
    plan = ssm_scan.plan_scan(b, s, d, n, sms=torch.cuda.get_device_properties(dev).multi_processor_count)
    assert plan.form == (ssm_scan.FORM_TOKEN if s == 1 else ssm_scan.FORM_SEQ)
    if s >= 1000:
        assert plan.chunks > 1


@pytest.mark.parametrize("chunk", [16, 32, 128, 2048])
def test_ssm_scan_chunk_lengths(dev, chunk, monkeypatch):
    """The sequence form at forced chunk lengths (one chunk, two, many),
    each within LINE_SUMS of the twin."""
    plan = ssm_scan.plan_scan
    monkeypatch.setattr(ssm_scan, "plan_scan", lambda b, s, *a, **kw: dataclasses.replace(
        plan(b, s, *a, **kw), chunk=chunk, chunks=-(-s // chunk)))
    args = _scan_inputs(dev, 2, 300, 200, 16, torch.bfloat16, chunk)
    y, h = ssm_scan.ssm_scan(*args)
    y_w, h_w = ssm_scan.ssm_scan_plain(*args)
    torch.cuda.synchronize()
    _close(y, y_w, LINE_SUMS)
    _close(h, h_w, LINE_SUMS)


def test_ssm_scan_rejects_what_the_kernel_does_not_take(dev):
    args = list(_scan_inputs(dev, 1, 4, 8, 17, torch.float32, 0))
    before = ssm_scan.ssm_scan.launches
    with pytest.raises(ValueError, match="N in"):
        ssm_scan.ssm_scan(*args)
    args = list(_scan_inputs(dev, 1, 4, 8, 4, torch.float32, 0))
    args[3] = args[3].to(torch.bfloat16)
    with pytest.raises(TypeError):
        ssm_scan.ssm_scan(*args)
    assert ssm_scan.ssm_scan.launches == before


# The selective scan's backward (ssm_scan_bwd) against its plain twin, which
# steps the reverse recurrence in order with exp where the kernel replays
# each 16-step tile from the forward's kept state with exp2 of dt*a*log2(e)
# and sums channels by a warp butterfly and a block's warps in order
# (BWD_SUMS, relative to each gradient's largest magnitude). dx comes back
# in x's dtype: in bf16 the store's rounding (2^-8 of a value) adds to it.
BWD_SUMS = 1e-5
BWD_DX_BF16 = BWD_SUMS + 2.0**-8


def _close_bwd(got, want):
    """The kernel's gradients against the twin's (all f32): dx in x's dtype
    (``got[0]``), the rest f32."""
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == (got[0].dtype if i == 0 else torch.float32) and g.shape == w.shape, i
        _close(g, w, BWD_DX_BF16 if g.dtype == torch.bfloat16 else BWD_SUMS)


def _bwd_case(dev, b, s, d, n, dtype, seed, dh_final=True):
    args = _scan_inputs(dev, b, s, d, n, dtype, seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    dy = torch.randn((b, s, d), generator=gen, device=dev).to(dtype)
    dhf = torch.randn((b, d, n), generator=gen, device=dev) if dh_final else None
    return args, dy, dhf


# The training shape of chip_smoke.py's SSM phase (K = 4 chunks), sequences
# of one chunk (the prompt shape, S = 17) and of several at narrow widths, a
# one-token step, S not a multiple of 16, D not a multiple of a block's 32
# channels (65, 33, 37, 70) and N = 1, 3, 5, 8, 9 and 16 (padded to 4, 8, 16).
@pytest.mark.parametrize("b,s,d,n", [(2, 2048, 8192, 16), (4, 64, 8192, 16), (1, 300, 200, 16), (3, 17, 65, 8),
                                     (2, 1000, 96, 16), (4, 1, 37, 9), (2, 40, 33, 3), (1, 2048, 512, 16),
                                     (2, 300, 70, 1), (1, 33, 65, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_scan_bwd(dev, b, s, d, n, dtype):
    """Against the twin, two runs bit-equal, one count a call, and the
    replayed final state equal to B15's h_final bit for bit."""
    args, dy, dhf = _bwd_case(dev, b, s, d, n, dtype, b * s + d, dh_final=b != 4)
    _, h, states = ssm_scan.ssm_scan(*args, keep_bounds=True)
    assert tuple(states.shape) == ssm_scan.kept_states_shape(b, s, d, n)
    before = ssm_scan.ssm_scan_bwd.launches
    got = ssm_scan.ssm_scan_bwd(*args, dy, dhf, states=states, with_final=True)
    again = ssm_scan.ssm_scan_bwd(*args, dy, dhf, states=states, with_final=True)
    want = ssm_scan.ssm_scan_bwd_plain(*args, dy, dhf)
    torch.cuda.synchronize()
    assert ssm_scan.ssm_scan_bwd.launches == before + 2
    for g, g2 in zip(got, again):
        assert torch.equal(g, g2)
    assert torch.equal(got[-1], h)
    assert got[0].dtype == dtype
    _close_bwd(got[:-1], want)


def test_ssm_scan_bwd_one_chunk_at_the_training_shape(dev, monkeypatch):
    """K = 1 at the training shape: the forward walks the whole sequence as
    one chunk from h0, keeping every tile's state, and the backward replays
    from those states."""
    plan = ssm_scan.plan_scan
    monkeypatch.setattr(ssm_scan, "plan_scan", lambda b, s, *a, **kw: dataclasses.replace(
        plan(b, s, *a, **kw), chunk=-(-s // 16) * 16, chunks=1))
    args, dy, dhf = _bwd_case(dev, 2, 2048, 8192, 16, torch.bfloat16, 11)
    _, h, states = ssm_scan.ssm_scan(*args, keep_bounds=True)
    got = ssm_scan.ssm_scan_bwd(*args, dy, dhf, states=states, with_final=True)
    again = ssm_scan.ssm_scan_bwd(*args, dy, dhf, states=states, with_final=True)
    want = ssm_scan.ssm_scan_bwd_plain(*args, dy, dhf)
    torch.cuda.synchronize()
    for g, g2 in zip(got, again):
        assert torch.equal(g, g2)
    assert torch.equal(got[-1], h)
    _close_bwd(got[:-1], want)


@pytest.mark.parametrize("b,s,d,n,dtype", [(2, 300, 70, 16, torch.bfloat16), (1, 17, 65, 5, torch.float32),
                                           (3, 1, 37, 9, torch.float32), (1, 2048, 512, 16, torch.bfloat16)])
def test_ssm_scan_keeps_tile_states(dev, b, s, d, n, dtype):
    """The KEEP output walk's state at the start of tile i against the plain
    recurrence after 16 i steps (LINE_SUMS), padded states exact zeros; its
    y and h_final equal the walk without the store bit for bit (S > 1)."""
    args = _scan_inputs(dev, b, s, d, n, dtype, 3)
    y, h, states = ssm_scan.ssm_scan(*args, keep_bounds=True)
    y2, h2 = ssm_scan.ssm_scan(*args)
    x, dt, a, b_t, c_t, d_skip, h0 = args
    hh = h0.clone()
    for t in range(s):
        if t % 16 == 0:
            _close(states[:, t // 16, :, :n], hh, LINE_SUMS)
        u = (dt[:, t] * x[:, t].float())[:, :, None] * b_t[:, t, None, :].float()
        hh = torch.exp(dt[:, t, :, None] * a) * hh + u
    torch.cuda.synchronize()
    assert not states[..., n:].any()
    if s > 1:
        assert torch.equal(y, y2) and torch.equal(h, h2)


def test_forwards_without_a_gradient_keep_no_states(dev):
    """The eval forward and the decode step (no gradient) launch B15 without
    the tile store; a training forward launches the store form, S = 1
    included. Each form's launches counted."""
    from repro_torch.models import ssm as tssm

    forms = ssm_scan.ssm_scan.form_launches
    for s, grad, want in ((64, False, "seq"), (1, False, "token"), (64, True, "seq_keep"), (1, True, "seq_keep")):
        leaves = [t.clone().requires_grad_(True) for t in _scan_inputs(dev, 2, s, 96, 16, torch.bfloat16, s)]
        before = dict(forms)
        with torch.set_grad_enabled(grad):
            tssm.selective_scan(*leaves)
        torch.cuda.synchronize()
        assert {k: forms[k] - before[k] for k in forms} == {k: int(k == want) for k in forms}, (s, grad)


@pytest.mark.parametrize("n", [3, 5, 13])
def test_ssm_scan_bwd_padded_states_add_exact_zeros(dev, n):
    """N and its explicit zero padding to the kernel's NP (a = B = C = h0 =
    dh_final = 0 there) give the same bits on the first N states and exact
    zeros on the padding."""
    npad = 4 if n <= 4 else 8 if n <= 8 else 16
    args, dy, dhf = _bwd_case(dev, 2, 300, 70, n, torch.float32, n)

    def z(t):
        return torch.cat([t, torch.zeros(t.shape[:-1] + (npad - n,), dtype=t.dtype, device=dev)], -1).contiguous()

    x, dt, a, b_t, c_t, d_skip, h0 = args
    padded = (x, dt, z(a), z(b_t), z(c_t), d_skip, z(h0))
    outs = []
    for ops, dh in ((args, dhf), (padded, z(dhf))):
        _, _, states = ssm_scan.ssm_scan(*ops, keep_bounds=True)
        outs.append(ssm_scan.ssm_scan_bwd(*ops, dy, dh, states=states))
    torch.cuda.synchronize()
    for name, g, gp in zip(("dx", "ddt", "da", "db", "dc", "dd", "dh0"), *outs):
        if name in ("dx", "ddt", "dd"):
            assert torch.equal(g, gp), name
        else:
            assert torch.equal(g, gp[..., :n]) and not gp[..., n:].any(), name


def test_ssm_scan_bwd_rejects_what_the_kernel_does_not_take(dev):
    args, dy, dhf = _bwd_case(dev, 1, 300, 64, 4, torch.bfloat16, 0)
    _, _, states = ssm_scan.ssm_scan(*args, keep_bounds=True)
    assert states is not None
    before = ssm_scan.ssm_scan_bwd.launches
    with pytest.raises(ValueError, match="tile states"):
        ssm_scan.ssm_scan_bwd(*args, dy, dhf)                        # no states: the kernel replays from them
    with pytest.raises(TypeError):
        ssm_scan.ssm_scan_bwd(*args, dy.float(), dhf, states=states)
    with pytest.raises(ValueError):
        ssm_scan.ssm_scan_bwd(*args, dy, dhf, states=states[:, :1].contiguous())
    assert ssm_scan.ssm_scan_bwd.launches == before

def test_selective_scan_backward_runs_the_kernel(dev):
    """The autograd function on CUDA tensors: B15 forward, ssm_scan_bwd
    backward (one count each), gradients in the inputs' dtypes, within
    BWD_SUMS of ``impl="plain"`` (bf16 gradients within one bf16 step)."""
    from repro_torch.models import ssm as tssm

    args, dy, dhf = _bwd_case(dev, 2, 700, 96, 16, torch.bfloat16, 3)
    grads = {}
    for impl in ("kernel", "plain"):
        leaves = [t.clone().requires_grad_(True) for t in args]
        counts = ssm_scan.ssm_scan.launches, ssm_scan.ssm_scan_bwd.launches
        kept = ssm_scan.ssm_scan.form_launches["seq_keep"]
        y, h = tssm.selective_scan(*leaves, impl=impl)
        ((y.float() * dy.float()).sum() + (h * dhf).sum()).backward()
        torch.cuda.synchronize()
        moved = ssm_scan.ssm_scan.launches - counts[0], ssm_scan.ssm_scan_bwd.launches - counts[1]
        assert moved == ((1, 1) if impl == "kernel" else (0, 0))
        assert ssm_scan.ssm_scan.form_launches["seq_keep"] - kept == moved[0]    # the forward kept its states
        assert [t.grad.dtype for t in leaves] == [t.dtype for t in args]
        grads[impl] = [t.grad for t in leaves]
    for g, w in zip(grads["kernel"], grads["plain"]):
        tol = 2.0**-7 if g.dtype == torch.bfloat16 else BWD_SUMS
        _close(g.float(), w.float(), tol)


# ---------------------------------------------------------------------------
# Flash attention on the card (plain PyTorch, the JAX model's block scan)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_against_dense_at_4096(dev, causal, dtype):
    """``flash_attention`` over 1024-key blocks at S = 4096 (GQA, 2 groups
    of 4 heads of 64) against the dense path in f32 on the same inputs:
    output and dq/dk/dv within 1e-5 of each one's largest magnitude in f32;
    in bf16 (f32 inside, bf16 out) within one bf16 step (2^-7)."""
    from repro_torch.models import attention as tattn

    gen = torch.Generator(device=dev).manual_seed(3)
    shapes = ((2, 4096, 8, 64), (2, 4096, 2, 64), (2, 4096, 2, 64))
    q, k, v = (torch.randn(s, generator=gen, device=dev).to(dtype) for s in shapes)
    w = torch.randn(shapes[0], generator=gen, device=dev)

    def run(fn, cast):
        leaves = [t.to(cast).requires_grad_(True) for t in (q, k, v)]
        out = fn(leaves[0], tattn._repeat_kv(leaves[1], 4), tattn._repeat_kv(leaves[2], 4))
        grads = torch.autograd.grad((out.float() * w).sum(), leaves)
        return [out.detach()] + list(grads)

    got = run(lambda a, b, c: tattn.flash_attention(a, b, c, causal, 1024), dtype)
    want = run(lambda a, b, c: tattn.dense_attention(a, b, c, causal=causal), torch.float32)
    torch.cuda.synchronize()
    for g, x in zip(got, want):
        assert g.dtype == dtype
        _close(g.float(), x, LINE_SUMS if dtype == torch.float32 else 2.0**-7)


# ---------------------------------------------------------------------------
# The serving fault drill on the card (B14 through the engine)
# ---------------------------------------------------------------------------


def test_serve_drill_on_the_card(dev):
    """``benchmarks/serve_drill.py``'s run at its own size (reduced f32
    gpt_small, 6 requests of 8 tokens, its plan) through the engine on the
    card: the four gates hold, and B14 launches exactly once a layer for
    every decode step and prefill chunk that was not degraded (a degraded one
    runs the plain twin and no kernel). Then the drill's admission check."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import Transformer
    from repro_torch.serve import Request
    from repro_torch.serve.drill import admission_check, run_drill

    cfg = get_reduced("gpt_small")
    params = Transformer(cfg, device="cpu", gen=torch.Generator().manual_seed(0)).params
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (6, 8), dtype=np.int32)
    res = run_drill(cfg, params, [Request(prompt=p) for p in prompts], device=dev)
    assert res.ok, res.failures + res.deviations
    m = res.metrics
    assert m.degraded_steps == 3
    assert res.kernel_launches == cfg.n_layers * (m.decode_steps + m.prefill_chunks - m.degraded_steps)
    flood = np.random.default_rng(2).integers(0, cfg.vocab_size, (8, 8), dtype=np.int32)
    assert admission_check(cfg, params, flood, device=dev) == []
