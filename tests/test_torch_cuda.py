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
boundary (2^-8 of the largest |p|). The selective scan's y sums its N terms
in another order than the twin (1e-5); its state is elementwise (1e-6).
"""
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
    """A contiguous copy of v that starts 4 bytes past a 16-byte boundary."""
    buf = torch.empty(v.numel() + 1, device=v.device)
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
    np.testing.assert_equal(len(kernels.KERNELS), 15)


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
                                     (1, 300, 200, 16), (3, 17, 65, 8)])
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
