"""The sharded psum kernels' plain twins (what the port runs for CPU tensors)
against the JAX package's Pallas kernels in interpret mode, on the same
numpy inputs:

* B9  ``snr_stats_centered_partial_batched`` and ``ops.snr_partial_op``;
* B10 ``slim_partial_stats_batched`` (and its 2-D wrapper), f32 and bf16 g,
  ``with_snr``, ``with_health``;
* B11 ``slim_finalize_batched`` (and its 2-D wrapper), ek and owner forms;
* B12 ``mega_slim_partial_stats_batched``, ``with_snr``, ``with_health``;
* B13 ``mega_slim_finalize_batched`` with per-line bias corrections, ek and
  owner forms;

both orientations, batched and 2-D, ragged kept extents (the TPU kernels
pad those). Tolerance 1e-5 of each output's largest magnitude (the
ROADMAP's bar; sums run in another order); non-finite counts of gradients
seeded with NaN/Inf equal exactly. Also the cross-shard algebra
(``rebase_centered_stats``) and the partial reference.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close
from repro.kernels import megaplan as jmega, ops as jops, ref as jref, slim_update as jslim, snr_stats as jsnr
from repro_torch.kernels import megaplan, ops, ref, slim_update, snr_stats

TOL = 1e-5
KW = dict(b1=0.9, b2=0.95, eps=1e-8)
# (B, R, C, axis): both orientations, batched and not, ragged kept extents.
SHAPES = [(1, 300, 64, 1), (2, 5, 33, 1), (1, 17, 7, 0), (3, 64, 129, 0), (12, 48, 40, 0)]


def _line(b, r, c, axis):
    return (b, r, 1) if axis == 1 else (b, 1, c)


def _inputs(shape, axis, seed, n_bad=0):
    rng = np.random.default_rng(seed)
    b, r, c = shape
    g = (0.3 * rng.standard_normal(shape)).astype(np.float32)
    if n_bad:
        flat = g.reshape(-1)
        idx = rng.choice(flat.size, n_bad, replace=False)
        flat[idx[0::3]] = np.nan
        flat[idx[1::3]] = np.inf
        flat[idx[2::3]] = -np.inf
    m = rng.standard_normal(shape).astype(np.float32)
    line = _line(b, r, c, axis)
    v = np.abs(rng.standard_normal(line)).astype(np.float32)
    ek = np.abs(rng.standard_normal(line)).astype(np.float32)
    bc1 = (0.05 + rng.random(line)).astype(np.float32)
    bc2 = (0.05 + rng.random(line)).astype(np.float32)
    return g, m, v, ek, bc1, bc2


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _compare(got, want, what):
    """Each output within TOL of its largest finite magnitude; non-finite
    entries (from poisoned gradients) at the same places."""
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = np.asarray(b, np.float32).reshape(a.shape)
        fin = np.isfinite(b)
        np.testing.assert_array_equal(np.isfinite(a), fin, err_msg=f"{what}[{i}] non-finite entries")
        assert_close(np.where(fin, a, 0), np.where(fin, b, 0), TOL, f"{what}[{i}]")


@pytest.mark.parametrize("b,r,c,axis", SHAPES)
@pytest.mark.parametrize("near_constant", [False, True])
def test_b9_partial_stats(b, r, c, axis, near_constant):
    rng = np.random.default_rng(b * r * c)
    v = rng.random((b, r, c)).astype(np.float32)
    if near_constant:
        v = (1.0 + 1e-4 * v).astype(np.float32) ** 2
    want = jsnr.snr_stats_centered_partial_batched(jnp.asarray(v), axis=axis)
    got = snr_stats.snr_stats_centered_partial_batched(_t(v), axis=axis)
    _compare(got, want, "B9")
    # the shift is the line's first entry exactly
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    if b == 1:
        want2 = jops.snr_partial_op(jnp.asarray(v[0]), axis=axis)
        _compare(ops.snr_partial_op(_t(v[0]), axis=axis), want2, "snr_partial_op")


@pytest.mark.parametrize("b,r,c,axis", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_snr", [False, True])
@pytest.mark.parametrize("with_health", [False, True])
def test_b10_partial_stats(b, r, c, axis, dtype, with_snr, with_health):
    g, m, *_ = _inputs((b, r, c), axis, seed=r + c, n_bad=6 if with_health else 0)
    jg = jnp.asarray(g).astype(dtype)
    tg = _t(g).to(getattr(torch, dtype))
    want = jslim.slim_partial_stats_batched(jg, jnp.asarray(m), axis=axis, b1=KW["b1"], with_snr=with_snr,
                                            with_health=with_health)
    got = slim_update.slim_partial_stats_batched(tg, _t(m), axis=axis, b1=KW["b1"], with_snr=with_snr,
                                                 with_health=with_health)
    if with_health:
        assert float(got[-1][0]) == float(want[-1][0]) == 6.0
    _compare(got, want, "B10")


@pytest.mark.parametrize("b,r,c,axis", SHAPES)
@pytest.mark.parametrize("form", ["ek", "owner"])
def test_b11_finalize(b, r, c, axis, form):
    _, m, v, ek, *_ = _inputs((b, r, c), axis, seed=7 * r + c)
    count = 3
    jek = jnp.asarray(ek) if form == "ek" else None
    tek = _t(ek) if form == "ek" else None
    want = jslim.slim_finalize_batched(jnp.asarray(m), jnp.asarray(v), axis=axis, ek=jek, count=count, **KW)
    got = slim_update.slim_finalize_batched(_t(m), _t(v), axis=axis, ek=tek, count=count, **KW)
    if form == "owner":
        want, got = (want,), (got,)
    _compare(got, want, f"B11 {form}")


def test_b10_b11_2d_wrappers():
    g, m, v, ek, *_ = _inputs((1, 40, 24), 1, seed=3)
    for axis in (0, 1):
        vl = v[0] if axis == 1 else np.abs(np.random.default_rng(1).standard_normal((1, 24))).astype(np.float32)
        ekl = ek[0] if axis == 1 else vl * 0.5
        want = jslim.slim_partial_stats(jnp.asarray(g[0]), jnp.asarray(m[0]), axis=axis, b1=0.9, with_snr=True)
        got = slim_update.slim_partial_stats(_t(g[0]), _t(m[0]), axis=axis, b1=0.9, with_snr=True)
        _compare(got, want, "B10 2-D")
        want = jslim.slim_finalize(jnp.asarray(m[0]), jnp.asarray(vl), axis=axis, ek=jnp.asarray(ekl), count=2, **KW)
        got = slim_update.slim_finalize(_t(m[0]), _t(vl), axis=axis, ek=_t(ekl), count=2, **KW)
        _compare(got, want, "B11 2-D")
        want = jslim.slim_finalize(jnp.asarray(m[0]), jnp.asarray(vl), axis=axis, count=2, **KW)
        _compare((slim_update.slim_finalize(_t(m[0]), _t(vl), axis=axis, count=2, **KW),), (want,), "B11 2-D owner")


@pytest.mark.parametrize("b,r,c,axis", SHAPES)
@pytest.mark.parametrize("with_snr", [False, True])
@pytest.mark.parametrize("with_health", [False, True])
def test_b12_mega_partial_stats(b, r, c, axis, with_snr, with_health):
    g, m, *_ = _inputs((b, r, c), axis, seed=r * c, n_bad=3 if with_health else 0)
    want = jmega.mega_slim_partial_stats_batched(jnp.asarray(g), jnp.asarray(m), axis=axis, b1=KW["b1"],
                                                 with_snr=with_snr, with_health=with_health)
    got = megaplan.mega_slim_partial_stats_batched(_t(g), _t(m), axis=axis, b1=KW["b1"], with_snr=with_snr,
                                                   with_health=with_health)
    if with_health:
        np.testing.assert_array_equal(got[-2].numpy(), np.asarray(want[-2]))   # per-line non-finite counts
        assert float(got[-2].sum()) == 3.0
    _compare(got, want, "B12")


@pytest.mark.parametrize("b,r,c,axis", SHAPES)
@pytest.mark.parametrize("form", ["ek", "owner"])
def test_b13_mega_finalize(b, r, c, axis, form):
    _, m, v, ek, bc1, bc2 = _inputs((b, r, c), axis, seed=11 * c + r)
    jek = jnp.asarray(ek) if form == "ek" else None
    tek = _t(ek) if form == "ek" else None
    want = jmega.mega_slim_finalize_batched(jnp.asarray(m), jnp.asarray(v), jnp.asarray(bc1), jnp.asarray(bc2),
                                            axis=axis, ek=jek, b2=KW["b2"], eps=KW["eps"])
    got = megaplan.mega_slim_finalize_batched(_t(m), _t(v), _t(bc1), _t(bc2), axis=axis, ek=tek, b2=KW["b2"],
                                              eps=KW["eps"])
    if form == "owner":
        want, got = (want,), (got,)
    _compare(got, want, f"B13 {form}")


def test_partial_pair_composes_to_the_unsharded_update():
    """Two shards of every line through B10 -> (sum) -> B11 equal the
    unsharded per-leaf update of the whole line (B4), and the rebased
    centered sums equal the whole line's."""
    g, m, v, *_ = _inputs((2, 6, 40), 1, seed=5)
    halves = [(g[..., :20], m[..., :20]), (g[..., 20:], m[..., 20:])]
    outs = [slim_update.slim_partial_stats_batched(_t(gh), _t(mh), axis=1, b1=0.9, with_snr=True)
            for gh, mh in halves]
    ek = (outs[0][1] + outs[1][1]) / 40
    us = [slim_update.slim_finalize_batched(o[0], _t(v), axis=1, ek=ek, count=2, **KW) for o in outs]
    whole = slim_update.slim_precond_batched(_t(g), _t(m), _t(v), axis=1, count=2, with_snr=True, **KW)
    assert_close(torch.cat([us[0][0], us[1][0]], dim=2).numpy(), whole[0].numpy(), TOL, "u")
    assert_close(us[0][1].numpy(), whole[2].numpy(), TOL, "v'")
    firsts = [o[4] for o in outs]
    shift = (firsts[0] + firsts[1]) / 2
    rebased = [ref.rebase_centered_stats(o[2], o[3], o[4], shift, 20) for o in outs]
    s1c, s2c = rebased[0][0] + rebased[1][0], rebased[0][1] + rebased[1][1]
    g2 = _t(g).double() ** 2
    d = g2 - shift.double()
    assert_close(s1c.numpy(), d.sum(2, keepdim=True).numpy(), TOL, "s1c")
    assert_close(s2c.numpy(), (d * d).sum(2, keepdim=True).numpy(), TOL, "s2c")


@pytest.mark.parametrize("dims", [(1,), (0, 2), (2,), (0, 1, 2)])
def test_partial_ref_and_rebase_match_jax(dims):
    rng = np.random.default_rng(4)
    v = (1.0 + 1e-3 * rng.standard_normal((4, 6, 10))).astype(np.float32)
    want = jref.snr_stats_centered_partial_ref(jnp.asarray(v), dims)
    got = ref.snr_stats_centered_partial_ref(_t(v), dims)
    _compare(got, want, "partial ref")
    shift = got[3] + 1e-4
    jw = jref.rebase_centered_stats(jnp.asarray(got[1].numpy()), jnp.asarray(got[2].numpy()),
                                    jnp.asarray(got[3].numpy()), jnp.asarray(shift.numpy()), 7)
    _compare(ref.rebase_centered_stats(got[1], got[2], got[3], shift, 7), jw, "rebase")
