"""The split walk's planner (``repro_torch.kernels.snr_stats.plan_split``),
which chooses the grid of the centered SNR-stats kernels B5 and B9 and of
the plain line sums B8 on the card, checked here without one.

The plan is pure integer arithmetic, and ``_work`` below repeats the
kernel's index arithmetic block by block, so on the main path's views (the
21 SNR candidates of full-width gpt_small, and rank 0's local views of the
21 candidates the (data=2, model=2) mesh splits) and on ragged ones this
file checks that the blocks cover every element of every line exactly
once, in the order the combine step adds their shares, within the launch
grid's limits. It then sums each segment's shifted shares in f64 with the
plain math, combines them in the plan's order, and holds the result to the
plain twin's f64 sums (1e-12 relative: only the f64 summation order
differs) and to the JAX package's Pallas kernel in interpret mode (1e-5
relative, as the other line-sum parity tests: f32 outputs, another order).
B8's PLAIN walk (per piece sum v and sum v*v, v*v rounded in f32, no shift)
is held the same way, on the views ``snr_stats`` gets on the main path
(chip_smoke's phase 8: gpt_small's 11 leaves as lines of their last axis)
and on views that take each of the WARP, SPLIT and MAJOR forms, to its plain
twin and to the Pallas ``snr_stats_batched`` in interpret mode.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close
from repro.kernels.snr_stats import snr_stats_batched as jax_snr_plain
from repro.kernels.snr_stats import snr_stats_centered_batched as jax_snr_stats
from repro_torch.configs import get_config
from repro_torch.core.labels import flatten_with_names
from repro_torch.kernels import snr_stats
from repro_torch.kernels.ops import canon_nd
from repro_torch.kernels.snr_stats import (SEG_MAX, SEG_MIN, TILE_SCALAR, TILE_VEC, WARP_LINE_MAX, WARPS,
                                           plan_split)
from repro_torch.sharding import ShardingContext
from repro_torch.sharding.shardspec import SpecMesh, local_shape, owning_axes

H100_SMS = 132
MAX_GRID_X = 2**31 - 1
LINE_SUMS = 1e-5
F64_ORDER = 1e-12


def _gpt_small():
    specs = dict(flatten_with_names(get_config("gpt_small").specs()))
    return specs, {k: s.meta() for k, s in specs.items()}


def _b5_views():
    """(batch, rows, cols, axis) of the 21 SNR candidates of full-width
    gpt_small's moments, as ``snr_along_dims`` canonicalizes them."""
    specs, meta = _gpt_small()
    views = []
    for name, spec in specs.items():
        for axes in meta[name].candidate_ks().values():
            cn = canon_nd(spec.shape, meta[name].dims_of(axes))
            views.append((cn.batch, cn.rows, cn.cols, cn.axis))
    return views


def _b9_views():
    """Rank 0's local views of the candidates whose lines a (data=2,
    model=2) mesh splits (the sharded SNR's B9 launches)."""
    specs, meta = _gpt_small()
    mesh = SpecMesh({"data": 2, "model": 2})
    ctx = ShardingContext(mesh)
    views = []
    for name, spec in specs.items():
        pspec = ctx.spec_for(meta[name].axes, spec.shape)
        for axes in meta[name].candidate_ks().values():
            dims = tuple(sorted(meta[name].dims_of(axes)))
            if owning_axes(spec.shape, pspec, mesh, dims):
                cn = canon_nd(local_shape(spec.shape, pspec, mesh), dims)
                views.append((cn.batch, cn.rows, cn.cols, cn.axis))
    return views


def _b8_views():
    """The views ``snr_stats`` (B8) reduces in chip_smoke's phase 8: each
    gpt_small leaf's second moment as lines of its last axis."""
    specs, _ = _gpt_small()
    return [(1, int(np.prod(s.shape[:-1])), s.shape[-1], 1) for s in specs.values()]


B5_VIEWS, B9_VIEWS, B8_VIEWS = _b5_views(), _b9_views(), _b8_views()
EMBED_BOTH = (1, 1, 50304 * 768, 1)

# Lines of 1 and 3 elements, warp-form lines at and past their limit,
# segment boundaries +-1, inner sizes not a multiple of 4, B > 1 on axis 0.
RAGGED = [
    (1, 5, 1, 1), (2, 3, 3, 1), (1, 1, 1, 0), (3, 1, 5, 0), (1, 3, 5, 0),
    (1, 4, WARP_LINE_MAX, 1), (2, 3, WARP_LINE_MAX + 1, 1), (1, 2, WARP_LINE_MAX - 1, 1),
    (1, 1, SEG_MIN + 1, 1), (1, 3, 2 * SEG_MIN - 1, 1), (1, 2, 2 * SEG_MIN + 1, 1), (1, 2, 3 * SEG_MIN + 3, 1),
    (1, 129, 40, 0), (2, 257, 44, 0), (3, 300, 33, 0), (2, 1025, 130, 0), (1, 4097, 6, 0), (1, 1025, 33, 0),
]


def _length(plan):
    """Elements per line."""
    return plan.rows if plan.form == snr_stats.FORM_MAJOR else plan.cols


def _work(plan, block):
    """(line, start, stop) of every piece that ``block`` sums, with the
    kernel's index arithmetic; lines are numbered as the outputs are."""
    if plan.form == snr_stats.FORM_WARP:
        per = WARPS * 32 // plan.group
        return [(line, 0, plan.cols) for line in range(block * per, min(plan.lines, (block + 1) * per))]
    k = block % plan.nseg
    start, stop = k * plan.seg, min(_length(plan), (k + 1) * plan.seg)
    if plan.form == snr_stats.FORM_SPLIT:
        return [(block // plan.nseg, start, stop)]
    width = TILE_VEC if plan.vec else TILE_SCALAR
    tile, ctiles = block // plan.nseg, -(-plan.cols // width)
    b, c0 = tile // ctiles, (tile % ctiles) * width
    return [(b * plan.cols + c, start, stop) for c in range(c0, min(plan.cols, c0 + width))]


def _cover(plan):
    """Each line's pieces in block order: {line: [(start, stop), ...]}."""
    pieces = {}
    for block in range(plan.blocks):
        for line, start, stop in _work(plan, block):
            pieces.setdefault(line, []).append((start, stop))
    return pieces


def _check_plan(plan):
    assert 0 < plan.blocks <= MAX_GRID_X and plan.combine_blocks <= MAX_GRID_X
    assert plan.group in (1, 2, 4, 8, 16, 32) and (plan.form == snr_stats.FORM_WARP or plan.group == 32)
    assert (plan.combine_blocks == 0) == (plan.nseg == 1)
    pieces = _cover(plan)
    assert sorted(pieces) == list(range(plan.lines))
    for line, segs in pieces.items():
        assert len(segs) == plan.nseg, (line, segs)
        assert segs[0][0] == 0 and segs[-1][1] == _length(plan), (line, segs)
        assert all(a[1] == b[0] for a, b in zip(segs, segs[1:])), (line, segs)
        assert all(start < stop for start, stop in segs), (line, segs)


def test_main_path_views():
    assert len(B5_VIEWS) == 21 and len(B9_VIEWS) == 21 and len(B8_VIEWS) == 11
    assert EMBED_BOTH in B5_VIEWS and (1, 1, 50304 * 768 // 4, 1) in B9_VIEWS


@pytest.mark.parametrize("view", sorted(set(B5_VIEWS)) + sorted(set(B9_VIEWS)) + RAGGED
                         + sorted(set(B8_VIEWS) - set(B5_VIEWS) - set(B9_VIEWS)))
@pytest.mark.parametrize("aligned", [True, False])
def test_plan_covers_every_line_once_in_order(view, aligned):
    b, r, c, axis = view
    plan = plan_split(b, r, c, axis, sms=H100_SMS, aligned=aligned)
    assert plan.vec == (aligned and c % 4 == 0)
    _check_plan(plan)


@pytest.mark.parametrize("view", sorted(set(B5_VIEWS)) + sorted(set(B9_VIEWS)))
def test_long_lines_are_split(view):
    b, r, c, axis = view
    plan = plan_split(b, r, c, axis, sms=H100_SMS, aligned=True)
    if _length(plan) > SEG_MAX:
        assert plan.nseg > 1
    # the pieces stay within the planned bytes: at most SEG_MAX elements
    # (256 KB) a block, beyond one warp-form line
    assert plan.seg * ((TILE_VEC if plan.vec else TILE_SCALAR) if axis == 0 else 1) <= max(SEG_MAX, WARP_LINE_MAX)


def test_embed_line_fills_the_card():
    plan = plan_split(*EMBED_BOTH, sms=H100_SMS, aligned=True)
    assert plan.nseg >= H100_SMS and plan.blocks >= H100_SMS
    local = plan_split(1, 1, 50304 * 768 // 4, 1, sms=H100_SMS, aligned=True)
    assert local.blocks >= H100_SMS


def test_major_b1_views_split_rows():
    """embed fan_in (B = 1, 768 columns) gets hundreds of blocks, not 24."""
    plan = plan_split(1, 50304, 768, 0, sms=H100_SMS, aligned=True)
    assert plan.blocks >= 4 * H100_SMS and plan.nseg > 1


def _split_sums(v, plan, plain=False):
    """The kernel's arithmetic with the plain math: each piece's shares
    (sum v, sum d, sum d^2) with d = v - v0 rounded in f32 and v0 the line's
    first entry, summed in f64, then each line's shares added in the plan's
    order. Returns three f64 arrays of shape (B, kept). ``plain``: B8's
    shares (sum v, sum v*v) with v*v rounded in f32, two arrays."""
    lines = np.moveaxis(v, 1, 2) if plan.form == snr_stats.FORM_MAJOR else v
    lines = lines.reshape(plan.lines, _length(plan))
    shares = np.zeros((plan.lines, plan.nseg, 3))
    k_of = {}
    for block in range(plan.blocks):
        for line, start, stop in _work(plan, block):
            k = k_of[line] = k_of.get(line, -1) + 1
            x = lines[line, start:stop]
            if plain:
                shares[line, k, :2] = (x.astype(np.float64).sum(), (x * x).astype(np.float64).sum())
                continue
            d = (x - lines[line, 0]).astype(np.float32).astype(np.float64)
            shares[line, k] = (x.astype(np.float64).sum(), d.sum(), (d * d).sum())
    out = np.zeros((plan.lines, 3))
    for k in range(plan.nseg):
        out += shares[:, k]
    kept = v.shape[2] if plan.form == snr_stats.FORM_MAJOR else v.shape[1]
    return tuple(out[:, i].reshape(v.shape[0], kept) for i in range(2 if plain else 3))


def _twin_f64(v, axis):
    """The plain twin's sums before its final cast to f32."""
    t = torch.from_numpy(v)
    red = 2 if axis == 1 else 1
    d = (t - t.narrow(red, 0, 1)).double()
    return t.double().sum(red).numpy(), d.sum(red).numpy(), (d * d).sum(red).numpy()


def _data(view, near_constant):
    b, r, c, _ = view
    rng = np.random.default_rng(b * r * c)
    x = rng.standard_normal((b, r, c))
    return (5.0 + 1e-4 * x if near_constant else x * x).astype(np.float32)


@pytest.mark.parametrize("view", [v for v in RAGGED if v[0] * v[1] * v[2] <= 2 * 10**5])
@pytest.mark.parametrize("near_constant", [False, True])
@pytest.mark.parametrize("aligned", [True, False])
def test_split_shares_add_up_to_the_plain_twin(view, near_constant, aligned):
    v = _data(view, near_constant)
    plan = plan_split(*view, sms=H100_SMS, aligned=aligned)
    for got, want in zip(_split_sums(v, plan), _twin_f64(v, view[3])):
        scale = max(float(np.abs(want).max()), 1e-300)
        assert float(np.abs(got - want).max()) <= F64_ORDER * scale


@pytest.mark.parametrize("view", [(1, 2, 2 * SEG_MIN + 1, 1), (2, 300, 40, 0), (1, 1025, 33, 0)])
def test_split_shares_match_the_tpu_kernel(view):
    """Segments of split lines combined in the plan's order, cast to f32,
    against the Pallas kernel in interpret mode on the same input."""
    v = _data(view, near_constant=True)
    plan = plan_split(*view, sms=H100_SMS, aligned=True)
    assert plan.nseg > 1
    want = jax_snr_stats(jnp.asarray(v), axis=view[3], interpret=True)
    for name, got, w in zip(("s1", "s1c", "s2c"), _split_sums(v, plan), want):
        assert_close(torch.from_numpy(got.astype(np.float32)), w, LINE_SUMS, name)


def _plain_twin_f64(v, axis):
    """B8's plain twin's sums before its final cast to f32."""
    t = torch.from_numpy(v)
    red = 2 if axis == 1 else 1
    return t.double().sum(red).numpy(), (t * t).double().sum(red).numpy()


# Views that take each form of B8's walk: warp lines, long split lines (a
# line of 3 segments, one of gpt_small's embedding rows' kind), axis-0
# column tiles split along their rows, and an inner size that forces
# 4-byte loads.
B8_FORMS = [(2, 7, 33, 1), (1, 3, 3 * SEG_MIN + 5, 1), (1, 2, 2 * SEG_MAX + 1, 1), (2, 300, 40, 0),
            (1, 1025, 33, 0), (1, 4097, 8, 0)]


@pytest.mark.parametrize("view", B8_FORMS + [v for v in RAGGED if v[0] * v[1] * v[2] <= 2 * 10**5])
@pytest.mark.parametrize("aligned", [True, False])
def test_plain_split_sums_add_up_to_the_plain_twin(view, aligned):
    v = _data(view, near_constant=False)
    plan = plan_split(*view, sms=H100_SMS, aligned=aligned)
    for got, want in zip(_split_sums(v, plan, plain=True), _plain_twin_f64(v, view[3])):
        scale = max(float(np.abs(want).max()), 1e-300)
        assert float(np.abs(got - want).max()) <= F64_ORDER * scale


def test_plain_views_take_every_form():
    forms = {plan_split(*view, sms=H100_SMS, aligned=True).form for view in B8_FORMS}
    assert forms == {snr_stats.FORM_WARP, snr_stats.FORM_SPLIT, snr_stats.FORM_MAJOR}
    assert any(plan_split(*view, sms=H100_SMS, aligned=True).nseg > 1 for view in B8_FORMS if view[3] == 0)
    assert {plan_split(*view, sms=H100_SMS, aligned=True).form for view in B8_VIEWS} == {snr_stats.FORM_WARP}


@pytest.mark.parametrize("view", B8_FORMS)
def test_plain_split_sums_match_the_tpu_kernel(view):
    """B8's pieces combined in the plan's order, cast to f32, against the
    Pallas ``snr_stats_batched`` in interpret mode on the same input."""
    v = _data(view, near_constant=False)
    plan = plan_split(*view, sms=H100_SMS, aligned=True)
    want = jax_snr_plain(jnp.asarray(v), axis=view[3], interpret=True)
    for name, got, w in zip(("s1", "s2"), _split_sums(v, plan, plain=True), want):
        assert_close(torch.from_numpy(got.astype(np.float32)), w, LINE_SUMS, name)


@pytest.mark.parametrize("cols,vec,group", [(64, True, 4), (768, True, 32), (512, True, 32), (256, True, 16),
                                            (33, False, 16), (4, True, 1), (3, False, 1), (4096, True, 32)])
def test_warp_form_gives_short_lines_fewer_lanes(cols, vec, group):
    """A WARP line of c float4s (or floats) takes the power of two of lanes
    that leaves each about GROUP_LOADS loads, at most a warp."""
    plan = plan_split(1, 1000, cols, 1, sms=H100_SMS, aligned=vec)
    assert plan.form == snr_stats.FORM_WARP and plan.vec == vec and plan.group == group
    assert plan.blocks == -(-1000 // (WARPS * 32 // group))
