"""The split walk's planner for B1 and B4
(``repro_torch.kernels.megaplan.plan_slim``), which chooses the grid of
``mega_slim_update_batched`` and ``slim_precond_batched`` on the card,
checked here without one.

The plan is pure integer arithmetic, and ``_work`` below repeats the
kernels' index arithmetic block by block (pass 2 takes the same pieces in
reverse order), so on the main path's views (the slim groups of full-width
gpt_small under Table 3 and the baseline rule sets, and ResNet-18's 9
axis-0 groups) and on ragged ones this file checks that the blocks cover
every element of every line exactly once, in the order the combine adds
their shares, within the launch grid's limits. It then emulates the walk:
each piece's shares (g^2, and with the flags the centered sums of g^2 and
the health terms) summed in f64, each line's shares added in the plan's
order, and the plain math for v', m' and u on the combined sums. At
reduced sizes that take every form, the combined sums hold to an f64 sum
of each whole line at 1e-12 relative (only the f64 order differs), the
outputs to the plain twins (1e-5 for what depends on a line sum, 1e-6 for
m'), and everything to the JAX package's ``mega_slim_update_batched`` and
``slim_precond_batched`` in interpret mode at the tolerances
``test_torch_kernels.py`` holds B1 to (u and m' 1e-6, line values 1e-5;
non-finite counts exact).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close
from repro.kernels.megaplan import mega_slim_update_batched as jax_mega_slim
from repro.kernels.slim_update import slim_precond_batched as jax_slim_precond
from repro_torch.configs import get_config
from repro_torch.core import baselines, rules_to_dims, table3_rules
from repro_torch.core.labels import flatten_with_names
from repro_torch.kernels import megaplan, slim_update
from repro_torch.kernels.fused_adam import bias_corrections
from repro_torch.kernels.megaplan import (FORM_MAJOR, FORM_ROWS, FORM_SPLIT, SLIM_SEG_MAX, SLIM_SEG_MIN, STRIP,
                                          plan_slim)
from repro_torch.kernels.snr_stats import SEG_QUANTUM, TILE_SCALAR, TILE_VEC, WARPS
from repro_torch.models import ResNetConfig

H100_SMS = 132
MAX_GRID_X = 2**31 - 1
MAX_GRID_Y = 65535
ELEMENTWISE = 1e-6
LINE_SUMS = 1e-5
F64_ORDER = 1e-12
KW = dict(b1=0.9, b2=0.95, eps=1e-8)


def _plan_views(specs, rule_sets):
    """{(batch, rows, cols, axis): [rule set names]} of the slim groups of
    each rule set's megaplan over ``specs``."""
    meta = {k: s.meta() for k, s in specs.items()}
    out = {}
    for name, rules in rule_sets(meta).items():
        dims = rules_to_dims(rules, meta)
        plan = megaplan.plan_megagroups([s.shape for s in specs.values()], [torch.float32] * len(specs),
                                        [dims[k] for k in specs])
        for g in plan.groups:
            if g.kind != "dense":
                out.setdefault((g.batch, g.rows, g.cols, g.axis), []).append(name)
    return out


def _gpt_small_views():
    specs = dict(flatten_with_names(get_config("gpt_small").specs()))
    return _plan_views(specs, lambda meta: {
        "table3": table3_rules(meta),
        **{n: getattr(baselines, f"{n}_rules")(meta) for n in ("adalayer", "adalayer_ln_tl", "adam_mini_v1",
                                                               "adam_mini_v2")}})


def _resnet_views():
    specs = dict(flatten_with_names(ResNetConfig(classes=100).specs()))
    return _plan_views(specs, lambda meta: {"table3": table3_rules(meta)})


GPT_VIEWS, RESNET_VIEWS = _gpt_small_views(), _resnet_views()
TABLE3 = sorted(v for v, names in GPT_VIEWS.items() if "table3" in names)
EMBED_LINE = (1, 1, 50304 * 768, 1)
RESNET_WIDE = (1, 4608, 1536, 0)

# Lines of 1 and 3 elements, lines at and around a piece and its quantum,
# inner sizes not a multiple of 4, B > 1 on both axes, thin and wide
# axis-0 views.
RAGGED = [
    (1, 5, 1, 1), (2, 3, 3, 1), (1, 1, 1, 0), (3, 1, 5, 0), (1, 3, 5, 0),
    (1, 2, SLIM_SEG_MIN, 1), (1, 2, SLIM_SEG_MIN + 1, 1), (2, 3, 3 * SLIM_SEG_MIN - 1, 1),
    (1, 1, 5 * SLIM_SEG_MAX + 3, 1), (3, 2, 2 * SLIM_SEG_MAX + 4, 1), (1, 7, 9001, 1),
    (1, 129, 40, 0), (2, 257, 44, 0), (3, 300, 33, 0), (2, 1025, 130, 0), (1, 4097, 6, 0), (1, 1025, 33, 0),
    (4, 20000, 8, 0), (1, 64, 128, 0), (1, 27, 64, 0),
]


def _length(plan):
    """Elements per line."""
    return plan.cols if plan.axis == 1 else plan.rows


def _tile(plan):
    """Columns of a MAJOR block: a float4, or a float, per lane."""
    return TILE_VEC if plan.vec else TILE_SCALAR


def _work(plan, block):
    """(line, start, stop) of every piece that ``block`` of pass 1 holds,
    with the kernels' index arithmetic (the axis-0 ROWS form's 2-D grid
    numbered batch-major); lines are numbered as the line outputs are."""
    if plan.form == FORM_ROWS and plan.axis == 1:
        return [(block, 0, plan.cols)]
    if plan.form == FORM_ROWS:
        strips = -(-plan.cols // STRIP)
        b, c0 = block // strips, block % strips * STRIP
        return [(b * plan.cols + c, 0, plan.rows) for c in range(c0, min(plan.cols, c0 + STRIP))]
    k = block % plan.nseg
    start, stop = k * plan.seg, min(_length(plan), (k + 1) * plan.seg)
    if plan.form == FORM_SPLIT:
        return [(block // plan.nseg, start, stop)]
    width = _tile(plan)
    tile, ctiles = block // plan.nseg, -(-plan.cols // width)
    b, c0 = tile // ctiles, tile % ctiles * width
    return [(b * plan.cols + c, start, stop) for c in range(c0, min(plan.cols, c0 + width))]


def _pass2_blocks(plan):
    """Pass 2's blocks in launch order: block i takes pass 1's piece
    blocks - 1 - i (one launch, and no second pass, for ROWS)."""
    return [] if plan.form == FORM_ROWS else [plan.blocks - 1 - i for i in range(plan.blocks)]


def _cover(plan, blocks=None):
    """Each line's pieces in block order: {line: [(start, stop), ...]}."""
    pieces = {}
    for block in range(plan.blocks) if blocks is None else blocks:
        for line, start, stop in _work(plan, block):
            pieces.setdefault(line, []).append((start, stop))
    return pieces


def _check_plan(plan):
    assert 0 < plan.blocks <= MAX_GRID_X and 0 < plan.seg and plan.nseg >= 1
    assert (plan.form == FORM_ROWS) == (plan.nseg == 1)
    assert plan.form in ((FORM_ROWS, FORM_SPLIT) if plan.axis == 1 else (FORM_ROWS, FORM_MAJOR))
    if plan.form == FORM_ROWS:
        assert plan.batch <= MAX_GRID_Y or plan.axis == 1
    if plan.form == FORM_SPLIT:
        assert plan.seg % SEG_QUANTUM == 0           # four-element loads start aligned in every segment
    if plan.form == FORM_MAJOR:
        assert plan.seg % WARPS == 0
    pieces = _cover(plan)
    assert sorted(pieces) == list(range(plan.lines))
    for line, segs in pieces.items():
        assert len(segs) == plan.nseg, (line, segs)
        assert segs[0][0] == 0 and segs[-1][1] == _length(plan), (line, segs)
        assert all(a[1] == b[0] for a, b in zip(segs, segs[1:])), (line, segs)
        assert all(start < stop for start, stop in segs), (line, segs)
    if plan.form != FORM_ROWS:
        assert {k: sorted(v) for k, v in _cover(plan, _pass2_blocks(plan)).items()} == pieces


def test_main_path_views():
    assert len(RESNET_VIEWS) == 9 and all(v[3] == 0 for v in RESNET_VIEWS)
    assert TABLE3 == [(1, 9216, 3072, 1), (1, 105600, 768, 1), (12, 768, 1536, 0)]
    assert EMBED_LINE in GPT_VIEWS and RESNET_WIDE in RESNET_VIEWS
    assert len(GPT_VIEWS) + len(RESNET_VIEWS) == 22


@pytest.mark.parametrize("view", sorted(GPT_VIEWS) + sorted(RESNET_VIEWS) + RAGGED)
@pytest.mark.parametrize("aligned", [True, False])
def test_plan_covers_every_line_once_in_order(view, aligned):
    b, r, c, axis = view
    plan = plan_slim(b, r, c, axis, sms=H100_SMS, aligned=aligned)
    assert plan.vec == (aligned and c % 4 == 0) and (plan.batch, plan.rows, plan.cols, plan.axis) == view
    _check_plan(plan)


@pytest.mark.parametrize("view", TABLE3)
def test_table3_groups_keep_the_rows_form(view):
    """Table 3's groups on gpt_small (lines of 768 and 3072; 576 strips of
    (12, 768, 1536)) stay on the one-launch walk they had."""
    assert plan_slim(*view, sms=H100_SMS, aligned=True).form == FORM_ROWS


@pytest.mark.parametrize("view", [EMBED_LINE, RESNET_WIDE])
def test_long_views_fill_the_card(view):
    plan = plan_slim(*view, sms=H100_SMS, aligned=True)
    assert plan.form in (FORM_SPLIT, FORM_MAJOR) and plan.blocks >= 4 * H100_SMS


@pytest.mark.parametrize("view", sorted(GPT_VIEWS) + sorted(RESNET_VIEWS))
def test_split_pieces_stay_within_the_planned_bytes(view):
    """A split view's piece holds SLIM_SEG_MIN..SLIM_SEG_MAX elements at
    most (beyond one ROWS line), and lines longer than a piece are split."""
    plan = plan_slim(*view, sms=H100_SMS, aligned=True)
    per_block = plan.seg * (_tile(plan) if plan.form == FORM_MAJOR else 1)
    assert plan.form == FORM_ROWS or per_block <= SLIM_SEG_MAX
    if plan.axis == 1 and plan.cols > SLIM_SEG_MAX:
        assert plan.form == FORM_SPLIT


def test_plans_are_cached_integers():
    a = plan_slim(1, 24, 2359296, 1, sms=H100_SMS, aligned=True)
    assert a is plan_slim(1, 24, 2359296, 1, sms=H100_SMS, aligned=True)
    with pytest.raises(ValueError):
        plan_slim(1, 0, 4, 1, sms=H100_SMS, aligned=True)


# -- the walk's arithmetic -------------------------------------------------------------

def _planes(with_snr, with_health):
    return 1 + 2 * with_snr + 2 * with_health


def _piece_shares(x, f, with_snr, with_health):
    """One piece's f64 shares: sum g^2 of exact squares; s1c, s2c of
    g^2 - f rounded in f32; the non-finite count and the finite sum of g^2
    rounded in f32."""
    x64 = x.astype(np.float64)
    out = [np.sum(x64 * x64)]
    x2 = (x * x).astype(np.float32)
    if with_snr:
        d = (x2 - np.float32(f)).astype(np.float32).astype(np.float64)
        out += [d.sum(), (d * d).sum()]
    if with_health:
        fin = np.isfinite(x)
        out += [float((~fin).sum()), x2[fin].astype(np.float64).sum()]
    return out


def _walk_sums(g, plan, with_snr=False, with_health=False):
    """Each line's combined f64 sums (lines, planes), from the pieces in the
    blocks' order, shares added k = 0 .. nseg - 1."""
    g = np.asarray(g, np.float32)
    lines = (np.moveaxis(g, 1, 2) if plan.axis == 0 else g).reshape(plan.lines, _length(plan))
    shares = np.zeros((plan.lines, plan.nseg, _planes(with_snr, with_health)))
    k_of = {}
    with np.errstate(invalid="ignore", over="ignore"):
        for block in range(plan.blocks):
            for line, start, stop in _work(plan, block):
                k = k_of[line] = k_of.get(line, -1) + 1
                f = lines[line, 0] * lines[line, 0]
                shares[line, k] = _piece_shares(lines[line, start:stop], f, with_snr, with_health)
    total = np.zeros(shares.shape[::2])
    for k in range(plan.nseg):
        total += shares[:, k]
    return total


def _line_view(x, plan):
    """(lines,) -> the line outputs' layout (B, R, 1) or (B, 1, C)."""
    return torch.from_numpy(np.ascontiguousarray(x)).reshape(
        (plan.batch, plan.rows, 1) if plan.axis == 1 else (plan.batch, 1, plan.cols))


def _emulate(g, m, v, bc1, bc2, plan, with_snr=False, with_health=False):
    """The walk's outputs: the combined sums rounded to f32 once, then the
    plain math of the kernels (and the twins) on them, in f32."""
    total = _walk_sums(g, plan, with_snr, with_health)
    g32 = torch.from_numpy(np.asarray(g, np.float32))
    ek = _line_view(total[:, 0].astype(np.float32), plan) * (1.0 / _length(plan))
    v_new = KW["b2"] * v + (1 - KW["b2"]) * ek
    m_new = KW["b1"] * m + (1 - KW["b1"]) * g32
    out = ((m_new / bc1) / (torch.sqrt(v_new / bc2) + KW["eps"]), m_new, v_new)
    rest = [_line_view(total[:, p].astype(np.float32), plan) for p in range(1, total.shape[1])]
    return out + tuple(rest)


def _slim_inputs(view, seed, n_bad=0):
    b, r, c, axis = view
    rng = np.random.default_rng(seed)
    line = (b, r, 1) if axis == 1 else (b, 1, c)
    g = rng.standard_normal((b, r, c)).astype(np.float32)
    if n_bad:
        idx = rng.choice(g.size, n_bad, replace=False)
        g.reshape(-1)[idx] = np.array([np.nan, np.inf, -np.inf], np.float32)[np.arange(n_bad) % 3]
    m = (0.1 * rng.standard_normal((b, r, c))).astype(np.float32)
    v = (0.01 * rng.random(line)).astype(np.float32)
    bc1 = (0.05 + rng.random(line)).astype(np.float32)
    bc2 = (0.05 + rng.random(line)).astype(np.float32)
    return g, m, v, bc1, bc2


# Reduced views that take each form on an H100's plan: SPLIT with
# four-element and 4-byte loads, MAJOR with 128- and 32-column tiles, B > 1,
# and ROWS on both axes.
WALK_VIEWS = [(1, 2, 20000, 1), (2, 3, 9001, 1), (1, 300, 40, 0), (2, 200, 33, 0), (1, 37, 96, 1), (3, 16, 70, 0)]
FLAGS = [(False, False), (True, True)]


def test_walk_views_take_every_form():
    plans = [plan_slim(*v, sms=H100_SMS, aligned=True) for v in WALK_VIEWS]
    assert [p.form for p in plans] == [FORM_SPLIT, FORM_SPLIT, FORM_MAJOR, FORM_MAJOR, FORM_ROWS, FORM_ROWS]
    assert [p.vec for p in plans[:4]] == [True, False, True, False]


def _f64_line_sums(g, axis, with_snr, with_health):
    """Each whole line's sums in f64, straight (the reference order)."""
    red = 2 if axis == 1 else 1
    t = torch.from_numpy(g)
    x2 = t * t
    out = [(t.double() ** 2).sum(red)]
    if with_snr:
        d = (x2 - x2.narrow(red, 0, 1)).double()
        out += [d.sum(red), (d * d).sum(red)]
    if with_health:
        fin = torch.isfinite(t)
        out += [(~fin).sum(red).double(), torch.where(fin, x2, 0.0).double().sum(red)]
    return [o.reshape(-1).numpy() for o in out]


@pytest.mark.parametrize("view", WALK_VIEWS)
@pytest.mark.parametrize("with_snr,with_health", FLAGS)
def test_walk_sums_add_up_to_the_line_sums(view, with_snr, with_health):
    g = _slim_inputs(view, sum(view), n_bad=0)[0]
    plan = plan_slim(*view, sms=H100_SMS, aligned=True)
    total = _walk_sums(g, plan, with_snr, with_health)
    for p, want in enumerate(_f64_line_sums(g, view[3], with_snr, with_health)):
        got = total[:, p]
        assert float(np.abs(got - want).max()) <= F64_ORDER * max(float(np.abs(want).max()), 1e-300), p


def _hold(got, want, tols, what):
    for name, tol, a, w in zip(("u", "m'", "v'", "s1c", "s2c", "nf", "ss"), tols, got, want):
        a, w = np.asarray(a, np.float64), np.asarray(w, np.float64)
        if tol is None:
            np.testing.assert_array_equal(a, w, err_msg=f"{what} {name}")
        else:
            fin = np.isfinite(w)
            np.testing.assert_array_equal(np.isfinite(a), fin, err_msg=f"{what} {name}")
            assert_close(np.where(fin, a, 0.0), np.where(fin, w, 0.0), tol, f"{what} {name}")


def _tols(with_snr, with_health, u, mp, line):
    return [u, mp, line] + [line] * (2 * with_snr) + [None, line] * with_health


@pytest.mark.parametrize("view", WALK_VIEWS)
@pytest.mark.parametrize("with_snr,with_health", FLAGS)
def test_group_walk_matches_the_plain_twin(view, with_snr, with_health):
    n_bad = 5 if with_health else 0
    g, m, v, bc1, bc2 = _slim_inputs(view, sum(view) + 1, n_bad)
    plan = plan_slim(*view, sms=H100_SMS, aligned=True)
    t = [torch.from_numpy(x) for x in (g, m, v, bc1, bc2)]
    got = _emulate(*t, plan, with_snr, with_health)
    want = megaplan.mega_slim_update_batched_plain(*t, axis=view[3], with_snr=with_snr, with_health=with_health, **KW)
    _hold(got, want, _tols(with_snr, with_health, LINE_SUMS, ELEMENTWISE, LINE_SUMS), f"{view} twin")
    if with_health:
        assert float(got[-2].sum()) == n_bad


@pytest.mark.parametrize("view", WALK_VIEWS)
@pytest.mark.parametrize("with_snr,with_health", FLAGS)
def test_group_walk_matches_the_tpu_kernel(view, with_snr, with_health):
    """The walk's outputs against the Pallas ``mega_slim_update_batched``
    in interpret mode on the same input (finite g: the TPU kernel's f32 line
    sums)."""
    g, m, v, bc1, bc2 = _slim_inputs(view, sum(view) + 2)
    plan = plan_slim(*view, sms=H100_SMS, aligned=True)
    got = _emulate(*[torch.from_numpy(x) for x in (g, m, v, bc1, bc2)], plan, with_snr, with_health)
    want = jax_mega_slim(*map(jnp.asarray, (g, m, v, bc1, bc2)), axis=view[3], with_snr=with_snr,
                         with_health=with_health, interpret=True, **KW)
    _hold(got, want, _tols(with_snr, with_health, ELEMENTWISE, ELEMENTWISE, LINE_SUMS), f"{view} pallas")


def _per_leaf_emulation(g, m, v, plan, count, with_snr, with_health):
    """B4 on the walk: B1's with the scalar bias corrections, and the
    per-line health terms summed (in f64, line order) to the leaf's (2,)."""
    bc1, bc2 = bias_corrections(KW["b1"], KW["b2"], torch.as_tensor(count))
    outs = _emulate(g.float().numpy(), m, v, bc1, bc2, plan, with_snr, with_health)
    if not with_health:
        return outs
    nf, ss = outs[-2], outs[-1]
    return outs[:-2] + (torch.stack([nf.double().sum(), ss.double().sum()]).float(),)


@pytest.mark.parametrize("view", WALK_VIEWS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_snr,with_health", FLAGS)
def test_per_leaf_walk_matches_the_twin_and_the_tpu_kernel(view, dtype, with_snr, with_health):
    """B4 (scalar bias corrections from the count, f32 or bf16 g) on the
    walk, against its plain twin and the Pallas ``slim_precond_batched`` in
    interpret mode."""
    g, m, v, _, _ = _slim_inputs(view, sum(view) + 3)
    plan = plan_slim(*view, sms=H100_SMS, aligned=True)
    gt = torch.from_numpy(g).to(dtype)
    mt, vt = torch.from_numpy(m), torch.from_numpy(v)
    flags = dict(with_snr=with_snr, with_health=with_health)
    got = _per_leaf_emulation(gt, mt, vt, plan, 3, **flags)
    twin = slim_update.slim_precond_batched(gt, mt, vt, axis=view[3], count=3, **flags, **KW)
    tols = [LINE_SUMS, ELEMENTWISE, LINE_SUMS] + [LINE_SUMS] * (2 * with_snr) + [LINE_SUMS] * with_health
    for name, tol, a, w in zip(("u", "m'", "v'", "s1c", "s2c", "health"), tols, got, twin):
        assert_close(a, w, tol, f"{view} twin {name}")
    g_jax = jnp.asarray(gt.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    want = jax_slim_precond(g_jax, jnp.asarray(m), jnp.asarray(v), axis=view[3], count=3, interpret=True, **flags,
                            **KW)
    tols = [ELEMENTWISE, ELEMENTWISE, LINE_SUMS] + [LINE_SUMS] * (2 * with_snr) + [LINE_SUMS] * with_health
    for name, tol, a, w in zip(("u", "m'", "v'", "s1c", "s2c", "health"), tols, got, want):
        assert_close(a, w, tol, f"{view} pallas {name}")
