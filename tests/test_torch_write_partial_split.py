"""B7 (``slim_update_batched``, the parameter-writing form), B12
(``mega_slim_partial_stats_batched``, the grouped psum pair's pass 1) and
B10 (``slim_partial_stats_batched``, its per-leaf twin) on the split walk of
``repro_torch.kernels.megaplan.plan_slim``, checked here without a card.

B7 takes B4's grid and pass 1; its pass 2 adds each line's f64 shares in
the plan's order and writes p' = p - lr*(u + wd*p) in p's dtype. B12 takes
one walk over the pieces that writes m' and each piece's f64 shares, then a
combine launch that adds a line's shares in a fixed order: on SPLIT a warp
a line, lane i adding shares i, i + 32, ... and then a shuffle tree; on
MAJOR a thread a column adding shares 0, 1, ... (stored at k * lines + l).
This file checks that the plans' pieces fill every workspace slot once, in
the combine's order, on the split views of ``test_torch_slim_split.py``,
AdaLayer's 38,633,472-element embedding line, a rank's 9,658,368-element
embedding shard on the (data=2, model=2) mesh and ResNet-18's widest axis-0
group; then emulates both walks in numpy and holds the combined sums to an
f64 sum of each whole line (1e-12), the outputs to the plain twins (m' and
p' 1e-6, line values 1e-5; a bf16 p' to one bf16 step, as the card tests
hold it) and to the JAX package's Pallas kernels in interpret mode (B7 at
``test_torch_param_kernels.py``'s 1e-5, B12 at ``test_torch_psum.py``'s
1e-5; non-finite counts exact).

B10 runs B12's kernels on the same plan (f32 or bf16 g; the (2,) health is
the combined per-line nf/ss lines summed in f64 in line order, as
``health_reduce_kernel`` sums them): on the ROWS, SPLIT and MAJOR views
``plan_slim`` picks at 132 and 8 SMs, its m', shift f and non-finite count
equal the plain twin's bit for bit (the same f32 operations), its line sums
(f64, rounded once; the twin sums in f32) within 1e-5, and everything within
1e-5 of the Pallas ``slim_partial_stats_batched`` in interpret mode.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close
from repro.kernels.megaplan import mega_slim_partial_stats_batched as jax_mega_partial
from repro.kernels.slim_update import slim_partial_stats_batched as jax_slim_partial
from repro.kernels.slim_update import slim_update_batched as jax_slim_update
from repro_torch.kernels import megaplan, slim_update
from repro_torch.kernels.fused_adam import host_bias_corrections
from repro_torch.kernels.megaplan import FORM_MAJOR, FORM_ROWS, FORM_SPLIT, SLIM_SEG_MIN, plan_slim
from test_torch_slim_split import (EMBED_LINE, F64_ORDER, H100_SMS, RESNET_WIDE, WALK_VIEWS, _check_plan,
                                   _f64_line_sums, _length, _line_view, _piece_shares, _planes, _slim_inputs,
                                   _walk_sums, _work)

ELEMENTWISE = 1e-6
LINE_SUMS = 1e-5
BAR = 1e-5               # test_torch_param_kernels.py and test_torch_psum.py against the Pallas kernels
BF16_STEP = 2.0**-8      # a bf16 p' may round one step apart where its f32 value straddles a boundary
KW = dict(b1=0.9, b2=0.95, eps=1e-8)
STEP = dict(lr=1e-3, wd=0.1, count=3)
SHARD_LINE = (1, 1, 25152 * 384, 1)   # the embedding's psum line on a (data=2, model=2) rank
FLAGS = [(False, False), (True, False), (False, True), (True, True)]
DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
          (torch.bfloat16, torch.float32)]
COVER_VIEWS = WALK_VIEWS + [EMBED_LINE, SHARD_LINE, RESNET_WIDE, (2, 3, SLIM_SEG_MIN + 1, 1), (3, 1025, 33, 0)]


def _slot(plan, line, k):
    """Where pass 1 stores share k of ``line`` in a plane: l * nseg + k on
    SPLIT, k * lines + l on MAJOR."""
    return line * plan.nseg + k if plan.form == FORM_SPLIT else k * plan.lines + line


def _combine_order(plan, line):
    """The slots the combine adds for ``line``, as the terms of its sum:
    SPLIT, lane i's shares i, i + 32, ...; MAJOR, shares 0, 1, ..."""
    if plan.form == FORM_MAJOR:
        return [[_slot(plan, line, k) for k in range(plan.nseg)]]
    return [[_slot(plan, line, k) for k in range(lane, plan.nseg, 32)] for lane in range(32)]


@pytest.mark.parametrize("view", COVER_VIEWS)
@pytest.mark.parametrize("aligned", [True, False])
def test_plans_fill_every_slot_once_in_combine_order(view, aligned):
    """B7 and B12 take B1's plan (its pieces cover every line once, pass 2 in
    reverse); pass 1's pieces write the workspace slots 0 .. lines*nseg - 1
    once each, piece k of a line at the slot the combine reads as share k."""
    plan = plan_slim(*view, sms=H100_SMS, aligned=aligned)
    _check_plan(plan)
    if plan.form == FORM_ROWS:
        return
    written, seen = {}, {}
    for block in range(plan.blocks):
        for line, start, stop in _work(plan, block):
            k = start // plan.seg
            assert (start, stop) == (k * plan.seg, min(_length(plan), (k + 1) * plan.seg))
            slot = _slot(plan, line, k)
            assert slot not in written, (view, line, k)
            written[slot] = (line, k)
            seen.setdefault(line, []).append(k)
    assert sorted(written) == list(range(plan.lines * plan.nseg))
    for line, ks in seen.items():
        assert sorted(ks) == list(range(plan.nseg))
        order = [s for lane in _combine_order(plan, line) for s in lane]
        assert sorted(order) == sorted(_slot(plan, line, k) for k in range(plan.nseg))


@pytest.mark.parametrize("view", [EMBED_LINE, SHARD_LINE, RESNET_WIDE])
def test_long_lines_fill_the_card(view):
    """The 38.6 M line and the shard line take SPLIT, ResNet-18's (1, 4608,
    1536) MAJOR, each with at least 4 blocks an SM of an H100."""
    plan = plan_slim(*view, sms=H100_SMS, aligned=True)
    assert plan.form == (FORM_SPLIT if view[3] == 1 else FORM_MAJOR) and plan.blocks >= 4 * H100_SMS


@pytest.mark.parametrize("view", [SHARD_LINE, RESNET_WIDE, (1, 300, 768, 1)])
@pytest.mark.parametrize("offset", [0, 1])
def test_slim_walk_keeps_the_plan_it_launches(monkeypatch, view, offset):
    """``slim_walk`` passes the launch the plan it keeps in ``last_plans``
    (what chip_smoke and slim_ab log through ``describe``): four-element
    loads on an aligned view, none on a view one element off, and a
    workspace of the shares exactly where the plan splits."""
    monkeypatch.setattr(megaplan.build, "sm_count", lambda device: H100_SMS)
    b, r, c, axis = view
    g = torch.zeros(b * r * c + offset)[offset:].view(b, r, c)
    m = torch.zeros(b, r, c)
    args, work = megaplan.slim_walk("walk test", g, m, axis, with_snr=True, with_health=False)
    plan = megaplan.last_plans["walk test"]
    assert plan == plan_slim(b, r, c, axis, sms=H100_SMS, aligned=offset == 0)
    assert args[:5] == (plan.form, int(plan.vec), plan.seg, plan.nseg, plan.blocks)
    if plan.nseg == 1:
        assert work is None and args[5] is None
    else:
        assert work.shape == (3, plan.lines * plan.nseg) and args[5] == work.data_ptr()
    name = {FORM_ROWS: "ROWS", FORM_SPLIT: "SPLIT", FORM_MAJOR: "MAJOR"}[plan.form]
    assert plan.describe() == f"{name}, nseg {plan.nseg}, {plan.blocks} blocks"


# -- B12: launch 1's shares, launch 2's combine ------------------------------------------

def _partial_shares(g, plan, with_snr, with_health):
    """Launch 1: each piece's f64 shares, in (planes, lines * nseg) at the
    plan's slots."""
    g = np.asarray(g, np.float32)
    lines = (np.moveaxis(g, 1, 2) if plan.axis == 0 else g).reshape(plan.lines, _length(plan))
    work = np.zeros((_planes(with_snr, with_health), plan.lines * plan.nseg))
    with np.errstate(invalid="ignore", over="ignore"):
        for block in range(plan.blocks):
            for line, start, stop in _work(plan, block):
                f = lines[line, 0] * lines[line, 0]
                work[:, _slot(plan, line, start // plan.seg)] = _piece_shares(lines[line, start:stop], f, with_snr,
                                                                                with_health)
    return work


def _combine(work, plan):
    """Launch 2: each line's f64 totals (lines, planes), added in the
    combine's order (the SPLIT lanes' sums joined by the xor shuffle tree)."""
    total = np.zeros((plan.lines, work.shape[0]))
    for line in range(plan.lines):
        lanes = np.zeros((32 if plan.form == FORM_SPLIT else 1, work.shape[0]))
        for i, slots in enumerate(_combine_order(plan, line)):
            for s in slots:
                lanes[i] = lanes[i] + work[:, s]
        off = len(lanes) // 2
        while off:
            lanes = lanes + lanes[np.arange(len(lanes)) ^ off]
            off //= 2
        total[line] = lanes[0]
    return total


def _emulate_partial(g, m, plan, with_snr, with_health):
    """B12's outputs on the split walk: m' elementwise, the combined sums
    rounded to f32 once, the shift f = g^2 at each line's first entry."""
    total = _combine(_partial_shares(g, plan, with_snr, with_health), plan)
    g32, m32 = torch.from_numpy(g), torch.from_numpy(m)
    out = (KW["b1"] * m32 + (1 - KW["b1"]) * g32, _line_view(total[:, 0].astype(np.float32), plan))
    rest = [_line_view(total[:, p].astype(np.float32), plan) for p in range(1, total.shape[1])]
    if with_snr:
        first = g32.narrow(2 if plan.axis == 1 else 1, 0, 1)
        out = out + (rest[0], rest[1], first * first)
        rest = rest[2:]
    return out + tuple(rest)


def _split_plan(view):
    plan = plan_slim(*view, sms=H100_SMS, aligned=True)
    assert plan.form != FORM_ROWS
    return plan


SPLIT_VIEWS = [v for v in WALK_VIEWS if plan_slim(*v, sms=H100_SMS, aligned=True).form != FORM_ROWS]


@pytest.mark.parametrize("view", SPLIT_VIEWS)
@pytest.mark.parametrize("with_snr,with_health", FLAGS)
def test_partial_combine_adds_up_to_the_line_sums(view, with_snr, with_health):
    g = _slim_inputs(view, sum(view) + 4, n_bad=0)[0]
    plan = _split_plan(view)
    total = _combine(_partial_shares(g, plan, with_snr, with_health), plan)
    for p, want in enumerate(_f64_line_sums(g, view[3], with_snr, with_health)):
        got = total[:, p]
        assert float(np.abs(got - want).max()) <= F64_ORDER * max(float(np.abs(want).max()), 1e-300), p
    # the same totals as B1's pass 2 sums, which add the shares in order
    np.testing.assert_allclose(total, _walk_sums(g, plan, with_snr, with_health), rtol=F64_ORDER, atol=0)


def _partial_tols(with_snr, with_health):
    return ([("m'", ELEMENTWISE), ("part", LINE_SUMS)] + [("s1c", LINE_SUMS), ("s2c", LINE_SUMS), ("first", None)]
            * with_snr + [("nf", None), ("ss", LINE_SUMS)] * with_health)


def _hold(got, want, tols, what):
    assert len(got) == len(want) == len(tols), what
    for (name, tol), a, w in zip(tols, got, want):
        a, w = np.asarray(a, np.float64), np.asarray(w, np.float64)
        fin = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(a), fin, err_msg=f"{what} {name}")
        if tol is None:
            np.testing.assert_array_equal(np.where(fin, a, 0.0), np.where(fin, w, 0.0), err_msg=f"{what} {name}")
        else:
            assert_close(np.where(fin, a, 0.0), np.where(fin, w, 0.0), tol, f"{what} {name}")


@pytest.mark.parametrize("view", SPLIT_VIEWS)
@pytest.mark.parametrize("with_snr,with_health", FLAGS)
def test_partial_walk_matches_the_plain_twin(view, with_snr, with_health):
    n_bad = 5 if with_health else 0
    g, m = _slim_inputs(view, sum(view) + 5, n_bad)[:2]
    plan = _split_plan(view)
    got = _emulate_partial(g, m, plan, with_snr, with_health)
    want = megaplan.mega_slim_partial_stats_batched(torch.from_numpy(g), torch.from_numpy(m), axis=view[3],
                                                    b1=KW["b1"], with_snr=with_snr, with_health=with_health)
    _hold(got, want, _partial_tols(with_snr, with_health), f"{view} twin")
    if with_health:
        assert float(got[-2].sum()) == n_bad


@pytest.mark.parametrize("view", SPLIT_VIEWS)
@pytest.mark.parametrize("with_snr,with_health", [(False, False), (True, True)])
def test_partial_walk_matches_the_tpu_kernel(view, with_snr, with_health):
    """The walk's outputs against the Pallas ``mega_slim_partial_stats_batched``
    in interpret mode (finite g)."""
    g, m = _slim_inputs(view, sum(view) + 6)[:2]
    plan = _split_plan(view)
    got = _emulate_partial(g, m, plan, with_snr, with_health)
    want = jax_mega_partial(jnp.asarray(g), jnp.asarray(m), axis=view[3], b1=KW["b1"], with_snr=with_snr,
                            with_health=with_health, interpret=True)
    tols = [(name, BAR if tol is not None else None) for name, tol in _partial_tols(with_snr, with_health)]
    _hold(got, want, tols, f"{view} pallas")


# -- B7: B4's pass 1, pass 2 writing p' -----------------------------------------------------

def _write_inputs(view, seed, p_dtype, g_dtype):
    b, r, c, axis = view
    rng = np.random.default_rng(seed)
    line = (b, r, 1) if axis == 1 else (b, 1, c)
    p = torch.from_numpy(rng.standard_normal((b, r, c)).astype(np.float32)).to(p_dtype)
    g = torch.from_numpy((1e-2 * rng.standard_normal((b, r, c))).astype(np.float32)).to(g_dtype)
    m = torch.from_numpy((1e-3 * rng.standard_normal((b, r, c))).astype(np.float32))
    v = torch.from_numpy((1e-4 * rng.random(line)).astype(np.float32))
    return p, g, m, v


def _emulate_write(p, g, m, v, plan):
    """B7's outputs on the split walk: v' from the f64 shares added in the
    plan's order and rounded once, then pass 2's elementwise m', u and p'
    (rounded to p's dtype)."""
    total = _walk_sums(g.float().numpy(), plan)
    c1, c2 = host_bias_corrections(KW["b1"], KW["b2"], STEP["count"])
    ek = _line_view(total[:, 0].astype(np.float32), plan) * (1.0 / _length(plan))
    v_new = KW["b2"] * v + (1 - KW["b2"]) * ek
    m_new = KW["b1"] * m + (1 - KW["b1"]) * g.float()
    u = (m_new / c1) / (torch.sqrt(v_new / c2) + KW["eps"])
    p32 = p.float()
    p_new = (p32 - STEP["lr"] * (u + STEP["wd"] * p32)).to(p.dtype)
    return p_new, m_new, v_new


def _hold_write(got, want, tols, what):
    for name, tol, a, w in zip(("p'", "m'", "v'"), tols, got, want):
        assert str(a.dtype).split(".")[-1] == str(w.dtype).split(".")[-1], (what, name, a.dtype, w.dtype)
        assert_close(a.float().numpy(), w.float().numpy(), tol, f"{what} {name}")


@pytest.mark.parametrize("view", SPLIT_VIEWS)
@pytest.mark.parametrize("p_dtype,g_dtype", DTYPES)
def test_write_pass2_matches_the_plain_twin(view, p_dtype, g_dtype):
    """p' and m' at 1e-6 of the twin (a bf16 p' within one bf16 step), v'
    at the line sums' 1e-5."""
    p, g, m, v = _write_inputs(view, sum(view) + 7, p_dtype, g_dtype)
    plan = _split_plan(view)
    got = _emulate_write(p, g, m, v, plan)
    want = slim_update.slim_update_batched(p, g, m, v, axis=view[3], **STEP, **KW)
    p_tol = ELEMENTWISE if p_dtype == torch.float32 else BF16_STEP
    _hold_write(got, want, (p_tol, ELEMENTWISE, LINE_SUMS), f"{view} twin")


@pytest.mark.parametrize("view", SPLIT_VIEWS)
@pytest.mark.parametrize("p_dtype,g_dtype", DTYPES)
def test_write_walk_matches_the_tpu_kernel(view, p_dtype, g_dtype):
    """The walk's outputs against the Pallas ``slim_update_batched`` in
    interpret mode, at the bar of ``test_torch_param_kernels.py``. A bf16 p
    holds values that bf16 can hold in both packages."""
    p, g, m, v = _write_inputs(view, sum(view) + 8, p_dtype, g_dtype)
    plan = _split_plan(view)
    got = _emulate_write(p, g, m, v, plan)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    want = jax_slim_update(jnp.asarray(p.float().numpy()).astype(jdt[p_dtype]),
                           jnp.asarray(g.float().numpy()).astype(jdt[g_dtype]), jnp.asarray(m.numpy()),
                           jnp.asarray(v.numpy()), axis=view[3], interpret=True, **STEP, **KW)
    _hold_write(got, [torch.from_numpy(np.asarray(w.astype(jnp.float32))).to(d)
                      for w, d in zip(want, (p_dtype, torch.float32, torch.float32))], (BAR,) * 3, f"{view} pallas")


# -- B10: B12's walk and combine, f32 or bf16 g, the (2,) health -------------------------------

B10_SMS = (H100_SMS, 8)


def _emulate_b10(g, m, plan, with_snr, with_health):
    """B10's outputs on ``plan``: B12's, with g read as f32 and the
    combined nf/ss lines summed in f64 in line order to the (2,) health."""
    outs = _emulate_partial(g.float().numpy(), m.numpy(), plan, with_snr, with_health)
    if not with_health:
        return outs
    nf, ss = outs[-2], outs[-1]
    return outs[:-2] + (torch.stack([nf.double().sum(), ss.double().sum()]).float(),)


def _b10_inputs(view, dtype, n_bad):
    g, m = _slim_inputs(view, sum(view) + 9, n_bad)[:2]
    return torch.from_numpy(g).to(dtype), torch.from_numpy(m)


def _hold_b10(got, want, with_snr, with_health, tol, what):
    """m', f and the non-finite count exact at ``tol=None``, else every
    output within ``tol`` of its largest magnitude; the line sums and ss
    within ``tol`` or LINE_SUMS."""
    assert len(got) == len(want) == 2 + 3 * with_snr + with_health, what
    exact = tol is None
    names = ["m'", "part"] + ["s1c", "s2c", "first"] * with_snr
    tols = {"m'": tol, "part": tol or LINE_SUMS, "s1c": tol or LINE_SUMS, "s2c": tol or LINE_SUMS, "first": tol}
    _hold(got[:len(names)], want[:len(names)], [(n, tols[n]) for n in names], what)
    if with_health:
        h, w = np.asarray(got[-1], np.float64), np.asarray(want[-1], np.float64)
        assert h[0] == w[0], (what, "nf", h[0], w[0])
        assert_close(h[1:], w[1:], tol or LINE_SUMS, f"{what} ss")
    if exact:
        assert torch.equal(got[0].nan_to_num(), want[0].nan_to_num()), f"{what}: m' is not the twin's bits"


@pytest.mark.parametrize("view", WALK_VIEWS)
@pytest.mark.parametrize("sms", B10_SMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_snr,with_health", FLAGS)
def test_b10_walk_matches_the_plain_twin(view, sms, dtype, with_snr, with_health):
    n_bad = 5 if with_health else 0
    g, m = _b10_inputs(view, dtype, n_bad)
    plan = plan_slim(*view, sms=sms, aligned=True)
    got = _emulate_b10(g, m, plan, with_snr, with_health)
    want = slim_update.slim_partial_stats_batched(g, m, axis=view[3], b1=KW["b1"], with_snr=with_snr,
                                                  with_health=with_health)
    _hold_b10(got, want, with_snr, with_health, None, f"{view} at {sms} SMs, {plan.describe()}, twin")
    if with_health:
        assert float(got[-1][0]) == n_bad


@functools.lru_cache(maxsize=None)
def _b10_pallas(view, dtype, with_snr, with_health):
    """The Pallas kernel in interpret mode on ``_b10_inputs``' operands
    (finite g), once a case for both SM counts."""
    g, m = _b10_inputs(view, dtype, 0)
    g_jax = jnp.asarray(g.float().numpy()).astype(jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    return tuple(np.asarray(o) for o in jax_slim_partial(g_jax, jnp.asarray(m.numpy()), axis=view[3], b1=KW["b1"],
                                                         with_snr=with_snr, with_health=with_health,
                                                         interpret=True))


@pytest.mark.parametrize("view", WALK_VIEWS)
@pytest.mark.parametrize("sms", B10_SMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_snr,with_health", [(False, False), (True, True)])
def test_b10_walk_matches_the_tpu_kernel(view, sms, dtype, with_snr, with_health):
    g, m = _b10_inputs(view, dtype, 0)
    plan = plan_slim(*view, sms=sms, aligned=True)
    got = _emulate_b10(g, m, plan, with_snr, with_health)
    want = _b10_pallas(view, dtype, with_snr, with_health)
    _hold_b10(got, want, with_snr, with_health, BAR, f"{view} at {sms} SMs, {plan.describe()}, pallas")


def test_b10_views_take_every_form_on_both_cards():
    """The views above give ROWS, SPLIT and MAJOR at 132 SMs, and at 8."""
    for sms in B10_SMS:
        forms = {plan_slim(*v, sms=sms, aligned=True).form for v in WALK_VIEWS}
        assert forms == {FORM_ROWS, FORM_SPLIT, FORM_MAJOR}, sms


@pytest.mark.parametrize("view", [SHARD_LINE, RESNET_WIDE, (1, 300, 768, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b10_walk_keeps_b12s_plan(monkeypatch, view, dtype):
    """B10 passes its launch ``slim_walk``'s plan under its own name, the
    one B12 takes on the same operands (four bf16 g are 8 bytes, so an
    8-byte aligned bf16 view takes the vector form too)."""
    monkeypatch.setattr(megaplan.build, "sm_count", lambda device: H100_SMS)
    b, r, c, axis = view
    g, m = torch.zeros(b, r, c, dtype=dtype), torch.zeros(b, r, c)
    args, work = megaplan.slim_walk("slim_partial_stats_batched", g, m, axis, with_snr=False, with_health=True)
    plan = megaplan.last_plans["slim_partial_stats_batched"]
    assert plan == plan_slim(b, r, c, axis, sms=H100_SMS, aligned=True)
    assert args[:5] == (plan.form, int(plan.vec), plan.seg, plan.nseg, plan.blocks)
    assert (work is None) == (plan.nseg == 1) and (work is None or work.shape == (3, plan.lines * plan.nseg))
