"""B11's and B13's flat walk (``repro_torch.kernels.slim_update.plan_finalize``
and ``csrc/slim_finalize.cu``'s ``finalize_flat_kernel``), checked here
without a card.

The plan is pure integer arithmetic on the shapes and the SM count.
``_walk`` repeats the kernel's loops over the plan's grid: block i walks
tiles i, i + blocks, ... of FLAT_THREADS x FLAT_UNROLL vectors, and each thread
loads its vectors of a tile FLAT_THREADS apart. Every vector must be loaded
exactly once, and no block may be without a tile. ``_emulate`` repeats what
a thread does with each vector it loads, in plain torch: the vector's row
q = j // (C / vec) of the (B*R, C) matrix, its line (q on axis 1; b*C + c
on axis 0, 4 adjacent lines for a float4), the line values, u, and v' from
the thread that holds the line's first element alone. It must equal the
plain twin bit for bit (the same operations in the same order), and the
JAX package's Pallas kernel in interpret mode within 1e-5 of each output's
largest magnitude (the bar of ``tests/test_torch_psum.py``), on the same
numpy inputs. Also the count forms: a Python int and 0-d int32 and int64
tensors give the same output; other counts raise. B13 (the group form)
walks the same vectors with its bias corrections given a line, read from
the vector's line index as v is (a float4 of 4 adjacent lines on axis 0):
with distinct values a line, bit-equal to its twin and within 1e-5 of
``mega_slim_finalize_batched`` in interpret mode.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close
from repro.kernels import megaplan as jmega
from repro.kernels import slim_update as jslim
from repro_torch.kernels import megaplan, slim_update
from repro_torch.kernels.fused_adam import host_bias_corrections
from repro_torch.kernels.slim_update import FLAT_BLOCKS_PER_SM, FLAT_THREADS, FLAT_UNROLL, WIDE, plan_finalize

TOL = 1e-5
KW = dict(b1=0.9, b2=0.95, eps=1e-8)
SMS = (132, 8)     # an H100, and a card smaller than the views

# chip_smoke.py's phase 6a: rank 0's local shards of the 7 psum leaves of
# full-width gpt_small on a (data=2, model=2) mesh (wk, wq; wo, wv; w_down;
# w_up; embed).
PHASE_6A = [(12, 384, 384, 0), (1, 4608, 384, 1), (1, 18432, 384, 1), (1, 4608, 1536, 1), (1, 25152, 384, 1)]
# c % 4 != 0, ragged tails, axis 0 with B > 1, a view smaller than a block.
SMALL = [(1, 300, 64, 1), (2, 5, 33, 1), (1, 17, 7, 0), (3, 64, 129, 0), (12, 48, 40, 0), (4, 9, 12, 0),
         (5, 3, 7, 1), (1, 1, 4, 1), (1, 1, 1, 0), (2, 1, 8, 0)]


def _walk(plan) -> np.ndarray:
    """Every vector index the kernel loads, in the order of blocks; checks
    on the way that every block has a first tile."""
    lanes = (np.arange(FLAT_UNROLL)[:, None] * FLAT_THREADS + np.arange(FLAT_THREADS)[None, :]).ravel()
    out = []
    for i in range(plan.blocks):
        starts = np.arange(i * plan.tile, plan.vectors, plan.blocks * plan.tile)
        assert starts.size >= 1, f"block {i} has no tile"
        j = (starts[:, None] + lanes[None, :]).ravel()
        out.append(j[j < plan.vectors])
    return np.concatenate(out)


@pytest.mark.parametrize("b,r,c,axis", PHASE_6A + SMALL)
@pytest.mark.parametrize("sms", SMS)
def test_plan_covers_every_vector_once(b, r, c, axis, sms):
    plan = plan_finalize(b, r, c, axis, sms)
    assert plan.vec == (4 if c % 4 == 0 else 1)
    assert plan.vectors * plan.vec == b * r * c
    assert not plan.wide
    assert 1 <= plan.blocks <= min(-(-plan.vectors // plan.tile), FLAT_BLOCKS_PER_SM * sms)
    hits = np.bincount(_walk(plan), minlength=plan.vectors)
    assert hits.size == plan.vectors and (hits == 1).all()


def test_plan_forms():
    """The grids at phase 6a's shapes on an H100, scalar loads where the
    buffers are not 16-byte aligned, and 64-bit indices from 2^31
    elements."""
    wk = plan_finalize(12, 384, 384, 0, 132)
    assert (wk.vec, wk.blocks) == (4, FLAT_BLOCKS_PER_SM * 132)       # 4 line values a float4
    wo = plan_finalize(1, 4608, 384, 1, 132)
    assert (wo.vec, wo.blocks) == (4, FLAT_BLOCKS_PER_SM * 132)       # 864 tiles: some blocks walk two
    small = plan_finalize(1, 1024, 384, 1, 132)
    assert (small.vec, small.blocks) == (4, 192)                      # one tile a block
    tiny = plan_finalize(1, 1, 4, 1, 132)
    assert (tiny.vec, tiny.blocks) == (4, 1)
    assert plan_finalize(1, 4608, 384, 1, 132, aligned=False).vec == 1
    assert plan_finalize(1, 2**16, 2**15, 1, 132).wide
    assert not plan_finalize(1, 2**16, 2**15 - 1, 1, 132).wide and 2**16 * (2**15 - 1) < WIDE
    for bad in ((0, 4, 4, 1, 132), (1, 4, 4, 2, 132), (1, 4, 4, 1, 0)):
        with pytest.raises(ValueError):
            plan_finalize(*bad)


def _inputs(b, r, c, axis, seed):
    rng = np.random.default_rng(seed)
    line = (b, r, 1) if axis == 1 else (b, 1, c)
    m = rng.standard_normal((b, r, c)).astype(np.float32)
    v = np.abs(rng.standard_normal(line)).astype(np.float32)
    ek = np.abs(rng.standard_normal(line)).astype(np.float32)
    return m, v, ek


def _emulate(plan, m, v, ek, bc1, bc2, *, b2, eps):
    """u (NaN where no thread wrote) and, with ``ek``, v' (NaN where no
    thread wrote), as the kernel's threads compute them from the vectors
    ``_walk`` gives them. ``bc1``/``bc2``: floats (B11), or lines shaped
    like ``v`` (B13), read at the vector's line index as v is."""
    vec = plan.vec
    j = torch.from_numpy(_walk(plan))
    q = j // (plan.cols // vec)
    cv = j - q * (plan.cols // vec)
    offs = torch.arange(vec)
    if plan.axis == 1:
        line, first = q[:, None], cv == 0              # one line value a vector
    else:
        bi = q // plan.rows
        line, first = (bi * plan.cols + cv * vec)[:, None] + offs, q == bi * plan.rows
    elem = j[:, None] * vec + offs
    v_flat = v.reshape(-1)
    vn = v_flat[line] if ek is None else b2 * v_flat[line] + (1 - b2) * ek.reshape(-1)[line]
    u = torch.full((m.numel(),), float("nan"))
    if isinstance(bc1, torch.Tensor):
        bc1, bc2 = bc1.reshape(-1)[line], bc2.reshape(-1)[line]
    u[elem.reshape(-1)] = ((m.reshape(-1)[elem] / bc1) / (torch.sqrt(vn / bc2) + eps)).reshape(-1)
    u = u.reshape(m.shape)
    if ek is None:
        return u
    writers = line[first].reshape(-1)
    assert (torch.bincount(writers, minlength=v.numel()) == 1).all(), "v' written other than once a line"
    v_out = torch.full((v.numel(),), float("nan"))
    v_out[writers] = vn[first].reshape(-1)
    return u, v_out.reshape(v.shape)


@pytest.mark.parametrize("b,r,c,axis", SMALL + [(12, 384, 384, 0), (1, 4608, 384, 1)])
@pytest.mark.parametrize("form", ["ek", "owner"])
@pytest.mark.parametrize("sms,aligned", [(132, True), (8, True), (132, False)])
def test_walk_equals_twin_and_jax(b, r, c, axis, form, sms, aligned):
    m, v, ek = _inputs(b, r, c, axis, seed=b * r + c)
    count = 3
    bc1, bc2 = host_bias_corrections(KW["b1"], KW["b2"], count)
    tek = torch.from_numpy(ek) if form == "ek" else None
    plan = plan_finalize(b, r, c, axis, sms, aligned=aligned)
    got = _emulate(plan, torch.from_numpy(m), torch.from_numpy(v), tek, bc1, bc2, b2=KW["b2"], eps=KW["eps"])
    twin = slim_update.slim_finalize_batched_plain(torch.from_numpy(m), torch.from_numpy(v), bc1, bc2, b2=KW["b2"],
                                                   eps=KW["eps"], ek=tek)
    want = jslim.slim_finalize_batched(jnp.asarray(m), jnp.asarray(v), axis=axis,
                                       ek=jnp.asarray(ek) if form == "ek" else None, count=count, **KW)
    if form == "owner":
        got, twin, want = (got,), (twin,), (want,)
    for label, g, t, w in zip(("u", "v'"), got, twin, want):
        assert torch.equal(g, t), f"{label}: the walk is not the twin"
        assert_close(g.numpy(), np.asarray(w), TOL, label)


def test_walk_other_grids():
    """The walk on grids smaller than the planner's: a single block that
    walks every tile, and 5 blocks whose tile counts differ."""
    base = plan_finalize(12, 48, 40, 0, 8)
    m, v, ek = (torch.from_numpy(x) for x in _inputs(12, 48, 40, 0, seed=1))
    want = slim_update.slim_finalize_batched_plain(m, v, 0.5, 0.25, b2=KW["b2"], eps=KW["eps"], ek=ek)
    assert -(-base.vectors // base.tile) % 5 != 0
    for plan in (dataclasses.replace(base, blocks=1), dataclasses.replace(base, blocks=5)):
        assert (np.bincount(_walk(plan), minlength=plan.vectors) == 1).all()
        u, v_out = _emulate(plan, m, v, ek, 0.5, 0.25, b2=KW["b2"], eps=KW["eps"])
        assert torch.equal(u, want[0]) and torch.equal(v_out, want[1])


@pytest.mark.parametrize("count", [1, 3, 1000, 10**6])
@pytest.mark.parametrize("form", ["ek", "owner"])
def test_count_forms_agree(count, form):
    """A Python int and 0-d int32 and int64 tensors give the same output
    (their bias corrections are the same f32 values), within 1e-5 of the
    JAX package's."""
    m, v, ek = _inputs(2, 24, 36, 1, seed=count % 97)
    tm, tv = torch.from_numpy(m), torch.from_numpy(v)
    tek = torch.from_numpy(ek) if form == "ek" else None
    outs = [slim_update.slim_finalize_batched(tm, tv, axis=1, ek=tek, count=cnt, **KW)
            for cnt in (count, torch.tensor(count, dtype=torch.int32), torch.tensor(count, dtype=torch.int64))]
    want = jslim.slim_finalize_batched(jnp.asarray(m), jnp.asarray(v), axis=1,
                                       ek=jnp.asarray(ek) if form == "ek" else None, count=count, **KW)
    if form == "owner":
        outs, want = [(o,) for o in outs], (want,)
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b)
    for label, g, w in zip(("u", "v'"), outs[0], want):
        assert_close(g.numpy(), np.asarray(w), TOL, f"{label} at count {count}")


@pytest.mark.parametrize("count", [torch.tensor(3.0), torch.tensor(3, dtype=torch.int16), torch.tensor([3]),
                                   torch.tensor(3, dtype=torch.uint8), 3.0])
def test_unsupported_count_raises(count):
    m, v, _ = _inputs(1, 4, 8, 1, seed=0)
    with pytest.raises(TypeError):
        slim_update.slim_finalize_batched(torch.from_numpy(m), torch.from_numpy(v), axis=1, count=count, **KW)


# -- B13: the same walk, bias corrections a line --------------------------------------------


def _bc_lines(v, seed):
    """Distinct bias corrections a line, shaped like ``v``."""
    rng = np.random.default_rng(seed)
    return tuple((0.05 + rng.random(v.shape)).astype(np.float32) for _ in range(2))


@pytest.mark.parametrize("b,r,c,axis", SMALL + PHASE_6A)
@pytest.mark.parametrize("form", ["ek", "owner"])
@pytest.mark.parametrize("sms,aligned", [(132, True), (8, True), (132, False)])
def test_group_walk_equals_twin(b, r, c, axis, form, sms, aligned):
    """B13 on the walk against ``slim_finalize_batched_plain`` given the
    lines, bit for bit."""
    m, v, ek = _inputs(b, r, c, axis, seed=b * r + c + 1)
    bc1, bc2 = (torch.from_numpy(x) for x in _bc_lines(v, b + r + c))
    tm, tv = torch.from_numpy(m), torch.from_numpy(v)
    tek = torch.from_numpy(ek) if form == "ek" else None
    plan = plan_finalize(b, r, c, axis, sms, aligned=aligned)
    got = _emulate(plan, tm, tv, tek, bc1, bc2, b2=KW["b2"], eps=KW["eps"])
    twin = megaplan.mega_slim_finalize_batched(tm, tv, bc1, bc2, axis=axis, ek=tek, b2=KW["b2"], eps=KW["eps"])
    if form == "owner":
        got, twin = (got,), (twin,)
    for label, g, t in zip(("u", "v'"), got, twin):
        assert torch.equal(g, t), f"{label}: the walk is not the twin"


@pytest.mark.parametrize("b,r,c,axis", SMALL + PHASE_6A)
@pytest.mark.parametrize("form", ["ek", "owner"])
def test_group_walk_equals_jax(b, r, c, axis, form):
    """B13 on the walk against the Pallas ``mega_slim_finalize_batched`` in
    interpret mode, within 1e-5."""
    m, v, ek = _inputs(b, r, c, axis, seed=b * r + c + 2)
    bc1, bc2 = _bc_lines(v, b * c + r)
    tek = torch.from_numpy(ek) if form == "ek" else None
    plan = plan_finalize(b, r, c, axis, 132)
    got = _emulate(plan, torch.from_numpy(m), torch.from_numpy(v), tek, torch.from_numpy(bc1), torch.from_numpy(bc2),
                   b2=KW["b2"], eps=KW["eps"])
    want = jmega.mega_slim_finalize_batched(jnp.asarray(m), jnp.asarray(v), jnp.asarray(bc1), jnp.asarray(bc2),
                                            axis=axis, ek=jnp.asarray(ek) if form == "ek" else None, b2=KW["b2"],
                                            eps=KW["eps"], interpret=True)
    if form == "owner":
        got, want = (got,), (want,)
    for label, g, w in zip(("u", "v'"), got, want):
        assert_close(g.numpy(), np.asarray(w), TOL, label)


def test_group_walk_counts_the_lines_in_the_alignment(monkeypatch):
    """On axis 0 a float4 of line values is read from each line operand, so
    B13's bias-correction lines count in the alignment; on axis 1 only m'
    does."""
    monkeypatch.setattr(slim_update.build, "sm_count", lambda device: 132)
    m = torch.zeros(2, 8, 12)
    line = torch.zeros(2 * 12 + 1)[1:].view(2, 1, 12)
    assert slim_update.finalize_plan(m, 0, (torch.zeros(2, 1, 12), None)).vec == 4
    assert slim_update.finalize_plan(m, 0, (torch.zeros(2, 1, 12), None, line, line)).vec == 1
    assert slim_update.finalize_plan(m, 1, (torch.zeros(2, 8, 1), None, line, line)).vec == 4


# The long views of the psum pair on an H100: AdaLayer's 38,633,472-element
# embedding line, a (data=2, model=2) rank's 9,658,368-element shard of it,
# and ResNet-18's widest axis-0 group.
LONG_VIEWS = [(1, 1, 50304 * 768, 1), (1, 1, 25152 * 384, 1), (1, 4608, 1536, 0)]


@pytest.mark.parametrize("b,r,c,axis", LONG_VIEWS)
def test_long_views_fill_the_card_on_both_walks(b, r, c, axis):
    """B10's plan (SPLIT on the lines, MAJOR on the axis-0 view) and B13's
    flat walk both give an H100 at least 4 blocks an SM; the flat walk's
    blocks load every vector of the shard line once."""
    slim = megaplan.plan_slim(b, r, c, axis, sms=132, aligned=True)
    assert slim.form == (megaplan.FORM_SPLIT if axis == 1 else megaplan.FORM_MAJOR)
    assert slim.blocks >= FLAT_BLOCKS_PER_SM * 132
    flat = plan_finalize(b, r, c, axis, 132)
    assert (flat.vec, flat.blocks, flat.wide) == (4, FLAT_BLOCKS_PER_SM * 132, False)
    if c == 25152 * 384:
        assert (np.bincount(_walk(flat), minlength=flat.vectors) == 1).all()
