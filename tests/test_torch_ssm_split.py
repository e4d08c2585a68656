"""The selective-scan planner (``repro_torch.kernels.ssm_scan.plan_scan``),
which chooses B15's form and grid on the card, and the chunked walk of its
sequence form, checked here without a card.

The plan is pure integer arithmetic on the shapes and the SM count.
``_pieces`` below repeats the kernel's block arithmetic over each launch's
grid: the output walk (and the one-token form) must write every (row,
timestep, channel) exactly once, and the carry walk must cover chunks
0..K-2 of every (row, channel) once. ``_walk`` repeats the sequence form's
three launches in plain torch: each chunk walked from a zero state (chunk 0
from h0) to its end state and summed dt, the carries composed in chunk
order as exp2(a*log2e * sum dt) * carry + end state, and every chunk
replayed from its true carry-in, with the kernel's exp2 of dt * (a*log2e).
It is held to the plain twin (1e-6 relative: only the exponentials' form
and the chunk composition differ), and to the JAX package's Pallas kernel
in interpret mode and its chunked oracle ``repro.models.ssm.selective_scan``
(1e-5 relative, as the other line-sum parity tests), all fed the same numpy
inputs; bf16 operands reach JAX as the f32 values of their bf16 rounding.
The shapes put chunk boundaries that do not divide S (S = 17, 300, 2048),
and cover S = 1, N = 1, 3 and 16, B = 1 and 4, f32 and bf16.

The backward (``plan_scan_bwd``, ``csrc/ssm_scan_bwd.cu``) the same way:
the forward's output walk keeps the state at the start of every 16-step
tile (checked against the plain scan's state at every 16th step, and
written once per (row, tile, channel) whatever the chunks); the planner's
walk writes dx and ddt of every (row, timestep, channel) once within the
grid limits, reading no tensor, and sizes its workspaces and shared memory;
``_walk_bwd`` repeats the kernel in plain torch (the tiles in reverse, each
replayed once from its kept state with A_t kept for the reverse step, one
exponential an element, counted; the warp's butterfly that leaves each of
the 2*NP channel sums of a step on its own lane; the block's sum of its
warps' sums in warp order; the workspace layouts and the combine). It fills
every db/dc workspace slot once, replays the forward walk's final state bit
for bit, keeps padded states at exact 0, and is held to the plain twin
``ssm_scan_bwd_plain`` and to ``jax.grad`` through the JAX package's custom
VJP (1e-5 relative to each gradient's largest magnitude: the exponentials'
form and the order of the sums differ).
"""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close
from repro.kernels.ssm_scan import ssm_scan as jax_ssm_scan
from repro.models import ssm as jssm
from repro_torch.kernels import ssm_scan as sc
from repro_torch.kernels.ssm_scan import (BWD_CHANNELS, BWD_COMBINE_THREADS, BWD_TILE, BWD_WARPS_PER_SM, FORM_SEQ,
                                          FORM_TOKEN, LANES, SEQ_THREADS, TILE, TOKEN_THREADS, kept_states_shape,
                                          plan_scan, plan_scan_bwd)

H100_SMS = 132
MAX_GRID_X, MAX_GRID_YZ = 2**31 - 1, 65535
TWIN = 1e-6
LINE_SUMS = 1e-5
LOG2E = np.float32(1.4426950408889634)

# chip_smoke.py's phase 7 at full-width falcon_mamba_7b: the eval forward,
# a decode step, and the legacy loop's 4 x 64 prompt.
EVAL, DECODE, PROMPT = (1, 2048, 8192, 16), (4, 1, 8192, 16), (4, 64, 8192, 16)

# (b, s, d, n, chunk): chunk None is the planner's choice.
SHAPES = [
    (1, 17, 8, 3, TILE), (4, 17, 6, 1, None), (1, 17, 5, 16, 2 * TILE),
    (2, 300, 10, 16, None), (1, 300, 5, 3, 4 * TILE), (4, 300, 3, 1, 3 * TILE),
    (1, 2048, 8, 16, None), (1, 2048, 4, 1, 512), (2, 2048, 3, 3, 13 * TILE),
    (4, 1, 16, 16, None), (1, 1, 5, 3, None), (4, 1, 8, 1, None),
]


def _plan(b, s, d, n, chunk=None):
    """The planner's plan, or with its chunk length set to ``chunk`` (a
    multiple of TILE) to put chunk boundaries where a test wants them."""
    plan = plan_scan(b, s, d, n, sms=H100_SMS)
    if chunk is None or plan.form == FORM_TOKEN:
        return plan
    chunk = min(chunk, -(-s // TILE) * TILE)
    return dataclasses.replace(plan, chunk=chunk, chunks=-(-s // chunk))


def _pieces(plan):
    """{launch: [(row, channel range, step range), ...]} with the kernel's
    index arithmetic over each launch's grid."""
    out = {"walk": [], "output": []}
    if plan.form == FORM_TOKEN:
        per = TOKEN_THREADS // LANES
        gx, gy, _ = plan.out_grid
        for x in range(gx):
            for y in range(gy):
                out["output"].append((y, range(x * per, min(plan.dim, (x + 1) * per)), range(0, 1)))
        return out
    for launch, grid in (("walk", plan.walk_grid), ("output", plan.out_grid)):
        if grid is None:
            continue
        gx, gy, gz = grid
        for x in range(gx):
            for k in range(gy):
                for b in range(gz):
                    out[launch].append((b, range(x * SEQ_THREADS, min(plan.dim, (x + 1) * SEQ_THREADS)),
                                        range(*plan.steps(k))))
    return out


def _cover(pieces, b, s, d):
    count = np.zeros((b, s, d), np.int64)
    for row, chans, steps in pieces:
        assert len(chans) and len(steps), (row, chans, steps)
        count[row, steps.start:steps.stop, chans.start:chans.stop] += 1
    return count


PLAN_SHAPES = SHAPES + [
    EVAL + (None,), DECODE + (None,), PROMPT + (None,), (1, 2048, 512, 16, None), (2, 1000, 96, 16, None),
    (3, 999, 130, 7, None), (65535, 2, 1, 1, None), (1, 10**6, 1, 16, None), (1, 2048, 8192, 16, 128),
    (1, 2048, 8192, 16, 512), (1, 2048, 8192, 16, 2048)]


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_plan_covers_every_step_once_within_the_grid(shape):
    b, s, d, n, chunk = shape
    plan = _plan(b, s, d, n, chunk)
    assert plan.states == (4 if n <= 4 else 8 if n <= 8 else 16)
    for grid in (plan.walk_grid, plan.out_grid):
        if grid is not None:
            assert 0 < grid[0] <= MAX_GRID_X and 0 < grid[1] <= MAX_GRID_YZ and 0 < grid[2] <= MAX_GRID_YZ
    assert 0 <= plan.carry_blocks <= MAX_GRID_X
    if plan.form == FORM_SEQ:
        assert plan.chunk % TILE == 0 and plan.chunks == -(-s // plan.chunk)
        assert plan.steps(plan.chunks - 1)[0] < s          # no empty chunk
        assert plan.chunks <= sc.MAX_CHUNKS or chunk is not None
        assert (plan.walk_grid is None) == (plan.chunks == 1)
        assert (plan.carry_blocks == 0) == (plan.chunks <= 2)
    if b * s * d > 5 * 10**6:
        return                                             # the covering check below is O(b*s*d)
    pieces = _pieces(plan)
    assert (_cover(pieces["output"], b, s, d) == 1).all()
    if plan.walk_grid is not None:
        want = np.zeros((b, s, d), np.int64)
        want[:, :plan.steps(plan.chunks - 1)[0]] = 1        # chunks 0..K-2
        assert (_cover(pieces["walk"], b, s, d) == want).all()


def test_forms_at_the_main_path_shapes():
    ev, de, pr = _plan(*EVAL), _plan(*DECODE), _plan(*PROMPT)
    assert ev.form == FORM_SEQ and ev.chunks > 1
    # each launch of the eval forward's scan puts >= 3 blocks on every SM
    assert ev.tiles * (ev.chunks - 1) >= 3 * H100_SMS and ev.tiles * ev.chunks >= 3 * H100_SMS
    assert de.form == FORM_TOKEN and de.out_grid[0] * de.out_grid[1] * TOKEN_THREADS == 4 * 8192 * LANES
    assert pr.form == FORM_SEQ and pr.chunks == 1            # 4 rows x 64 tiles fill the card alone


def test_planner_reads_no_tensor():
    params = inspect.signature(plan_scan).parameters
    assert list(params) == ["b", "s", "d", "n", "sms"]
    code = plan_scan.__wrapped__.__code__
    assert "torch" not in code.co_names and "cuda" not in code.co_names
    assert _plan(*EVAL) is _plan(*EVAL)                      # cached: the wrapper plans every launch
    with pytest.raises(ValueError):
        _plan(1, 8, 4, 17)


def _inputs(b, s, d, n, dtype, seed):
    """Numpy operands (bf16 ones rounded through torch) and their torch
    twins; a[d, :] around the S4D-real init, dt a softplus."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, d)) - 1.0)).astype(np.float32)
    a = (-np.arange(1, n + 1, dtype=np.float32) * np.exp(0.1 * rng.standard_normal((d, n)))).astype(np.float32)
    b_t = rng.standard_normal((b, s, n)).astype(np.float32)
    c_t = rng.standard_normal((b, s, n)).astype(np.float32)
    d_skip = rng.standard_normal((d,)).astype(np.float32)
    h0 = rng.standard_normal((b, d, n)).astype(np.float32)
    ts = [torch.from_numpy(v) for v in (x, dt, a, b_t, c_t, d_skip, h0)]
    for i in (0, 3, 4):
        ts[i] = ts[i].to(dtype)
    arrays = [t.float().numpy() for t in ts]
    return arrays, ts


def _chunk(h, a2, xf, dtf, bf, cf, dsk, t0, t1, y=None, keep=None):
    """Steps [t0, t1) from state h in the kernel's arithmetic; writes y
    when given, and into ``keep`` {tile: state} the state at the start of
    every TILE-step tile. Returns (end state, the chunk's sum of dt, summed
    in order)."""
    sdt = torch.zeros_like(dtf[:, 0])
    for t in range(t0, t1):
        if keep is not None and t % TILE == 0:
            keep[t // TILE] = keep.get(t // TILE, []) + [h]
        h = torch.exp2(dtf[:, t, :, None] * a2) * h + (dtf[:, t] * xf[:, t])[:, :, None] * bf[:, t, None, :]
        sdt = sdt + dtf[:, t]
        if y is not None:
            y[:, t] = (h * cf[:, t, None, :]).sum(-1) + dsk * xf[:, t]
    return h, sdt


def _walk(plan, x, dt, a, b_t, c_t, d_skip, h0, keep=None):
    """B15's forms in plain torch (f32): the one-token step, or the carry
    walk, the carry composition and the output walk. ``keep``, a dict,
    receives {tile: [states]}: what the output walk's KEEP form stores at
    the start of each TILE-step tile (a list, to count the stores)."""
    xf, dtf, bf, cf = x.float(), dt.float(), b_t.float(), c_t.float()
    a2 = a.float() * float(LOG2E)
    y = torch.zeros(xf.shape)
    if plan.form == FORM_TOKEN:
        h, _ = _chunk(h0.clone(), a2, xf, dtf, bf, cf, d_skip, 0, 1, y, keep=keep)
        return y, h
    slots, sums = [], []
    for k in range(plan.chunks - 1):                     # launch 1
        start = h0.clone() if k == 0 else torch.zeros_like(h0)
        h, sdt = _chunk(start, a2, xf, dtf, bf, cf, d_skip, *plan.steps(k))
        slots.append(h)
        sums.append(sdt)
    for j in range(1, plan.chunks - 1):                  # launch 2
        slots[j] = torch.exp2(a2 * sums[j][:, :, None]) * slots[j - 1] + slots[j]
    h_final = None
    for k in range(plan.chunks):                         # launch 3
        start = h0.clone() if k == 0 else slots[k - 1]
        h_final, _ = _chunk(start, a2, xf, dtf, bf, cf, d_skip, *plan.steps(k), y=y, keep=keep)
    return y, h_final


DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_chunked_walk_matches_plain_twin(shape, dtype):
    b, s, d, n, chunk = shape
    _, ts = _inputs(b, s, d, n, dtype, seed=b * s + d + n)
    plan = _plan(b, s, d, n, chunk)
    y, h = _walk(plan, *ts)
    y_w, h_w = sc.ssm_scan_plain(*ts)
    assert_close(y.numpy(), y_w.numpy(), TWIN, f"y {plan}")
    assert_close(h.numpy(), h_w.numpy(), TWIN, f"h {plan}")


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_chunked_walk_matches_tpu_kernel_and_oracle(shape, dtype):
    b, s, d, n, chunk = shape
    arrays, ts = _inputs(b, s, d, n, dtype, seed=b * s + d + n)
    plan = _plan(b, s, d, n, chunk)
    y, h = _walk(plan, *ts)
    y_k, h_k = jax_ssm_scan(*map(jnp.asarray, arrays), interpret=True)
    assert_close(y.numpy(), np.asarray(y_k), LINE_SUMS, f"y vs Pallas {plan}")
    assert_close(h.numpy(), np.asarray(h_k), LINE_SUMS, f"h vs Pallas {plan}")
    y_o, h_o = jssm.selective_scan(*map(jnp.asarray, arrays), 64)
    assert_close(y.numpy(), np.asarray(y_o), LINE_SUMS, f"y vs selective_scan {plan}")
    assert_close(h.numpy(), np.asarray(h_o), LINE_SUMS, f"h vs selective_scan {plan}")


def test_padded_states_stay_zero():
    """States past N (a = 0, B = C = 0 in the kernel's padding) keep h = 0
    exactly and add nothing to y: the N = 3 walk equals its N = 4 padding
    (y to 1e-7: torch's sum over 4 states may add in another order)."""
    _, ts = _inputs(2, 40, 6, 3, torch.float32, seed=3)
    x, dt, a, b_t, c_t, d_skip, h0 = ts
    pad = [x, dt, torch.cat([a, torch.zeros(6, 1)], 1), torch.cat([b_t, torch.zeros(2, 40, 1)], 2),
           torch.cat([c_t, torch.zeros(2, 40, 1)], 2), d_skip, torch.cat([h0, torch.zeros(2, 6, 1)], 2)]
    plan = _plan(2, 40, 6, 3, TILE)
    y, h = _walk(plan, *ts)
    y4, h4 = _walk(_plan(2, 40, 6, 4, TILE), *pad)
    assert torch.equal(h, h4[..., :3]) and not h4[..., 3].any()
    assert_close(y4.numpy(), y.numpy(), 1e-7, "y")


# -- the backward ---------------------------------------------------------------

# The training shape of chip_smoke.py's SSM phase (B = 2 rows of 2048 tokens,
# full-width falcon_mamba_7b).
TRAIN = (2, 2048, 8192, 16)
BWD_SHAPES = SHAPES + [(2, 300, 70, 16, 4 * TILE), (1, 33, 65, 5, TILE), (3, 40, 33, 8, None)]


def _kept_states(keep, b, s, d, n):
    """The KEEP output walk's stores ({tile: [states]}) as the kernel's
    (B, tiles, D, NP) buffer; each tile must have been stored once."""
    out = torch.zeros(kept_states_shape(b, s, d, n))
    assert sorted(keep) == list(range(out.shape[1]))
    for i, hs in keep.items():
        assert len(hs) == 1, i
        out[:, i, :, :n] = hs[0]
    return out


@pytest.mark.parametrize("shape", PLAN_SHAPES + [TRAIN + (None,), TRAIN[:2] + (96, 16, 2048)], ids=str)
def test_bwd_plan_covers_every_step_once_within_the_grid(shape):
    b, s, d, n, chunk = shape
    fwd = sc.keep_form(_plan(b, s, d, n, chunk))
    plan = plan_scan_bwd(b, s, d, n)
    assert fwd.form == FORM_SEQ and fwd.chunk % TILE == 0
    assert plan.states == fwd.states and plan.lanes * plan.channels == 32 and plan.lanes == plan.states // 4
    assert plan.warps * plan.channels == BWD_CHANNELS and plan.threads == 32 * plan.warps
    assert plan.blocks * BWD_CHANNELS >= d > (plan.blocks - 1) * BWD_CHANNELS
    gx, gy = plan.walk_grid
    assert 0 < gx <= MAX_GRID_X and 0 < gy <= MAX_GRID_YZ and 0 < plan.combine_blocks <= MAX_GRID_X
    assert plan.combine_blocks * BWD_COMBINE_THREADS >= b * s * 2 * n + d * n + d
    steps = [plan.steps(i) for i in range(plan.tiles)]
    assert steps[0][0] == 0 and steps[-1][1] == s and all(t0 < t1 for t0, t1 in steps)
    assert all(steps[i][1] == steps[i + 1][0] for i in range(plan.tiles - 1))
    assert plan.tiles == kept_states_shape(b, s, d, n)[1] == -(-s // BWD_TILE)
    ws = plan.workspace_shapes()
    assert ws == {"ws_bc": (b, s, plan.blocks, 2 * plan.states), "ws_a": (b, d, n), "ws_d": (b, d)}
    # the forward's KEEP output walk stores every tile once, whatever its chunks
    kept = [t // TILE for k in range(fwd.chunks) for t in range(*fwd.steps(k)) if t % TILE == 0]
    assert kept == list(range(plan.tiles))
    if b * s * d > 5 * 10**6:
        return
    # the walk's pieces: block (x, row) over its channels, every tile's steps
    pieces = [(row, range(x * BWD_CHANNELS, min(d, (x + 1) * BWD_CHANNELS)), range(*plan.steps(i)))
              for x in range(gx) for row in range(gy) for i in range(plan.tiles)]
    assert (_cover(pieces, b, s, d) == 1).all()


def test_bwd_plan_at_the_training_shape():
    fwd, plan = _plan(*TRAIN), plan_scan_bwd(*TRAIN)
    assert fwd.form == FORM_SEQ and (fwd.chunks, fwd.chunk) == (4, 512)
    assert plan.walk_grid == (256, 2) and plan.tiles == 128                # 32 channels a block
    assert (plan.warps, plan.channels, plan.lanes) == (4, 8, 4)            # 4 warps of 8 channels x 4 lanes
    assert plan.blocks_per_sm == BWD_WARPS_PER_SM // 4 == 4                # 528 blocks a wave: 512 take one
    one = plan_scan_bwd(1, 2048, 8192, 16)
    assert one.walk_grid == (256, 1) and one.tiles == 128


def test_bwd_workspace_bytes_at_the_training_shape():
    """The forward's kept tile states, 134,217,728 B; the db/dc partials,
    one per block of 32 channels, 134,217,728 B (one-warp blocks wrote
    536,870,912); the walk's shared memory within an SM at its launch
    bound's blocks."""
    plan = plan_scan_bwd(*TRAIN)

    def nbytes(shape):
        return 4 * int(np.prod(shape))

    assert nbytes(kept_states_shape(*TRAIN)) == 134_217_728
    assert nbytes(plan.workspace_shapes()["ws_bc"]) == 134_217_728 <= 135_000_000
    assert nbytes(plan.workspace_shapes()["ws_bc"]) * plan.warps == 536_870_912
    assert (plan.shared_bytes(2), plan.shared_bytes(4)) == (56_320, 57_344)   # bf16, f32 operands
    for itemsize in (2, 4):
        assert plan.shared_bytes(itemsize) <= 232_448                          # a block's most
        assert plan.blocks_per_sm * (plan.shared_bytes(itemsize) + 1024) <= 233_472   # an SM's 228 KB


def test_bwd_planner_reads_no_tensor():
    params = inspect.signature(plan_scan_bwd).parameters
    assert list(params) == ["b", "s", "d", "n"]
    code = plan_scan_bwd.__wrapped__.__code__
    assert "torch" not in code.co_names and "cuda" not in code.co_names
    assert plan_scan_bwd(*TRAIN) is plan_scan_bwd(*TRAIN)
    for bad in ((1, 8, 4, 17), (0, 8, 4, 4), (1, 0, 4, 4)):
        with pytest.raises(ValueError):
            plan_scan_bwd(*bad)


@pytest.mark.parametrize("shape", [sh for sh in SHAPES if sh[1] <= 300], ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_kept_states_match_the_plain_scan_every_16_steps(shape, dtype):
    """The KEEP output walk's state at the start of tile i equals the plain
    scan's state after 16 i steps (TWIN: the chunked walk's exponentials
    and composition differ); padded states stay 0."""
    b, s, d, n, chunk = shape
    _, ts = _inputs(b, s, d, n, dtype, seed=b * s + d + n)
    keep = {}
    _walk(sc.keep_form(_plan(b, s, d, n, chunk)), *ts, keep=keep)
    states = _kept_states(keep, b, s, d, n)
    x, dt, a, b_t, c_t, d_skip, h0 = ts
    for i in range(states.shape[1]):
        t = i * TILE
        want = h0 if t == 0 else sc.ssm_scan_plain(x[:, :t], dt[:, :t], a, b_t[:, :t], c_t[:, :t], d_skip, h0)[1]
        assert_close(states[:, i, :, :n].numpy(), want.numpy(), TWIN, f"tile {i}")
    assert not states[..., n:].any()


def _channel_sum(vals, lanes):
    """The walk's warp butterfly on (..., 32 lanes, 8 values), lane = channel
    * ``lanes`` + q: three reduce-scatter levels over lane bits 4, 3, 2, then
    xor levels over the channel bits below 2. Returns what each lane holds:
    the sum over the warp's channels of its value lane >> 2 (of the states
    4q ..)."""
    lane = torch.arange(32)
    v = vals
    for h in (4, 2, 1):
        off = 4 * h
        up = ((lane & off) != 0)[:, None]
        send = torch.where(up, v[..., :h], v[..., h:2 * h])
        keep = torch.where(up, v[..., h:2 * h], v[..., :h])
        v = keep + send[..., lane ^ off, :]
    r, off = v[..., 0], 2
    while off >= lanes:
        r = r + r[..., lane ^ off]
        off //= 2
    return r


def _slots(lanes, np_):
    """(writer lanes, their db/dc workspace slots), as the walk stores them."""
    lane = torch.arange(32)
    writers = lane[(lane & 3) < lanes]
    v, q = writers >> 2, writers % lanes
    return writers, torch.where(v >= 4, np_, 0) + 4 * q + (v & 3)


@pytest.mark.parametrize("lanes", [1, 2, 4])
def test_channel_sum_leaves_each_sum_on_its_lane(lanes):
    np_ = 4 * lanes
    vals = torch.from_numpy(np.random.default_rng(lanes).standard_normal((3, 32 // lanes, lanes, 8)))
    r = _channel_sum(vals.reshape(3, 32, 8), lanes)
    per_q = vals.sum(1)                                               # (3, lanes, 8): summed over channels
    want = torch.cat([per_q[..., :4].reshape(3, -1), per_q[..., 4:].reshape(3, -1)], -1)   # (3, 2 * NP) slots
    writers, slots = _slots(lanes, np_)
    assert sorted(slots.tolist()) == list(range(2 * np_))             # every slot written once
    torch.testing.assert_close(r[:, writers], want[:, slots], rtol=1e-12, atol=1e-12)


def _walk_bwd(plan, x, dt, a, b_t, c_t, d_skip, dy, dh_final, states):
    """csrc/ssm_scan_bwd.cu in plain torch (f32): channels padded to whole
    blocks, states to NP and steps to whole tiles, a lane's 4 states in a
    (channel, lane, 4) view as the kernel's lanes hold them. Each tile is
    replayed once from ``states`` (the forward's kept tile states), keeping
    A_t for the reverse step. Returns (dx, ddt, da, db, dc, dd, dh0), the
    replayed final state, how often each db/dc workspace slot was written,
    the exponentials evaluated, and the padded states' values."""
    b, s, d, n, np_ = plan.batch, plan.seq, plan.dim, plan.n, plan.states
    lanes, warps, dp, sp = plan.lanes, plan.warps, plan.blocks * BWD_CHANNELS, plan.tiles * BWD_TILE

    def pad(t, shape):
        out = torch.zeros(shape)
        out[tuple(slice(0, k) for k in t.shape)] = t.float()
        return out

    xf, dtf, dyf = (pad(t, (b, sp, dp)) for t in (x, dt, dy))
    af, bf, cf = pad(a, (dp, np_)), pad(b_t, (b, sp, np_)), pad(c_t, (b, sp, np_))
    dsk = pad(d_skip, (dp,))
    carry = pad(dh_final, (b, dp, np_)) if dh_final is not None else torch.zeros(b, dp, np_)
    kept = pad(states, (b, plan.tiles, dp, np_))
    ws_bc = torch.full(plan.workspace_shapes()["ws_bc"], float("nan"))
    written = torch.zeros(ws_bc.shape, dtype=torch.int64)
    dx, ddt = torch.full((b, s, d), float("nan")), torch.full((b, s, d), float("nan"))
    da_rows, dd_rows = torch.zeros(b, dp, np_), torch.zeros(b, dp)
    writers, slots = _slots(lanes, np_)
    a2u = a.float() * float(LOG2E)
    xu, dtu, bu = x.float(), dt.float(), b_t.float()
    exps = [0]

    def step(h, t):
        """B15's step on the live channels and states (the same tensor
        shapes as ``_chunk``'s, so torch rounds alike) and its A_t; padding
        and padded steps have A = 1 (exp2 of 0) and leave h unchanged."""
        e = torch.ones(b, dp, np_)
        out = h.clone()
        exps[0] += e.numel()                                          # the kernel's ex2, one an element
        if t < s:
            e[:, :d, :n] = torch.exp2(dtu[:, t, :, None] * a2u)
            out[:, :d, :n] = e[:, :d, :n] * h[:, :d, :n] + (dtu[:, t] * xu[:, t])[:, :, None] * bu[:, t, None, :]
        return out, e

    h_last = None
    for i in reversed(range(plan.tiles)):
        tt = i * BWD_TILE
        hs, es = [kept[:, i]], []                                     # the states before each step, A_t
        for t in range(tt, tt + BWD_TILE):                            # the replay: all 16 steps
            h, e = step(hs[-1], t)
            hs.append(h)
            es.append(e)
        if i == plan.tiles - 1:
            h_last = hs[-1][:, :d, :n]
        for t in reversed(range(tt, tt + BWD_TILE)):                  # the reverse walk: no exponential
            j = t - tt
            dh = dyf[:, t, :, None] * cf[:, t, None, :] + carry
            dl = dh * hs[j] * es[j]
            gx, ga = (dh * bf[:, t, None, :]).sum(-1), (dl * af).sum(-1)
            da_rows += dl * dtf[:, t, :, None]
            shape = (b, plan.blocks, warps, plan.channels, lanes, 4)
            db_v = (dh * (dtf[:, t] * xf[:, t])[..., None]).reshape(shape)
            dc_v = (hs[j + 1] * dyf[:, t, :, None]).reshape(shape)
            vals = torch.cat([db_v, dc_v], -1).reshape(b, plan.blocks, warps, 32, 8)   # lane = channel * lanes + q
            r = _channel_sum(vals, lanes)[..., writers]               # (b, blocks, warps, 2 * NP): a warp's sums
            acc = torch.zeros(b, plan.blocks, len(writers))
            for w in range(warps):                                    # the block's sum, in warp order
                acc = acc + r[:, :, w]
            if t < s:
                ws_bc[:, t, :, slots] = acc
                written[:, t, :, slots] += 1
                ddt[:, t] = (gx * xf[:, t] + ga)[:, :d]
                dx[:, t] = (gx * dtf[:, t] + dsk * dyf[:, t])[:, :d]
            dd_rows += dyf[:, t] * xf[:, t]
            carry = es[j] * dh
    db, dc = ws_bc[..., :n].sum(2), ws_bc[..., np_:np_ + n].sum(2)
    grads = (dx, ddt, da_rows[:, :d, :n].sum(0), db, dc, dd_rows[:, :d].sum(0), carry[:, :d, :n])
    padded = (carry[:, :, n:], da_rows[:, :, n:], ws_bc[..., n:np_], ws_bc[..., np_ + n:])
    return grads, h_last, written, exps[0], padded


def _bwd_inputs(b, s, d, n, dtype, seed, dh_random=True):
    arrays, ts = _inputs(b, s, d, n, dtype, seed)
    rng = np.random.default_rng(seed + 1)
    dy = torch.from_numpy(rng.standard_normal((b, s, d)).astype(np.float32)).to(dtype)
    dhf = torch.from_numpy(rng.standard_normal((b, d, n)).astype(np.float32)) if dh_random else None
    return arrays, ts, dy, dhf


def _run_bwd(shape, dtype, dh_random=True):
    b, s, d, n, chunk = shape
    arrays, ts, dy, dhf = _bwd_inputs(b, s, d, n, dtype, b * s + d + n, dh_random)
    keep = {}
    _, h_fwd = _walk(sc.keep_form(_plan(b, s, d, n, chunk)), *ts, keep=keep)
    plan = plan_scan_bwd(b, s, d, n)
    return arrays, ts, dy, dhf, plan, h_fwd, _walk_bwd(plan, *ts[:6], dy, dhf, _kept_states(keep, b, s, d, n))


NAMES = ("dx", "ddt", "da", "db", "dc", "dd_skip", "dh0")


@pytest.mark.parametrize("shape", BWD_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_bwd_walk_matches_plain_twin_and_replays_the_forward(shape, dtype):
    _, ts, dy, dhf, plan, h_fwd, (grads, h_last, written, exps, padded) = _run_bwd(shape, dtype, shape[0] != 4)
    assert torch.equal(h_last, h_fwd)                 # the replay is the forward walk's, bit for bit
    assert (written == 1).all() and written.shape == (plan.batch, plan.seq, plan.blocks, 2 * plan.states)
    # one exponential an element: the replay's, for every lane's 4 states of every step of every tile
    assert exps == plan.batch * plan.tiles * BWD_TILE * plan.blocks * BWD_CHANNELS * plan.states
    for t in padded:                                  # states past N: exact zeros, never written
        assert not t.any()
    want = sc.ssm_scan_bwd_plain(*ts, dy, dhf)
    for name, got, w in zip(NAMES, grads, want):
        assert got.shape == w.shape, name
        assert_close(got.numpy(), w.numpy(), LINE_SUMS, f"{name} {plan}")


@pytest.mark.parametrize("shape", [BWD_SHAPES[i] for i in (0, 2, 3, 7, 9, 12, 13)], ids=str)
def test_bwd_walk_matches_jax_custom_vjp(shape):
    arrays, ts, dy, dhf, plan, _, (grads, _, _, _, _) = _run_bwd(shape, torch.float32)

    def loss(*args):
        y, h = jssm.selective_scan(*args, 64)
        return jnp.sum(y * dy.numpy()) + jnp.sum(h * dhf.numpy())

    want = jax.grad(loss, argnums=tuple(range(7)))(*map(jnp.asarray, arrays))
    for name, got, w in zip(NAMES, grads, want):
        assert_close(got.numpy(), np.asarray(w), LINE_SUMS, f"{name} vs jax.grad {plan}")
