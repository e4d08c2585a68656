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
"""
import dataclasses
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close
from repro.kernels.ssm_scan import ssm_scan as jax_ssm_scan
from repro.models import ssm as jssm
from repro_torch.kernels import ssm_scan as sc
from repro_torch.kernels.ssm_scan import (FORM_SEQ, FORM_TOKEN, LANES, SEQ_THREADS, TILE, TOKEN_THREADS,
                                          plan_scan)

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


def _chunk(h, a2, xf, dtf, bf, cf, dsk, t0, t1, y=None):
    """Steps [t0, t1) from state h in the kernel's arithmetic; writes y
    when given. Returns (end state, the chunk's sum of dt, summed in order)."""
    sdt = torch.zeros_like(dtf[:, 0])
    for t in range(t0, t1):
        h = torch.exp2(dtf[:, t, :, None] * a2) * h + (dtf[:, t] * xf[:, t])[:, :, None] * bf[:, t, None, :]
        sdt = sdt + dtf[:, t]
        if y is not None:
            y[:, t] = (h * cf[:, t, None, :]).sum(-1) + dsk * xf[:, t]
    return h, sdt


def _walk(plan, x, dt, a, b_t, c_t, d_skip, h0):
    """B15's forms in plain torch (f32): the one-token step, or the carry
    walk, the carry composition and the output walk."""
    xf, dtf, bf, cf = x.float(), dt.float(), b_t.float(), c_t.float()
    a2 = a.float() * float(LOG2E)
    y = torch.zeros(xf.shape)
    if plan.form == FORM_TOKEN:
        h, _ = _chunk(h0.clone(), a2, xf, dtf, bf, cf, d_skip, 0, 1, y)
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
        h_final, _ = _chunk(start, a2, xf, dtf, bf, cf, d_skip, *plan.steps(k), y=y)
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
