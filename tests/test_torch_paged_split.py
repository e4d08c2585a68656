"""The paged-attention planner (``repro_torch.kernels.paged_attention.
plan_paged``), which chooses the grid of B14 on the card, and the split walk
with its combine, checked here without a card.

The plan is pure integer arithmetic on shapes and the SM count. ``_walk``
below repeats the kernel's walk in plain torch on the CPU: the plan's query
tiles and pieces of whole pages, each live piece's partial ``(acc, m, l)``
over its keys (pieces that start past a tile's live keys are skipped, as
their blocks exit at once), and the merge of the partials in piece order by
the rescaled online-softmax rule. On the geometries of the card tests
(``tests/test_torch_cuda.py``'s ``_paged_case``) and on the main path's
full-width smollm_135m shapes (9 query heads over 3 KV groups, hd 64, pages
of 16, 128-page table rows: 16 ragged decode rows and the 128-token prefill
chunks at pos0 = 0 and 1024), and on the dense zoo's hd-128 card geometries
(40 KV groups of one query head; 8 groups of 8), the result is held to the plain twin (1e-6
relative, f32: only the order of the softmax sums differs) and to the JAX
package's Pallas kernel in interpret mode (1e-5 relative, as the other
line-sum parity tests). The file also checks that the pieces cover every
live key of every query row exactly once, that the grid stays within
CUDA's limits, that a piece with no live key for a row adds nothing, that
inactive rows come out exactly 0, and that the planner takes no
``lengths`` (so the wrapper needs no host sync).
"""
import inspect
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close
from repro.kernels.paged_attention import paged_attention as jax_paged
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels.paged_attention import FORM_CORES, FORM_MMA, MMA_ROWS, ROW_TILES, THREADS, plan_paged

H100_SMS = 132
MAX_GRID_X = 2**31 - 1
TWIN = 1e-6
LINE_SUMS = 1e-5
NEG = -1e30


def _cdiv(a, b):
    return -(-a // b)


def _tables(positions, page, max_pages):
    """Distinct pages for each row's ``positions`` (null page 0 past them),
    and the pool size they need."""
    table = np.zeros((len(positions), max_pages), np.int32)
    first = 1
    for i, n in enumerate(_cdiv(int(x), page) for x in positions):
        n = min(n, max_pages)
        table[i, :n] = np.arange(first, first + n)
        first += n
    return table, first


def _card_case(*, c, kv, rep, hd, page, b=5, max_pages=6, seed=0):
    """``tests/test_torch_cuda.py``'s ``_paged_case`` geometry, from numpy:
    decode rows (full, one position into page 2, inactive, mid-page, one
    position), chunk rows (full, from 0, at pos0 = 2 pages, a padded
    length past the row's pages, past the table's reach); row 2's table is
    padded with the null page from page 3."""
    rng = np.random.default_rng(seed)
    pool = rng.standard_normal((b * max_pages + 1, page, 2 * kv, hd)).astype(np.float32)
    table = (1 + np.arange(b * max_pages, dtype=np.int32)).reshape(b, max_pages)
    table[2, 3:] = 0
    reach = max_pages * page
    lengths = ([reach, page + 1, 0, 3 * page - 2, 1] if c == 1
               else [reach, c, 2 * page + c, 3 * page + c, reach + c - 1])
    q = rng.standard_normal((b, c, kv * rep, hd)).astype(np.float32)
    return q, pool, table, np.asarray(lengths, np.int32)


# chip_smoke.py's phase 4: full-width smollm_135m attention, pages of 16, 128-page rows.
_DEC = np.random.default_rng(0).integers(1, 2049, 16)
_DEC[0], _DEC[1] = 0, 16 * 37 + 5
PHASE4 = {"decode": (1, _DEC, _DEC), "prefill_pos0_0": (128, [128], [128]),
          "prefill_pos0_1024": (128, [1024 + 128], [1024 + 100])}


def _phase4_case(name, seed=0):
    c, lengths, alloc = PHASE4[name]
    rng = np.random.default_rng(seed)
    table, n_pages = _tables(alloc, 16, 128)
    pool = rng.standard_normal((n_pages, 16, 6, 64)).astype(np.float32)
    q = rng.standard_normal((len(lengths), c, 9, 64)).astype(np.float32)
    return q, pool, table, np.asarray(lengths, np.int32)


CARD_GEOMS = [dict(hd=hd, kv=kv, rep=rep, c=c, page=page)
              for hd, kv, rep in [(64, 3, 3), (16, 1, 3), (32, 3, 1), (128, 2, 4), (64, 1, 32)]
              for c in (1, 11, 128) for page in (4, 16, 64)]


# qwen15_32b (40 KV groups, one query head each) and command_r_35b / deepseek_67b (8 groups of 8)
ZOO_GEOMS = [(40, 1), (8, 8)]


def _plan(q, pool, table, *, q_dtype=torch.float32, pool_dtype=torch.float32, sms=H100_SMS):
    b, c, h, hd = q.shape
    kv = pool.shape[2] // 2
    return plan_paged(b, c, kv, h // kv, hd, pool.shape[1], table.shape[1], q_dtype, pool_dtype, sms=sms)


def _tile_keys(plan, c, length, page, max_pages, t):
    """Query tile t's (first token, tokens, first query position, live-key end)."""
    c0 = t * plan.tokens
    n_tok = min(plan.tokens, c - c0)
    q_first = int(length) - c + c0
    return c0, n_tok, q_first, max(0, min(q_first + n_tok, max_pages * page))


def _pieces(plan, page, kend):
    """The live pieces' key ranges [k0, k1), in piece order."""
    span = plan.pages * page
    return [(k * span, min(kend, (k + 1) * span)) for k in range(min(plan.pieces, _cdiv(kend, span)))]


def _partial(qrows, q_abs, k, v, keys):
    """One piece's (acc, m, l) for query rows ``qrows`` (pre-scaled) at
    positions ``q_abs`` over the keys at positions ``keys``."""
    s = qrows @ k.T
    mask = keys[None, :] <= q_abs[:, None]
    s = torch.where(mask, s, -math.inf)
    m = torch.clamp(s.amax(dim=1), min=NEG)
    p = torch.where(mask, torch.exp(s - m[:, None]), 0.0)
    return p @ v, m, p.sum(dim=1)


def _merge(parts):
    """Rescaled online-softmax merge of (acc, m, l) partials, in order."""
    m = torch.full_like(parts[0][1], NEG) if parts else None
    for _, mk, _ in parts:
        m = torch.maximum(m, mk)
    acc, l = torch.zeros_like(parts[0][0]), torch.zeros_like(parts[0][2])
    for ak, mk, lk in parts:
        w = torch.exp(mk - m)
        l = l + lk * w
        acc = acc + ak * w[:, None]
    return acc, l


def _walk(q, pool, table, lengths, plan, *, record=None):
    """The kernel's split walk and combine in plain torch (f32). ``record``
    collects (b, tile, g, piece, k0, k1, partial) for the checks below."""
    q, pool = torch.as_tensor(q).float(), torch.as_tensor(pool).float()
    b, c, h, hd = q.shape
    page, kv = pool.shape[1], pool.shape[2] // 2
    rep, max_pages, n_pages = h // kv, table.shape[1], pool.shape[0]
    scale = np.float32(1.0) / np.float32(math.sqrt(hd))
    out = torch.zeros_like(q)
    for bi in range(b):
        for t in range(plan.qtiles):
            c0, n_tok, q_first, kend = _tile_keys(plan, c, lengths[bi], page, max_pages, t)
            pieces = _pieces(plan, page, kend)
            if not pieces:
                continue                    # the tile's rows stay exactly 0
            q_abs = torch.tensor([q_first + r // rep for r in range(n_tok * rep)])
            for g in range(kv):
                qrows = q[bi, c0:c0 + n_tok, g * rep:(g + 1) * rep].reshape(-1, hd) * float(scale)
                parts = []
                for piece, (k0, k1) in enumerate(pieces):
                    keys = torch.arange(k0, k1)
                    ids = torch.as_tensor(table[bi, (keys // page).numpy()]).long()
                    ids = torch.where((ids < 0) | (ids >= n_pages), 0, ids)
                    rows = pool[ids, keys % page]
                    part = _partial(qrows, q_abs, rows[:, 2 * g], rows[:, 2 * g + 1], keys)
                    parts.append(part)
                    if record is not None:
                        record.append((bi, t, g, piece, k0, k1, part))
                acc, l = _merge(parts)
                res = acc / torch.clamp(l, min=1e-30)[:, None]
                out[bi, c0:c0 + n_tok, g * rep:(g + 1) * rep] = res.reshape(n_tok, rep, hd)
    return out


def _all_cases():
    for geom in CARD_GEOMS:
        yield f"card-hd{geom['hd']}-kv{geom['kv']}-rep{geom['rep']}-c{geom['c']}-p{geom['page']}", _card_case(**geom)
    for name in PHASE4:
        yield f"phase4-{name}", _phase4_case(name)
    for kv, rep in ZOO_GEOMS:     # the dense zoo's card tests: hd 128, pages of 16, 12-page rows
        for c in (1, 128):
            yield f"zoo-kv{kv}-rep{rep}-c{c}", _card_case(c=c, kv=kv, rep=rep, hd=128, page=16, max_pages=12)


CASES = dict(_all_cases())


@pytest.mark.parametrize("case", list(CASES))
def test_split_walk_matches_plain_twin(case):
    q, pool, table, lengths = CASES[case]
    for q_dtype, pool_dtype in ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16)):
        plan = _plan(q, pool, table, q_dtype=q_dtype, pool_dtype=pool_dtype)
        got = _walk(q, pool, table, lengths, plan)
        want = pa.paged_attention_plain(*map(torch.as_tensor, (q, pool, table, lengths)))
        assert_close(got.numpy(), want.numpy(), TWIN, f"{case} {plan}")


@pytest.mark.parametrize("case", list(CASES))
def test_split_walk_matches_tpu_kernel(case):
    q, pool, table, lengths = CASES[case]
    got = _walk(q, pool, table, lengths, _plan(q, pool, table))
    want = jax_paged(*map(jnp.asarray, (q, pool, table, lengths)), interpret=True)
    assert_close(got.numpy(), np.asarray(want), LINE_SUMS, case)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("sms", [H100_SMS, 8])
def test_pieces_cover_every_live_key_once(case, sms):
    """Every (token, head) of every row lies in exactly one query tile, and
    each of its live keys (k <= its position, within the table's reach) in
    exactly one live piece of that tile; pieces are whole pages."""
    q, pool, table, lengths = CASES[case]
    b, c, h, hd = q.shape
    page, kv, max_pages = pool.shape[1], pool.shape[2] // 2, table.shape[1]
    for q_dtype in (torch.float32, torch.bfloat16):
        plan = _plan(q, pool, table, q_dtype=q_dtype, pool_dtype=q_dtype, sms=sms)
        assert (plan.pieces - 1) * plan.pages < max_pages <= plan.pieces * plan.pages
        assert plan.qtiles == _cdiv(c, plan.tokens) and plan.tokens * (h // kv) <= plan.rows
        for bi in range(b):
            seen = np.zeros((c, max_pages * page), np.int64)
            for t in range(plan.qtiles):
                c0, n_tok, q_first, kend = _tile_keys(plan, c, lengths[bi], page, max_pages, t)
                for k0, k1 in _pieces(plan, page, kend):
                    assert k0 % page == 0 and k0 < k1
                    for tok in range(c0, c0 + n_tok):
                        lim = min(q_first + tok - c0 + 1, k1)
                        seen[tok, k0:max(k0, lim)] += 1
            for tok in range(c):
                live = max(0, min(int(lengths[bi]) - c + tok + 1, max_pages * page))
                assert (seen[tok, :live] == 1).all() and not seen[tok, live:].any(), (bi, tok)


@pytest.mark.parametrize("case", list(CASES))
def test_grid_within_cuda_limits(case):
    q, pool, table, _ = CASES[case]
    b, c, h, hd = q.shape
    kv = pool.shape[2] // 2
    for q_dtype, pool_dtype in ((torch.float32, torch.float32), (torch.float32, torch.bfloat16),
                                (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)):
        plan = _plan(q, pool, table, q_dtype=q_dtype, pool_dtype=pool_dtype)
        assert plan.form == (FORM_MMA if q_dtype == pool_dtype == torch.bfloat16 and c > 1 else FORM_CORES)
        assert plan.rows == MMA_ROWS if plan.form == FORM_MMA else plan.rows in ROW_TILES
        assert 1 <= plan.blocks <= MAX_GRID_X and plan.blocks == b * kv * plan.qtiles * plan.pieces
        assert plan.combine_blocks <= MAX_GRID_X
        assert plan.combine_blocks == (0 if plan.pieces == 1 else _cdiv(b * c * h * hd // 4, THREADS))
        assert plan.launches == (1 if plan.pieces == 1 else 2)


def test_main_path_plans():
    """The phase-4 shapes split as the design says: 16 decode rows x 3
    groups in 768 blocks of 8 pages (354 of them live for these lengths),
    the 128-token chunk in 64-row tiles of 21 tokens, its key axis split
    too."""
    q, pool, table, lengths = _phase4_case("decode")
    plan = _plan(q, pool, table, pool_dtype=torch.bfloat16)
    assert (plan.form, plan.rows, plan.tokens, plan.pages, plan.pieces, plan.blocks) == (FORM_CORES, 4, 1, 8, 16, 768)
    live = sum(len(_pieces(plan, 16, min(int(n), 2048))) for n in lengths) * 3
    assert live == 354, live
    for q_dtype, form in ((torch.float32, FORM_CORES), (torch.bfloat16, FORM_MMA)):
        q, pool, table, _ = _phase4_case("prefill_pos0_1024")
        plan = _plan(q, pool, table, q_dtype=q_dtype, pool_dtype=torch.bfloat16)
        assert (plan.form, plan.rows, plan.tokens, plan.qtiles) == (form, 64, 21, 7)
        assert plan.pieces > 1 and plan.blocks >= H100_SMS


@pytest.mark.parametrize("case", ["phase4-prefill_pos0_1024", "card-hd64-kv3-rep3-c128-p64",
                                  "card-hd16-kv1-rep3-c128-p16"])
def test_piece_without_live_keys_adds_nothing(case):
    """A query row whose causal limit ends before a live piece gets (0,
    -1e30, 0) from it, and merging that partial changes nothing, bit for
    bit."""
    q, pool, table, lengths = CASES[case]
    record = []
    _walk(q, pool, table, lengths, _plan(q, pool, table), record=record)
    by_tile = {}
    for bi, t, g, piece, k0, k1, part in record:
        by_tile.setdefault((bi, t, g), []).append(part)
    empty_rows = 0
    for parts in by_tile.values():
        for i, (acc, m, l) in enumerate(parts):
            dead = l == 0
            assert (acc[dead] == 0).all() and (m[dead] == NEG).all()
            if dead.any() and i:
                empty_rows += int(dead.sum())
                without = _merge(parts[:i] + parts[i + 1:])
                with_it = _merge(parts)
                assert torch.equal(without[0][dead], with_it[0][dead]) and torch.equal(without[1][dead],
                                                                                        with_it[1][dead])
    assert empty_rows > 0, "the case has no row that a live piece leaves without keys"


@pytest.mark.parametrize("case", [k for k in CASES if "-c1-" in k] + ["phase4-decode"])
def test_inactive_rows_are_exactly_zero(case):
    q, pool, table, lengths = CASES[case]
    got = _walk(q, pool, table, lengths, _plan(q, pool, table))
    dead = np.flatnonzero(lengths == 0)
    assert dead.size and not got[dead].any()


def test_planner_reads_no_lengths():
    """The planner's inputs are shapes, dtypes and the SM count: no
    ``lengths`` or ``table`` values, so the wrapper reads nothing from the
    device."""
    params = inspect.signature(plan_paged).parameters
    assert "lengths" not in params and "table" not in params
    assert all(p.annotation in (int, torch.dtype, "int", "torch.dtype") for p in params.values())
    src = inspect.getsource(pa.paged_attention)
    assert not any(s in src for s in (".item()", ".tolist()", ".cpu()", ".numpy()"))
