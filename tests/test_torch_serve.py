"""The port's serving slice (paged attention, the paged model steps, the
engine and its scheduler, smollm_135m) against the JAX package on the CPU.

The same numpy inputs and the JAX-initialised weights (carried across by
``repro_torch.convert``) go through both packages. Tolerances, relative to
each output's largest magnitude: 1e-5 for attention outputs (summation order
differs) and for smollm's training-forward logits; 1e-6 for the K/V rows
written into the pools (RoPE rounds a last bit apart); 1e-4 for the logits
of whole paged model steps (3 layers of f32 reassociation). Greedy completions
and scheduler counters must be equal. On the CPU the paged-attention wrapper
runs its plain twin; the JAX kernel runs in interpret mode, as
tests/test_serve_paged.py runs it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, jax_params
from repro.configs import get_config as jax_config
from repro.core.labels import flatten_with_names as jflat
from repro.data import DataConfig as JaxDataConfig, ZipfLM as JaxZipfLM
from repro.kernels.paged_attention import paged_attention as jax_paged, paged_attention_ref as jax_paged_ref
from repro.models import attention as jattn, transformer as jtf
from repro.serve import Engine as JaxEngine, Request as JaxRequest, ServeConfig as JaxServeConfig
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.labels import flatten_with_names
from repro_torch.data import DataConfig, ZipfLM
from repro_torch.kernels.paged_attention import paged_attention, paged_attention_plain
from repro_torch.models import Transformer, forward
from repro_torch.models import attention as tattn, transformer as ttf
from repro_torch.serve import Engine, Request, ServeConfig
from repro_torch.serve.__main__ import main as serve_cli
from repro_torch.train import Trainer, TrainerConfig

ATTN = 1e-5
STEP = 1e-4
ARCHS = ("smollm_135m", "gpt_small")
COUNTERS = ("admitted", "retired", "preempted", "prefill_chunks", "decode_steps", "page_high_water")
# tests/test_serve_paged.py's preemption case: capacity 7 pages of 2 positions for 2 slots
PREEMPT = dict(max_seq=16, max_new_tokens=6, max_slots=2, page_size=2, pool_pages=8)
QUEUE = dict(max_seq=32, max_new_tokens=3, max_slots=2, page_size=8)


def _port(arch):
    """(JAX config, JAX params, port config, port params) from one JAX init."""
    jcfg, jparams, _, arrays = jax_params(seed=0, arch=arch)
    return jcfg, jparams, get_reduced(arch), params_from_numpy(arrays, "cpu")


# ---------------------------------------------------------------------------
# B14's plain twin
# ---------------------------------------------------------------------------


def _pool_case(c, kv, rep, page, *, hd=16, b=4, max_pages=3, seed=0):
    """Random pool, distinct page tables (row 2 padded with the null page),
    ragged lengths. Decode (c == 1): a full row, one ending a position into
    its second page, an inactive row (length 0), one ending mid-page.
    Chunk: a full row, one past its first page, a prefill from position 0,
    and one whose padded length passes the table's reach."""
    rng = np.random.default_rng(seed)
    pool = rng.standard_normal((b * max_pages + 1, page, 2 * kv, hd)).astype(np.float32)
    table = (1 + np.arange(b * max_pages, dtype=np.int32)).reshape(b, max_pages)
    table[2, max_pages - 1] = 0
    reach = max_pages * page
    lengths = [reach, page + 1, 0, 2 * page - 1] if c == 1 else [reach, page + c, c, reach + 2]
    q = rng.standard_normal((b, c, kv * rep, hd)).astype(np.float32)
    return q, pool, table, np.asarray(lengths, np.int32)


# Decode and chunk forms x KV 1 and 3 (rep 3) x pages 4 and 16 x f32 and
# bf16 pools: the half of the 16 combinations in which every pair of factors
# still meets in all four of its combinations.
CASES = [(c, kv, page, dt) for c in (1, 4) for kv in (1, 3) for page in (4, 16) for dt in ("float32", "bfloat16")
         if (c == 4) ^ (kv == 3) ^ (page == 16) ^ (dt == "bfloat16")]


@pytest.mark.parametrize("c,kv,page,pool_dtype", CASES)
def test_plain_twin_matches_jax_kernel_and_ref(c, kv, page, pool_dtype):
    rep = 3
    q, pool, table, lengths = _pool_case(c, kv, rep, page)
    jpool = jnp.asarray(pool).astype(pool_dtype)
    jargs = (jnp.asarray(q), jpool, jnp.asarray(table), jnp.asarray(lengths))
    want_kernel = np.asarray(jax_paged(*jargs))
    want_ref = np.asarray(jax_paged_ref(*jargs))
    tpool = torch.from_numpy(pool).to(getattr(torch, pool_dtype))
    args = (torch.from_numpy(q), tpool, torch.from_numpy(table), torch.from_numpy(lengths))
    got = paged_attention(*args)          # CPU operands: the plain twin
    torch.testing.assert_close(got, paged_attention_plain(*args), rtol=0, atol=0)
    assert paged_attention.launches == 0
    assert_close(got, want_kernel, ATTN, "vs JAX kernel")
    assert_close(got, want_ref, ATTN, "vs JAX ref")
    if c == 1:
        assert not got[2].any(), "an inactive row is exactly 0"


def test_wrapper_rejects_bad_operands():
    q, pool, table, lengths = (torch.from_numpy(a) for a in _pool_case(1, 1, 3, 4))
    with pytest.raises(TypeError):
        paged_attention(q, pool, table.long(), lengths)
    with pytest.raises(TypeError):
        paged_attention(q.double(), pool, table, lengths)
    with pytest.raises(ValueError):
        paged_attention(q, pool[..., :8], table, lengths)
    with pytest.raises(ValueError):
        paged_attention(q, pool, table[:2], lengths)


# ---------------------------------------------------------------------------
# The attention layer's paged decode and prefill
# ---------------------------------------------------------------------------


def _layer0(arch):
    jcfg, jparams, cfg, params = _port(arch)
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["slot_0"]["attn"])
    tp = {k.split(".")[-1]: v[0] for k, v in params.items() if k.startswith("blocks.slot_0.attn.")}
    return jcfg, jp, cfg, tp


@pytest.mark.parametrize("arch", ARCHS)
def test_attention_paged_decode_matches_jax(arch):
    jcfg, jp, cfg, tp = _layer0(arch)
    rng = np.random.default_rng(1)
    page, max_pages, b = 4, 4, 3
    pool = rng.standard_normal((b * max_pages + 1, page, 2 * cfg.n_kv_heads, cfg.hd)).astype(np.float32)
    table = (1 + np.arange(b * max_pages, dtype=np.int32)).reshape(b, max_pages)
    lengths = np.array([5, 0, 9], np.int32)
    active = np.array([True, False, True])
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    jy, jpool = jax.jit(lambda *a: jattn.attention_paged_decode(*a, jcfg.attn_cfg()))(
        jp, jnp.asarray(x), jnp.asarray(pool), jnp.asarray(table), jnp.asarray(lengths), jnp.asarray(active))
    tpool = torch.from_numpy(pool.copy())
    y = tattn.attention_paged_decode(tp, torch.from_numpy(x), tpool, torch.from_numpy(table),
                                     torch.from_numpy(lengths), torch.from_numpy(active), cfg.attn_cfg())
    assert_close(y, jy, ATTN, "y")
    assert_close(tpool, jpool, 1e-6, "pool")


@pytest.mark.parametrize("arch", ARCHS)
def test_attention_paged_prefill_matches_jax(arch):
    """A chunk at pos0 = 6 with 3 valid of 8 positions: padded positions go
    to the null page, page indices clip at max_pages - 1, and the padded
    length 14 passes the table's reach of 12."""
    jcfg, jp, cfg, tp = _layer0(arch)
    rng = np.random.default_rng(2)
    page, pos0, n_valid, c = 4, 6, 3, 8
    pool = rng.standard_normal((6, page, 2 * cfg.n_kv_heads, cfg.hd)).astype(np.float32)
    table_row = np.array([[1, 2, 3]], np.int32)
    x = rng.standard_normal((1, c, cfg.d_model)).astype(np.float32)
    jy, jpool = jax.jit(lambda *a: jattn.attention_paged_prefill(*a, pos0, n_valid, jcfg.attn_cfg()))(
        jp, jnp.asarray(x), jnp.asarray(pool), jnp.asarray(table_row))
    tpool = torch.from_numpy(pool.copy())
    y = tattn.attention_paged_prefill(tp, torch.from_numpy(x), tpool, torch.from_numpy(table_row), pos0, n_valid,
                                      cfg.attn_cfg())
    assert_close(y[:, :n_valid], np.asarray(jy)[:, :n_valid], ATTN, "valid rows")
    assert_close(tpool[1:], np.asarray(jpool)[1:], 1e-6, "pool pages")


# ---------------------------------------------------------------------------
# Whole paged model steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_steps_match_jax(arch):
    """Two prefill chunks (one per row), then two decode steps, the second
    with row 1 inactive: logits, health taps, lengths and pools agree."""
    jcfg, jparams, cfg, params = _port(arch)
    rng = np.random.default_rng(3)
    page, max_pages, c = 4, 4, 8
    n_pages = 2 * max_pages + 1
    table = (1 + np.arange(2 * max_pages, dtype=np.int32)).reshape(2, max_pages)
    jpools = jtf.init_paged_pools(jcfg, n_pages, page, jnp.float32)
    pools = ttf.init_paged_pools(cfg, n_pages, page, torch.float32)
    jprefill = jax.jit(lambda pr, pl, row, p0, nv, tok: jtf.paged_prefill_chunk(jcfg, pr, pl, row, p0, nv, tok))
    jdecode = jax.jit(lambda pr, st, tok: jtf.paged_decode_step(jcfg, pr, st, tok))
    lengths = []
    for row, n_valid in ((0, 6), (1, 5)):
        tok = np.zeros((1, c), np.int32)
        tok[0, :n_valid] = rng.integers(0, cfg.vocab_size, n_valid)
        jl, jok, jpools = jprefill(jparams, jpools, jnp.asarray(table[row:row + 1]), 0, n_valid, jnp.asarray(tok))
        tl, tok_ok, _ = ttf.paged_prefill_chunk(cfg, params, pools, torch.from_numpy(table[row:row + 1]), 0,
                                                n_valid, torch.from_numpy(tok))
        assert_close(tl[0, :n_valid], np.asarray(jl)[0, :n_valid], STEP, f"prefill row {row}")
        assert bool(tok_ok) == bool(jok)
        lengths.append(n_valid)
    lengths = np.asarray(lengths, np.int32)
    for active in (np.array([True, True]), np.array([True, False])):
        tokens = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
        jstate = jtf.PagedState(pools=jpools, table=jnp.asarray(table), lengths=jnp.asarray(lengths),
                                active=jnp.asarray(active))
        jl, jok, jstate = jdecode(jparams, jstate, jnp.asarray(tokens))
        jpools = jstate.pools
        state = ttf.PagedState(pools=pools, table=torch.from_numpy(table), lengths=torch.from_numpy(lengths),
                               active=torch.from_numpy(active))
        tl, tok_ok, state = ttf.paged_decode_step(cfg, params, state, torch.from_numpy(tokens))
        assert_close(tl[active], np.asarray(jl)[active], STEP, f"decode {active}")
        np.testing.assert_array_equal(tok_ok.numpy(), np.asarray(jok))
        np.testing.assert_array_equal(state.lengths.numpy(), np.asarray(jstate.lengths))
        lengths = state.lengths.numpy()
    assert_close(pools["slot_0"][:, 1:], np.asarray(jpools["slot_0"])[:, 1:], 1e-5, "pools")


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


def _invariants(eng):
    """No slot double-use, no page mapped twice, table agrees with pool
    ownership (tests/test_serve_paged.py's check, between steps)."""
    sched = eng.scheduler
    seen = {}
    for slot in range(sched.n_slots):
        rid = sched.slot_rid[slot]
        row = sched.table[slot]
        if rid is None:
            assert not row.any(), f"empty slot {slot} has mapped pages"
            continue
        for pg in row[row != 0]:
            assert pg not in seen, f"page {pg} mapped by slots {seen[pg]},{slot}"
            seen[int(pg)] = slot
            assert eng.pool.owner(int(pg)) == rid


def _prompts(case, vocab):
    if case == "preempt":       # tests/test_serve_paged.py:245's two prompts
        return [np.array([1, 2, 3, 4], np.int32), np.array([9, 8, 7, 6], np.int32)]
    rng = np.random.default_rng(4)
    return [rng.integers(0, vocab, int(n), dtype=np.int32) for n in rng.integers(3, 9, 5)]


@pytest.mark.parametrize("case", ["queue", "preempt"])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax_engine(arch, case):
    """Greedy completions token for token, and the scheduler counters, with
    more requests than slots (invariants checked between steps) and with
    pool exhaustion forcing preemption."""
    jcfg, jparams, cfg, params = _port(arch)
    kw = QUEUE if case == "queue" else PREEMPT
    prompts = _prompts(case, cfg.vocab_size)
    jeng = JaxEngine(jcfg, jparams, JaxServeConfig(**kw))
    jrids = [jeng.submit(JaxRequest(prompt=p)) for p in prompts]
    jdone = jeng.run_until_drained()
    eng = Engine(cfg, params, ServeConfig(**kw), device="cpu")
    rids = [eng.submit(Request(prompt=p)) for p in prompts]
    while eng.scheduler.queue or eng.scheduler.active_slots():
        eng.step()
        _invariants(eng)
    done = eng.completions()
    for jr, r in zip(jrids, rids):
        np.testing.assert_array_equal(done[r].tokens, jdone[jr].tokens)
        assert done[r].finish_reason == jdone[jr].finish_reason == "length"
        assert done[r].preemptions == jdone[jr].preemptions
    jm, m = jeng.metrics(), eng.metrics()
    assert [getattr(m, k) for k in COUNTERS] == [getattr(jm, k) for k in COUNTERS]
    assert m.used_pages == 0 and eng.pool.free_count == eng.pool.alloc_count
    if case == "preempt":
        assert m.preempted >= 1
    else:
        assert m.admitted == len(prompts) > eng.sc.max_slots


def test_sampling_seed_reproduces_across_preemption():
    """Temperature sampling: the same seed gives the same tokens, and a
    request preempted and recomputed samples what a solo run samples."""
    _, _, cfg, params = _port("gpt_small")
    prompts = _prompts("preempt", cfg.vocab_size)

    def run(reqs):
        eng = Engine(cfg, params, ServeConfig(**PREEMPT), device="cpu")
        rids = [eng.submit(Request(prompt=p, temperature=1.0, seed=s)) for p, s in reqs]
        done = eng.run_until_drained()
        return [done[r] for r in rids], eng.metrics()

    both, m = run([(prompts[0], 11), (prompts[1], 12)])
    assert m.preempted >= 1 and any(c.preemptions for c in both)
    for c, (p, s) in zip(both, [(prompts[0], 11), (prompts[1], 12)]):
        (solo,), _ = run([(p, s)])
        np.testing.assert_array_equal(c.tokens, solo.tokens)
    (again,), _ = run([(prompts[0], 11)])
    (other,), _ = run([(prompts[0], 13)])
    np.testing.assert_array_equal(again.tokens, both[0].tokens)
    assert not np.array_equal(other.tokens, both[0].tokens)


def test_engine_request_api_and_admission():
    _, _, cfg, params = _port("smollm_135m")
    eng = Engine(cfg, params, ServeConfig(max_seq=32, max_new_tokens=16, max_queue=1), device="cpu")
    prompt = np.array([1, 2, 3, 4], np.int32)
    r_short = eng.submit(Request(prompt=prompt, max_new_tokens=2))
    assert eng.submit(Request(prompt=prompt)).reason == "queue_full"
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit(Request(prompt=np.arange(40, dtype=np.int32)))
    with pytest.warns(UserWarning, match="truncating"):
        eng.sc.max_queue = None
        r_long = eng.submit(Request(prompt=torch.from_numpy(prompt), max_new_tokens=40))
    done = eng.run_until_drained()
    assert len(done[r_short].tokens) == 2 and len(done[r_long].tokens) == 28
    np.testing.assert_array_equal(done[r_short].tokens, done[r_long].tokens[:2])
    m = eng.metrics()
    assert (m.rejected_queue, m.truncated_max_new, m.used_pages) == (1, 1, 0)
    assert m.ttft_mean_s is not None and m.tpot_mean_s is not None


def test_deadlines_and_pool_watermark():
    """A request past its deadline is dropped from the queue without
    touching the device; an active one retires with what it generated; the
    pool watermark rejects a request whose pages would pass it."""
    _, _, cfg, params = _port("gpt_small")
    eng = Engine(cfg, params, ServeConfig(max_seq=32, max_new_tokens=8, max_slots=1, page_size=4,
                                          admit_watermark=1.0), device="cpu")
    prompt = np.array([1, 2, 3], np.int32)
    live = eng.submit(Request(prompt=prompt, deadline_s=60.0))
    late = eng.submit(Request(prompt=prompt, deadline_s=0.0))
    assert eng.submit(Request(prompt=np.arange(20, dtype=np.int32))).reason == "pool_pressure"
    with pytest.warns(UserWarning, match="deadline"):
        eng.step()
    assert eng.prefill_chunks == 1               # only the live request reached the device
    eng._reqs[live].deadline_s = 0.0
    done = eng.run_until_drained()
    assert done[late].finish_reason == "deadline" and len(done[late].tokens) == 0
    assert done[live].finish_reason == "deadline" and 0 < len(done[live].tokens) < 8
    m = eng.metrics()
    assert (m.deadline_expired, m.rejected_pool, m.used_pages) == (2, 1, 0)


def test_engine_and_cli_need_a_device_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, cfg, params = _port("smollm_135m")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, params, ServeConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_cli(["--requests", "1"])
    done = serve_cli(["--device", "cpu", "--requests", "2", "--new-tokens", "3"])
    assert [len(c.tokens) for c in done.values()] == [3, 3]
    # an arch outside the paged path serves through generate() only
    non_attn = dataclasses.replace(cfg, pattern=(ttf.LayerSlot(None, "dense"),))
    with pytest.raises(NotImplementedError, match="generate"):
        Engine(non_attn, params, ServeConfig(), device="cpu").submit(Request(prompt=np.array([1, 2], np.int32)))


# ---------------------------------------------------------------------------
# smollm_135m: RoPE, GQA, RMSNorm, gated MLP
# ---------------------------------------------------------------------------


def test_smollm_forward_matches_jax():
    jcfg, jparams, cfg, params = _port("smollm_135m")
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    jlogits, _ = jtf.forward(jcfg, jparams, {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        logits, _ = forward(cfg, params, {"tokens": torch.from_numpy(tokens)})
    assert_close(logits, jlogits, 1e-5, "logits")


def test_smollm_param_tree_round_trips():
    _, _, _, arrays = jax_params(seed=0, arch="smollm_135m")
    model = Transformer(get_reduced("smollm_135m"), device="cpu")
    assert list(model.names) == list(arrays)
    assert any(n.endswith("mlp.w_gate") for n in arrays) and "pos_embed" not in arrays
    assert arrays["blocks.slot_0.attn.wk"].shape[2] == 1
    back = params_to_numpy(params_from_numpy(arrays, "cpu"))
    assert list(back) == list(arrays)
    for name, a in arrays.items():
        np.testing.assert_array_equal(back[name], a)
    jfull, jmeta = jax_config("smollm_135m").abstract()
    specs = dict(flatten_with_names(get_config("smollm_135m").specs()))
    assert [(n, s.shape) for n, s in specs.items()] == [(n, tuple(p.shape)) for n, p in jflat(jfull)[0]]
    assert ([dataclasses.astuple(s.meta()) for s in specs.values()]
            == [dataclasses.astuple(m) for _, m in jflat(jmeta)[0]])
    assert get_config("smollm_135m").param_count() == 134_515_008


def test_trainer_builds_smollm():
    """The port's trainer on reduced smollm_135m: SlimAdam (Table 3) on the
    fused backend, 3 steps, against the JAX trainer's losses (1e-3, the
    slice-1 bar for short curves)."""
    from repro.train import Trainer as JaxTrainer, TrainerConfig as JaxTrainerConfig

    jcfg, _, cfg, params = _port("smollm_135m")
    data = dict(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2, seed=6)
    jtr = JaxTrainer(jcfg, "slim", 3e-3, JaxZipfLM(JaxDataConfig(**data)),
                     JaxTrainerConfig(total_steps=3, log_every=1, seed=0, backend="jnp"))
    jtr.run()
    tr = Trainer(cfg, "slim", 3e-3, ZipfLM(DataConfig(**data)),
                 TrainerConfig(total_steps=3, log_every=1, seed=0, backend="fused"), device="cpu")
    tr.model.load_params(params)
    tr.run()
    want = [m["loss"] for m in jtr.metrics_log]
    got = [m["loss"] for m in tr.metrics_log]
    np.testing.assert_allclose(got, want, rtol=1e-3)
