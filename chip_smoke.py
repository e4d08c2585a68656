#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, one CUDA GPU

Phases, each of which raises on failure (the script then exits non-zero):

1. Device and build: the card's name and power limit, then the CUDA kernels
   built from ``src/repro_torch/kernels/csrc`` (nvcc, one process per source).
2. Kernel parity and timing at the full-width gpt_small shapes of the main
   path, each kernel against its plain PyTorch twin: ``mega_adam_update``
   and ``mega_slim_update_batched`` on every group of the megaplans the
   fused backend runs (planned by ``plan_megagroups`` from the model's
   parameter specs: Adam's, the Table-3 rules', and in phase 3 the derived
   rules'), ``snr_stats_centered_batched`` on all 21 SNR candidates. Times
   are CUDA-event medians with L2 flushed before each launch, beside the
   least time the card needs for the same bytes and operations and, where
   one PyTorch call computes the same function, that call's time.
3. Main path through the port's entry points, full-width gpt_small (depth
   not cut, random weights from a seed), batch 8 x seq 1024, bf16
   activations, ``backend="fused"``: 6 Adam steps measuring SNR at steps 3
   and 6, ``derive_slim_rules`` (whose plan's new groups are then held as in
   phase 2), 4 SlimAdam steps with Table-3 rules and 4 with the derived
   rules. Launch counters are zeroed before and read after each run and
   must show every kernel of the path. Then one fused optimizer update
   against the plain 'jnp' backend from the same state for each of the
   three optimizers, a small reduced-model run on the card against the
   CPU, and step timings.
4. ``paged_attention`` (B14) against its plain twin at full-width
   smollm_135m shapes (9 heads over 3 KV groups, hd 64, pages of 16,
   128-page table rows), bf16 and f32 pools, f32 queries: a decode batch of
   16 ragged rows (one empty, one ending mid-page) and 128-token prefill
   chunks at pos0 = 0 and at pos0 = 1024 with 100 valid tokens. Timed as in
   phase 2, beside the bound and ``scaled_dot_product_attention`` on K/V
   gathered dense (gather untimed).
5. The serving main path through ``repro_torch.serve.Engine`` on the card:
   full-width smollm_135m (30 layers, random weights from seed 0), 32
   requests of 64 new tokens (28 greedy, 4 sampled) over 16 slots and a pool
   small enough to preempt. Every request must finish by length with no
   page left used, and ``paged_attention`` must launch 30 times per decode
   step and prefill chunk. Then decode-step and prefill-chunk times and a
   device profile of decode steps; the logits of a prefill chunk and of 4
   decode steps through the kernel against the plain twin from the same
   state; and reduced f32 smollm_135m and gpt_small served on the card
   against the CPU, token for token.
6. One ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last the
   ``{"ok": true, "device": ...}`` line.

TF32 is off for every phase (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``), so f32 matrix products are full f32.
A detailed report goes to ``build/chip_smoke_report.json`` (git-ignored).
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Peak rates (NVIDIA data sheets, dense, SXM parts at 700 W unless named):
# device memory bytes/s by card, f32 and f64 operations/s outside the tensor
# cores for the H100.
MEM_RATE = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H200": 4.8e12, "H100": 3.35e12}
F32_RATE = 67e12
F64_RATE = 34e12

TOL_ELEMENTWISE = 1e-6   # same operation order in kernel and plain version
TOL_LINE = 1e-5          # depends on a line sum; summation order differs
TOL_STEP = 1e-5          # a whole fused update against the plain 'jnp' backend
TOL_SMALL_RUN = 1e-3     # reduced-model loss curve, card against CPU, 5 steps
TOL_SERVE_LOGITS = 5e-2  # full-width logits, kernel against plain attention: bf16 activations through 30 layers

# Serving run geometry (phase 5). 800 pool pages force preemption of the 32
# requests; the scheduler's counts do not depend on the weights, since no
# request stops at an eos token.
SERVE_SC = dict(max_seq=2048, page_size=16, max_slots=16, prefill_chunk=128, pool_pages=800)
SERVE_REQUESTS, SERVE_GREEDY, SERVE_NEW = 32, 28, 64


def log(*a):
    print(*a, flush=True)


def mem_rate(name: str) -> float:
    for key, rate in MEM_RATE.items():
        if key in name:
            return rate
    raise RuntimeError(f"no memory rate on record for {name!r}")


def max_err(a, b):
    """(max abs error, max abs error / max |b|) over tensors of one shape."""
    err = float((a.double() - b.double()).abs().max())
    return err, err / max(float(b.double().abs().max()), 1e-30)


def check(what: str, a, b, tol: float) -> float:
    err, rel = max_err(a, b)
    ok = rel <= tol
    log(f"  {what}: max_abs_err {err:.3e}  rel {rel:.3e}  tol {tol:.0e}  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what}: relative error {rel:.3e} above {tol:.0e}")
    return err


class Timer:
    """Median time of a device function: CUDA events around each call, with
    L2 (50 MB) flushed by a 256 MB write before it."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")

    def __call__(self, fn, reps: int = 10) -> float:
        torch = self.torch
        fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def profile_device(torch, fn, n: int, wall_ms: float, label: str) -> dict:
    """Device time by kernel over ``n`` calls of ``fn`` (torch.profiler),
    and the device's busy share against the unprofiled time ``wall_ms`` of
    one call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3 / n) for e in prof.key_averages()
            if getattr(e, "device_type", None) == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(t for _, t in rows)
    log(f"  profile ({n} {label}s): device busy {busy:.3f} ms per {label} of {wall_ms:.3f} ms "
        f"({busy / wall_ms:.1%}); top kernels by device time per {label}:")
    for key, t in rows[:12]:
        log(f"    {t:8.4f} ms  {key[:110]}")
    return dict(busy_ms=busy, wall_ms=wall_ms, kernels=rows[:40])


def page_table(torch, positions, page: int, max_pages: int):
    """A (rows, max_pages) int32 table on the card giving each row distinct
    pages for its ``positions``, padded with the null page 0, and the pool
    size (pages, the null page included) it needs."""
    table = torch.zeros((len(positions), max_pages), dtype=torch.int32)
    first = 1
    for i, n in enumerate(-(-int(x) // page) for x in positions):
        table[i, :n] = torch.arange(first, first + n, dtype=torch.int32)
        first += n
    return table.to(torch.device("cuda")), first


def paged_case(torch, gen, *, lengths, alloc, c, pool_dtype, heads=9, kv=3, hd=64, page=16, max_pages=128):
    """B14 operands: f32 queries (B, C, heads, hd), a pool holding exactly
    the pages that ``alloc`` positions of each row need, the table, and
    ``lengths``."""
    dev = torch.device("cuda")
    table, n_pages = page_table(torch, alloc, page, max_pages)
    pool = torch.randn((n_pages, page, 2 * kv, hd), generator=gen, device=dev).to(pool_dtype)
    q = torch.randn((len(alloc), c, heads, hd), generator=gen, device=dev)
    return q, pool, table, torch.tensor([int(x) for x in lengths], dtype=torch.int32, device=dev)


def paged_bound(q, pool, table, lengths, rate: float):
    """Least time (ms) for one paged-attention call on these inputs, and what
    sets it: the larger of the bytes it must move (each row's live pages,
    whole page rows of K and V for every group; q, the output, the table and
    the lengths) over the memory rate, and its operations (4 * hd per query
    head and attended key, counted causally for these lengths) over the f32
    rate."""
    b, c, h, hd = q.shape
    page = pool.shape[1]
    reach = table.shape[1] * page
    row_bytes = pool.shape[2] * hd * pool.element_size()
    read, keys = 0, 0
    for length in lengths.tolist():
        read += -(-max(0, min(length, reach)) // page) * page * row_bytes
        keys += sum(max(0, min(length - c + i + 1, reach)) for i in range(c))
    nbytes = read + 2 * q.numel() * q.element_size() + 4 * (table.numel() + lengths.numel())
    t_bytes, t_ops = nbytes / rate, 4 * h * hd * keys / F32_RATE
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def sdpa_call(torch, q, pool, table, lengths):
    """One ``scaled_dot_product_attention`` call computing the same
    attention on K/V already gathered dense (the gather is not timed)."""
    import torch.nn.functional as F

    b, c, h, hd = q.shape
    kv = pool.shape[2] // 2
    s = table.shape[1] * pool.shape[1]
    g = pool[table.long()]
    k = g[:, :, :, 0::2].reshape(b, s, kv, hd).transpose(1, 2).contiguous()
    v = g[:, :, :, 1::2].reshape(b, s, kv, hd).transpose(1, 2).contiguous()
    qd = q.to(pool.dtype).transpose(1, 2).contiguous()
    q_abs = lengths.long()[:, None] - c + torch.arange(c, device=q.device)[None, :]
    mask = (torch.arange(s, device=q.device)[None, None, :] <= q_abs[:, :, None])[:, None]
    return lambda: F.scaled_dot_product_attention(qd, k, v, attn_mask=mask, enable_gqa=True)


def serve_phases(torch, timer, rate: float, smi: str):
    """Phases 4 and 5. Returns (report, the B14 entry of the kernels line)."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import Transformer
    from repro_torch.models.transformer import PagedState, init_paged_pools, paged_decode_step, paged_prefill_chunk
    from repro_torch.serve import Engine, Request, ServeConfig

    report: dict = {}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)

    # -- 4. B14 against its plain twin ------------------------------------
    log("[4] paged_attention (B14) at full-width smollm_135m shapes against its plain twin, bound, SDPA")
    rng = np.random.default_rng(0)
    dec = rng.integers(1, 2049, 16)
    dec[0], dec[1] = 0, 16 * 37 + 5
    cases = {"decode": dict(lengths=dec, alloc=dec, c=1),
             "prefill_pos0_0": dict(lengths=[128], alloc=[128], c=128),
             "prefill_pos0_1024": dict(lengths=[1024 + 128], alloc=[1024 + 100], c=128)}
    held = {}
    for case, kw in cases.items():
        for pool_dtype in (torch.bfloat16, torch.float32):
            q, pool, table, lengths = paged_case(torch, gen, pool_dtype=pool_dtype, **kw)
            args = (q, pool, table, lengths)
            tag = f"{case} {str(pool_dtype).split('.')[-1]} pool"
            got, want = pa.paged_attention(*args), pa.paged_attention_plain(*args)
            torch.cuda.synchronize()
            err = check(tag, got, want, TOL_LINE)
            if case == "decode" and got[0].any():
                raise AssertionError("decode: the empty row's output is not exactly 0")
            ms = timer(lambda: pa.paged_attention(*args), reps=20)
            plain_ms = timer(lambda: pa.paged_attention_plain(*args), reps=5)
            lib_ms = timer(sdpa_call(torch, *args), reps=20)
            bound, by = paged_bound(*args, rate)
            log(f"  {tag}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound:.4f} ms ({by})  "
                f"SDPA {lib_ms:.4f} ms  ({smi})")
            held[tag] = dict(case=case, pool=str(pool_dtype), err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                             bound_by=by, library_ms=lib_ms, lengths=[int(x) for x in kw["lengths"]])
            del q, pool, table, lengths, args, got, want
    report["paged_attention"] = held
    torch.cuda.empty_cache()

    # -- 5. the serving main path -------------------------------------------
    cfg = get_config("smollm_135m")
    log(f"[5] serving main path: full-width smollm_135m ({cfg.param_count()} parameters, random weights from "
        f"seed 0), {SERVE_REQUESTS} requests x {SERVE_NEW} new tokens, {SERVE_SC}")
    model = Transformer(cfg, device=dev, gen=torch.Generator().manual_seed(0))
    eng = Engine(cfg, model.params, ServeConfig(**SERVE_SC))
    del model
    rng = np.random.default_rng(0)
    prompt_lens = rng.integers(64, 1537, SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32) for n in prompt_lens]
    for i, p in enumerate(prompts):
        sampled = i >= SERVE_GREEDY
        eng.submit(Request(prompt=p, max_new_tokens=SERVE_NEW, temperature=0.8 if sampled else 0.0,
                           seed=i if sampled else None))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    m = eng.metrics()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    # bf16 pools: per layer and page, page positions x 2 * KV rows x hd
    pool_gib = cfg.n_layers * eng.pool.n_pages * SERVE_SC["page_size"] * 2 * cfg.n_kv_heads * cfg.hd * 2 / 2**30
    log(f"  drained in {wall:.2f} s: {m.tokens_out} tokens ({m.tokens_out / wall:.1f} tokens/s overall), "
        f"{m.decode_steps} decode steps, {m.prefill_chunks} prefill chunks, {m.preempted} preemptions, "
        f"page high water {m.page_high_water}/{m.pool_capacity}, launches {counts}")
    log(f"  mean TTFT {m.ttft_mean_s * 1e3:.1f} ms, mean TPOT {m.tpot_mean_s * 1e3:.2f} ms, peak memory "
        f"{peak:.3f} GiB above the parameters, pool {pool_gib:.3f} GiB ({smi})")
    bad = [c for c in done.values() if c.finish_reason != "length" or len(c.tokens) != SERVE_NEW]
    if len(done) != SERVE_REQUESTS or bad:
        raise AssertionError(f"{len(done)} completions, unfinished or short: {[(c.id, c.finish_reason) for c in bad]}")
    if m.used_pages != 0 or m.preempted < 1:
        raise AssertionError(f"used pages {m.used_pages} after the drain, {m.preempted} preemptions (want >= 1)")
    want_launches = cfg.n_layers * (m.decode_steps + m.prefill_chunks)
    if counts["paged_attention"] != want_launches or sum(counts.values()) != want_launches:
        raise AssertionError(f"launches {counts}, expected paged_attention {want_launches} and no other kernel")
    run = dict(wall_s=wall, metrics=m.to_dict(), launches=counts, peak_gib=peak, pool_gib=pool_gib,
               prompt_lens=prompt_lens.tolist())

    # Step times on the synchronised host clock, outside the counted run: 16
    # rows mid-generation (the first 16 prompts plus 32 tokens) in a pool of
    # their own; then a device profile of decode steps.
    params = eng.params
    page = SERVE_SC["page_size"]
    max_pages = -(-SERVE_SC["max_seq"] // page)
    tl = [int(n) + 32 for n in prompt_lens[:16]]
    table, n_pages = page_table(torch, [n + 1 for n in tl], page, max_pages)
    pools = init_paged_pools(cfg, n_pages, page, torch.bfloat16, dev)
    state = PagedState(pools=pools, table=table, lengths=torch.tensor(tl, dtype=torch.int32, device=dev),
                       active=torch.ones(16, dtype=torch.bool, device=dev))
    tokens = torch.randint(0, cfg.vocab_size, (16, 1), device=dev)
    chunk = torch.randint(0, cfg.vocab_size, (1, SERVE_SC["prefill_chunk"]), device=dev)

    def decode():
        paged_decode_step(cfg, params, state, tokens)

    def prefill():
        paged_prefill_chunk(cfg, params, pools, table[:1], 512, SERVE_SC["prefill_chunk"], chunk)

    def host_ms(fn, n=10):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    decode_ms, prefill_ms = host_ms(decode), host_ms(prefill)
    log(f"  decode step (16 rows of {min(tl)}..{max(tl)} positions) {decode_ms:.3f} ms = "
        f"{16 / decode_ms * 1e3:.1f} decode tokens/s; prefill chunk (128 tokens at pos0 512) {prefill_ms:.3f} ms")
    run.update(decode_step_ms=decode_ms, prefill_chunk_ms=prefill_ms, decode_tokens_per_s=16 / decode_ms * 1e3,
               decode_profile=profile_device(torch, decode, 3, decode_ms, "decode step"),
               prefill_profile=profile_device(torch, prefill, 2, prefill_ms, "prefill chunk"))
    del pools, state
    report["serving"] = run

    # The kernel path against the plain path at full width, from the same
    # state: the first prefill chunk, then 4 decode steps over 4 prompts.
    log(f"[5] logits through the kernel against the plain twin, full width, tolerance {TOL_SERVE_LOGITS:.0e} "
        f"of max|logit|")
    rng = np.random.default_rng(2)
    lens4 = [300, 129, 1000, 64]
    prompts4 = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32) for n in lens4]
    table, n_pages = page_table(torch, [n + 4 for n in lens4], page, max_pages)
    pools_k = init_paged_pools(cfg, n_pages, page, torch.bfloat16, dev)
    pools_p = {k: v.clone() for k, v in pools_k.items()}
    c = SERVE_SC["prefill_chunk"]
    first_chunk = torch.from_numpy(prompts4[0][:c][None].copy()).to(dev)
    lk, _, _ = paged_prefill_chunk(cfg, params, pools_k, table[:1], 0, c, first_chunk)
    lp, _, _ = paged_prefill_chunk(cfg, params, pools_p, table[:1], 0, c, first_chunk, attn_impl="plain")
    worst = {"prefill": check("first prefill chunk logits", lk.float(), lp.float(), TOL_SERVE_LOGITS)
             / float(lp.float().abs().max())}
    last = []
    for row, p in enumerate(prompts4):
        for lo in range(0, len(p), c):
            buf = np.zeros((1, c), np.int32)
            buf[0, :len(p[lo:lo + c])] = p[lo:lo + c]
            n_valid = min(c, len(p) - lo)
            logits, _, _ = paged_prefill_chunk(cfg, params, pools_k, table[row:row + 1], lo, n_valid,
                                               torch.from_numpy(buf).to(dev))
        last.append(int(logits[0, n_valid - 1].float().argmax()))
    pools_p = {k: v.clone() for k, v in pools_k.items()}
    lengths = torch.tensor(lens4, dtype=torch.int32, device=dev)
    active = torch.ones(4, dtype=torch.bool, device=dev)
    tokens = torch.tensor(last, device=dev)[:, None]
    for step in range(4):
        sk = PagedState(pools=pools_k, table=table, lengths=lengths, active=active)
        sp = PagedState(pools=pools_p, table=table, lengths=lengths, active=active)
        lk, ok_k, sk = paged_decode_step(cfg, params, sk, tokens)
        lp, ok_p, _ = paged_decode_step(cfg, params, sp, tokens, attn_impl="plain")
        err = check(f"decode step {step} logits", lk.float(), lp.float(), TOL_SERVE_LOGITS)
        worst[f"decode_{step}"] = err / float(lp.float().abs().max())
        if not (bool(ok_k.all()) and bool(ok_p.all())):
            raise AssertionError(f"decode step {step}: non-finite logits")
        lengths, tokens = sk.lengths, lk[:, -1].float().argmax(-1)[:, None]
    report["kernel_vs_plain_logits_rel"] = worst
    del pools_k, pools_p, eng, params
    torch.cuda.empty_cache()

    # A small input against a reference: reduced f32 models served on the
    # card (through the kernel) and on the CPU (plain twin), greedy.
    log("[5] reduced f32 smollm_135m and gpt_small served on the card against the CPU, greedy tokens")
    rng = np.random.default_rng(3)
    small = {}
    for arch in ("smollm_135m", "gpt_small"):
        rcfg = get_reduced(arch)
        rparams = Transformer(rcfg, device="cpu", gen=torch.Generator().manual_seed(0)).params
        rprompts = [rng.integers(0, rcfg.vocab_size, n, dtype=np.int32) for n in rng.integers(5, 25, 6)]
        toks = {}
        for device in ("cuda", "cpu"):
            before = pa.paged_attention.launches
            e = Engine(rcfg, rparams, ServeConfig(max_seq=64, page_size=8, max_slots=4, prefill_chunk=8),
                       device=device)
            rids = [e.submit(Request(prompt=p, max_new_tokens=16)) for p in rprompts]
            d = e.run_until_drained()
            toks[device] = [d[r].tokens.tolist() for r in rids]
            launched = pa.paged_attention.launches - before
            if (device == "cuda") != (launched > 0):
                raise AssertionError(f"{arch} on {device}: {launched} kernel launches")
        if toks["cuda"] != toks["cpu"]:
            raise AssertionError(f"{arch}: card and CPU tokens differ: {toks}")
        log(f"  {arch}: 6 requests x 16 tokens identical on the card and the CPU (first {toks['cuda'][0][:8]})")
        small[arch] = toks["cuda"]
    report["reduced_card_vs_cpu_tokens"] = small

    dec_b = held["decode bfloat16 pool"]
    entry = {"name": "paged_attention", "route": "cuda", "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
             "replaces": "src/repro/kernels/paged_attention.py:143", "launches": counts["paged_attention"],
             "max_abs_err": max(h["err"] for h in held.values()), "ms": dec_b["ms"], "plain_ms": dec_b["plain_ms"],
             "bound_ms": dec_b["bound_ms"], "bound_by": dec_b["bound_by"], "library_ms": dec_b["library_ms"]}
    return report, entry


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch import kernels
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.core import rules_to_dims, second_moment_savings, table3_rules
    from repro_torch.core.labels import flatten_with_names
    from repro_torch.core.slim_adam import scale_by_slim_adam
    from repro_torch.data import DataConfig, ZipfLM
    from repro_torch.kernels import build, megaplan, snr_stats
    from repro_torch.kernels.ops import canon_apply, canon_nd
    from repro_torch.models import forward
    from repro_torch.optim.adam import scale_by_adam
    from repro_torch.optim.fused import bias_corrections
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.train.loss import lm_loss

    report: dict = {}
    t_start = time.perf_counter()

    # -- 1. device and build ------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    rate = mem_rate(kind)
    log(f"[1] device: {smi}  (torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"memory rate {rate / 1e12:.2f} TB/s on record)")
    t0 = time.perf_counter()
    build.library()
    log(f"[1] kernels built in {time.perf_counter() - t0:.1f} s (nvcc {build.build_log['seconds']:.1f} s)")
    for line in build.build_log["output"].splitlines():
        if "registers" in line or "spill" in line or line.startswith("---"):
            log("    " + line.strip())
    report["build"] = build.build_log

    timer = Timer(torch)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    kw = dict(b1=0.9, b2=0.95, eps=1e-8)
    bc1, bc2 = bias_corrections(0.9, 0.95, torch.tensor(3, dtype=torch.int32, device=dev))

    # -- 2. kernel parity and timing at the main path's shapes --------------
    # The fused backend's megaplan is a pure function of the parameter shapes
    # in tree order and the per-leaf reduction dims, so the groups held here
    # are those the main path launches on: Adam's and the Table-3 rules' now,
    # the derived rules' as soon as phase 3 derives them. drive() checks that
    # each trainer's parameters are these specs, name for name.
    cfg = get_config("gpt_small")
    specs = dict(flatten_with_names(cfg.specs()))
    meta = {k: s.meta() for k, s in specs.items()}

    def plan_for(rules):
        dims = rules_to_dims(rules, meta)
        return megaplan.plan_megagroups([s.shape for s in specs.values()], [torch.float32] * len(specs),
                                        [dims[k] for k in specs])

    held = {}   # (kind, batch, rows, cols, axis) -> parity and timing of that group

    def group_key(group):
        return group.kind, group.batch, group.rows, group.cols, group.axis

    def hold_group(group):
        """One megaplan group's kernel against its plain twin on inputs of
        the group's shape, then kernel, twin, bound and library times."""
        key = group_key(group)
        if key in held:
            return
        b, r, c = group.batch, group.rows, group.cols
        dense = group.kind == "dense"
        shape = (r, c) if dense else (b, r, c)
        line = (r, 1) if dense else (b, r, 1) if group.axis == 1 else (b, 1, c)
        g = 1e-3 * torch.randn(shape, generator=gen, device=dev)
        m = 1e-4 * torch.randn(shape, generator=gen, device=dev)
        v = 1e-6 * torch.rand(shape if dense else line, generator=gen, device=dev)
        args = (g, m, v, bc1.expand(line).contiguous(), bc2.expand(line).contiguous())
        n, lines = g.numel(), math.prod(line)
        lib_ms = None
        if dense:
            name, tols = "mega_adam_update", (TOL_ELEMENTWISE,) * 3
            run = lambda: megaplan.mega_adam_update(*args, **kw)               # noqa: E731
            plain = lambda: megaplan.mega_adam_update_plain(*args, **kw)       # noqa: E731
            bound = max((24 * n + 8 * lines) / rate, 11 * n / F32_RATE) * 1e3
        else:
            name, tols = "mega_slim_update_batched", (TOL_LINE, TOL_ELEMENTWISE, TOL_LINE)
            run = lambda: megaplan.mega_slim_update_batched(*args, axis=group.axis, **kw)          # noqa: E731
            plain = lambda: megaplan.mega_slim_update_batched_plain(*args, axis=group.axis, **kw)  # noqa: E731
            bound = max((16 * n + 16 * lines) / rate, 9 * n / F32_RATE) * 1e3
        tag = f"{name} {group.kind} {shape}" + ("" if dense else f" axis {group.axis}")
        errs = [check(f"{tag} {o}", a, w, tol) for o, a, w, tol in zip(("u", "m'", "v'"), run(), plain(), tols)]
        ms, plain_ms = timer(run), timer(plain)
        if dense:   # the nearest one-call yardstick: fused AdamW, which also writes the parameters
            p = torch.zeros(n, device=dev, requires_grad=True)
            p.grad = g.reshape(-1)
            opt = torch.optim.Adam([p], lr=1e-3, betas=(0.9, 0.95), eps=1e-8, fused=True)
            lib_ms = timer(opt.step)
            del p, opt
        log(f"  {tag}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound:.4f} ms"
            + ("" if lib_ms is None else f"  Adam(fused) {lib_ms:.4f} ms"))
        held[key] = dict(kernel=name, kind=group.kind, shape=list(shape), axis=group.axis, err=max(errs), ms=ms,
                         plain_ms=plain_ms, bound_ms=bound, library_ms=lib_ms)
        del g, m, v, args

    def hold_plan(label, plan):
        log(f"  {label} plan: {len(plan.groups)} groups ({', '.join(g.kind for g in plan.groups)})")
        for group in plan.groups:
            hold_group(group)

    def plan_sum(plan, kernel, field):
        return sum(held[group_key(g)][field] for g in plan.groups if held[group_key(g)]["kernel"] == kernel)

    adam_plan, t3_plan = plan_for({}), plan_for(table3_rules(meta))
    kinds = [g.kind for g in t3_plan.groups]
    if adam_plan.jnp_idx or t3_plan.jnp_idx or [g.kind for g in adam_plan.groups] != ["dense"] \
            or kinds.count("dense") != 1 or len(kinds) != 4:
        raise AssertionError(f"unexpected plans: Adam {adam_plan.groups}, Table 3 {t3_plan.groups}")
    log("[2] megaplan kernels on the groups of the main path's plans, each against its plain twin")
    hold_plan("Adam", adam_plan)
    hold_plan("SlimAdam Table-3", t3_plan)

    log("[2] snr_stats_centered_batched (B5) on the 21 gpt_small candidates, plain twin, bound, torch.var_mean")
    snr = {"err": 0.0, "candidates": [], "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    for name, spec in specs.items():
        for label, axes in meta[name].candidate_ks().items():
            cn = canon_nd(spec.shape, meta[name].dims_of(axes))
            x = torch.randn(spec.shape, generator=gen, device=dev)
            v3 = canon_apply(x * x, cn)
            v3 = v3 if v3.ndim == 3 else v3[None]
            red = 2 if cn.axis == 1 else 1
            got = snr_stats.snr_stats_centered_batched(v3, axis=cn.axis)
            want = snr_stats.snr_stats_centered_batched_plain(v3, axis=cn.axis)
            tag = f"{name} {label} {tuple(v3.shape)} axis {cn.axis}"
            errs = [check(f"{tag} {s}", a, w, TOL_LINE) for s, a, w in zip(("s1", "s1c", "s2c"), got, want)]
            n, lines = v3.numel(), got[0].numel()
            ms = timer(lambda: snr_stats.snr_stats_centered_batched(v3, axis=cn.axis), reps=5)
            plain_ms = timer(lambda: snr_stats.snr_stats_centered_batched_plain(v3, axis=cn.axis), reps=3)
            lib_ms = timer(lambda: torch.var_mean(v3, dim=red, correction=0), reps=5)
            bound = max((4 * n + 12 * lines) / rate, 5 * n / F64_RATE) * 1e3
            log(f"  {tag}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound:.4f} ms  "
                f"var_mean {lib_ms:.4f} ms")
            snr["candidates"].append(dict(param=name, k=label, shape=list(v3.shape), axis=cn.axis, ms=ms,
                                          plain_ms=plain_ms, bound_ms=bound, library_ms=lib_ms))
            snr["err"] = max(snr["err"], *errs)
            for k, t in (("ms", ms), ("plain_ms", plain_ms), ("bound_ms", bound), ("library_ms", lib_ms)):
                snr[k] += t
            del x, v3, got, want
    if len(snr["candidates"]) != 21:
        raise AssertionError(f"expected 21 SNR candidates, got {len(snr['candidates'])}")
    torch.cuda.empty_cache()

    # -- 3. the main path -----------------------------------------------------
    data = ZipfLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=1024, global_batch=8, seed=0))
    lr = 1e-3

    def drive(optimizer, steps, expect, *, rules=None, measure_snr=False):
        """Run one trainer through the port's entry point with the launch
        counters zeroed just before and read just after."""
        tc = TrainerConfig(total_steps=steps, log_every=1, measure_snr=measure_snr, snr_early_every=3,
                           backend="fused", seed=0)
        # Peak memory counts from before the trainer allocates its parameters
        # and optimizer state, less what earlier phases still hold.
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tr = Trainer(cfg, optimizer, lr, data, tc, rules=rules)
        if [(k, tuple(p.shape)) for k, p in tr.params.items()] != [(k, s.shape) for k, s in specs.items()]:
            raise AssertionError(f"{optimizer}: trainer parameters differ from the specs the plans were made from")
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        tr.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        losses = [m["loss"] for m in tr.metrics_log]
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        inner = tr.opt_state.inner_states[1]
        nu_gib = sum(t.numel() * t.element_size() for t in inner.nu.values()) / 2**30
        log(f"  {optimizer}: {steps} steps in {wall:.2f} s, losses {[round(x, 4) for x in losses]}, "
            f"launches {counts}, peak memory {peak:.2f} GiB, second moments {nu_gib:.4f} GiB ({kind})")
        if len(losses) != steps or not all(map(math.isfinite, losses)):
            raise AssertionError(f"{optimizer}: losses not finite: {losses}")
        for k, want in expect(tr).items():
            if counts[k] != want:
                raise AssertionError(f"{optimizer}: {k} launched {counts[k]} times, expected {want}")
        return tr, dict(steps=steps, wall_s=wall, losses=losses, launches=counts, peak_gib=peak, nu_gib=nu_gib)

    log("[3] main path: full-width gpt_small, batch 8 x 1024, bf16 activations, backend='fused'")
    main = {}
    adam_tr, main["adam"] = drive("adam", 6, lambda tr: {
        "mega_adam_update": 6, "mega_slim_update_batched": 0, "snr_stats_centered_batched": 21 * 2},
        measure_snr=True)
    if adam_tr.snr.steps != [3, 6]:
        raise AssertionError(f"SNR measured at steps {adam_tr.snr.steps}, expected [3, 6]")
    rules = adam_tr.derive_slim_rules()
    for label, r in (("table3", table3_rules(meta)), ("derived", rules)):
        s = second_moment_savings(adam_tr.params, adam_tr.meta, r)
        log(f"  {label} rules save {s['saved_fraction']:.5%} of second moments "
            f"({int(s['stored_second_moments'])} of {int(s['total_second_moments'])} stored)")
        main[f"savings_{label}"] = s
    main["derived_rules"] = {k: list(v) if v else None for k, v in rules.items()}
    log(f"  derived rules: {main['derived_rules']}")

    adam_state = adam_tr.opt_state
    del adam_tr
    torch.cuda.empty_cache()
    log("[3] megaplan kernels on the derived-rules plan's groups not held yet, each against its plain twin")
    derived_plan = plan_for(rules)
    hold_plan("SlimAdam derived-rules", derived_plan)
    dd = sum(g.kind == "dense" for g in derived_plan.groups)
    sd = len(derived_plan.groups) - dd
    slim_tr, main["slim"] = drive("slim", 4, lambda tr: {
        "mega_adam_update": 4, "mega_slim_update_batched": 4 * 3, "snr_stats_centered_batched": 0})
    slim_state = slim_tr.opt_state
    del slim_tr
    torch.cuda.empty_cache()
    snr_tr, main["slim_snr"] = drive("slim_snr", 4, lambda tr: {
        "mega_adam_update": 4 * dd, "mega_slim_update_batched": 4 * sd, "snr_stats_centered_batched": 0},
        rules=rules)

    # One fused update against the plain 'jnp' backend, from the same state
    # and gradients (launches here are outside the counted runs).
    log("[3] one fused optimizer update against the plain 'jnp' backend, same state and gradients")
    params = snr_tr.params
    loss, _ = lm_loss(cfg, params, snr_tr.batch(100), forward)
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    del loss
    step_check = {}
    t3_dims, derived_dims = rules_to_dims(table3_rules(meta), meta), rules_to_dims(rules, meta)
    for label, make, state in (("adam", lambda b: scale_by_adam(b2=0.95, backend=b), adam_state.inner_states[1]),
                               ("slim", lambda b: scale_by_slim_adam(t3_dims, backend=b),
                                slim_state.inner_states[1]),
                               ("slim_snr", lambda b: scale_by_slim_adam(derived_dims, backend=b),
                                snr_tr.opt_state.inner_states[1])):
        with torch.no_grad():
            uf, sf = make("fused").update(grads, state)
            uj, sj = make("jnp").update(grads, state)
        worst = {}
        for what, a, b in (("u", uf, uj), ("m", sf.mu, sj.mu), ("v", sf.nu, sj.nu)):
            worst[what] = max(max_err(a[k], b[k])[1] for k in a)
            if worst[what] > TOL_STEP:
                raise AssertionError(f"{label} fused vs jnp {what}: rel err {worst[what]:.3e} > {TOL_STEP:.0e}")
        log(f"  {label}: worst relative error u {worst['u']:.3e}  m {worst['m']:.3e}  v {worst['v']:.3e}  "
            f"tol {TOL_STEP:.0e}  ok")
        step_check[label] = worst
    main["fused_vs_jnp"] = step_check

    # Step time and the optimizer's share of it (outside the counted runs).
    log(f"[3] step timing ({smi})")
    timing_runs = {}
    snr_tr.tc.measure_snr = False

    def step_ms(tr, n=3):
        tr.run(tr.step + 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.run(tr.step + n)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    def profile_steps(tr, wall_ms, n=2):
        return profile_device(torch, lambda: tr.run(tr.step + 1), n, wall_ms, "step")

    t0 = time.perf_counter()
    for k in range(3):
        data.batch(1000 + k)
    timing_runs["batch_host_ms"] = (time.perf_counter() - t0) / 3 * 1e3
    log(f"  host data pipeline (ZipfLM batch 8 x 1024): {timing_runs['batch_host_ms']:.2f} ms per batch")
    timing_runs["slim_snr_step_ms"] = step_ms(snr_tr)
    upd = timer(lambda: snr_tr.tx.update(grads, snr_tr.opt_state, params), reps=5)
    timing_runs["slim_snr_optimizer_ms"] = upd
    del snr_tr
    torch.cuda.empty_cache()
    for optimizer, rules_ in (("adam", None), ("slim", None)):
        tr = Trainer(cfg, optimizer, lr, data, TrainerConfig(total_steps=1, backend="fused", seed=0), rules=rules_)
        s_ms = step_ms(tr)
        loss, _ = lm_loss(cfg, tr.params, tr.batch(0), forward)
        g = dict(zip(tr.params, torch.autograd.grad(loss, list(tr.params.values()))))
        del loss
        with torch.no_grad():
            upd = timer(lambda: tr.tx.update(g, tr.opt_state, tr.params), reps=5)
            inner = tr.opt_state.inner_states[1]
            if optimizer == "adam":
                fused_tx, plan = scale_by_adam(b2=0.95, backend="fused"), adam_plan
            else:
                fused_tx, plan = scale_by_slim_adam(t3_dims, backend="fused"), t3_plan
            kernel_ms = sum(held[group_key(g)]["ms"] for g in plan.groups)
            precond = timer(lambda: fused_tx.update(g, inner), reps=5)
        if optimizer == "adam":
            timing_runs["adam_profile"] = profile_steps(tr, s_ms)
        timing_runs[f"{optimizer}_step_ms"] = s_ms
        timing_runs[f"{optimizer}_optimizer_ms"] = upd
        timing_runs[f"{optimizer}_precond_ms"] = precond
        timing_runs[f"{optimizer}_precond_outside_kernels_ms"] = precond - kernel_ms
        log(f"  {optimizer}: step {s_ms:.2f} ms, optimizer update {upd:.3f} ms ({upd / s_ms:.1%} of the step), "
            f"fused preconditioner {precond:.3f} ms of which {precond - kernel_ms:.3f} ms outside the kernels "
            f"(gather/scatter, bias lines)")
        del tr, g
        torch.cuda.empty_cache()
    log(f"  slim_snr: step {timing_runs['slim_snr_step_ms']:.2f} ms, optimizer update "
        f"{timing_runs['slim_snr_optimizer_ms']:.3f} ms")
    main["timing"] = timing_runs

    # A small input against a reference: reduced gpt_small (f32), 5 SlimAdam
    # steps on the card (fused kernels) and on the CPU (plain 'jnp' backend).
    log("[3] reduced gpt_small, 5 SlimAdam steps: card (fused kernels) against CPU (plain jnp backend)")
    rcfg = get_reduced("gpt_small")
    rdata = ZipfLM(DataConfig(vocab_size=rcfg.vocab_size, seq_len=64, global_batch=8, seed=1))
    curves = {}
    for device, backend in (("cuda", "fused"), ("cpu", "jnp")):
        tr = Trainer(rcfg, "slim", 3e-3, rdata, TrainerConfig(total_steps=5, log_every=1, backend=backend),
                     device=device)
        tr.run()
        curves[device] = [m["loss"] for m in tr.metrics_log]
    err = max(abs(a - b) / abs(b) for a, b in zip(curves["cuda"], curves["cpu"]))
    log(f"  losses card {curves['cuda']}\n  losses cpu  {curves['cpu']}\n  worst relative difference {err:.3e} "
        f"tol {TOL_SMALL_RUN:.0e}")
    if not err <= TOL_SMALL_RUN:
        raise AssertionError(f"reduced run: card and CPU loss curves differ by {err:.3e}")
    main["reduced_card_vs_cpu"] = dict(curves=curves, worst_rel=err)
    report["main_path"] = main
    report["kernels_detail"] = dict(groups=list(held.values()), snr=snr)
    del rdata, curves
    torch.cuda.empty_cache()
    report["serve"], paged_entry = serve_phases(torch, timer, rate, smi)

    # -- 6. result lines ------------------------------------------------------
    # Times per step of the main path: B2 on Adam's one dense group, B1 summed
    # over the Table-3 plan's three slim groups, B5 over one SNR measurement.
    # Errors are the worst over every group the main path launched on.
    launches = {k: main["adam"]["launches"][k] + main["slim"]["launches"][k] + main["slim_snr"]["launches"][k]
                for k in main["adam"]["launches"]}
    src = "src/repro_torch/kernels/csrc/"

    def group_entry(name, plan, source, replaces):
        return {"name": name, "route": "cuda", "source": src + source, "replaces": replaces,
                "launches": launches[name],
                "max_abs_err": max(h["err"] for h in held.values() if h["kernel"] == name),
                "ms": plan_sum(plan, name, "ms"), "plain_ms": plan_sum(plan, name, "plain_ms"),
                "bound_ms": plan_sum(plan, name, "bound_ms"), "bound_by": "bytes",
                "library_ms": plan_sum(plan, name, "library_ms") if name == "mega_adam_update" else None}

    line = {"kernels": [
        group_entry("mega_adam_update", adam_plan, "mega_adam.cu", "src/repro/kernels/megaplan.py:351"),
        group_entry("mega_slim_update_batched", t3_plan, "mega_slim.cu", "src/repro/kernels/megaplan.py:417"),
        {"name": "snr_stats_centered_batched", "route": "cuda", "source": src + "snr_stats.cu",
         "replaces": "src/repro/kernels/snr_stats.py:133", "launches": launches["snr_stats_centered_batched"],
         "max_abs_err": snr["err"], "ms": snr["ms"], "plain_ms": snr["plain_ms"], "bound_ms": snr["bound_ms"],
         "bound_by": "bytes", "library_ms": snr["library_ms"]},
        paged_entry,
    ]}
    report["kernels"] = line
    report["device"] = smi
    report["seconds"] = time.perf_counter() - t_start
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_report.json").write_text(json.dumps(report, indent=1, default=str))
    log(f"[6] done in {report['seconds']:.0f} s; report in build/chip_smoke_report.json")
    log(json.dumps(line))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
