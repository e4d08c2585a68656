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
   one PyTorch call computes the same function, that call's time. B5's
   total over the 21 candidates is printed against ``torch.var_mean``'s
   total and the bound (the share of the bound reached).
2b. The fault-tolerant slice's kernels against their plain twins on
   gradients seeded with a known number of NaN and +-Inf entries (counts
   held exactly): ``mega_adam_update(with_health)`` (B2) on Adam's dense
   group, ``mega_slim_update_batched`` with ``with_snr``, ``with_health``
   and both (B1) on the Table-3 slim groups, ``adam_precond`` (B3, with
   and without health) on the per-leaf route's views of the leaves, its
   small-leaf bucket and a ragged bf16 leaf, and ``slim_precond_batched``
   (B4, axis 0 and 1, batch 12, bf16, ``with_snr`` and ``with_health``) on
   the per-leaf Table-3 views; timed as in phase 2, B3 beside
   ``Adam(fused=True)`` on the same tensors.
3. Main path through the port's entry points, full-width gpt_small (depth
   not cut, random weights from a seed), batch 8 x seq 1024, bf16
   activations, ``backend="fused"``: 6 Adam steps measuring SNR at steps 3
   and 6, ``derive_slim_rules`` (whose plan's new groups are then held as in
   phase 2), 4 SlimAdam steps with Table-3 rules and 4 with the derived
   rules. Launch counters are zeroed before and read after each run and
   must show every kernel of the path. Then one fused optimizer update
   against the plain 'jnp' backend from the same state for each of the
   three optimizers, a small reduced-model run on the card against the
   CPU, and step timings, among them one SNR measurement of Adam's moments
   (``measure_tree_snr``, backend 'fused') in turns with a plain step, and
   its device profile (busy share, kernels by name).
3b. Guarded training at full width, batch 8 x 1024 as ``grad_accum=2``:
   Adam measuring SNR and SlimAdam (Table 3) with from-update SNR, each 8
   steps under ``FaultPlan(nan_grad_steps=(3,), spike_steps=(6,))`` with
   checkpoints every 2 steps. The NaN step must leave parameters, moments
   and count bit-identical with every gradient entry counted non-finite by
   the kernels; the guard counters must be what the plan implies; the
   from-update SNR of each compressed leaf must match the plain math on the
   same g and v' (1e-4); no kernel may degrade; checkpoint bytes on disk.
3c. Resume: a second Trainer on a guarded run's checkpoint directory
   resumes at its latest step, and its next two losses match the
   uninterrupted run's (1e-4).
3d. The per-leaf route (``megakernel=False``): guarded Adam and SlimAdam
   runs through B3 and B4, then one update against the megaplan route from
   the same state (1e-5), with launches and times per update on each.
3e. Kernel-failure drill: with ``inject_kernel_failure()`` installed, every
   leaf of the plan's groups degrades (counted) and the run equals
   ``backend="jnp"`` (1e-5); without the hook the count resets and the
   kernels launch again. 3f: step times, plain against guarded, and a
   SlimAdam measure step with from-update SNR against one with B5.
   Launch counters are zeroed before and read after each counted run of
   phases 3b-3d; every kernel of the slice must have launched.
4. ``paged_attention`` (B14) against its plain twin at full-width
   smollm_135m shapes (9 heads over 3 KV groups, hd 64, pages of 16,
   128-page table rows): f32 queries over bf16 and f32 pools, and the
   serving path's bf16 queries over a bf16 pool (the tensor-core form in
   prefill); a decode batch of 16 ragged rows (one empty, one ending
   mid-page) and 128-token prefill chunks at pos0 = 0 and at pos0 = 1024
   with 100 valid tokens. Each case runs twice and the two outputs must be
   bit-equal. Timed as in phase 2, beside the bound and
   ``scaled_dot_product_attention`` on K/V gathered dense (gather untimed).
5. The serving main path through ``repro_torch.serve.Engine`` on the card:
   full-width smollm_135m (30 layers, random weights from seed 0), 32
   requests of 64 new tokens (28 greedy, 4 sampled) over 16 slots and a pool
   small enough to preempt. Every request must finish by length with no
   page left used, and ``paged_attention`` must launch 30 times per decode
   step and prefill chunk. Then decode-step and prefill-chunk times and a
   device profile of decode steps and prefill chunks, with B14's share;
   the logits of a prefill chunk and of 4 decode steps through the kernel
   against the plain twin from the same state; and reduced f32 smollm_135m
   and gpt_small served on the card against the CPU, token for token.
6. The sharded slice: 4 processes share the card as the ranks of a
   (data=2, model=2) mesh (``repro_torch.launch.mesh``; gloo, since NCCL
   refuses two ranks on one device; all-reduce and all-gather on the device
   tensors), full-width gpt_small with the
   global batch 8 x 1024 split 2 rows per rank. 6a: B9-B13 against their
   twins on each rank's local shards of the Table-3 plan's 7 psum leaves
   (B10 base, ``with_snr``, ``with_health``; B11 ek and owner; B12 and B13
   on the psum groups; B9 on the 21 SNR candidates, whose lines the mesh
   splits), non-finite counts exact, then each kernel timed on rank 0 alone
   (B9's total over its 21 candidates against ``torch.var_mean``'s).
   6b: a sharded Table-3 SlimAdam update and a sharded Adam update against
   the port's unsharded update of the same whole gradients (local leaves
   and Adam bit-equal, psum leaves within 2e-6), the per-leaf route against
   the grouped one. 6c: the sharded trainer, each run's launch counters
   zeroed before and read after: Adam measuring SNR (B9), derived rules,
   SlimAdam with them and from-update SNR, Table-3 SlimAdam (B12/B13), its
   per-leaf route (B10/B11), a guarded step with an injected NaN that must
   leave every rank's shards bit-identical; losses against the unsharded
   port on the same batches (1e-4). 6d: a checkpoint saved on the mesh,
   restored on the mesh (bit-equal shards) and unsharded (equal crc32s).
   6e: the sharded step's time, 4 ranks on one card (not a multi-GPU
   number), and the gradient all-reduce's. A rank that fails ends the run.
7. The SSM serving path: ``ssm_scan`` (B15) against its plain twin at the
   eval shape (1 x 2048 x 8192, N 16) and the decode shape (4 rows, S = 1,
   a random h0), timed as in phase 2 beside its bound (bytes, or its
   exponentials over the SFU rate); then full-width, full-depth
   falcon_mamba_7b (64 layers, 7,006,326,784 parameters, 28.0 GB in f32)
   initialised on the card from a seeded CUDA generator: ``make_eval_step``
   on a ZipfLM batch of 1 x 2048 (finite loss, 64 B15 launches), and
   ``Engine.generate``'s legacy loop on 4 ZipfLM prompts of 64 tokens with
   32 greedy new tokens (64 launches per ``decode_step``, 64 + 31 steps);
   decode-step time, tokens/s, the device-busy share (torch.profiler) and
   the SSM cache's bytes. Then a 4-layer cut at full width: logits of the
   eval batch and of 8 decode steps through B15 against the plain twin;
   and reduced f32 falcon_mamba_7b served on the card against the CPU,
   token for token. The model is freed before phase 8.
8. The parameter-writing API: ``fused_adam_op`` (B6) over every full-width
   gpt_small leaf, ``slim_update_nd`` (B7) over its Table-3 compressed
   leaves, ``fused_adam_op`` and ``slim_update_op`` (axis 0 and 1) on
   benchmarks/opt_speed.py's 4096 x 8192 tensor with wd 0.1 and f32 and
   bf16 p, ``snr_stats`` (B8) over the Adam v lines, with the launch
   counters zeroed before and read after; each against its plain twin, p'
   against ``adam_precond`` / ``slim_precond_batched`` followed by the same
   step, and timed beside its bound and ``AdamW(fused=True)`` (B6) or
   ``torch.var_mean`` (B8).
9. One ``{"kernels": [...]}`` line (all 15 kernels, B1 and B2 with their
   flags on rows of their own), the ``nvidia-smi`` line, and last the
   ``{"ok": true, "device": ...}`` line.

TF32 is off for every phase (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``), so f32 matrix products are full f32.
A detailed report goes to ``build/chip_smoke_report.json`` (git-ignored).
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Peak rates (NVIDIA data sheets, dense, SXM parts at 700 W unless named):
# device memory bytes/s by card, f32 and f64 operations/s outside the tensor
# cores for the H100.
MEM_RATE = {"H100 PCIe": 2.0e12, "H100 NVL": 3.9e12, "H200": 4.8e12, "H100": 3.35e12}
F32_RATE = 67e12
F64_RATE = 34e12
BF16_TC_RATE = 989e12    # dense bf16 on the tensor cores

TOL_ELEMENTWISE = 1e-6   # same operation order in kernel and plain version
TOL_LINE = 1e-5          # depends on a line sum; summation order differs
TOL_STEP = 1e-5          # a whole fused update against the plain 'jnp' backend
TOL_SMALL_RUN = 1e-3     # reduced-model loss curve, card against CPU, 5 steps
TOL_SERVE_LOGITS = 5e-2  # full-width logits, kernel against plain attention: bf16 activations through 30 layers
TOL_BF16_OUT = 2.0**-7   # a bf16 attention output: kernel and twin may round one bf16 step apart
TOL_SNR = 1e-4           # from-update SNR against the plain math on the same g and v' (f64 against f32 sums)
TOL_RESUME = 1e-4        # losses after a resume: the embedding backward sums with atomics on the card

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
    L2 (50 MB) flushed by a 256 MB write before it. A ~1 ms device-side wait
    follows the flush, so the host has enqueued the call before the start
    event is reached and the time is the device's, not the host's time to
    run a Python wrapper. ``slack_cycles=0`` drops the wait (the earlier
    timer), so the span also holds the host's time to enqueue the call."""

    SLACK_CYCLES = 2_000_000

    def __init__(self, torch, slack_cycles: int = SLACK_CYCLES):
        self.torch = torch
        self.slack = slack_cycles
        self.flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")

    def __call__(self, fn, reps: int = 10) -> float:
        torch = self.torch
        fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            if self.slack:
                torch.cuda._sleep(self.slack)
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


def host_ms(torch, fn, n: int = 3) -> float:
    """Host-clock ms per call of ``fn`` over ``n`` calls, synchronised."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def in_turns(torch, variants: dict, rounds: int = 3):
    """Each variant's median ``host_ms`` over blocks run in turns (a b b a
    ...), so drift between them cancels; and every block's time."""
    for fn in variants.values():
        fn()
    times = {k: [] for k in variants}
    for r in range(rounds):
        order = list(variants) if r % 2 == 0 else list(reversed(variants))
        for k in order + list(reversed(order)):
            times[k].append(host_ms(torch, variants[k]))
    return {k: statistics.median(v) for k, v in times.items()}, times


def snr_total(kernel: str, acc: dict, n: int, where: str) -> dict:
    """Log the total of B5 or B9 over one SNR measurement's ``n``
    candidates beside torch.var_mean's and the bound; return the two
    ratios."""
    ratio, share = acc["ms"] / acc["library_ms"], acc["bound_ms"] / acc["ms"]
    log(f"  {kernel} total over the {n} candidates: kernel {acc['ms']:.4f} ms  var_mean {acc['library_ms']:.4f} ms  "
        f"bound {acc['bound_ms']:.4f} ms  kernel / var_mean {ratio:.3f}  bound reached {share:.1%}  ({where})")
    return dict(vs_var_mean=ratio, bound_share=share)


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


def paged_case(torch, gen, *, lengths, alloc, c, pool_dtype, q_dtype=None, heads=9, kv=3, hd=64, page=16,
               max_pages=128):
    """B14 operands: queries (B, C, heads, hd) (f32 unless ``q_dtype``), a
    pool holding exactly the pages that ``alloc`` positions of each row
    need, the table, and ``lengths``."""
    dev = torch.device("cuda")
    table, n_pages = page_table(torch, alloc, page, max_pages)
    pool = torch.randn((n_pages, page, 2 * kv, hd), generator=gen, device=dev).to(pool_dtype)
    q = torch.randn((len(alloc), c, heads, hd), generator=gen, device=dev).to(q_dtype or torch.float32)
    return q, pool, table, torch.tensor([int(x) for x in lengths], dtype=torch.int32, device=dev)


def paged_bound(q, pool, table, lengths, rate: float):
    """Least time (ms) for one paged-attention call on these inputs, and what
    sets it: the larger of the bytes it must move (each row's live pages,
    whole page rows of K and V for every group; q, the output, the table and
    the lengths) over the memory rate, and its operations (4 * hd per query
    head and attended key, counted causally for these lengths) over the f32
    rate, or the bf16 tensor-core rate where q and the pool are both bf16
    (the kernel may rightly use the tensor cores there)."""
    b, c, h, hd = q.shape
    page = pool.shape[1]
    reach = table.shape[1] * page
    row_bytes = pool.shape[2] * hd * pool.element_size()
    read, keys = 0, 0
    for length in lengths.tolist():
        read += -(-max(0, min(length, reach)) // page) * page * row_bytes
        keys += sum(max(0, min(length - c + i + 1, reach)) for i in range(c))
    nbytes = read + 2 * q.numel() * q.element_size() + 4 * (table.numel() + lengths.numel())
    ops_rate = BF16_TC_RATE if str(q.dtype) == str(pool.dtype) == "torch.bfloat16" else F32_RATE
    t_bytes, t_ops = nbytes / rate, 4 * h * hd * keys / ops_rate
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
    log("[4] paged_attention (B14) at full-width smollm_135m shapes against its plain twin, bound, SDPA; each case "
        "run twice, bit for bit")
    rng = np.random.default_rng(0)
    dec = rng.integers(1, 2049, 16)
    dec[0], dec[1] = 0, 16 * 37 + 5
    cases = {"decode": dict(lengths=dec, alloc=dec, c=1),
             "prefill_pos0_0": dict(lengths=[128], alloc=[128], c=128),
             "prefill_pos0_1024": dict(lengths=[1024 + 128], alloc=[1024 + 100], c=128)}
    held = {}
    types = ((torch.float32, torch.bfloat16), (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16))
    for case, kw in cases.items():
        for q_dtype, pool_dtype in types:
            q, pool, table, lengths = paged_case(torch, gen, pool_dtype=pool_dtype, q_dtype=q_dtype, **kw)
            args = (q, pool, table, lengths)
            tag = f"{case} {str(q_dtype).split('.')[-1]} q {str(pool_dtype).split('.')[-1]} pool"
            got, again, want = pa.paged_attention(*args), pa.paged_attention(*args), pa.paged_attention_plain(*args)
            torch.cuda.synchronize()
            err = check(tag, got.float(), want.float(), TOL_LINE if q_dtype == torch.float32 else TOL_BF16_OUT)
            if not torch.equal(got, again):
                raise AssertionError(f"{tag}: two runs of the kernel differ")
            if case == "decode" and got[0].any():
                raise AssertionError("decode: the empty row's output is not exactly 0")
            plan = pa.plan_of(*args)
            ms = timer(lambda: pa.paged_attention(*args), reps=20)
            plain_ms = timer(lambda: pa.paged_attention_plain(*args), reps=5)
            lib_ms = timer(sdpa_call(torch, *args), reps=20)
            bound, by = paged_bound(*args, rate)
            log(f"  {tag}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound:.4f} ms ({by})  "
                f"SDPA {lib_ms:.4f} ms  two runs bit-equal; {plan.blocks} blocks, {plan.pieces} pieces of "
                f"{plan.pages} pages a tile, {plan.launches} CUDA launch(es) a call  ({smi})")
            held[tag] = dict(case=case, q=str(q_dtype), pool=str(pool_dtype), err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bound, bound_by=by, library_ms=lib_ms, runs_bit_equal=True,
                             cuda_launches=plan.launches, plan=dataclasses.asdict(plan),
                             lengths=[int(x) for x in kw["lengths"]])
            del q, pool, table, lengths, args, got, again, want
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

    decode()
    decode_ms = host_ms(torch, decode, 10)
    prefill()
    prefill_ms = host_ms(torch, prefill, 10)
    log(f"  decode step (16 rows of {min(tl)}..{max(tl)} positions) {decode_ms:.3f} ms = "
        f"{16 / decode_ms * 1e3:.1f} decode tokens/s; prefill chunk (128 tokens at pos0 512) {prefill_ms:.3f} ms")
    run.update(decode_step_ms=decode_ms, prefill_chunk_ms=prefill_ms, decode_tokens_per_s=16 / decode_ms * 1e3,
               decode_profile=profile_device(torch, decode, 3, decode_ms, "decode step"),
               prefill_profile=profile_device(torch, prefill, 2, prefill_ms, "prefill chunk"))
    for what in ("decode", "prefill"):
        prof = run[f"{what}_profile"]
        b14 = sum(t for key, t in prof["kernels"] if "paged_" in key)
        run[f"{what}_b14_ms"] = b14
        log(f"  B14 in a {what} {'step' if what == 'decode' else 'chunk'}: {b14:.4f} ms of {prof['busy_ms']:.3f} ms "
            f"device busy ({b14 / prof['busy_ms']:.1%})")
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

    dec_b, serving = held["decode float32 q bfloat16 pool"], held["decode bfloat16 q bfloat16 pool"]
    entry = {"name": "paged_attention", "route": "cuda", "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
             "replaces": "src/repro/kernels/paged_attention.py:143", "launches": counts["paged_attention"],
             "max_abs_err": max(h["err"] for h in held.values()), "ms": dec_b["ms"], "plain_ms": dec_b["plain_ms"],
             "bound_ms": dec_b["bound_ms"], "bound_by": dec_b["bound_by"], "library_ms": dec_b["library_ms"],
             "serving_decode_ms": serving["ms"], "serving_decode_library_ms": serving["library_ms"]}
    return report, entry


# -- the fault-tolerant slice (phases 2b, 3b-3e) ----------------------------------


def check_masked(what: str, a, b, tol) -> float:
    """The same non-finite positions in ``a`` and ``b``; finite entries within
    ``tol`` of max|b| (``tol=None``: equal)."""
    import torch

    fa, fb = torch.isfinite(a), torch.isfinite(b)
    if not torch.equal(fa, fb):
        raise AssertionError(f"{what}: non-finite entries at different positions")
    if tol is None:
        if not torch.equal(a[fa], b[fb]):
            raise AssertionError(f"{what}: not equal")
        log(f"  {what}: equal")
        return 0.0
    return check(what, torch.where(fa, a, 0.0), torch.where(fb, b, 0.0), tol)


def poison(torch, x, n_bad: int, seed: int):
    """``x`` with ``n_bad`` distinct entries set to NaN, +Inf, -Inf in turn."""
    x = x.clone()
    flat = x.view(-1)
    idx = torch.randperm(flat.numel(), generator=torch.Generator().manual_seed(seed))[:n_bad].to(x.device)
    vals = torch.tensor([float("nan"), float("inf"), float("-inf")], device=x.device, dtype=x.dtype)
    flat[idx] = vals[torch.arange(n_bad, device=x.device) % 3]
    return x


def robust_kernels(torch, timer, rate, gen, specs, meta, adam_plan, t3_plan, t3_dims):
    """Phase 2b: B2's and B1's flags on the main path's megaplan groups, B3
    and B4 on the per-leaf route's views of the gpt_small leaves, each
    against its plain twin on gradients seeded with NaN/Inf. Returns
    {entry name: parity and timing}."""
    from repro_torch.kernels import fused_adam, megaplan, slim_update
    from repro_torch.kernels.ops import canon_apply, canon_nd
    from repro_torch.optim.fused import DEFAULT_BUCKET_MIN, bias_corrections

    kw = dict(b1=0.9, b2=0.95, eps=1e-8)
    dev = torch.device("cuda")
    count = torch.tensor(3, dtype=torch.int32, device=dev)
    bc1, bc2 = bias_corrections(0.9, 0.95, count)
    out = {}

    def inputs(shape, line, n_bad, seed):
        g = poison(torch, 1e-3 * torch.randn(shape, generator=gen, device=dev), n_bad, seed)
        return g, 1e-4 * torch.randn(shape, generator=gen, device=dev), 1e-6 * torch.rand(line, generator=gen, device=dev)

    def add(name, **row):
        acc = out.setdefault(name, dict(err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=None, cases=[]))
        acc["err"] = max(acc["err"], row["err"])
        for k in ("ms", "plain_ms", "bound_ms"):
            acc[k] += row[k]
        acc["cases"].append(row)

    def hold_outputs(tag, got, want, tols):
        """Hold outputs in order; tolerance None = exact (the nf lines)."""
        errs = []
        for (label, tol), a, w in zip(tols, got, want):
            errs.append(check_masked(f"{tag} {label}", a, w, tol))
        return max(errs)

    # B2 with_health on Adam's dense group, and B1's flags on the Table-3 slim groups
    log("[2b] B2 with_health and B1 with_snr/with_health on the main path's groups, plain twin, bound")
    for group in adam_plan.groups + tuple(g for g in t3_plan.groups if g.kind != "dense"):
        b, r, c = group.batch, group.rows, group.cols
        dense = group.kind == "dense"
        shape = (r, c) if dense else (b, r, c)
        line = (r, 1) if dense else (b, r, 1) if group.axis == 1 else (b, 1, c)
        n_bad = 3000
        g, m, v = inputs(shape, shape if dense else line, n_bad, r)
        args = (g, m, v, bc1.expand(line).contiguous(), bc2.expand(line).contiguous())
        n, lines = g.numel(), math.prod(line)
        flag_sets = [dict(with_health=True)] if dense else [dict(with_snr=True), dict(with_health=True),
                                                             dict(with_snr=True, with_health=True)]
        for flags in flag_sets:
            if dense:
                name = "mega_adam_update(with_health)"
                run = lambda: megaplan.mega_adam_update(*args, **flags, **kw)              # noqa: E731
                plain = lambda: megaplan.mega_adam_update_plain(*args, **flags, **kw)      # noqa: E731
                tols = [("u", TOL_ELEMENTWISE), ("m'", TOL_ELEMENTWISE), ("v'", TOL_ELEMENTWISE)]
                nbytes = 24 * n + 16 * lines
            else:
                name = "mega_slim_update_batched(" + ",".join(sorted(flags)) + ")"
                run = lambda: megaplan.mega_slim_update_batched(*args, axis=group.axis, **flags, **kw)      # noqa
                plain = lambda: megaplan.mega_slim_update_batched_plain(*args, axis=group.axis, **flags, **kw)  # noqa
                tols = [("u", TOL_LINE), ("m'", TOL_ELEMENTWISE), ("v'", TOL_LINE)]
                if flags.get("with_snr"):
                    tols += [("s1c", TOL_LINE), ("s2c", TOL_LINE)]
                nbytes = 16 * n + 16 * lines + 8 * lines * len(flags)
            if flags.get("with_health"):
                tols += [("nf", None), ("ss", TOL_LINE)]
            got, want = run(), plain()
            tag = f"{name} {group.kind} {shape}"
            err = hold_outputs(tag, got, want, tols)
            if flags.get("with_health") and float(got[-2].double().sum()) != n_bad:
                raise AssertionError(f"{tag}: {float(got[-2].double().sum())} non-finite counted, {n_bad} seeded")
            ms, plain_ms = timer(run), timer(plain, reps=3)
            bound = nbytes / rate * 1e3
            log(f"  {tag}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound:.4f} ms")
            add(name, kind=group.kind, shape=list(shape), err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound)
            del got, want
        del g, m, v, args

    # B3 on the per-leaf Adam route's views: the large leaves one by one, the
    # small leaves as one bucket, and a ragged bf16 leaf
    log("[2b] adam_precond (B3) on the per-leaf route's views, with and without health, plain twin, bound, "
        "Adam(fused=True)")
    big = [tuple(s.shape) for s in specs.values() if math.prod(s.shape) >= DEFAULT_BUCKET_MIN]
    small = sum(math.prod(s.shape) for s in specs.values() if math.prod(s.shape) < DEFAULT_BUCKET_MIN)
    views = [(shape[0] if len(shape) == 2 else math.prod(shape[:-1]), shape[-1]) for shape in big]
    views += [(1, small)]
    lib_tensors = []
    for rows, cols in views + [(1001, 333)]:
        extra = (rows, cols) == (1001, 333)
        for dtype in ((torch.bfloat16,) if extra else (torch.float32,)):
            g, m, v = inputs((rows, cols), (rows, cols), 77, rows + cols)
            g = g.to(dtype)
            n = g.numel()
            for health in (False, True):
                run = lambda: fused_adam.adam_precond(g, m, v, count=count, with_health=health, **kw)          # noqa
                plain = lambda: fused_adam.adam_precond_plain(g, m, v, bc1, bc2, with_health=health, **kw)  # noqa
                got, want = run(), plain()
                tag = f"adam_precond {(rows, cols)} {str(dtype).split('.')[-1]} health={health}"
                err = hold_outputs(tag, got[:3], want[:3], [("u", TOL_ELEMENTWISE), ("m'", TOL_ELEMENTWISE),
                                                            ("v'", TOL_ELEMENTWISE)])
                if health:
                    if float(got[3][0]) != 77 or float(want[3][0]) != 77:
                        raise AssertionError(f"{tag}: nf {float(got[3][0])} (plain {float(want[3][0])}), 77 seeded")
                    err = max(err, check(f"{tag} ss", got[3][1:], want[3][1:], TOL_LINE))
                ms, plain_ms = timer(run), timer(plain, reps=3)
                bound = (n * (g.element_size() + 20) + (8 if health else 0)) / rate * 1e3
                log(f"  {tag}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound:.4f} ms")
                if not extra:
                    add("adam_precond(with_health)" if health else "adam_precond", shape=[rows, cols], err=err,
                        ms=ms, plain_ms=plain_ms, bound_ms=bound)
                else:
                    out.setdefault("adam_precond_ragged_bf16", {})[str(health)] = dict(err=err, ms=ms,
                                                                                       plain_ms=plain_ms, bound_ms=bound)
                del got, want
            if not extra:
                p = torch.zeros(n, device=dev, requires_grad=True)
                p.grad = g.float().reshape(-1).nan_to_num()
                lib_tensors.append(p)
            del g, m, v
    opt = torch.optim.Adam(lib_tensors, lr=1e-3, betas=(0.9, 0.95), eps=1e-8, fused=True)
    lib_ms = timer(opt.step)
    for name in ("adam_precond", "adam_precond(with_health)"):
        out[name]["library_ms"] = lib_ms
    log(f"  the route's {len(views)} views: Adam(fused=True) over the same tensors, one call: {lib_ms:.4f} ms")
    del opt, lib_tensors

    # B4 on the per-leaf SlimAdam route's canonical views
    log("[2b] slim_precond_batched (B4) on the per-leaf Table-3 route's views, plain twin, bound")
    for name_leaf, spec in specs.items():
        dims = t3_dims[name_leaf]
        if not dims:
            continue
        cn = canon_nd(spec.shape, dims)
        shape3 = (cn.batch, cn.rows, cn.cols)
        line = (cn.batch, cn.rows, 1) if cn.axis == 1 else (cn.batch, 1, cn.cols)
        dtypes = (torch.float32, torch.bfloat16) if cn.batch > 1 else (torch.float32,)
        for dtype in dtypes:
            g, m, v = inputs(shape3, line, 101, cn.rows)
            g = g.to(dtype)
            n, lines = g.numel(), math.prod(line)
            for flags in (dict(with_health=True), dict(with_snr=True, with_health=True)):
                run = lambda: slim_update.slim_precond_batched(g, m, v, axis=cn.axis, count=count, **flags, **kw)  # noqa
                plain = lambda: slim_update.slim_precond_batched_plain(g, m, v, bc1, bc2, axis=cn.axis, **flags,  # noqa
                                                                       **kw)
                got, want = run(), plain()
                tag = (f"slim_precond_batched {name_leaf} {shape3} axis {cn.axis} {str(dtype).split('.')[-1]} "
                       f"{'+'.join(sorted(flags))}")
                tols = [("u", TOL_LINE), ("m'", TOL_ELEMENTWISE), ("v'", TOL_LINE)]
                tols += [("s1c", TOL_LINE), ("s2c", TOL_LINE)] if flags.get("with_snr") else []
                err = hold_outputs(tag, got[:-1], want[:-1], tols)
                if float(got[-1][0]) != 101 or float(want[-1][0]) != 101:
                    raise AssertionError(f"{tag}: nf {float(got[-1][0])} (plain {float(want[-1][0])}), 101 seeded")
                err = max(err, check(f"{tag} ss", got[-1][1:], want[-1][1:], TOL_LINE))
                ms, plain_ms = timer(run), timer(plain, reps=3)
                bound = (n * (g.element_size() + 12) + lines * (16 + 8 * len(flags)) + 8) / rate * 1e3
                log(f"  {tag}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound:.4f} ms")
                if dtype == torch.float32:
                    add("slim_precond_batched(" + ",".join(sorted(flags)) + ")", leaf=name_leaf, shape=list(shape3),
                        axis=cn.axis, err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound)
                else:
                    out.setdefault("slim_precond_batched_bf16", {})["+".join(sorted(flags))] = dict(
                        err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound)
                del got, want
            del g, m, v
    torch.cuda.empty_cache()
    return out


def robust_phases(torch, timer, smi, cfg, specs, meta, data, lr, t3_plan, t3_dims):
    """Phases 3b-3f through the port's entry points at full width. Returns
    the report; each counted run's launches are in it."""
    import shutil

    from repro_torch import kernels
    from repro_torch.core.slim_adam import scale_by_slim_adam
    from repro_torch.models import forward
    from repro_torch.optim import fused
    from repro_torch.optim.adam import scale_by_adam
    from repro_torch.optim.base import EmptyState, clip_by_global_norm
    from repro_torch.train import FaultPlan, GuardConfig, Trainer, TrainerConfig, inject_kernel_failure
    from repro_torch.train.loss import lm_loss

    report: dict = {}
    numel = sum(math.prod(s.shape) for s in specs.values())
    ckpt_root = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt_root, ignore_errors=True)
    guard = GuardConfig(max_bad_steps=2, min_history=4)
    plan = FaultPlan(nan_grad_steps=(3,), spike_steps=(6,))
    n_steps = 8

    def trainer(optimizer, *, faults=None, okw=None, **tc_kw):
        tc = TrainerConfig(**{**dict(total_steps=n_steps, log_every=1, backend="fused", seed=0, guard=guard),
                              **tc_kw})
        tr = Trainer(cfg, optimizer, lr, data, tc, grad_accum=2, faults=faults, optimizer_kw=okw)
        if [(k, tuple(p.shape)) for k, p in tr.params.items()] != [(k, s.shape) for k, s in specs.items()]:
            raise AssertionError(f"{optimizer}: trainer parameters differ from the specs")
        return tr

    def counted(fn):
        """Run ``fn`` with the launch counters zeroed before and read after."""
        kernels.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        return kernels.launch_counts()

    def accumulated_grads(tr, step):
        """The step's gradients as the trainer forms them: two microbatches
        of the batch, accumulated in f32, then the chain's global-norm clip."""
        acc = {k: torch.zeros(p.shape, device=p.device) for k, p in tr.params.items()}
        batch = tr.batch(step)
        for micro in zip(*(v.chunk(2) for v in batch.values())):
            loss, _ = lm_loss(cfg, tr.params, dict(zip(batch, micro)), forward)
            for k, g in zip(acc, torch.autograd.grad(loss, list(tr.params.values()))):
                acc[k] = acc[k] + g.float() / 2
        return clip_by_global_norm(1.0).update(acc, EmptyState())[0]

    def state_of(tr):
        inner = tr.opt_state.inner_states[1]
        return [p.detach().clone() for p in tr.params.values()] + [t.clone() for t in inner.mu.values()] \
            + [t.clone() for t in inner.nu.values()] + [inner.count.clone()]

    # -- 3b. guarded runs with faults, checkpoints, from-update SNR -----------
    log(f"[3b] guarded training, full-width gpt_small, batch 8 x 1024 as grad_accum=2, {plan}, "
        f"GuardConfig(max_bad_steps=2, min_history=4), checkpoints every 2 steps")
    ft = {}
    for optimizer in ("adam", "slim"):
        fused.reset_kernel_degradation()
        tc_kw = dict(measure_snr=True, snr_early_every=2, ckpt_every=2, ckpt_keep=2,
                     ckpt_dir=str(ckpt_root / optimizer), snr_from_update=optimizer == "slim")
        tr = trainer(optimizer, faults=plan, **tc_kw)
        snr_check = {}
        t0 = time.perf_counter()

        def drive():
            tr.run(1)
            if optimizer == "slim":     # step 1 is a measure step: its SNR rides the update
                inner = tr.opt_state.inner_states[1]
                gc = accumulated_grads(tr, 1)
                with torch.no_grad():
                    for k, d in t3_dims.items():
                        if d:
                            v_new = fused.jnp_slim_leaf(gc[k], inner.mu[k], inner.nu[k], d, b1=0.9, b2=0.95,
                                                        eps=1e-8, count=inner.count + 1)[2]
                            snr_check[k] = float(fused.jnp_update_snr_leaf(gc[k], v_new, d, b2=0.95))
                del gc
            tr.run(3)
            before = state_of(tr)
            tr.run(4)                   # step 3: NaN gradients
            after = state_of(tr)
            if not all(torch.equal(a, b) for a, b in zip(before, after)):
                raise AssertionError(f"{optimizer}: the NaN step changed parameters, moments or count")
            snr_check["nan_step"] = dict(tr.metrics_log[-1])
            tr.run()

        counts = counted(drive)
        wall = time.perf_counter() - t0
        nan_step = snr_check.pop("nan_step")
        stats = tr.guard.stats()
        want = dict(guard_skipped=1.0, guard_spikes=1.0, guard_backoffs=1.0, guard_rollbacks=0.0,
                    guard_nonfinite_total=float(numel))
        got = {k: stats[k] for k in want}
        losses = [m["loss"] for m in tr.metrics_log]
        log(f"  {optimizer}: {n_steps} guarded steps in {wall:.2f} s, losses {[round(x, 4) for x in losses]}, "
            f"guard {stats}, SNR at steps {tr.snr.steps}, launches {counts}")
        if got != want or nan_step["step_skipped"] != 1.0 or nan_step["nonfinite_count"] != numel:
            raise AssertionError(f"{optimizer}: guard counters {got}, NaN step {nan_step}; expected {want} and "
                                 f"{numel} non-finite entries counted by the kernels")
        log(f"  {optimizer}: the NaN step was skipped with parameters, moments and count bit-identical; the "
            f"kernels counted {nan_step['nonfinite_count']:.0f} non-finite entries = every gradient entry")
        if tr.snr.steps != [2, 6, 8] or not all(map(math.isfinite, losses)):
            raise AssertionError(f"{optimizer}: SNR steps {tr.snr.steps}, losses {losses}")
        if fused.kernel_degraded_leaves() != 0 or tr.ckpt_failures != 0:
            raise AssertionError(f"{optimizer}: {fused.kernel_degraded_leaves()} degraded leaves, "
                                 f"{tr.ckpt_failures} failed saves")
        step_dirs = sorted((ckpt_root / optimizer).glob("step_*"))
        if [p.name for p in step_dirs] != ["step_00000006", "step_00000008"]:
            raise AssertionError(f"{optimizer}: checkpoints {[p.name for p in step_dirs]}")
        ckpt_bytes = sum(f.stat().st_size for f in step_dirs[-1].iterdir())
        log(f"  {optimizer}: checkpoint step_00000008 is {ckpt_bytes} bytes on disk ({ckpt_bytes / 2**30:.4f} GiB)")
        worst_snr = 0.0
        if optimizer == "slim":
            for k, want_snr in snr_check.items():
                d = sorted(t3_dims[k])
                label = [lab for lab, axes in meta[k].candidate_ks().items() if sorted(meta[k].dims_of(axes)) == d]
                got_snr = tr.snr.trajectory[k][label[0]][0]
                rel = abs(got_snr - want_snr) / abs(want_snr)
                worst_snr = max(worst_snr, rel)
                log(f"  from-update SNR {k} along {label[0]}: {got_snr:.6e}, plain math on the same g and v' "
                    f"{want_snr:.6e}, rel {rel:.2e}")
            if len(snr_check) != 7 or worst_snr > TOL_SNR:
                raise AssertionError(f"from-update SNR: {len(snr_check)} leaves, worst rel {worst_snr:.2e}")
            per_measure = sum(1 for k, s in specs.items() for lab, axes in meta[k].candidate_ks().items()
                              if sorted(meta[k].dims_of(axes)) != sorted(t3_dims[k]))
            want_counts = {"mega_adam_update": n_steps, "mega_slim_update_batched": 3 * n_steps,
                           "snr_stats_centered_batched": 3 * per_measure}
        else:
            want_counts = {"mega_adam_update": n_steps, "snr_stats_centered_batched": 3 * 21}
        for k, n in want_counts.items():
            if counts[k] != n:
                raise AssertionError(f"{optimizer}: {k} launched {counts[k]} times, expected {n}")
        ft[optimizer] = dict(wall_s=wall, losses=losses, guard=stats, snr_steps=tr.snr.steps, launches=counts,
                             ckpt_bytes=ckpt_bytes, from_update_snr_worst_rel=worst_snr, nan_step=nan_step)
        del tr
        torch.cuda.empty_cache()
    report["guarded"] = ft

    # -- 3c. resume from a checkpoint -------------------------------------------
    log("[3c] resume: a guarded SlimAdam run without faults checkpoints at steps 2 and 4; a second Trainer on "
        "the same directory resumes at step 4 and its next two losses match the uninterrupted run's")
    resume_dir = ckpt_root / "resume"

    def drive_resume():
        first = trainer("slim", total_steps=6, ckpt_every=2, ckpt_dir=str(resume_dir))
        first.run(4)
        first.tc.ckpt_every = 0
        second = trainer("slim", total_steps=6, ckpt_dir=str(resume_dir))
        if second.step != 4:
            raise AssertionError(f"resumed at step {second.step}, expected 4")
        first.run(6)
        second.run(6)
        return [m["loss"] for m in first.metrics_log[-2:]], [m["loss"] for m in second.metrics_log]

    holder = {}
    counts = counted(lambda: holder.update(zip(("want", "got"), drive_resume())))
    rel = max(abs(a - b) / abs(b) for a, b in zip(holder["got"], holder["want"]))
    log(f"  uninterrupted losses {holder['want']}, resumed {holder['got']}, worst rel {rel:.2e} tol "
        f"{TOL_RESUME:.0e}, launches {counts}")
    if len(holder["got"]) != 2 or rel > TOL_RESUME:
        raise AssertionError(f"resumed losses {holder['got']} against {holder['want']}")
    report["resume"] = dict(want=holder["want"], got=holder["got"], worst_rel=rel)
    torch.cuda.empty_cache()

    # -- 3d. the per-leaf route ---------------------------------------------------
    log("[3d] the per-leaf route (megakernel=False): guarded Adam and SlimAdam runs with from-update SNR, then "
        "one update against the megaplan route from the same state")
    per_leaf = {}
    for optimizer in ("adam", "slim"):
        tr = trainer(optimizer, total_steps=2, okw=dict(megakernel=False), measure_snr=True, snr_early_every=2,
                     snr_from_update=optimizer == "slim")
        counts = counted(tr.run)
        log(f"  {optimizer} per-leaf: 2 guarded steps, losses {[round(m['loss'], 4) for m in tr.metrics_log]}, "
            f"launches {counts}")
        want_counts = ({"adam_precond": 2 * 9, "mega_adam_update": 0} if optimizer == "adam" else
                       {"slim_precond_batched": 2 * 7, "adam_precond": 2 * 2, "mega_slim_update_batched": 0})
        for k, n in want_counts.items():
            if counts[k] != n:
                raise AssertionError(f"{optimizer} per-leaf: {k} launched {counts[k]} times, expected {n}")
        grads = accumulated_grads(tr, 5)
        state = tr.opt_state.inner_states[1]
        routes, times = {}, {True: [], False: []}
        txs = {mk: scale_by_adam(b2=0.95, backend="fused", emit_health=True, megakernel=mk) if optimizer == "adam"
               else scale_by_slim_adam(t3_dims, backend="fused", emit_snr=True, emit_health=True, megakernel=mk)
               for mk in (True, False)}
        with torch.no_grad():
            for mk, tx in txs.items():
                kernels.reset_launch_counts()
                u, s = tx.update(grads, state)
                routes[mk] = (u, s, {k: n for k, n in kernels.launch_counts().items() if n})
            for mk in (True, False, False, True, True, False):        # in turns
                times[mk].append(timer(lambda: txs[mk].update(grads, state), reps=5))
        (um, sm, lm), (ul, sl, ll) = routes[True], routes[False]
        msm, msl = statistics.median(times[True]), statistics.median(times[False])
        worst = {what: max(max_err(b[k], a[k])[1] for k in a) for what, a, b in
                 (("u", um, ul), ("m", sm.mu, sl.mu), ("v", sm.nu, sl.nu))}
        if max(worst.values()) > TOL_STEP or not torch.equal(sm.health.nonfinite, sl.health.nonfinite):
            raise AssertionError(f"{optimizer}: per-leaf against mega {worst}")
        if optimizer == "slim":
            snr_rel = max(abs(float(sl.snr[k]) - float(sm.snr[k])) / abs(float(sm.snr[k]))
                          for k in sm.snr if sm.snr[k] is not None)
            worst["snr"] = snr_rel
            if snr_rel > TOL_SNR:
                raise AssertionError(f"slim: per-leaf from-update SNR off by {snr_rel:.2e}")
        log(f"  {optimizer}: per-leaf against mega, worst relative error {worst} (tol {TOL_STEP:.0e}); launches "
            f"per update: mega {lm}, per-leaf {ll}; update time mega {msm:.3f} ms, per-leaf {msl:.3f} ms ({smi})")
        per_leaf[optimizer] = dict(launches=counts, worst_rel=worst, mega_launches=lm, leaf_launches=ll,
                                   mega_update_ms=msm, leaf_update_ms=msl)
        del tr, grads, state, routes, txs, um, sm, ul, sl
        torch.cuda.empty_cache()
    report["per_leaf"] = per_leaf

    # -- 3e. the kernel-failure drill -------------------------------------------------
    log("[3e] kernel-failure drill: SlimAdam steps with every kernel dispatch failing, against backend='jnp'")
    drill_steps = 2
    plain_tr = trainer("slim", total_steps=drill_steps, backend="jnp", guard=None)
    plain_tr.run()
    drill_tr = trainer("slim", total_steps=drill_steps, guard=None)
    with inject_kernel_failure(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        counts = counted(drill_tr.run)
        degraded = fused.kernel_degraded_leaves()
    in_groups = sum(len(g.segments) for g in t3_plan.groups)
    loss_rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(drill_tr.metrics_log,
                                                                               plain_tr.metrics_log))
    param_rel = max(max_err(drill_tr.params[k].detach(), plain_tr.params[k].detach())[1] for k in specs)
    log(f"  degraded leaves {degraded} (= {drill_steps} steps x {in_groups} leaves in the plan's groups), "
        f"launches {counts}, losses against jnp worst rel {loss_rel:.2e}, parameters {param_rel:.2e} "
        f"(tol {TOL_STEP:.0e})")
    if degraded != drill_steps * in_groups or any(counts.values()) or loss_rel > TOL_STEP or param_rel > TOL_STEP:
        raise AssertionError(f"drill: degraded {degraded}, launches {counts}, loss rel {loss_rel:.2e}, "
                             f"params rel {param_rel:.2e}")
    fused.reset_kernel_degradation()
    counts = counted(lambda: drill_tr.run(drill_steps + 1))
    if fused.kernel_degraded_leaves() != 0 or counts["mega_slim_update_batched"] != 3:
        raise AssertionError(f"after the drill: {fused.kernel_degraded_leaves()} degraded, launches {counts}")
    log(f"  hook removed: count reset to 0, the next step launched {counts} and degraded nothing")
    report["drill"] = dict(degraded=degraded, in_groups=in_groups, loss_rel=loss_rel, param_rel=param_rel)
    del plain_tr, drill_tr
    torch.cuda.empty_cache()

    # -- step times of this slice (outside the counted runs) ----------------------------
    # Host clock around synchronised blocks of steps, the variants of one
    # comparison in turns (a b b a ...) so drift between them cancels; the
    # trainers log rarely, as a long run does, so only the guard reads the
    # device during a step.
    log(f"[3f] step times, in turns: Adam plain against guarded, and SlimAdam plain, measure step with "
        f"from-update SNR, plain step plus a B5 measurement ({smi})")

    timing = {}
    trainers = {label: trainer("adam", total_steps=10**6, log_every=10**6, guard=g)
                for label, g in (("plain", None), ("guarded", guard))}
    med, raw = in_turns(torch, {f"adam_{k}_step_ms": (lambda tr=tr: tr.run(tr.step + 1))
                                for k, tr in trainers.items()})
    timing.update(med, adam_raw=raw)
    tr = trainers["guarded"]
    timing["adam_guarded_profile"] = profile_device(torch, lambda: tr.run(tr.step + 1), 2,
                                                    med["adam_guarded_step_ms"], "guarded step")
    del trainers, tr
    from repro_torch.core import measure_tree_snr
    from repro_torch.train.guard import find_slim_snr, strip_slim_snr

    tr = trainer("slim", total_steps=10**6, log_every=10**6, guard=None, measure_snr=True, snr_from_update=True)
    batch = tr.batch(0)
    dims = {k: t3_dims[k] for k in specs}

    def step(fn):
        tr.opt_state, _ = fn(tr.opt_state, batch)

    def snr_step():
        step(tr._train_step_snr)
        measure_tree_snr(tr.opt_state.inner_states[1].nu, tr.meta, backend="fused",
                         from_update=find_slim_snr(tr.opt_state), update_dims=dims)
        tr.opt_state = strip_slim_snr(tr.opt_state)

    def b5_step():
        step(tr._train_step)
        measure_tree_snr(tr.opt_state.inner_states[1].nu, tr.meta, backend="fused")

    med, raw = in_turns(torch, {"slim_plain_step_ms": lambda: step(tr._train_step),
                                "slim_from_update_measure_step_ms": snr_step, "slim_b5_measure_step_ms": b5_step})
    timing.update(med, slim_raw=raw)
    del tr
    torch.cuda.empty_cache()
    log("  medians: " + ", ".join(f"{k} {v:.2f}" for k, v in timing.items() if k.endswith("_ms")))
    log(f"  every block: Adam {timing['adam_raw']}, SlimAdam {timing['slim_raw']}")
    report["timing"] = timing
    shutil.rmtree(ckpt_root, ignore_errors=True)
    return report


# -- the sharded slice (phase 6) ---------------------------------------------------

# Phase 6 geometry: the mesh, and full-width gpt_small's global batch split
# across its 4 ranks (2 rows of 1024 each).
SHARD_SHAPE, SHARD_AXES = (2, 2), ("data", "model")
SHARD_RANKS = 4
SHARD_TIMEOUT_S = 300       # group timeout: a rank that raises ends the others' collectives
TOL_PSUM_ABS = 2e-6         # psum leaves against the unsharded update (tests/test_psum_kernels.py:353)
TOL_SHARDED_LOSS = 1e-4     # losses against the unsharded port: the gradient all-reduce sums in another
                            # order than one whole-batch backward


def shard_inputs(torch, shape, seed, scale=1e-3):
    """A tensor every rank draws alike (seeded on the card)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return scale * torch.randn(shape, generator=gen, device="cuda")


def sharded_kernels(torch, mesh, timer, rate, params, plans, dims, meta, lead):
    """6a: B9-B13 against their plain twins on this rank's local shards of
    every psum leaf of the Table-3 plan (B9 on every SNR candidate whose
    lines the mesh splits), gradients seeded with NaN/Inf for the health
    outputs; then, on rank 0 alone while the others wait, each kernel's time
    over the shards one step (or one SNR measurement) launches it on."""
    from repro_torch.kernels import megaplan, slim_update, snr_stats
    from repro_torch.kernels.fused_adam import bias_corrections
    from repro_torch.kernels.ops import canon_apply, canon_nd
    from repro_torch.sharding.shardspec import global_shape, owning_axes

    kw = dict(b1=0.9, b2=0.95, eps=1e-8)
    count = torch.tensor(3, dtype=torch.int32, device="cuda")
    bc1, bc2 = bias_corrections(0.9, 0.95, count)
    names = list(params)
    psum = [i for i, pl in enumerate(plans) if pl.regime == "psum"]
    out = {k: dict(err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=None, cases=[])
           for k in ("B9", "B10", "B11", "B12", "B13")}
    timed = []   # (kernel, tag, run, plain, bound, library) on rank 0

    def hold(kernel, tag, got, want, tols):
        errs = [check_masked(f"[{mesh.rank}] {kernel} {tag} {label}", a, w, tol)
                for (label, tol), a, w in zip(tols, got, want)]
        out[kernel]["err"] = max(out[kernel]["err"], *errs)

    def health_counts(kernel, tag, got, want, n_bad):
        got_nf = float(got.sum()) if got.ndim else float(got)
        if got_nf != float(want.sum() if want.ndim else want) or got_nf != n_bad:
            raise AssertionError(f"{kernel} {tag}: {got_nf} non-finite counted, {n_bad} seeded")

    local_g, local_m = {}, {}
    for i in psum:
        pl, name = plans[i], names[i]
        cn = pl.cn
        to3 = (lambda x: x) if cn.batch > 1 else (lambda x: x[None])
        g = shard_inputs(torch, pl.local_shape, 10 + i)
        m = shard_inputs(torch, pl.local_shape, 50 + i, 1e-4)
        local_g[i], local_m[i] = g, m
        g3, m3 = to3(canon_apply(g, cn)).contiguous(), to3(canon_apply(m, cn)).contiguous()
        tag = f"{name} {tuple(g3.shape)} axis {cn.axis}"
        n, lines = g3.numel(), (g3.shape[0] * (g3.shape[1] if cn.axis == 1 else g3.shape[2]))
        for flags in ({}, {"with_snr": True}, {"with_health": True}):
            gg = poison(torch, g3, 7, i) if flags.get("with_health") else g3
            got = slim_update.slim_partial_stats_batched(gg, m3, axis=cn.axis, b1=0.9, **flags)
            want = slim_update.slim_partial_stats_batched_plain(gg, m3, axis=cn.axis, b1=0.9, **flags)
            tols = [("m'", TOL_ELEMENTWISE), ("part", TOL_LINE)]
            tols += [("s1c", TOL_LINE), ("s2c", TOL_LINE), ("first", None)] if flags.get("with_snr") else []
            hold("B10", f"{tag} {flags}", got[:len(tols)], want[:len(tols)], tols)
            if flags.get("with_health"):
                health_counts("B10", tag, got[-1][0], want[-1][0], 7)
                hold("B10", f"{tag} {flags}", [got[-1][1:]], [want[-1][1:]], [("ss", TOL_LINE)])
        line = got[1].shape
        v = 1e-6 * torch.rand(line, device="cuda") + 1e-8
        ek = 1e-6 * torch.rand(line, device="cuda")
        m_new = slim_update.slim_partial_stats_batched_plain(g3, m3, axis=cn.axis, b1=0.9)[0]
        for form, e in (("ek", ek), ("owner", None)):
            got = slim_update.slim_finalize_batched(m_new, v, axis=cn.axis, ek=e, count=count, **kw)
            want = slim_update.slim_finalize_batched_plain(m_new, v, bc1, bc2, b2=0.95, eps=1e-8, ek=e)
            pairs = (got, want) if e is not None else ((got,), (want,))
            hold("B11", f"{tag} {form}", *pairs, [("u", TOL_ELEMENTWISE), ("v'", TOL_ELEMENTWISE)])
        timed.append(("B10", tag, lambda g3=g3, m3=m3, a=cn.axis: slim_update.slim_partial_stats_batched(
            g3, m3, axis=a, b1=0.9), lambda g3=g3, m3=m3, a=cn.axis: slim_update.slim_partial_stats_batched_plain(
            g3, m3, axis=a, b1=0.9), max((12 * n + 4 * lines) / rate, 4 * n / F32_RATE) * 1e3, None))
        timed.append(("B11", tag, lambda m_new=m_new, v=v, a=cn.axis: slim_update.slim_finalize_batched(
            m_new, v, axis=a, count=count, **kw), lambda m_new=m_new, v=v: slim_update.slim_finalize_batched_plain(
            m_new, v, bc1, bc2, b2=0.95, eps=1e-8), max((8 * n + 4 * lines) / rate, 4 * n / F32_RATE) * 1e3, None))

    # B12/B13 on the psum groups the grouped route launches (per form).
    items = [(i, plans[i].local_shape, tuple(1 if d in dims[names[i]] else s
                                             for d, s in enumerate(plans[i].local_shape)),
              dims[names[i]], plans[i].cn) for i in psum]
    by_form = {f: [it for it in items if bool(plans[it[0]].owner) == (f == "owner")] for f in ("owner", "plain")}
    groups = [(form, grp) for form in ("owner", "plain") for grp in megaplan.groups_from_plans(by_form[form])]
    for form, grp in groups:
        to3 = (lambda x: x) if grp.kind == "batched" else (lambda x: x[None])
        g3 = to3(megaplan.gather_group(grp, local_g)).contiguous()
        m3 = to3(megaplan.gather_group(grp, local_m)).contiguous()
        tag = f"{grp.kind}[{len(grp.segments)}] {tuple(g3.shape)} axis {grp.axis}"
        n = g3.numel()
        for flags in ({}, {"with_snr": True}, {"with_health": True}):
            gg = poison(torch, g3, 5, n) if flags.get("with_health") else g3
            got = megaplan.mega_slim_partial_stats_batched(gg, m3, axis=grp.axis, b1=0.9, **flags)
            want = megaplan.mega_slim_partial_stats_batched_plain(gg, m3, axis=grp.axis, b1=0.9, **flags)
            tols = [("m'", TOL_ELEMENTWISE), ("part", TOL_LINE)]
            tols += [("s1c", TOL_LINE), ("s2c", TOL_LINE), ("first", None)] if flags.get("with_snr") else []
            tols += [("nf", None), ("ss", TOL_LINE)] if flags.get("with_health") else []
            hold("B12", f"{tag} {flags}", got, want, tols)
            if flags.get("with_health"):
                health_counts("B12", tag, got[-2], want[-2], 5)
        line = got[1].shape
        lines = math.prod(line)
        v = 1e-6 * torch.rand(line, device="cuda") + 1e-8
        ek = 1e-6 * torch.rand(line, device="cuda")
        l1, l2 = bc1.expand(line).contiguous(), bc2.expand(line).contiguous()
        m_new = megaplan.mega_slim_partial_stats_batched_plain(g3, m3, axis=grp.axis, b1=0.9)[0]
        for f, e in (("ek", ek), ("owner", None)):
            got = megaplan.mega_slim_finalize_batched(m_new, v, l1, l2, axis=grp.axis, ek=e, b2=0.95, eps=1e-8)
            want = slim_update.slim_finalize_batched_plain(m_new, v, l1, l2, b2=0.95, eps=1e-8, ek=e)
            pairs = (got, want) if e is not None else ((got,), (want,))
            hold("B13", f"{tag} {f}", *pairs, [("u", TOL_ELEMENTWISE), ("v'", TOL_ELEMENTWISE)])
        timed.append(("B12", tag, lambda g3=g3, m3=m3, a=grp.axis: megaplan.mega_slim_partial_stats_batched(
            g3, m3, axis=a, b1=0.9), lambda g3=g3, m3=m3, a=grp.axis: megaplan.mega_slim_partial_stats_batched_plain(
            g3, m3, axis=a, b1=0.9), max((12 * n + 4 * lines) / rate, 4 * n / F32_RATE) * 1e3, None))
        timed.append(("B13", tag, lambda m_new=m_new, v=v, l1=l1, l2=l2, a=grp.axis:
                      megaplan.mega_slim_finalize_batched(m_new, v, l1, l2, axis=a, b2=0.95, eps=1e-8),
                      lambda m_new=m_new, v=v, l1=l1, l2=l2: slim_update.slim_finalize_batched_plain(
                          m_new, v, l1, l2, b2=0.95, eps=1e-8),
                      max((8 * n + 12 * lines) / rate, 4 * n / F32_RATE) * 1e3, None))

    # B9 on the SNR candidates of Adam's second moments whose lines the mesh splits.
    for i, name in enumerate(names):
        spec = plans[i].spec
        for label, axes in meta[name].candidate_ks().items():
            d = tuple(sorted(meta[name].dims_of(axes)))
            shape = global_shape(plans[i].local_shape, spec, mesh)
            if not owning_axes(shape, spec, mesh, d):
                continue
            x = shard_inputs(torch, plans[i].local_shape, 90 + i)
            cn = canon_nd(plans[i].local_shape, d)
            v3 = canon_apply(x * x, cn).contiguous()
            v3 = v3 if v3.ndim == 3 else v3[None]
            tag = f"{name} {label} {tuple(v3.shape)} axis {cn.axis}"
            got = snr_stats.snr_stats_centered_partial_batched(v3, axis=cn.axis)
            want = snr_stats.snr_stats_centered_partial_batched_plain(v3, axis=cn.axis)
            hold("B9", tag, got, want, [("s1", TOL_LINE), ("s1c", TOL_LINE), ("s2c", TOL_LINE), ("v0", None)])
            n, lines = v3.numel(), got[0].numel()
            red = 2 if cn.axis == 1 else 1
            timed.append(("B9", tag, lambda v3=v3, a=cn.axis: snr_stats.snr_stats_centered_partial_batched(v3, axis=a),
                          lambda v3=v3, a=cn.axis: snr_stats.snr_stats_centered_partial_batched_plain(v3, axis=a),
                          max((4 * n + 16 * lines) / rate, 5 * n / F64_RATE) * 1e3,
                          lambda v3=v3, red=red: torch.var_mean(v3, dim=red, correction=0)))
    torch.cuda.synchronize()
    # Times on rank 0 alone: the other ranks wait at the barrier.
    if lead:
        log(f"[6a] B9-B13 times at the local shapes, rank 0 alone on the card ({mesh.transport_note()})")
        for kernel, tag, run, plain, bound, lib in timed:
            ms, plain_ms = timer(run, reps=5), timer(plain, reps=3)
            lib_ms = timer(lib, reps=5) if lib is not None else None
            acc = out[kernel]
            acc["ms"] += ms
            acc["plain_ms"] += plain_ms
            acc["bound_ms"] += bound
            if lib_ms is not None:
                acc["library_ms"] = (acc["library_ms"] or 0.0) + lib_ms
            acc["cases"].append(dict(tag=tag, ms=ms, plain_ms=plain_ms, bound_ms=bound, library_ms=lib_ms))
            log(f"  {kernel} {tag}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound:.4f} ms"
                + ("" if lib_ms is None else f"  var_mean {lib_ms:.4f} ms"))
        out["B9"].update(snr_total("B9", out["B9"], len(out["B9"]["cases"]), "rank 0 alone on the card"))
    mesh.barrier()
    return out


def same_tensors(what, a, b):
    """Bit equality of two dicts of tensors, key for key."""
    if a.keys() != b.keys():
        raise AssertionError(f"{what}: other leaves")
    for k in a:
        if not torch_equal(a[k], b[k]):
            raise AssertionError(f"{what}: {k} differs")


def torch_equal(a, b):
    import torch

    return a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(a, b))


def sharded_vs_unsharded(torch, mesh, params, plans, dims, lead):
    """6b: one sharded Table-3 SlimAdam update (two, so the moments carry
    history) and one sharded Adam update against the port's unsharded
    update of the same whole gradients on the same card; the per-leaf route
    (B10/B11) against the grouped one (B12/B13)."""
    from repro_torch.core.slim_adam import scale_by_slim_adam
    from repro_torch.optim.adam import scale_by_adam

    say = log if lead else (lambda *a: None)
    names = list(params)
    grads = [{k: shard_inputs(torch, p.shape, 200 * s + i) for i, (k, p) in enumerate(params.items())}
             for s in range(2)]
    specs = {k: pl.spec for k, pl in zip(names, plans)}
    res = {}
    with torch.no_grad():
        txs = {"unsharded": scale_by_slim_adam(dims, backend="fused"),
               "grouped": scale_by_slim_adam(dims, backend="fused", mesh=mesh, param_specs=specs),
               "per_leaf": scale_by_slim_adam(dims, backend="fused", mesh=mesh, param_specs=specs, megakernel=False)}
        states = {k: tx.init(params) for k, tx in txs.items()}
        for g in grads:
            ups = {}
            for k, tx in txs.items():
                ups[k], states[k] = tx.update(g, states[k])
        worst = dict(u=0.0, mu=0.0, nu=0.0)
        for i, (k, pl) in enumerate(zip(names, plans)):
            un, sh = states["unsharded"], states["grouped"]
            nu_spec = pl.nu_spec if pl.nu_spec is not None else pl.red_spec
            pairs = {"u": (ups["grouped"][k], ups["unsharded"][k]), "mu": (sh.mu[k], mesh.shard(un.mu[k], pl.spec)),
                     "nu": (sh.nu[k], mesh.shard(un.nu[k], nu_spec))}
            for what, (a, b) in pairs.items():
                if pl.regime == "local":
                    if not torch_equal(a, b):
                        raise AssertionError(f"local leaf {k} {what}: sharded differs from unsharded")
                else:
                    err = float((a.double() - b.double()).abs().max())
                    worst[what] = max(worst[what], err)
                    if err > TOL_PSUM_ABS:
                        raise AssertionError(f"psum leaf {k} {what}: {err:.3e} above {TOL_PSUM_ABS:.0e}")
        say(f"[6b] sharded Table-3 SlimAdam against unsharded, 2 updates: local leaves bit-equal; psum leaves "
            f"max abs err u {worst['u']:.3e}  m' {worst['mu']:.3e}  owner-slice v' {worst['nu']:.3e} "
            f"(tol {TOL_PSUM_ABS:.0e})")
        res["slim_psum_abs_err"] = worst
        route = 0.0
        for k in names:
            for a, b in ((ups["per_leaf"][k], ups["grouped"][k]), (states["per_leaf"].mu[k], states["grouped"].mu[k]),
                         (states["per_leaf"].nu[k], states["grouped"].nu[k])):
                route = max(route, max_err(a, b)[1])
        if route > TOL_ELEMENTWISE:
            raise AssertionError(f"per-leaf route against grouped route: rel err {route:.3e}")
        say(f"[6b] per-leaf route (B10/B11, B3/B4) against the grouped one (B12/B13, B1/B2): worst rel err "
            f"{route:.3e}")
        res["per_leaf_vs_grouped_rel"] = route
        del txs, states, ups
        ta_u, ta_s = scale_by_adam(b2=0.95, backend="fused"), scale_by_adam(b2=0.95, backend="fused", mesh=mesh,
                                                                            param_specs=specs)
        uu, su = ta_u.update(grads[0], ta_u.init(params))
        us, ss = ta_s.update(grads[0], ta_s.init(params))
        for k, pl in zip(names, plans):
            if not (torch_equal(us[k], uu[k]) and torch_equal(ss.mu[k], mesh.shard(su.mu[k], pl.spec))
                    and torch_equal(ss.nu[k], mesh.shard(su.nu[k], pl.spec))):
                raise AssertionError(f"sharded Adam differs from unsharded on {k}")
        say("[6b] sharded Adam against unsharded: u, m', v' bit-equal on every leaf")
    torch.cuda.empty_cache()
    return res


def state_copy(torch, tree):
    from repro_torch.checkpoint.store import named_leaves

    return {n: t.detach().clone() for n, t in named_leaves(tree) if isinstance(t, torch.Tensor)}


def crcs(torch, tree):
    import zlib

    from repro_torch.checkpoint.store import named_leaves

    return {n: zlib.crc32(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
            for n, t in named_leaves(tree)}


def sharded_rank(rank, rdv, out, rate, ckpt_dir):
    """One rank of the (data=2, model=2) mesh on the card: phases 6a-6e.
    Rank 0 logs; every rank checks. Results go to ``out``; a failure
    raises, which ends the process with a non-zero code."""
    import datetime

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import rules_to_dims, table3_rules
    from repro_torch.data import DataConfig, ZipfLM
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import fused as F
    from repro_torch.models import Transformer
    from repro_torch.sharding import ShardingContext, param_specs, use_sharding
    from repro_torch.sharding.shardspec import regime_counts
    from repro_torch.train import FaultPlan, GuardConfig, Trainer, TrainerConfig

    t_start = time.perf_counter()
    if rank:   # rank 0 speaks for the mesh; the others' failures still reach stderr
        sys.stdout = open(os.devnull, "w")
    mesh = make_mesh(SHARD_SHAPE, SHARD_AXES, device="cuda", init_method=f"file://{rdv}", rank=rank,
                     world_size=SHARD_RANKS, timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S))
    lead = rank == 0
    say = log if lead else (lambda *a: None)
    res = {"transport": mesh.transport_note(), "coords": mesh.coords}
    say(f"[6] {mesh.transport_note()}")
    cfg = get_config("gpt_small")
    timer = Timer(torch) if lead else None
    with use_sharding(ShardingContext(mesh)):
        model = Transformer(cfg, device=torch.device("cuda"), gen=torch.Generator().manual_seed(0))
        params, meta = model.params, model.meta
        specs = param_specs(meta, params)
        dims = rules_to_dims(table3_rules(meta), meta)
        plans = F.sharded_tree_plans(list(params.values()), [dims[k] for k in params], [specs[k] for k in params],
                                     mesh)
        counts = regime_counts(plans)
        say(f"[6] Table-3 plan on the mesh: {counts}; psum leaves' local shapes "
            f"{[(k, pl.local_shape) for k, pl in zip(params, plans) if pl.regime == 'psum']}")
        if counts != {"local": 4, "psum": 7, "psum_jnp": 0, "jnp": 0, "degraded": 0}:
            raise AssertionError(f"unexpected regimes {counts}")
        res["kernels"] = sharded_kernels(torch, mesh, timer, rate, params, plans, dims, meta, lead)
        res["vs_unsharded"] = sharded_vs_unsharded(torch, mesh, params, plans, dims, lead)
        del model, params
        torch.cuda.empty_cache()

        # -- 6c. the sharded trainer: counted runs -----------------------------
        data = ZipfLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=1024, global_batch=8, seed=0))

        def counted(label, trainer, steps=None):
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            trainer.run(steps)
            torch.cuda.synchronize()
            c = kernels.launch_counts()
            say(f"[6c] {label}: {trainer.step} steps in {time.perf_counter() - t0:.1f} s, losses "
                f"{[round(m['loss'], 5) for m in trainer.metrics_log]}, launches "
                f"{ {k: v for k, v in c.items() if v} }")
            return c

        tc = dict(log_every=1, backend="fused", seed=0, measure_snr=True, snr_early_every=2)
        adam = Trainer(cfg, "adam", 1e-3, data, TrainerConfig(total_steps=2, **tc))
        res["adam_launches"] = counted("Adam, SNR measured at step 2", adam)
        res["adam_losses"] = [m["loss"] for m in adam.metrics_log]
        rules = adam.derive_slim_rules()
        res["rules"] = {k: list(v) if v else None for k, v in rules.items()}
        res["adam_snr"] = adam.snr.trajectory
        say(f"[6c] derived rules: {res['rules']}")
        del adam
        torch.cuda.empty_cache()
        snr_tr = Trainer(cfg, "slim_snr", 1e-3, data, TrainerConfig(total_steps=2, snr_from_update=True, ckpt_every=2,
                                                                     ckpt_dir=ckpt_dir, **tc), rules=rules)
        res["slim_snr_launches"] = counted("SlimAdam (derived rules), from-update SNR at step 2, checkpoint", snr_tr)
        res["slim_snr_losses"] = [m["loss"] for m in snr_tr.metrics_log]
        res["slim_snr_snr"] = snr_tr.snr.trajectory
        # -- 6d. checkpoints: restore on the mesh; the whole state's checksums
        # for the parent's unsharded restore
        saved = state_copy(torch, snr_tr._state())
        whole = snr_tr.global_state()      # a collective: every rank gathers
        res["ckpt_crc"] = crcs(torch, whole) if lead else None
        del whole
        del snr_tr
        torch.cuda.empty_cache()
        back = Trainer(cfg, "slim_snr", 1e-3, data, TrainerConfig(ckpt_dir=ckpt_dir, **tc), rules=rules)
        if back.step != 2:
            raise AssertionError(f"restored at step {back.step}, expected 2")
        same_tensors("restore on the mesh", saved, state_copy(torch, back._state()))
        say("[6d] checkpoint saved on the mesh (rank 0 wrote the gathered state) and restored on the mesh: every "
            "rank's shards bit-equal")
        del back, saved
        torch.cuda.empty_cache()
        t3 = Trainer(cfg, "slim", 1e-3, data, TrainerConfig(total_steps=2, log_every=1, backend="fused", seed=0))
        res["slim_launches"] = counted("SlimAdam (Table 3)", t3)
        res["slim_losses"] = [m["loss"] for m in t3.metrics_log]
        # -- 6e. the sharded step's time, all 4 ranks together -----------------
        steps = 2
        mesh.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t3.run(t3.step + steps)
        torch.cuda.synchronize()
        mesh.barrier()
        step_ms = (time.perf_counter() - t0) / steps * 1e3
        n_grad = sum(p.numel() for p in t3.params.values())
        flat = torch.zeros(n_grad, device="cuda")
        mesh.barrier()
        t0 = time.perf_counter()
        mesh.psum(flat, SHARD_AXES)
        torch.cuda.synchronize()
        mesh.barrier()
        allreduce_ms = (time.perf_counter() - t0) * 1e3
        del flat
        res["timing"] = dict(step_ms=step_ms, grad_allreduce_ms=allreduce_ms)
        say(f"[6e] sharded Table-3 SlimAdam step (4 ranks sharing one card over gloo, not a multi-GPU number): "
            f"{step_ms:.1f} ms per step; the gradient all-reduce alone ({n_grad:,} f32) {allreduce_ms:.1f} ms")
        del t3
        torch.cuda.empty_cache()
        per_leaf = Trainer(cfg, "slim", 1e-3, data, TrainerConfig(total_steps=1, log_every=1, backend="fused", seed=0),
                           optimizer_kw=dict(megakernel=False))
        res["per_leaf_launches"] = counted("SlimAdam (Table 3), per-leaf route", per_leaf)
        del per_leaf
        torch.cuda.empty_cache()
        guard = Trainer(cfg, "slim", 1e-3, data, TrainerConfig(total_steps=2, log_every=1, backend="fused", seed=0,
                                                                guard=GuardConfig(min_history=1)),
                        faults=FaultPlan(nan_grad_steps=(1,)))
        guard.run(1)
        before = state_copy(torch, guard._state())
        res["guard_launches"] = counted("guarded SlimAdam (Table 3), NaN injected at step 1", guard, 2)
        last = guard.metrics_log[-1]
        if last["step_skipped"] != 1.0 or last["nonfinite_count"] != 124373760:
            raise AssertionError(f"guarded NaN step: skipped {last['step_skipped']}, "
                                 f"non-finite {last['nonfinite_count']}")
        same_tensors("guarded NaN step", before, state_copy(torch, guard._state()))
        say("[6c] guarded NaN step skipped on every rank, 124,373,760 gradient entries counted non-finite, "
            "every rank's parameters and optimizer shards bit-identical")
        res["guard"] = dict(skipped=last["step_skipped"], nonfinite=last["nonfinite_count"])
        del guard, before
    res["seconds"] = time.perf_counter() - t_start
    out.put((rank, res))
    mesh.barrier()


def sharded_phase(torch, smi, rate):
    """Phase 6: spawn the 4 ranks of a (data=2, model=2) mesh on this one
    card and check what they report; then the unsharded port on the same
    batches and the unsharded restore of the mesh's checkpoint. A rank that
    fails ends the run with a non-zero code."""
    import multiprocessing as mp
    import queue
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, ZipfLM
    from repro_torch.train import Trainer, TrainerConfig

    log(f"[6] sharded slice: full-width gpt_small on a (data=2, model=2) mesh, {SHARD_RANKS} ranks sharing this "
        f"card ({smi}), batch 8 x 1024 split 2 rows per rank")
    work = ROOT / "build" / "chip_smoke_sharded"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    ckpt_dir = str(work / "ckpt")
    torch.cuda.empty_cache()
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    t0 = time.perf_counter()
    procs = [ctx.Process(target=sharded_rank, args=(r, str(work / "rdv"), out, rate, ckpt_dir))
             for r in range(SHARD_RANKS)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + 900
    try:
        while len(results) < SHARD_RANKS:
            try:
                rank, res = out.get(timeout=2.0)
                results[rank] = res
            except queue.Empty:
                failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if failed:
                    raise RuntimeError(f"rank {failed[0]} failed with exit code {procs[failed[0]].exitcode}")
                if time.monotonic() > deadline:
                    raise TimeoutError("the sharded ranks did not finish")
        for p in procs:
            p.join(timeout=SHARD_TIMEOUT_S)
        if any(p.exitcode != 0 for p in procs):
            raise RuntimeError(f"rank exit codes {[p.exitcode for p in procs]}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    spawn_s = time.perf_counter() - t0
    r0 = results[0]
    for r in range(1, SHARD_RANKS):
        for key in ("adam_losses", "slim_snr_losses", "rules", "slim_losses"):
            if results[r][key] != r0[key]:
                raise AssertionError(f"rank {r} reports other {key} than rank 0")

    # The unsharded port on the same batches and rules, and its restore.
    cfg = get_config("gpt_small")
    data = ZipfLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=1024, global_batch=8, seed=0))
    tc = dict(log_every=1, backend="fused", seed=0, measure_snr=True, snr_early_every=2)
    rules = {k: tuple(v) if v else None for k, v in r0["rules"].items()}
    ref = {}
    for label, optimizer, kw in (("adam", "adam", {}), ("slim_snr", "slim_snr", dict(rules=rules)),
                                 ("slim", "slim", {})):
        tr = Trainer(cfg, optimizer, 1e-3, data, TrainerConfig(total_steps=2, **tc), **kw)
        tr.run()
        ref[label] = [m["loss"] for m in tr.metrics_log]
        del tr
        torch.cuda.empty_cache()
    worst = 0.0
    for label, key in (("adam", "adam_losses"), ("slim_snr", "slim_snr_losses"), ("slim", "slim_losses")):
        got = r0[key][:2]
        errs = [abs(a - b) / abs(b) for a, b in zip(got, ref[label])]
        worst = max(worst, *errs)
        log(f"[6c] {label} losses sharded {got} unsharded {ref[label]}: worst rel diff {max(errs):.3e}")
    if worst > TOL_SHARDED_LOSS:
        raise AssertionError(f"sharded losses differ from the unsharded port's by {worst:.3e}")
    back = Trainer(cfg, "slim_snr", 1e-3, data, TrainerConfig(ckpt_dir=ckpt_dir, **tc), rules=rules)
    if back.step != 2 or crcs(torch, back._state()) != r0["ckpt_crc"]:
        raise AssertionError("the mesh's checkpoint restored unsharded differs from the mesh's gathered state")
    log("[6d] the mesh's checkpoint restored unsharded: every leaf's crc32 equals the gathered state's")
    del back
    torch.cuda.empty_cache()
    shutil.rmtree(work, ignore_errors=True)

    def need(counts, names, label):
        for n in names:
            if counts[n] <= 0:
                raise AssertionError(f"{label}: {n} never launched")

    # every SNR candidate of gpt_small has its lines split on this mesh: B9 only
    need(r0["adam_launches"], ["snr_stats_centered_partial_batched", "mega_adam_update"], "sharded Adam run")
    need(r0["slim_launches"], ["mega_slim_partial_stats_batched", "mega_slim_finalize_batched"], "sharded SlimAdam")
    need(r0["per_leaf_launches"], ["slim_partial_stats_batched", "slim_finalize_batched"], "sharded per-leaf run")
    log(f"[6] sharded phase: ranks {spawn_s:.1f} s (rank 0 {r0['seconds']:.1f} s), total "
        f"{time.perf_counter() - t0:.1f} s")
    summary = {k: v for k, v in r0.items() if k != "ckpt_crc"}
    summary.update(reference_losses=ref, loss_rel_err=worst, spawn_s=spawn_s,
                   kernel_err={k: max(results[r]["kernels"][k]["err"] for r in results) for k in r0["kernels"]})
    return summary


# -- the SSM serving path (phase 7) and the parameter-writing API (phase 8) -----------

# The SFUs evaluate exponentials: 16 per SM per clock on compute capability
# 9.0 (CUDA C++ Programming Guide, arithmetic instruction throughput), 132 SMs
# at the 1.98 GHz boost clock of the H100 SXM.
SFU_RATE = 132 * 16 * 1.98e9
TOL_SSM_LOGITS = 5e-2    # full-width logits, kernel against plain scan: bf16 activations through 4 Mamba layers
TOL_BF16_PARAM = 2.0**-8  # a bf16 p' may round one bf16 step apart where the f32 value straddles a boundary
# Phase 7 geometry: the eval batch, and the served prompts.
SSM_EVAL_SEQ, SSM_ROWS, SSM_PROMPT, SSM_NEW = 2048, 4, 64, 32


def scan_case(torch, gen, b, s, d, n, in_dtype):
    """B15 operands as the model makes them: x, B, C in the activations'
    dtype, dt a softplus, a = -exp(a_log) around the S4D-real init, a random
    h0."""
    dev = torch.device("cuda")
    x = torch.randn((b, s, d), generator=gen, device=dev).to(in_dtype)
    dt = torch.nn.functional.softplus(torch.randn((b, s, d), generator=gen, device=dev) - 2.0)
    a = -torch.arange(1, n + 1, dtype=torch.float32, device=dev).expand(d, n) \
        * torch.exp(0.1 * torch.randn((d, n), generator=gen, device=dev))
    b_t = torch.randn((b, s, n), generator=gen, device=dev).to(in_dtype)
    c_t = torch.randn((b, s, n), generator=gen, device=dev).to(in_dtype)
    d_skip = torch.randn((d,), generator=gen, device=dev)
    h0 = torch.randn((b, d, n), generator=gen, device=dev)
    return x, dt, a.contiguous(), b_t, c_t, d_skip, h0


def scan_bound(args, rate: float):
    """Least time (ms) for one selective scan, and what sets it: the bytes
    (x, dt, B, C, a, d_skip, h0 read once; y and h_final written once) over
    the memory rate; its exponentials (one per timestep, channel and state)
    over the SFU rate; its other f32 operations (6 per timestep, channel and
    state: dt*a, decay*h, dx*B, their sum, h*C, the sum of y) over the f32
    rate."""
    x, dt, a, b_t, c_t, d_skip, h0 = args
    b, s, d = x.shape
    n = a.shape[1]
    nbytes = sum(t.numel() * t.element_size() for t in args) + 4 * (b * s * d + b * d * n)
    times = {"bytes": nbytes / rate, "operations": b * s * d * n / SFU_RATE}
    t_f32 = 6 * b * s * d * n / F32_RATE
    by = max(times, key=times.get)
    return max(times[by], t_f32) * 1e3, by


def ssm_phase(torch, timer, rate: float, smi: str):
    """Phase 7: B15 against its twin, then full-width falcon_mamba_7b
    evaluated and served through the legacy loop. Returns (report, the B15
    entry of the kernels line)."""
    import dataclasses

    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.data import DataConfig, ZipfLM
    from repro_torch.kernels import ssm_scan as sc
    from repro_torch.models import Transformer, forward
    from repro_torch.models.transformer import decode_step, init_decode_cache
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.train.step import make_eval_step

    report: dict = {}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    cfg = get_config("falcon_mamba_7b")
    scfg = cfg.ssm_cfg()

    # -- 7a. B15 against its plain twin at the eval and decode shapes ------
    log(f"[7] ssm_scan (B15) at full-width falcon_mamba_7b shapes against its plain twin, bound ({smi})")
    held = {}
    for case, (b, s) in (("eval", (1, SSM_EVAL_SEQ)), ("decode", (SSM_ROWS, 1))):
        args = scan_case(torch, gen, b, s, scfg.d_inner, scfg.d_state, torch.bfloat16)
        (y, h), (y_w, h_w) = sc.ssm_scan(*args), sc.ssm_scan_plain(*args)
        torch.cuda.synchronize()
        errs = [check(f"{case} {what}", got, want, TOL_LINE) for what, got, want in (("y", y, y_w), ("h", h, h_w))]
        ms = timer(lambda: sc.ssm_scan(*args), reps=20)
        plain_ms = timer(lambda: sc.ssm_scan_plain(*args), reps=3)
        bound, by = scan_bound(args, rate)
        log(f"  {case} (B={b}, S={s}, D={scfg.d_inner}, N={scfg.d_state}): kernel {ms:.4f} ms  plain "
            f"{plain_ms:.4f} ms  bound {bound:.4f} ms ({by})  library: none (no PyTorch call computes a "
            f"selective scan)")
        held[case] = dict(err_y=errs[0], err_h=errs[1], ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
        del args, y, h, y_w, h_w
    report["ssm_scan"] = held
    torch.cuda.empty_cache()

    # -- 7b. the model, on the card -----------------------------------------
    t0 = time.perf_counter()
    model = Transformer(cfg, device=dev, gen=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.params.values())
    p_gb = sum(p.numel() * p.element_size() for p in model.params.values()) / 1e9
    log(f"[7] full-width falcon_mamba_7b ({cfg.n_layers} layers, d_model {cfg.d_model}, d_inner {scfg.d_inner}, "
        f"{n_params} parameters, {p_gb:.1f} GB in f32) initialised on the card in {time.perf_counter() - t0:.1f} s")
    if n_params != 7_006_326_784:
        raise AssertionError(f"falcon_mamba_7b has {n_params} parameters, expected 7006326784")
    report["params"] = n_params

    # -- 7c. the forward: make_eval_step on one ZipfLM batch ----------------
    batch = {k: torch.from_numpy(v).to(dev) for k, v in
             ZipfLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=SSM_EVAL_SEQ, global_batch=1, seed=0)).batch(0).items()}
    eval_step = make_eval_step(model)
    eval_step(batch)     # warm the cuBLAS handles outside the counted run
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    loss = float(eval_step(batch)["loss"])
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_counts = kernels.launch_counts()
    log(f"  make_eval_step on 1 x {SSM_EVAL_SEQ}: loss {loss:.4f} in {eval_s * 1e3:.1f} ms, launches "
        f"{ {k: v for k, v in eval_counts.items() if v} }")
    if not math.isfinite(loss):
        raise AssertionError(f"falcon_mamba_7b eval loss is not finite: {loss}")
    if eval_counts["ssm_scan"] != cfg.n_layers or sum(eval_counts.values()) != cfg.n_layers:
        raise AssertionError(f"eval launches {eval_counts}, expected ssm_scan {cfg.n_layers} and no other kernel")
    report["eval"] = dict(loss=loss, ms=eval_s * 1e3, launches=eval_counts)

    # -- 7d. the legacy serving loop -------------------------------------------
    prompts = ZipfLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=SSM_PROMPT, global_batch=SSM_ROWS,
                                seed=1)).batch(0)["tokens"]
    eng = Engine(cfg, model.params, ServeConfig(max_seq=2 * SSM_PROMPT, max_new_tokens=SSM_NEW))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.generate(prompts)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen_counts = kernels.launch_counts()
    steps = SSM_PROMPT + SSM_NEW - 1
    log(f"  Engine.generate: {SSM_ROWS} prompts x {SSM_PROMPT} tokens + {SSM_NEW} greedy in {gen_s:.2f} s, "
        f"{eng.decode_steps} decode steps, launches {({k: v for k, v in gen_counts.items() if v})}")
    if tuple(out.shape) != (SSM_ROWS, SSM_PROMPT + SSM_NEW) or not np.array_equal(out[:, :SSM_PROMPT].numpy(), prompts) \
            or int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
        raise AssertionError(f"generate returned {tuple(out.shape)} tokens outside the prompt/vocabulary contract")
    if eng.decode_steps != steps or gen_counts["ssm_scan"] != cfg.n_layers * steps \
            or sum(gen_counts.values()) != gen_counts["ssm_scan"]:
        raise AssertionError(f"generate: {eng.decode_steps} steps, launches {gen_counts}; expected {steps} steps "
                             f"and ssm_scan {cfg.n_layers} per step")

    # decode-step time (host clock, synchronised), device busy share, cache bytes
    cache = init_decode_cache(cfg, SSM_ROWS, 2 * SSM_PROMPT, torch.bfloat16, device=dev)
    tok = torch.from_numpy(prompts[:, :1]).to(dev)
    params = model.params

    def step():
        nonlocal cache
        _, cache = decode_step(cfg, params, cache, tok)

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 5 * 1e3
    cache_bytes = sum(t.numel() * t.element_size() for t in cache.slots["slot_0"])
    log(f"  decode step ({SSM_ROWS} rows): {step_ms:.3f} ms per token = {SSM_ROWS / step_ms * 1e3:.1f} tokens/s; "
        f"SSM cache {cache_bytes / cfg.n_layers / 1e6:.3f} MB per layer, {cache_bytes / 1e6:.1f} MB in all ({smi})")
    report["serve"] = dict(generate_s=gen_s, decode_steps=eng.decode_steps, launches=gen_counts,
                           tokens=out[:, SSM_PROMPT:].tolist(), decode_step_ms=step_ms,
                           tokens_per_s=SSM_ROWS / step_ms * 1e3, cache_bytes=cache_bytes,
                           profile=profile_device(torch, step, 2, step_ms, "decode step"))
    del eng, cache, model, params, eval_step
    torch.cuda.empty_cache()

    # -- 7e. kernel against plain scan, full width, a 4-layer cut -----------
    cut = dataclasses.replace(cfg, n_layers=4)
    log(f"[7] 4-layer cut of falcon_mamba_7b at full width: logits through B15 against the plain twin, "
        f"tolerance {TOL_SSM_LOGITS:.0e} of max|logit|")
    params = Transformer(cut, device=dev, gen=torch.Generator(device=dev).manual_seed(0)).params
    worst = {}
    with torch.no_grad():
        lk, _ = forward(cut, params, batch)
        lp, _ = forward(cut, params, batch, ssm_impl="plain")
    worst["eval"] = check("eval batch logits", lk.float(), lp.float(), TOL_SSM_LOGITS) / float(lp.float().abs().max())
    del lk, lp
    ck = init_decode_cache(cut, SSM_ROWS, 16, torch.bfloat16, device=dev)
    cp = init_decode_cache(cut, SSM_ROWS, 16, torch.bfloat16, device=dev)
    for t in range(8):
        tok = torch.from_numpy(prompts[:, t:t + 1]).to(dev)
        lk, ck = decode_step(cut, params, ck, tok)
        lp, cp = decode_step(cut, params, cp, tok, ssm_impl="plain")
        err = check(f"decode step {t} logits", lk.float(), lp.float(), TOL_SSM_LOGITS)
        worst[f"decode_{t}"] = err / float(lp.float().abs().max())
    report["kernel_vs_plain_logits_rel"] = worst
    del params, ck, cp, batch
    torch.cuda.empty_cache()

    # A small input against a reference: reduced f32 falcon_mamba_7b served on
    # the card (B15) and on the CPU (plain twin), greedy.
    rcfg = get_reduced("falcon_mamba_7b")
    rparams = Transformer(rcfg, device="cpu", gen=torch.Generator().manual_seed(0)).params
    rprompts = np.random.default_rng(3).integers(0, rcfg.vocab_size, (4, 12), dtype=np.int32)
    toks = {d: Engine(rcfg, rparams, ServeConfig(max_seq=32, max_new_tokens=16), device=d).generate(rprompts)
            for d in ("cuda", "cpu")}
    if not torch.equal(toks["cuda"], toks["cpu"]):
        raise AssertionError(f"reduced falcon_mamba_7b: card and CPU tokens differ: {toks}")
    log(f"  reduced falcon_mamba_7b: 4 rows x 16 tokens identical on the card and the CPU "
        f"(first {toks['cuda'][0, 12:20].tolist()})")

    e = held["eval"]
    entry = {"name": "ssm_scan", "route": "cuda", "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
             "replaces": "src/repro/kernels/ssm_scan.py:58",
             "launches": eval_counts["ssm_scan"] + gen_counts["ssm_scan"],
             "max_abs_err": max(max(h["err_y"], h["err_h"]) for h in held.values()), "ms": e["ms"],
             "plain_ms": e["plain_ms"], "bound_ms": e["bound_ms"], "bound_by": e["bound_by"], "library_ms": None}
    return report, entry


def param_phase(torch, timer, rate: float, smi: str, specs, t3_dims):
    """Phase 8: the parameter-writing API (B6, B7) and the plain line stats
    (B8) on full-width gpt_small's leaves and opt_speed's 4096 x 8192
    tensor. Returns (report, the three entries of the kernels line)."""
    from repro_torch import kernels
    from repro_torch.kernels import fused_adam as fa, ops, slim_update as su, snr_stats as ss

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    hyper = dict(b1=0.9, b2=0.95, eps=1e-8)
    kw = dict(lr=1e-3, wd=0.1, count=3, **hyper)
    leaves = {}
    for name, spec in specs.items():
        p = 0.02 * torch.randn(spec.shape, generator=gen, device=dev)
        g = 1e-3 * torch.randn(spec.shape, generator=gen, device=dev)
        m = 1e-4 * torch.randn(spec.shape, generator=gen, device=dev)
        v = 1e-6 * torch.rand(spec.shape, generator=gen, device=dev)
        leaves[name] = (p, g, m, v)
    slim = {}   # Table-3 leaves that B7 serves: (dims, plan, v_red)
    for name, dims in t3_dims.items():
        plan = ops.leaf_plan(tuple(specs[name].shape), torch.float32, dims)
        if plan.route == "slim":
            p = leaves[name][0]
            red = tuple(1 if i in {d % p.ndim for d in dims} else n for i, n in enumerate(p.shape))
            slim[name] = (tuple(dims), plan, 1e-6 * torch.rand(red, generator=gen, device=dev))
    r, c = 4096, 8192   # benchmarks/opt_speed.py's "full" tensor
    full = {dt: (torch.randn((r, c), generator=gen, device=dev).to(dt),
                 (0.1 * torch.randn((r, c), generator=gen, device=dev)).to(dt)) for dt in (torch.float32, torch.bfloat16)}
    zeros, zrow, zcol = (torch.zeros(shape, device=dev) for shape in ((r, c), (r, 1), (1, c)))
    full_kw = dict(lr=1e-3, wd=0.1, count=1, **hyper)

    # -- 8a. the counted run through the entry points ------------------------
    log(f"[8] the parameter-writing API: fused_adam_op over gpt_small's {len(leaves)} leaves, slim_update_nd over "
        f"its {len(slim)} Table-3 compressed leaves, slim_update_op (axis 0 and 1) and fused_adam_op on a "
        f"{r} x {c} tensor (f32 and bf16 p), snr_stats over v's lines")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    adam_out = {k: ops.fused_adam_op(*t, **kw) for k, t in leaves.items()}
    slim_out = {k: ops.slim_update_nd(*leaves[k][:3], v_red, dims=dims, **kw) for k, (dims, _, v_red) in slim.items()}
    full_out = {}
    for dt, (p, g) in full.items():
        tag = str(dt).split(".")[-1]
        g32 = g.float().contiguous()
        full_out[f"fused_adam_op {tag}"] = ops.fused_adam_op(p, g32, zeros, zeros, **full_kw)
        full_out[f"slim_update_op axis 1 {tag}"] = ops.slim_update_op(p, g32, zeros, zrow, axis=1, **full_kw)
        full_out[f"slim_update_op axis 0 {tag}"] = ops.slim_update_op(p, g32, zeros, zcol, axis=0, **full_kw)
    lines = {k: o[2].reshape(-1, o[2].shape[-1]) for k, o in adam_out.items()}
    snr_out = {k: ss.snr_stats(v2) for k, v2 in lines.items()}
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = {"fused_adam": len(leaves) + 2, "slim_update_batched": len(slim) + 4, "snr_stats_batched": len(lines)}
    log(f"  launches { {k: v for k, v in counts.items() if v} }")
    if {k: counts[k] for k in want} != want or sum(counts.values()) != sum(want.values()):
        raise AssertionError(f"parameter-writing run launched {counts}, expected {want} and no other kernel")

    # -- 8b. each against its plain twin and the preconditioner route ---------
    bc1, bc2 = fa.host_bias_corrections(0.9, 0.95, 3)
    errs = {"fused_adam": 0.0, "slim_update_batched": 0.0, "snr_stats_batched": 0.0}
    for name, (p, g, m, v) in leaves.items():
        got, twin = adam_out[name], fa.fused_adam_plain(p, g, m, v, lr=1e-3, wd=0.1, bc1=bc1, bc2=bc2, **hyper)
        errs["fused_adam"] = max(errs["fused_adam"], *(max_err(a, b)[0] for a, b in zip(got, twin)))
        for what, a, b in zip(("p'", "m'", "v'"), got, twin):
            if max_err(a, b)[1] > TOL_ELEMENTWISE:
                raise AssertionError(f"fused_adam {name} {what}: {max_err(a, b)} against its twin")
        u, m_p, v_p = fa.adam_precond(*(t.reshape(-1, t.shape[-1]) for t in (g, m, v)), count=3, **hyper)
        u, m_p, v_p = (t.reshape(p.shape) for t in (u, m_p, v_p))
        if max_err(got[0], fa.param_step(p, u, lr=1e-3, wd=0.1))[1] > TOL_ELEMENTWISE or not (
                torch.equal(got[1], m_p) and torch.equal(got[2], v_p)):
            raise AssertionError(f"fused_adam {name}: p' differs from adam_precond followed by the step")
    log(f"  fused_adam: {len(leaves)} leaves against the twin and adam_precond + step, worst abs err "
        f"{errs['fused_adam']:.3e} (tol {TOL_ELEMENTWISE:.0e} relative)  ok")
    for name, (dims, plan, v_red) in slim.items():
        cn = plan.cn
        p3, g3, m3 = (ops.canon_apply(t, cn).contiguous() for t in leaves[name][:3])
        v3 = ops.canon_apply(v_red, cn, reduced_cols=True).contiguous()
        if p3.ndim == 2:
            p3, g3, m3, v3 = p3[None], g3[None], m3[None], v3[None]
        got = su.slim_update_batched(p3, g3, m3, v3, axis=cn.axis, **kw)
        twin = su.slim_update_batched_plain(p3, g3, m3, v3, axis=cn.axis, lr=1e-3, wd=0.1, bc1=bc1, bc2=bc2, **hyper)
        for what, a, b, tol in zip(("p'", "m'", "v'"), got, twin, (TOL_LINE, TOL_ELEMENTWISE, TOL_LINE)):
            errs["slim_update_batched"] = max(errs["slim_update_batched"], max_err(a, b)[0])
            if max_err(a, b)[1] > tol:
                raise AssertionError(f"slim_update_batched {name} {what}: {max_err(a, b)} against its twin")
        u, m_p, v_p = su.slim_precond_batched(g3, m3, v3, axis=cn.axis, count=3, **hyper)
        if max_err(got[0], fa.param_step(p3, u, lr=1e-3, wd=0.1))[1] > TOL_ELEMENTWISE or not (
                torch.equal(got[1], m_p) and torch.equal(got[2], v_p)):
            raise AssertionError(f"slim_update_batched {name}: p' differs from slim_precond_batched + the step")
        nd = slim_out[name]
        for a, b in zip(nd, (ops.canon_restore(o[0] if plan.cn.batch == 1 else o, cn, t.shape)
                             for o, t in zip(got, (leaves[name][0], leaves[name][2], v_red)))):
            if not torch.equal(a, b):
                raise AssertionError(f"slim_update_nd {name}: differs from B7 on its canonical view")
    log(f"  slim_update_batched: {len(slim)} Table-3 leaves against the twin and slim_precond_batched + step, "
        f"worst abs err {errs['slim_update_batched']:.3e}  ok")
    f1 = fa.host_bias_corrections(0.9, 0.95, 1)
    for dt, (p, g) in full.items():
        tag = str(dt).split(".")[-1]
        g32 = g.float().contiguous()
        tol = TOL_ELEMENTWISE if dt == torch.float32 else TOL_BF16_PARAM
        twins = {f"fused_adam_op {tag}": fa.fused_adam_plain(p, g32, zeros, zeros, lr=1e-3, wd=0.1, bc1=f1[0],
                                                              bc2=f1[1], **hyper),
                 f"slim_update_op axis 1 {tag}": [o[0] for o in su.slim_update_batched_plain(
                     p[None], g32[None], zeros[None], zrow[None], axis=1, lr=1e-3, wd=0.1, bc1=f1[0], bc2=f1[1],
                     **hyper)],
                 f"slim_update_op axis 0 {tag}": [o[0] for o in su.slim_update_batched_plain(
                     p[None], g32[None], zeros[None], zcol[None], axis=0, lr=1e-3, wd=0.1, bc1=f1[0], bc2=f1[1],
                     **hyper)]}
        for key, twin in twins.items():
            for what, a, b, t in zip(("p'", "m'", "v'"), full_out[key], twin, (tol, TOL_ELEMENTWISE, TOL_LINE)):
                check(f"{key} {what}", a.float(), b.float(), max(t, TOL_LINE) if what == "p'" and "slim" in key
                      else t)
    for name, v2 in lines.items():
        for a, b in zip(snr_out[name], ss.snr_stats_batched_plain(v2[None], axis=1)):
            errs["snr_stats_batched"] = max(errs["snr_stats_batched"], max_err(a, b[0])[0])
            if max_err(a, b[0])[1] > TOL_LINE:
                raise AssertionError(f"snr_stats {name}: {max_err(a, b[0])} against its twin")
    log(f"  snr_stats: {len(lines)} leaves' v lines against the twin, worst abs err "
        f"{errs['snr_stats_batched']:.3e}  ok")

    # -- 8c. times against bounds, twins and one PyTorch call ------------------
    def total(items):
        return {k: sum(i[k] for i in items) for k in items[0]}

    adam_t = []
    for name, t in leaves.items():
        n = t[0].numel()
        adam_t.append(dict(ms=timer(lambda: fa.fused_adam(*t, **kw), reps=5),
                           plain_ms=timer(lambda: fa.fused_adam_plain(*t, lr=1e-3, wd=0.1, bc1=bc1, bc2=bc2, **hyper),
                                          reps=3),
                           bound_ms=max(28 * n / rate, 16 * n / F32_RATE) * 1e3))
    ps = [torch.nn.Parameter(t[0].clone()) for t in leaves.values()]
    for q, t in zip(ps, leaves.values()):
        q.grad = t[1].clone()
    opt = torch.optim.AdamW(ps, lr=1e-3, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1, fused=True)
    opt.step()
    adam_lib = timer(opt.step, reps=5)
    del ps, opt
    adam_sum = total(adam_t)
    slim_t = []
    for name, (dims, plan, v_red) in slim.items():
        cn = plan.cn
        p3, g3, m3 = (ops.canon_apply(t, cn).contiguous() for t in leaves[name][:3])
        v3 = ops.canon_apply(v_red, cn, reduced_cols=True).contiguous()
        if p3.ndim == 2:
            p3, g3, m3, v3 = p3[None], g3[None], m3[None], v3[None]
        n, n_lines = p3.numel(), v3.numel()
        slim_t.append(dict(
            ms=timer(lambda: su.slim_update_batched(p3, g3, m3, v3, axis=cn.axis, **kw), reps=5),
            plain_ms=timer(lambda: su.slim_update_batched_plain(p3, g3, m3, v3, axis=cn.axis, lr=1e-3, wd=0.1,
                                                                bc1=bc1, bc2=bc2, **hyper), reps=3),
            bound_ms=max((20 * n + 8 * n_lines) / rate, 14 * n / F32_RATE) * 1e3))
    slim_sum = total(slim_t)
    snr_t = []
    for name, v2 in lines.items():
        v3 = v2[None]
        n = v3.numel()
        snr_t.append(dict(ms=timer(lambda: ss.snr_stats_batched(v3, axis=1), reps=5),
                          plain_ms=timer(lambda: ss.snr_stats_batched_plain(v3, axis=1), reps=3),
                          bound_ms=max((4 * n + 8 * v3.shape[1]) / rate, 3 * n / F64_RATE) * 1e3,
                          library_ms=timer(lambda: torch.var_mean(v3, dim=2, correction=0), reps=5)))
    snr_sum = total(snr_t)
    full_t = {}
    for dt, (p, g) in full.items():
        tag = str(dt).split(".")[-1]
        g32 = g.float().contiguous()
        n, pb = p.numel(), p.element_size()
        full_t[f"fused_adam_op {tag}"] = dict(ms=timer(lambda: ops.fused_adam_op(p, g32, zeros, zeros, **full_kw)),
                                              bound_ms=(2 * pb + 20) * n / rate * 1e3)
        for axis, v_red in ((1, zrow), (0, zcol)):
            full_t[f"slim_update_op axis {axis} {tag}"] = dict(
                ms=timer(lambda: ops.slim_update_op(p, g32, zeros, v_red, axis=axis, **full_kw)),
                bound_ms=((2 * pb + 12) * n + 8 * v_red.numel()) / rate * 1e3)
        q = torch.nn.Parameter(p.clone())
        q.grad = g32.to(dt)
        opt = torch.optim.AdamW([q], lr=1e-3, betas=(0.9, 0.95), eps=1e-8, weight_decay=0.1, fused=True)
        opt.step()
        full_t[f"fused_adam_op {tag}"]["library_ms"] = timer(opt.step)
        del q, opt
    for key, t in full_t.items():
        log(f"  {key} ({r} x {c}): kernel {t['ms']:.4f} ms  bound {t['bound_ms']:.4f} ms"
            + (f"  AdamW(fused) {t['library_ms']:.4f} ms" if "library_ms" in t else ""))
    log(f"  per gpt_small tree: fused_adam kernel {adam_sum['ms']:.4f} ms  plain {adam_sum['plain_ms']:.4f} ms  "
        f"bound {adam_sum['bound_ms']:.4f} ms  AdamW(fused) {adam_lib:.4f} ms; slim_update_batched "
        f"{slim_sum['ms']:.4f} / {slim_sum['plain_ms']:.4f} / {slim_sum['bound_ms']:.4f} ms; snr_stats_batched "
        f"{snr_sum['ms']:.4f} / {snr_sum['plain_ms']:.4f} / {snr_sum['bound_ms']:.4f} ms, var_mean "
        f"{snr_sum['library_ms']:.4f} ms ({smi})")
    report = dict(launches=counts, errs=errs, fused_adam=dict(adam_sum, library_ms=adam_lib), slim=slim_sum,
                  snr=snr_sum, full=full_t)
    src = "src/repro_torch/kernels/csrc/"
    entries = [
        {"name": "fused_adam", "route": "cuda", "source": src + "adam_precond.cu",
         "replaces": "src/repro/kernels/fused_adam.py:58", "launches": counts["fused_adam"],
         "max_abs_err": errs["fused_adam"], "ms": adam_sum["ms"], "plain_ms": adam_sum["plain_ms"],
         "bound_ms": adam_sum["bound_ms"], "bound_by": "bytes", "library_ms": adam_lib},
        {"name": "slim_update_batched", "route": "cuda", "source": src + "mega_slim.cu",
         "replaces": "src/repro/kernels/slim_update.py:74", "launches": counts["slim_update_batched"],
         "max_abs_err": errs["slim_update_batched"], "ms": slim_sum["ms"], "plain_ms": slim_sum["plain_ms"],
         "bound_ms": slim_sum["bound_ms"], "bound_by": "bytes", "library_ms": None},
        {"name": "snr_stats_batched", "route": "cuda", "source": src + "snr_stats.cu",
         "replaces": "src/repro/kernels/snr_stats.py:126", "launches": counts["snr_stats_batched"],
         "max_abs_err": errs["snr_stats_batched"], "ms": snr_sum["ms"], "plain_ms": snr_sum["plain_ms"],
         "bound_ms": snr_sum["bound_ms"], "bound_by": "bytes", "library_ms": snr_sum["library_ms"]},
    ]
    return report, entries



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
    from repro_torch.core import measure_tree_snr, rules_to_dims, second_moment_savings, table3_rules
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
    snr.update(snr_total("B5", snr, 21, smi))
    torch.cuda.empty_cache()
    t3_dims = rules_to_dims(table3_rules(meta), meta)
    robust_held = robust_kernels(torch, timer, rate, gen, specs, meta, adam_plan, t3_plan, t3_dims)

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
    derived_dims = rules_to_dims(rules, meta)
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
            # One SNR measurement of Adam's moments (21 B5 launches and the
            # host work around them), in turns with a plain step.
            med, raw = in_turns(torch, {
                "adam_plain_step_ms": lambda: tr.run(tr.step + 1),
                "adam_snr_measure_ms": lambda: measure_tree_snr(tr.opt_state.inner_states[1].nu, tr.meta,
                                                                backend="fused")})
            timing_runs.update(med, adam_snr_raw=raw)
            log(f"  adam: SNR measurement (measure_tree_snr over nu, backend 'fused') "
                f"{med['adam_snr_measure_ms']:.3f} ms against a plain step's {med['adam_plain_step_ms']:.2f} ms, "
                f"in turns; B5 kernels alone {snr['ms']:.4f} ms (phase 2) ({smi})")
            # Where the measurement's time goes: device busy against its wall time, kernels by name.
            timing_runs["adam_snr_profile"] = profile_device(
                torch, lambda: measure_tree_snr(tr.opt_state.inner_states[1].nu, tr.meta, backend="fused"), 3,
                med["adam_snr_measure_ms"], "SNR measurement")
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
    report["kernels_detail"] = dict(groups=list(held.values()), snr=snr, robust=robust_held)
    del rdata, curves
    torch.cuda.empty_cache()
    report["robust"] = robust_phases(torch, timer, smi, cfg, specs, meta, data, lr, t3_plan, t3_dims)
    report["serve"], paged_entry = serve_phases(torch, timer, rate, smi)
    del timer
    torch.cuda.empty_cache()
    report["sharded"] = sharded = sharded_phase(torch, smi, rate)
    timer = Timer(torch)
    report["ssm"], ssm_entry = ssm_phase(torch, timer, rate, smi)
    report["param_api"], param_entries = param_phase(torch, timer, rate, smi, specs, t3_dims)
    del timer
    torch.cuda.empty_cache()

    # -- 9. result lines ------------------------------------------------------
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

    # This slice's kernels: launches from its counted runs (3b's guarded runs,
    # where every launch of B1/B2 carries with_health; 3d's per-leaf runs),
    # times per step of the path that launches them: B2's flag on Adam's dense
    # group, B1's two flags over the Table-3 plan's three slim groups, B3 over
    # the per-leaf Adam route's launches, B4 over the per-leaf Table-3 route's
    # compressed leaves, health on (the guarded step's form).
    guarded = report["robust"]["guarded"]
    per_leaf = report["robust"]["per_leaf"]

    def robust_entry(name, held_name, source, replaces, n_launch):
        h = robust_held[held_name]
        return {"name": name, "route": "cuda", "source": src + source, "replaces": replaces, "launches": n_launch,
                "max_abs_err": h["err"], "ms": h["ms"], "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
                "bound_by": "bytes", "library_ms": h["library_ms"]}

    b2_flag = robust_entry("mega_adam_update(with_health)", "mega_adam_update(with_health)", "mega_adam.cu",
                           "src/repro/kernels/megaplan.py:351",
                           guarded["adam"]["launches"]["mega_adam_update"])
    b2_flag["library_ms"] = plan_sum(adam_plan, "mega_adam_update", "library_ms")
    line = {"kernels": [
        group_entry("mega_adam_update", adam_plan, "mega_adam.cu", "src/repro/kernels/megaplan.py:351"),
        group_entry("mega_slim_update_batched", t3_plan, "mega_slim.cu", "src/repro/kernels/megaplan.py:417"),
        b2_flag,
        robust_entry("mega_slim_update_batched(with_health,with_snr)", "mega_slim_update_batched(with_health,with_snr)",
                     "mega_slim.cu", "src/repro/kernels/megaplan.py:417",
                     guarded["slim"]["launches"]["mega_slim_update_batched"]),
        robust_entry("adam_precond", "adam_precond(with_health)", "adam_precond.cu",
                     "src/repro/kernels/fused_adam.py:129",
                     per_leaf["adam"]["launches"]["adam_precond"] + per_leaf["slim"]["launches"]["adam_precond"]),
        robust_entry("slim_precond_batched", "slim_precond_batched(with_health)", "mega_slim.cu",
                     "src/repro/kernels/slim_update.py:154", per_leaf["slim"]["launches"]["slim_precond_batched"]),
        {"name": "snr_stats_centered_batched", "route": "cuda", "source": src + "snr_stats.cu",
         "replaces": "src/repro/kernels/snr_stats.py:133", "launches": launches["snr_stats_centered_batched"],
         "max_abs_err": snr["err"], "ms": snr["ms"], "plain_ms": snr["plain_ms"], "bound_ms": snr["bound_ms"],
         "bound_by": "bytes", "library_ms": snr["library_ms"]},
        paged_entry,
    ]}
    # The sharded slice's kernels: launches from 6c's counted runs on rank 0
    # (every rank launches the same), errors the worst over every rank, times
    # on rank 0 alone over what one step (B10-B13) or one SNR measurement
    # (B9) launches them on.
    def sharded_entry(name, key, source, replaces, n_launch):
        h = sharded["kernels"][key]
        return {"name": name, "route": "cuda", "source": src + source, "replaces": replaces, "launches": n_launch,
                "max_abs_err": sharded["kernel_err"][key], "ms": h["ms"], "plain_ms": h["plain_ms"],
                "bound_ms": h["bound_ms"], "bound_by": "bytes", "library_ms": h["library_ms"]}

    grouped_runs = ("slim_launches", "slim_snr_launches", "guard_launches")
    line["kernels"] += [
        sharded_entry("snr_stats_centered_partial_batched", "B9", "snr_stats.cu",
                      "src/repro/kernels/snr_stats.py:152",
                      sharded["adam_launches"]["snr_stats_centered_partial_batched"]),
        sharded_entry("slim_partial_stats_batched", "B10", "mega_slim.cu", "src/repro/kernels/slim_update.py:260",
                      sharded["per_leaf_launches"]["slim_partial_stats_batched"]),
        sharded_entry("slim_finalize_batched", "B11", "slim_finalize.cu", "src/repro/kernels/slim_update.py:329",
                      sharded["per_leaf_launches"]["slim_finalize_batched"]),
        sharded_entry("mega_slim_partial_stats_batched", "B12", "mega_slim.cu", "src/repro/kernels/megaplan.py:486",
                      sum(sharded[r]["mega_slim_partial_stats_batched"] for r in grouped_runs)),
        sharded_entry("mega_slim_finalize_batched", "B13", "slim_finalize.cu", "src/repro/kernels/megaplan.py:536",
                      sum(sharded[r]["mega_slim_finalize_batched"] for r in grouped_runs)),
    ]
    line["kernels"] += param_entries + [ssm_entry]
    if len(line["kernels"]) != len(kernels.KERNELS) + 2 or min(e["launches"] for e in line["kernels"]) < 1:
        raise AssertionError(f"kernels line: {len(line['kernels'])} entries (B1 and B2 with their flags as "
                             f"separate rows), launches {[e['launches'] for e in line['kernels']]}")
    report["kernels"] = line
    report["device"] = smi
    report["seconds"] = time.perf_counter() - t_start
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_report.json").write_text(json.dumps(report, indent=1, default=str))
    log(f"[9] done in {report['seconds']:.0f} s; report in build/chip_smoke_report.json")
    log(json.dumps(line))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
