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
   one PyTorch call computes the same function, that call's time. On every
   slim group (here and wherever phases 3 and 9 hold a plan) B1 reruns bit
   for bit, its walk's form (``plan_slim``) and design floor (g read twice
   where a split view's g outgrows the L2) are logged, and
   ``slim_precond_batched`` (B4, same walk) is held against its twin, rerun
   bit for bit and timed on the same inputs. B5's
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
3b. Guarded training at full width cut to 4 of gpt_small's 12 layers (every
   leaf, plan group and launch count of the whole model), batch 8 x 1024 as
   ``grad_accum=2``:
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
   the same state (1e-5), the per-leaf update again (bit for bit), with
   launches and times per update on each.
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
   full-width smollm_135m cut to SERVE_LAYERS of its 30 layers (random
   weights from seed 0), 32 requests of 64 new tokens (28 greedy, 4
   sampled) over 16 slots and a pool small enough to preempt. Every request
   must finish by length with no page left used, and ``paged_attention``
   must launch once a layer per decode step and prefill chunk. Then
   decode-step and prefill-chunk times and a device profile of decode
   steps and prefill chunks, with B14's share; the logits of a prefill chunk and of 4 decode steps through the kernel
   against the plain twin from the same state; and reduced f32 smollm_135m
   and gpt_small served on the card against the CPU, token for token.
6. The sharded slice: 4 processes share the card as the ranks of a
   (data=2, model=2) mesh (``repro_torch.launch.mesh``; gloo, since NCCL
   refuses two ranks on one device; all-reduce and all-gather on the device
   tensors), full-width gpt_small with the global batch 8 x 1024, 4 rows a
   data group (6c-6e train it cut to 2 of its 12 layers: the forward's
   collectives, staged through the host by gloo, cost a layer each; 6a,
   6b and 6f hold the whole model). 6a: B9-B13 against their
   twins on each rank's local shards of the Table-3 plan's 7 psum leaves
   (B10 base, ``with_snr``, ``with_health``, its ``plan_slim`` form logged;
   B11 ek and owner, two runs bit-equal; B12 and B13 on the psum groups,
   B12 rerun bit for bit with each flag set, B12's and B13's plans logged;
   B9 on the 21 SNR candidates,
   whose lines the mesh splits), non-finite counts exact, then each kernel
   timed on rank 0 alone (B9's total over its 21 candidates against
   ``torch.var_mean``'s; B11's twin forms its bias corrections from the
   same count on the card), and one B11 and one B13 call under
   torch.profiler, each of which must run exactly one device kernel (the
   flat walk).
   6b: sharded Table-3 and AdaLayer SlimAdam updates and a sharded Adam
   update against the port's unsharded update of the same whole gradients
   (local leaves and Adam bit-equal, psum leaves within 2e-6), the
   per-leaf route against the grouped one. 6c: the sharded trainer, each run's launch counters
   zeroed before and read after: Adam measuring SNR (B9), derived rules,
   SlimAdam with them and from-update SNR, Table-3 SlimAdam (B12/B13), its
   per-leaf route (B10/B11), a guarded step with an injected NaN that must
   leave every rank's shards bit-identical (every gradient entry counted
   non-finite), then 2 AdaLayer steps on each
   route (every leaf in the psum regime, the embedding's shard one
   9,658,368-element line through B12/B13 and B10/B11; regime counts,
   launches and wall time logged); the forward runs tensor- and
   sequence-parallel over ``model`` (every attention and MLP region
   counted in its parallel form, none by the fallback); losses against the
   unsharded port on the same batches within 1e-4. 6d: a checkpoint saved on the mesh,
   restored on the mesh (bit-equal shards) and unsharded (equal crc32s).
   6e: the sharded step's time, 4 ranks on one card (not a multi-GPU
   number), and the gradient all-reduce's; one more step profiled (busy
   share on every rank) with the forward's collectives timed; peak memory
   on every rank. A rank that fails ends the run.
6f-6l. The forward on the mesh, phase 6's 4 rank processes and group
   going on (``mesh_rank``): gpt_small cut to 2 layers (8 x 1024),
   olmoe_1b_7b cut to 1 layer and falcon_mamba_7b cut to 1 (2 x 2048: a row a data group; olmoe's 320
   slots an expert a group) at full width through the sharded Trainer: in
   f32 activations Adam for 2 steps measuring SNR at step 2, in bf16
   Table-3 SlimAdam for 2 (6f; olmoe's bf16 run is 6k's, TP_DTYPES).
   Every layer's attention,
   MLP, MoE or Mamba mixer must take its tensor-, sequence- or
   expert-parallel form (counted a layer a step, forward and remat
   recompute; no fallback); launches counted (B2; B9; B12/B13 where the
   Table-3 plan has psum leaves; on falcon B15 twice a layer a step and the
   backward once, all on 4096 of the 8192 channels). Each run is held to
   the unsharded port's from the same weights (those runs dealt out to two
   ranks at once, rank 0 gathering and checking) (olmoe's under a
   ``SpecMesh`` with a ``data`` axis of 2: JAX's 2 dispatch groups) (6g):
   f32 losses within 1e-4 and the first batch's gradients within 1e-5 of
   each leaf's largest |g|, and the split form's losses (the model ranks'
   partial sums added in one process by ``tests/_torch_split.py``, no
   collective) within 1e-4 of unsharded; bf16 losses within max(1e-4,
   twice the unsharded port's own difference when the batch is summed as
   2 micro-batches) of the split form's, which round the mesh's bf16
   partial sums as the mesh does (their distance from unsharded is
   reported). bf16 (6h): step
   times, the last Table-3 step profiled (busy share on every rank against
   the first step's time; the regions' collectives timed, synchronized),
   one gradient bucket's all-reduce, peak memory of every rank. 6i:
   ``gpipe`` on a (4,) ``pipe`` mesh of the same ranks, a full-width
   gpt_small block a stage (f32), 8 microbatches of 1 x 1024:
   outputs and the gradients of x and the stage parameters against
   ``sequential_reference`` (1e-5), 10 handoffs each way. 6j: moment-less
   SlimAdam (Table 3 on gpt_small's leaves) sharded against unsharded, 2
   updates (2e-6), no kernel launched. 6k: parameter-shard storage on the
   same ranks, through ``repro_torch.launch.train`` (``build``: each leaf
   drawn whole from a CUDA generator seeded 0, as 6f's Trainer draws it,
   and kept as this rank's shard; the step built with ``grad_shardings``;
   ``train``, the launcher's loop): gpt_small cut to 2 layers (8 x 1024) and
   falcon_mamba_7b cut to 1 layer (2 x 2048), f32 Adam for 2 steps, held
   to 6f's whole-parameter run on the same rank (losses 1e-5, first-step
   gradient shards TOL_TP_GRAD of each leaf's largest |g|); olmoe_1b_7b
   cut to 1 layer (2 x 2048, lr 1e-4, JAX's G = 2 groups; its f32 run also
   held to 6f's), f32 Adam with one SNR measurement of its moment shards
   (B9) after its steps, then bf16 Table-3 SlimAdam, 2 steps each. Every
   rank's bytes of p, g, m and v must equal the count reckoned from
   ``shardspec.local_shape`` (``launch.train.reckon_bytes``); each run's
   peak over the rank's start, regions (parallel form, a layer a step
   forward and recompute) and launches (B2; B9; B12/B13 where Table 3 has
   psum leaves) on every rank; the bf16 Table-3 step's host time and
   device-busy share (rank 0 and every rank; gloo on one card, not a
   multi-GPU number). After the ranks exit, olmoe's references on the
   whole card: f32 against the unsharded port (losses 1e-5, every rank's
   gradient shards TOL_TP_GRAD), bf16 against the split form at 6g's bar,
   and the routing choices and drops of each step and layer that differ
   from the split form's and the unsharded port's, counted. 6k (a): the
   dry run (``repro_torch.launch.dryrun``, in a process of its own over a
   fake 4-rank group, on ``meta``, started after the build) of each of those runs:
   its bytes a rank, the last step's collectives (calls and bytes by kind)
   and kernel launches must equal rank 0's; its predicted peak is printed
   beside the measured one. 6k (b): Adafactor, SM3, Lion, SGD-M and
   SlimAdam on ``backend="jnp"`` under shard storage on full-width
   gpt_small cut to 2 layers (4 x 512, f32, 2 steps each: batch and
   sequence halved too, since each run trains twice, and the regions'
   gloo collectives of activations grow with the tokens), bytes against
   the reckoned count, losses within 1e-5 of the whole-parameter Trainer on
   the same ranks; (c) the Adafactor run checkpoints through the launcher
   and a fresh build restored from it continues bit-equal. Then B15's
   training form and
   ``ssm_scan_bwd`` at a rank's channel shard (1 x 2048 x 4096, N 16, bf16)
   against their twins, timed beside their bounds.
6l. The decode step on the same ranks in JAX's decode layout
   (``train.step.make_serve_step`` under ``repro/launch/dryrun.py:204-217``:
   each rank's stored parameter shards, ``launch.train.stored_weights``, read
   tensor-parallel over ``model``; its rows; its block of the cache, the KV
   positions and the SSM ``d_inner`` over ``model``): (a) olmoe_1b_7b and
   (b) falcon_mamba_7b each cut to 2 layers at full width, 4 rows (2 a data
   rank), a 64-position cache (32 a model rank), 12 prompt tokens then 36
   greedy steps, so the writes cross the block boundary; each rank first
   serves the same weights unsharded (drawn on the card from a CUDA
   generator seeded 0). f32: every step's logits within 1e-5 of max|logit|,
   identical tokens, the cache blocks and SSM states within 1e-5 of the
   unsharded cache's cut, every region (the vocabulary-parallel embedding
   and head, attention, the MoE, the Mamba mixer) in its parallel form, B15's
   one-token form 2 x 48 times, all on every rank. bf16 (parameters too): fed
   the unsharded run's tokens, the greedy agreement and logit gap reported.
   (c) one step of (a) at decode_32k's 32,768-position cache (16,384 a model
   rank): 3 steps on the host clock, synchronised; one profiled (busy share
   by rank); collectives and peak by rank. (d) after the ranks, B15's
   one-token form at a rank's channels (2 x 1 x 4096, N 16, f32) against its
   twin, twice bit for bit, timed beside its bound. (e) the dry run of each
   of those steps (the 6k subprocess, on ``meta``): bytes a rank (parameter
   shards and cache block), collectives and launches equal every rank's
   measured step; its peak beside each rank's.
6m. The launcher on a mesh, end to end: ``python -m
   repro_torch.launch.train`` (``launch.train.main(argv)``, unchanged) run
   by fresh rank processes sharing the card over gloo, each started as
   torchrun starts a rank (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
   ``MASTER_ADDR``/``MASTER_PORT``, ``OMP_NUM_THREADS=1``), with ``launch.mesh.
   make_production_mesh`` replaced by a mesh of the production mesh's axes
   at small sizes (LAUNCH_MESHES): 8 ranks of (pod=2, data=2, model=2) run
   ``--arch gpt_small --mesh multi --steps 4 --ckpt DIR --log-every 1`` at
   full width and depth (124,373,760 parameters; the launcher's ``--seq
   128 --batch 8``, ``--optimizer slim``, ``--backend auto``: the fused
   route), a checkpoint every step; then 4 fresh ranks of (data=2,
   model=2) run ``--mesh single`` from the step-2 checkpoint to step 4.
   Checks, each ending the run: only rank 0 prints; every rank's bytes of
   p, g, m and v equal ``reckon_bytes`` for its mesh; the dry run of each
   mesh's step on ``meta`` (``--dryrun-6m``, a process each, started after
   the build) equals every rank's first and last step in bytes, collectives and
   launches, its peak within 6l (e)'s band of each rank's second step's (the
   first also allocates one-time buffers); every kernel of the plan
   (B2 on the dense leaves; B12 and B13 on Table 3's psum groups: under it
   every compressed leaf of gpt_small is a psum leaf on these meshes, so B1
   has no leaf) launches on every rank; the losses against the unsharded
   port on the whole card (the same weights from a CPU generator seeded 0)
   and steps 3-4 after the resume against the uninterrupted multi job,
   within 6g's bf16 bar. Reported: host ms a step, busy share and
   collectives by rank (gloo on one card, not a multi-GPU number).
7. The SSM serving path: ``ssm_scan`` (B15) against its plain twin at the
   eval shape (1 x 2048 x 8192, N 16; the planner's sequence form) and the
   decode shape (4 rows, S = 1, a random h0; the one-token form), each run
   twice and compared bit for bit, timed as in phase 2 beside its bound
   (bytes, or its exponentials over the SFU rate, with the sequence form's
   second pass of them); then full-width, full-depth
   falcon_mamba_7b (64 layers, 7,006,326,784 parameters, 28.0 GB in f32)
   initialised on the card from a seeded CUDA generator: ``make_eval_step``
   on a ZipfLM batch of 1 x 2048 (finite loss, 64 B15 launches, B15's
   share of its device time by torch.profiler), and
   ``Engine.generate``'s legacy loop on 4 ZipfLM prompts of 64 tokens with
   32 greedy new tokens (64 launches per ``decode_step``, 64 + 31 steps);
   decode-step time, tokens/s, the device-busy share (torch.profiler) and
   the SSM cache's bytes. Then a 4-layer cut at full width: logits of the
   eval batch and of 8 decode steps through B15 against the plain twin;
   the eval forward and the decode steps take B15's forms without the tile
   store (``ssm_scan.form_launches`` counted);
   and reduced f32 falcon_mamba_7b served on the card against the CPU,
   token for token. The model is freed before phase 8.
7f. The SSM training path: ``ssm_scan_bwd`` against its plain twin at the
   training shape (B = 2, S = 2048, D = 8192, N = 16, bf16 x/B/C/dy, random
   dh_final; the forward's 4 chunks) and a one-chunk shape (4 x 256), from
   the tile states B15's training form kept, each twice and compared bit
   for bit, its replayed final state equal to B15's h_final, timed beside
   its bound (bytes, or one exponential and 18 f32 operations an element)
   and the twin; no library call computes it. Its geometry (grid, warps a
   block, shared bytes, workspace bytes) and B15's training form with and
   without the tile store, in turns.
7g. Full-width falcon_mamba_7b cut to 4 layers (687,591,424 parameters;
   depth is the only cut) on ZipfLM batches of 2 x 2048, bf16 activations,
   remat, through the Trainer (``backend="fused"``): Adam for 4 steps
   measuring SNR at step 4 (B5 on the 15 candidates), the rules
   ``derive_slim_rules`` gives the ssm leaves beside Table 3's, then Table-3
   SlimAdam for 4 steps; launch counters zeroed before and read after each
   run (B15 twice a layer a step under remat, both in the form that keeps
   its tile states, ``ssm_scan_bwd`` once, replaying from them, B2/B1 per
   the plan's groups); finite losses, the last below the first; peak
   memory, second-moment bytes and savings, step times in turns and each
   step's device profile (busy share, the backward kernel's and B15's ms).
7h. One step's gradients of a 2-layer full-width cut through the kernels
   against the plain scan (``ssm_impl="plain"``), f32 activations (1e-3 of
   each leaf's largest |g|) and the path's bf16 (5e-2).
8. The parameter-writing API: ``fused_adam_op`` (B6) over every full-width
   gpt_small leaf, ``slim_update_nd`` (B7) over its Table-3 compressed
   leaves, ``fused_adam_op`` and ``slim_update_op`` (axis 0 and 1) on
   benchmarks/opt_speed.py's 4096 x 8192 tensor with wd 0.1 and f32 and
   bf16 p, ``snr_stats`` (B8) over the Adam v lines, with the launch
   counters zeroed before and read after; each against its plain twin, p'
   against ``adam_precond`` / ``slim_precond_batched`` followed by the same
   step (B7 on each leaf rerun bit for bit, its ``plan_slim`` form logged),
   and timed beside its bound and ``AdamW(fused=True)`` (B6) or
   ``torch.var_mean`` (B8); B8 also per form of its split walk, the
   embedding's v as one line (SPLIT) and along its rows (MAJOR) beside the
   main path's WARP views.
9. The paper's baselines and figure probes. 9a: ``mega_slim_update_batched``
   (B1; B2 on their dense groups) against its twin on every group of the
   AdaLayer, AdaLayer-LN-TL and Adam-mini v1/v2 plans of full-width
   gpt_small, timed as in phase 2 (B4 beside it), with the time of
   AdaLayer's 38,633,472-element embedding line and each plan's total;
   then ``slim_update_batched`` (B7), ``mega_slim_partial_stats_batched``
   (B12) and ``slim_partial_stats_batched`` (B10; f32 and bf16 g, without
   and with both flags) on their split walk, and
   ``mega_slim_finalize_batched`` (B13; ek and owner form) on the flat
   walk, held against their twins, rerun bit for bit, counted (one launch
   a call) and timed beside bound, floor and twin (B13 also beside a
   device copy of its bytes) on that line (SPLIT), on a rank's
   9,658,368-element embedding shard line (SPLIT) and on ResNet-18's (1,
   4608, 1536) axis-0 group (MAJOR). 9b: the 12 optimizers of
   ``repro_torch.train.trainer.OPTIMIZERS`` through the Trainer on
   full-width gpt_small cut to 4 of its 12 layers (batch 8 x 1024, bf16
   activations, 3 steps each,
   launch counters zeroed before and read after each run: B1 and B2 per
   the plan's groups each step for the SlimAdam family, B2 for Adam, no
   kernel for Adafactor, SM3, Lion and SGD-M), finite losses, optimizer
   state bytes, second-moment entries and savings, peak memory, one fused
   update against the plain 'jnp' backend for each SlimAdam rule set, and
   every optimizer's step time in turns. 9c: ResNet-18 (11,218,240
   parameters) at full width on ``synthetic_cifar`` batches of 32 x 32 x
   32: its Table-3 plan's groups (9 axis-0) held as in 9a, 4 Adam steps and one SNR
   measurement (B5 on its 63 candidates), 4 Table-3 SlimAdam steps and one
   update against 'jnp', a reduced ResNet's logits on the card against the
   CPU. 9d: the linear LM (vocab 49152, d 32), 4 Adam steps and one SNR
   measurement; full-width gpt_medium (354,599,936 parameters), 2 Table-3
   SlimAdam steps.
10. Serving the MoE family: ``paged_attention`` (B14) against its plain
   twin at olmoe_1b_7b's geometry (16 heads of 128 over 16 KV groups, one
   query head a group; pages of 16): a decode batch of 8 ragged rows and
   128-token prefill chunks at pos0 0 and 384, f32 and bf16 queries over a
   bf16 pool, each twice bit for bit, timed as in phase 4. Then
   full-width, full-depth olmoe_1b_7b (16 layers of attention and a 64-expert
   top-8 MoE, 6,919,096,320 parameters, 27.7 GB of f32 weights drawn on the
   card from a seed, bf16 activations) through the paged engine: 8
   requests of 64-512 prompt tokens and 32 greedy tokens each over 8 slots;
   B14 launches 16 times a decode step and prefill chunk and no other
   kernel runs; TTFT, TPOT, the decode step's and a prefill chunk's host
   time and device profile (busy share, B14's ms), the MoE layer's device
   time by stage (router, sort, dispatch, the weights' casts, the experts'
   bmm, combine) at both shapes; the first prefill chunk's logits through
   B14 against the plain twin, and how many of the engine's greedy tokens
   the plain twin's path gives too (reported, not required); reduced f32
   olmoe_1b_7b served on the card against the CPU, token for token.
11. Training the MoE family: full-width olmoe_1b_7b cut to 1 of its 16
   layers (625,612,800 parameters; depth is the only cut) on ZipfLM
   batches of 2 x 2048, bf16 activations, remat, through the Trainer: the
   first 2 losses with ``backend='jnp'``, then Adam (fused) for 4 steps
   measuring SNR at step 4, whose first 2 losses must match (1e-4), the
   rules ``derive_slim_rules`` gives the expert leaves beside Table 3's,
   Table-3 SlimAdam for 4 steps; launches counted (B2/B1 per the plan's
   groups, B5 on the candidates), the routing choices the expert capacity
   (640) drops per layer and step (the backward's recompute must drop the
   same), finite and falling losses, peak memory split as in 7g,
   second-moment bytes and savings, step times in turns; one fused update
   of each optimizer against 'jnp' from the same state and gradients
   (1e-5) and one SNR measurement of Adam's second moments through B5
   against 'jnp' (the expert leaves' candidates 1e-4, the derived rules
   equal); each step's device profile (busy share, the megaplan kernels'
   share) and the MoE layers' share (one layer's forward and forward +
   backward timed alone).
12. ``python -m repro_torch.examples.diy_slim``'s ``run`` on the card with
   ``backend='fused'`` (reduced jamba: Mamba and attention mixers, dense and
   MoE FFNs; B15 and its backward once a Mamba layer a step, B1, B2, B5):
   the first 5 probe losses against the twin's probe with 'jnp' on the CPU
   (1e-3), the SNR table, derived rules and savings reported.
13. Training the rest of the dense zoo through ``make_train_step`` (as
   the JAX package trains these models), each on one fixed batch from a
   seed, bf16 activations, remat, lr 1e-4. 13a: hubert_xlarge at full
   width cut to 6 of its 48 layers (d 1280, 16 heads of 80, non-causal;
   118,626,560 parameters; 944,487,680 whole) on
   2 x 4096 frame embeddings with per-frame labels: the flash path forward
   and backward in blocks of 1024; 3 Adam steps (B2), one SNR measurement
   of its second moments (B5), ``derive_rules``, 3 SlimAdam steps with the
   derived rules (B1/B2 per the plan's groups), 3 with Table 3's rules
   (B1 on the compressed groups). 13b: vit_small whole (85,237,248
   parameters) on 32 x 256 patches of 12 with per-patch labels (learned
   positions, dense non-causal attention), the same sequence. 13c:
   internvl2_26b at full width cut to 2 of 48 layers (1,917,462,528
   parameters) on 256 frontend rows + 4096 ZipfLM tokens = 4352 positions
   (causal flash in blocks of 544, GQA rep 6, the loss on the text
   positions), 3 Table-3 SlimAdam steps. Launches counted per run against
   the megaplan's groups, B1 at least once a model; finite losses,
   falling over Adam's and the derived rules' runs (internvl: its one
   run); after each run one update from its state on fresh gradients,
   fused against ``make_optimizer(..., backend='jnp')`` (u, m', v' at
   1e-5); after Adam, B5's three sums on every candidate against its
   plain twin (1e-5); each run's host step times, peak memory, second
   moments and savings, and one step's device profile. 13d: ``flash_attention`` forward and backward at
   13a's and 13c's shapes beside one ``scaled_dot_product_attention``
   call on the same tensors (a yardstick).
14. Serving the rest of the dense zoo at full width, depth-cut (f32
   weights of the whole models do not fit the card): B14 against its
   plain twin at qwen15_32b's geometry (40 heads of 128 over 40 KV groups)
   and at command_r_35b's and deepseek_67b's (64 heads of 128 over 8
   groups), as in 10a; qwen15_32b at 4 layers (qkv biases; 3,659,637,760
   parameters), command_r_35b at 2 (LayerNorm, a tied 256,000-row
   embedding; 3,506,479,104) and deepseek_67b at 2 (3,061,882,880) through
   the paged engine, 4 requests x 16 greedy tokens each (B14 once a layer a
   step and chunk, no other kernel), TTFT, TPOT, a prefill chunk's host
   and device time, the first chunk's logits against the plain twin
   (5e-2). 14c: qwen15_32b's ``optimized()`` (int8 KV cache) at the same
   cut through ``Engine.generate``'s legacy loop, then the same tokens
   through ``decode_step``: in f32 activations the int8 cache's logits
   against a plain f32 path over its stored rows dequantized (1e-5 of
   max|logit|) and each stored row within half a scale step of its K/V;
   in bf16 against a bf16 cache, max|dlogit| / max|logit| < 0.05 and
   greedy agreement > 0.95 on the positions whose bf16 top-2 margin
   exceeds that deviation (all positions' agreement reported); then the
   JAX test's two bars (< 0.05, agreement > 0.95) on reduced f32
   qwen15_32b against its forward on the card.
15. The serving fault layer and the rest of serving. 15a:
   ``benchmarks/serve_drill.py``'s own run through
   ``repro_torch.serve.drill`` (reduced f32 gpt_small, 6 requests of 8
   tokens, max_seq 48, pages of 4, 13 pool pages, 3 slots, prefill chunks
   of 4; kernel failures at decode steps 2 and 5 and prefill chunk 1,
   request 2 poisoned after 2 tokens, 4 pages squeezed over scheduler
   steps [1, 5), a 10 s stall at step 1 against the last request's 5 s
   deadline), a clean run then the injected one on the card, held to the
   drill's four gates (drains; greedy parity, the poisoned request's
   prefix; no leak; every injection counted within 200 scheduler steps),
   B14 launched exactly n_layers x (decode steps + prefill chunks -
   degraded steps) times, and the drill's admission check. 15b: the plan
   scaled to phase 5's engine and 32 requests (``FAULT_PLAN_FULL``), gates
   (a), (c), (d) held, every degraded step's logits against the kernel's
   from the same pools (TOL_SERVE_LOGITS), B14's launch identity, token
   agreement with phase 5's clean run reported. Phases 5, 10 and 14 require
   no degraded step and no injection. 15c: jamba_v01_52b at full width,
   one 8-layer period (13,295,235,072 parameters, 49.5 GiB of f32 weights
   drawn on the card), 4 prompts of 16 tokens + 16 greedy through
   ``make_serve_step``: the first step's logits through B15 against its
   plain twin (TOL_SERVE_LOGITS), B15's one-token form 7 times a step and
   no other form or kernel, the legacy loop's tokens on the same prompts
   (agreement reported), a decode step's host and device time and profile,
   peak memory; ``decode_input_specs`` of the whole 32-layer model at
   decode_32k sized on the ``meta`` device.
Contracts: every pass of ``python -m repro_torch.analysis`` on this machine,
   the card passes included (the ptxas resource rows held to
   ``kernelcheck.RESOURCES``, the guarded step's launch-stable check), with
   its table; each compiled kernel's registers, spills, shared memory and
   blocks an SM by ``__global__`` function; the dry run's kernel calls on
   ``meta`` (``count_kernel_calls``) against the launches the card makes for
   full-width gpt_small's Adam and Table-3 SlimAdam updates; each of the 16
   wrappers run twice on the same full-width inputs, bit for bit; and
   compute-sanitizer's racecheck over a small case of every wrapper where
   the machine has a working tool (where not, a line says so, and nothing
   counts as passed). Its seconds are printed (budget 60 s).
16. One ``{"kernels": [...]}`` line (all 16 kernels: the 15 TPU kernels'
   ports and the selective scan's backward, B1 and B2 with their flags on
   rows of their own; B1, B2 and B5 count phases 9, 11, 12 and 13's
   launches too, B14 phases 10, 14 and 15's, B15 phases 12 and 15's, the
   backward phase 12's), the ``nvidia-smi`` line, and last the
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
TOL_SERVE_LOGITS = 5e-2  # full-width logits, kernel against plain attention: bf16 activations through the layers
TOL_BF16_OUT = 2.0**-7   # a bf16 attention output: kernel and twin may round one bf16 step apart
TOL_SNR = 1e-4           # from-update SNR against the plain math on the same g and v' (f64 against f32 sums)
TOL_RESUME = 1e-4        # losses after a resume: the embedding backward sums with atomics on the card
TOL_CARD_FORWARD = 1e-4  # a reduced f32 ResNet's logits, card against CPU: convolutions sum in another order

# Serving run geometry (phase 5). 800 pool pages force preemption of the 32
# requests; the scheduler's counts do not depend on the weights or the depth,
# since no request stops at an eos token. smollm_135m is cut to SERVE_LAYERS
# of its 30 layers: its steps are bound by the host's work a layer (at 30
# layers a decode step keeps the device busy under a tenth of its time), and
# phases 5 and 15b step the engine ~430 times each.
SERVE_SC = dict(max_seq=2048, page_size=16, max_slots=16, prefill_chunk=128, pool_pages=800)
SERVE_REQUESTS, SERVE_GREEDY, SERVE_NEW = 32, 28, 64
SERVE_LAYERS = 10


def log(*a):
    print(*a, flush=True)


def card_gen(seed: int = 0):
    """A CUDA generator seeded ``seed``, for a Trainer to draw its weights on
    the card: drawn on the host, gpt_small's take about a second."""
    import torch

    return torch.Generator(device="cuda").manual_seed(seed)


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


def device_kernels(torch, fn, traces: int = 20) -> list:
    """The names of the device kernels that one call of ``fn`` (after a
    warm-up call) runs, from a torch.profiler trace. Each trace starts with
    a short spin kernel: a trace that kept it saw the device from before
    the call's first kernel and is the answer (the spin left out); a trace
    that lost it is taken again, up to ``traces`` times, as
    ``tests/test_torch_cuda.py`` ``_trace`` does. The profiler's own
    ``ProfilerStep*`` range, which a trace can list as a device event, is no
    kernel and is left out too."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA and not e.name.startswith("ProfilerStep")]
        if any("spin_kernel" in n for n in names):
            return [n for n in names if "spin_kernel" not in n]
    raise AssertionError(f"none of {traces} torch.profiler traces kept its first device kernel")


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
    cfg = get_config("smollm_135m", n_layers=SERVE_LAYERS)
    log(f"[5] serving main path: full-width smollm_135m cut to {cfg.n_layers} of 30 layers ({cfg.param_count()} "
        f"parameters, random weights from seed 0), {SERVE_REQUESTS} requests x {SERVE_NEW} new tokens, {SERVE_SC}")
    model = Transformer(cfg, device=dev, gen=torch.Generator().manual_seed(0))
    eng = Engine(cfg, model.params, ServeConfig(**SERVE_SC))
    del model
    prompt_lens, reqs = serve_requests(cfg)
    rids = [eng.submit(r) for r in reqs]
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
    assert_clean(m, "phase 5")
    want_launches = cfg.n_layers * (m.decode_steps + m.prefill_chunks)
    if counts["paged_attention"] != want_launches or sum(counts.values()) != want_launches:
        raise AssertionError(f"launches {counts}, expected paged_attention {want_launches} and no other kernel")
    run = dict(wall_s=wall, metrics=m.to_dict(), launches=counts, peak_gib=peak, pool_gib=pool_gib,
               prompt_lens=prompt_lens.tolist(), tokens=[done[r].tokens.tolist() for r in rids])

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


# -- B1 and B4 on their split walk (phases 2, 3, 9a, 9c) ------------------------------

L2_BYTES = 50 * 2**20    # the H100's L2


def slim_floor_ms(plan, n: int, per_line: int, rate: float) -> float:
    """The least time the walk's design can take: each byte once (the 16 B
    an f32 element moves plus the line bytes), and g a second time where a
    split view's g is larger than the L2, so pass 2 reads it again from
    device memory (20 B an element)."""
    per_elem = 20 if plan.nseg > 1 and 4 * n > L2_BYTES else 16
    return (per_elem * n + per_line) / rate * 1e3


def slim_walk_row(torch, timer, rate, group, g, m, v) -> dict:
    """The walk's plan for one slim group, B1's design floor, and B4 (the
    per-leaf kernel on the same walk, scalar bias corrections from a count
    on the card) against its twin on the group's inputs, rerun bit for bit
    and timed beside its bound."""
    from repro_torch.kernels import megaplan, slim_update
    from repro_torch.optim.fused import bias_corrections

    kw = dict(b1=0.9, b2=0.95, eps=1e-8)
    b, r, c = g.shape
    n, lines = g.numel(), v.numel()
    count = torch.tensor(3, dtype=torch.int32, device=g.device)
    c1, c2 = bias_corrections(0.9, 0.95, count)
    run = lambda: slim_update.slim_precond_batched(g, m, v, axis=group.axis, count=count, **kw)          # noqa: E731
    plain = lambda: slim_update.slim_precond_batched_plain(g, m, v, c1, c2, axis=group.axis, **kw)   # noqa: E731
    tag = f"slim_precond_batched {(b, r, c)} axis {group.axis}"
    got = run()
    plan = megaplan.last_plans["slim_precond_batched"]   # B1 plans alike on the same views
    err = max(check(f"{tag} {o}", a, w, tol) for o, a, w, tol in
              zip(("u", "m'", "v'"), got, plain(), (TOL_LINE, TOL_ELEMENTWISE, TOL_LINE)))
    same_tensors(f"{tag}: two runs", dict(enumerate(got)), dict(enumerate(run())))
    ms, plain_ms = timer(run), timer(plain)
    bound = (16 * n + 8 * lines + 8) / rate * 1e3
    form = plan.describe()
    row = dict(form=form, floor_ms=slim_floor_ms(plan, n, 16 * lines, rate),
               b4=dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                       floor_ms=slim_floor_ms(plan, n, 8 * lines + 8, rate)))
    log(f"  {tag} [{form}]: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound:.4f} ms  floor "
        f"{row['b4']['floor_ms']:.4f} ms; B1's floor {row['floor_ms']:.4f} ms; both rerun bit for bit")
    del got
    return row


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


# Phases 3b-3f train full-width gpt_small cut to 4 of its 12 layers: the
# guard, checkpoints, routes and drill act leaf by leaf, and gpt_small's
# layers stack on one leaf each, so the cut keeps every leaf, group and
# launch count and halves the time of each step and checkpoint.
ROBUST_LAYERS = 4


def robust_phases(torch, timer, smi, cfg, specs, meta, data, lr, t3_plan, t3_dims):
    """Phases 3b-3f through the port's entry points at full width, ``cfg``
    cut to ROBUST_LAYERS layers (``specs``, ``meta``, ``t3_plan`` and
    ``t3_dims`` are the cut's). Returns the report; each counted run's
    launches are in it."""
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
        tr = Trainer(cfg, optimizer, lr, data, tc, grad_accum=2, faults=faults, optimizer_kw=okw, gen=card_gen())
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
    log(f"[3b] guarded training, full-width gpt_small cut to {cfg.n_layers} layers, batch 8 x 1024 as "
        f"grad_accum=2, {plan}, "
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
            u2, s2 = txs[False].update(grads, state)        # the per-leaf route again: bit for bit
            for what, a, b in (("u", routes[False][0], u2), ("m", routes[False][1].mu, s2.mu),
                               ("v", routes[False][1].nu, s2.nu)):
                same_tensors(f"{optimizer} per-leaf update, two runs, {what}", a, b)
            del u2, s2
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
        log(f"  {optimizer}: per-leaf against mega, worst relative error {worst} (tol {TOL_STEP:.0e}); the per-leaf "
            f"update reruns bit for bit; launches per update: mega {lm}, per-leaf {ll}; update time mega {msm:.3f} "
            f"ms, per-leaf {msl:.3f} ms ({smi})")
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
# 6c-6e train gpt_small cut to 2 of its 12 layers (full width): on the mesh
# the forward's collectives cost a layer each, staged through the host by
# gloo; 6a/6b hold the whole model.
SHARD_TRAIN_LAYERS = 2
TOL_PSUM_ABS = 2e-6         # psum leaves against the unsharded update (tests/test_psum_kernels.py:353)
TOL_SHARDED_LOSS = 1e-4     # losses against the unsharded port: the gradient all-reduce sums in another
                            # order than one whole-batch backward


def run_rank(body, rank, rdv, out, *args):
    """A rank's process: ``body(rank, rdv, out, *args)``. A failure goes to
    the parent through ``out`` with its traceback, then ends the process
    with a non-zero code, so the parent can name the rank that failed first
    and not only the ranks whose collectives its exit broke."""
    try:
        body(rank, rdv, out, *args)
    except BaseException:
        import traceback

        out.put((rank, {"error": traceback.format_exc()}))
        raise


def collect_ranks(procs, out, what, deadline_s=900):
    """{rank: result} from ``run_rank``'s processes. On a rank's failure,
    waits a few seconds for the others' reports and raises with the
    traceback of the rank whose failure reached the queue first."""
    import queue

    results, errors = {}, []
    deadline = time.monotonic() + deadline_s
    while len(results) < len(procs):
        try:
            rank, res = out.get(timeout=2.0)
        except queue.Empty:
            rank, res = None, None
        if res is not None and "error" in res:
            errors.append((rank, res["error"]))
        elif res is not None:
            results[rank] = res
        exited = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
        if errors or exited:
            grace = time.monotonic() + 10
            while time.monotonic() < grace and any(p.exitcode is None for p in procs):
                try:
                    rank, res = out.get(timeout=0.5)
                    if "error" in res:
                        errors.append((rank, res["error"]))
                except queue.Empty:
                    pass
            codes = [p.exitcode for p in procs]
            if not errors:
                raise RuntimeError(f"{what}: rank exit codes {codes}, no rank reported a failure")
            first, text = errors[0]
            later = "; ".join(f"rank {r}: {t.strip().splitlines()[-1]}" for r, t in errors[1:])
            raise RuntimeError(f"{what}: rank {first} failed first (rank exit codes {codes}"
                               + (f"; then {later}" if later else "") + f"):\n{text}")
        if time.monotonic() > deadline:
            raise TimeoutError(f"{what}: the ranks did not finish in {deadline_s} s")
    return results


def start_ranks(work: Path, body, *args) -> dict:
    """Spawn the SHARD_RANKS processes of the (data=2, model=2) mesh on this
    card, rank r running ``run_rank(body, r, rdv, out, *args)`` with its
    file rendezvous in ``work`` (made empty here). Returns what
    ``collect_ranks`` takes (``procs``, ``out``), the ``work`` directory and
    ``mark``, the time the ranks were started (each phase's collection moves
    it on)."""
    import multiprocessing as mp
    import shutil

    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=run_rank, args=(body, r, str(work / "rdv"), out, *args)) for r in range(SHARD_RANKS)]
    mark = time.perf_counter()
    for p in procs:
        p.start()
    return dict(procs=procs, out=out, work=work, mark=mark)


def end_ranks(ranks: dict) -> None:
    """Wait for ``start_ranks``' processes to exit; raise unless each exited
    with 0. Any still alive after that is killed."""
    procs = ranks["procs"]
    try:
        for p in procs:
            p.join(timeout=SHARD_TIMEOUT_S)
        if any(p.exitcode != 0 for p in procs):
            raise RuntimeError(f"rank exit codes {[p.exitcode for p in procs]}")
    finally:
        kill_ranks(ranks)


def kill_ranks(ranks: dict) -> None:
    """Kill whichever of ``start_ranks``' processes is still alive."""
    for p in ranks["procs"]:
        if p.is_alive():
            p.kill()


def mesh_rank(rank, rdv, out, rate, ckpt_dir, smi):
    """One rank of the (data=2, model=2) mesh for phase 6 and then phases
    6f-6l, in one process and one process group: a fresh rank pays seconds
    of one-time set-up (its start, CUDA, its group, its first collectives),
    which the two phases then share. Each phase's results go to ``out`` in
    turn; 6f-6l's files go beside the rendezvous, as when it runs alone."""
    sharded_rank(rank, rdv, out, rate, ckpt_dir)
    import torch

    torch.cuda.empty_cache()
    tp_rank(rank, rdv, out, rate, smi)


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
    profiled = None   # (tag, B11 in the ek form on the first leaf), profiled on rank 0
    profiled_b13 = None   # (tag, B13 in the ek form on the first group), likewise

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
        walk_form = megaplan.last_plans["slim_partial_stats_batched"].describe()
        out["B10"].setdefault("forms", {})[tag] = walk_form
        log(f"  [{mesh.rank}] B10 {tag} [{walk_form}]")
        line = got[1].shape
        v = 1e-6 * torch.rand(line, device="cuda") + 1e-8
        ek = 1e-6 * torch.rand(line, device="cuda")
        m_new = slim_update.slim_partial_stats_batched_plain(g3, m3, axis=cn.axis, b1=0.9)[0]
        for form, e in (("ek", ek), ("owner", None)):
            got = slim_update.slim_finalize_batched(m_new, v, axis=cn.axis, ek=e, count=count, **kw)
            again = slim_update.slim_finalize_batched(m_new, v, axis=cn.axis, ek=e, count=count, **kw)
            want = slim_update.slim_finalize_batched_plain(m_new, v, bc1, bc2, b2=0.95, eps=1e-8, ek=e)
            pairs = (got, want) if e is not None else ((got,), (want,))
            hold("B11", f"{tag} {form}", *pairs, [("u", TOL_ELEMENTWISE), ("v'", TOL_ELEMENTWISE)])
            if not all(torch_equal(a, b) for a, b in zip(pairs[0], (again,) if e is None else again)):
                raise AssertionError(f"B11 {tag} {form}: two runs differ")
        timed.append(("B10", tag, lambda g3=g3, m3=m3, a=cn.axis: slim_update.slim_partial_stats_batched(
            g3, m3, axis=a, b1=0.9), lambda g3=g3, m3=m3, a=cn.axis: slim_update.slim_partial_stats_batched_plain(
            g3, m3, axis=a, b1=0.9), max((12 * n + 4 * lines) / rate, 4 * n / F32_RATE) * 1e3, None))
        # The twin forms its bias corrections from the same count on the card, as the kernel does.
        timed.append(("B11", tag, lambda m_new=m_new, v=v, a=cn.axis: slim_update.slim_finalize_batched(
            m_new, v, axis=a, count=count, **kw), lambda m_new=m_new, v=v: slim_update.slim_finalize_batched_plain(
            m_new, v, *bias_corrections(0.9, 0.95, count), b2=0.95, eps=1e-8),
            max((8 * n + 4 * lines) / rate, 4 * n / F32_RATE) * 1e3, None))
        profiled = profiled or (tag, lambda m_new=m_new, v=v, ek=ek, a=cn.axis: slim_update.slim_finalize_batched(
            m_new, v, axis=a, ek=ek, count=count, **kw))

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
            again = megaplan.mega_slim_partial_stats_batched(gg, m3, axis=grp.axis, b1=0.9, **flags)
            if not all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(got, again)):
                raise AssertionError(f"B12 {tag} {flags}: two runs differ")
        walk_form = megaplan.last_plans["mega_slim_partial_stats_batched"].describe()
        out["B12"].setdefault("forms", {})[tag] = walk_form
        log(f"  [{mesh.rank}] B12 {tag} [{walk_form}]: three flag sets rerun bit for bit")
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
        walk_form = slim_update.finalize_plan(m_new, grp.axis, (v, ek, l1, l2)).describe()
        out["B13"].setdefault("forms", {})[tag] = walk_form
        log(f"  [{mesh.rank}] B13 {tag} [{walk_form}]")
        profiled_b13 = profiled_b13 or (tag, lambda m_new=m_new, v=v, ek=ek, l1=l1, l2=l2, a=grp.axis:
                                        megaplan.mega_slim_finalize_batched(m_new, v, l1, l2, axis=a, ek=ek, b2=0.95,
                                                                            eps=1e-8))
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
        # One B11 or B13 call is one device kernel, the flat walk's: no torch
        # operation forms B11's bias corrections.
        for kernel, (tag, call) in (("B11", profiled), ("B13", profiled_b13)):
            names = device_kernels(torch, call)
            log(f"  {kernel} {tag} ek form, one call under torch.profiler: {len(names)} device kernel(s) {names}")
            if len(names) != 1 or "finalize_flat_kernel" not in names[0]:
                raise AssertionError(f"{kernel} {tag}: one call ran {names}, want one finalize_flat_kernel")
            out[kernel]["profiled_kernels"] = names
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


def sharded_vs_unsharded(torch, mesh, params, rule_sets, lead):
    """6b: for each rule set (``{label: (dims, plans)}``: Table 3's, and
    AdaLayer's, whose every leaf takes the psum regime and whose embedding
    shard is one 9,658,368-element line), two sharded SlimAdam updates (so
    the moments carry history) against the port's unsharded update of the
    same whole gradients on the same card, and the per-leaf route (B10/B11)
    against the grouped one (B12/B13); then one sharded Adam update against
    the unsharded one."""
    from repro_torch.core.slim_adam import scale_by_slim_adam
    from repro_torch.optim.adam import scale_by_adam

    say = log if lead else (lambda *a: None)
    names = list(params)
    grads = [{k: shard_inputs(torch, p.shape, 200 * s + i) for i, (k, p) in enumerate(params.items())}
             for s in range(2)]
    specs = {k: pl.spec for k, pl in zip(names, next(iter(rule_sets.values()))[1])}
    res = {}
    with torch.no_grad():
        for label, (dims, plans) in rule_sets.items():
            txs = {"unsharded": scale_by_slim_adam(dims, backend="fused"),
                   "grouped": scale_by_slim_adam(dims, backend="fused", mesh=mesh, param_specs=specs),
                   "per_leaf": scale_by_slim_adam(dims, backend="fused", mesh=mesh, param_specs=specs,
                                                  megakernel=False)}
            states = {k: tx.init(params) for k, tx in txs.items()}
            for g in grads:
                ups = {}
                for k, tx in txs.items():
                    ups[k], states[k] = tx.update(g, states[k])
            worst = dict(u=0.0, mu=0.0, nu=0.0)
            for i, (k, pl) in enumerate(zip(names, plans)):
                un, sh = states["unsharded"], states["grouped"]
                nu_spec = pl.nu_spec if pl.nu_spec is not None else pl.red_spec
                pairs = {"u": (ups["grouped"][k], ups["unsharded"][k]),
                         "mu": (sh.mu[k], mesh.shard(un.mu[k], pl.spec)),
                         "nu": (sh.nu[k], mesh.shard(un.nu[k], nu_spec))}
                for what, (a, b) in pairs.items():
                    if pl.regime == "local":
                        if not torch_equal(a, b):
                            raise AssertionError(f"{label} local leaf {k} {what}: sharded differs from unsharded")
                    else:
                        err = float((a.double() - b.double()).abs().max())
                        worst[what] = max(worst[what], err)
                        if err > TOL_PSUM_ABS:
                            raise AssertionError(f"{label} psum leaf {k} {what}: {err:.3e} above {TOL_PSUM_ABS:.0e}")
            say(f"[6b] sharded {label} SlimAdam against unsharded, 2 updates: local leaves bit-equal; psum leaves "
                f"max abs err u {worst['u']:.3e}  m' {worst['mu']:.3e}  owner-slice v' {worst['nu']:.3e} "
                f"(tol {TOL_PSUM_ABS:.0e})")
            res[f"{label}_psum_abs_err"] = worst
            route = 0.0
            for k in names:
                for a, b in ((ups["per_leaf"][k], ups["grouped"][k]),
                             (states["per_leaf"].mu[k], states["grouped"].mu[k]),
                             (states["per_leaf"].nu[k], states["grouped"].nu[k])):
                    route = max(route, max_err(a, b)[1])
            if route > TOL_ELEMENTWISE:
                raise AssertionError(f"{label}: per-leaf route against grouped route: rel err {route:.3e}")
            say(f"[6b] {label}: per-leaf route (B10/B11, B3/B4) against the grouped one (B12/B13, B1/B2): worst "
                f"rel err {route:.3e}")
            res[f"{label}_per_leaf_vs_grouped_rel"] = route
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
    from repro_torch.sharding import ShardingContext, logical, param_specs, use_sharding
    from repro_torch.sharding.shardspec import regime_counts
    from repro_torch.train import FaultPlan, GuardConfig, Trainer, TrainerConfig
    from repro_torch.train.trainer import slim_rule_dims

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
        # AdaLayer: one second moment a parameter block, so every leaf's lines
        # are split across ranks; the embedding's shard is one line
        ada_dims = slim_rule_dims("adalayer", params, meta)
        ada_plans = F.sharded_tree_plans(list(params.values()), [ada_dims[k] for k in params],
                                         [specs[k] for k in params], mesh)
        res["adalayer_regimes"] = regime_counts(ada_plans)
        embed = ada_plans[list(params).index("embed")]
        say(f"[6] AdaLayer on the mesh: {res['adalayer_regimes']}; the embedding's shard {embed.local_shape} takes "
            f"the {embed.regime} regime as one line of {embed.cn.cols:,} (axis {embed.cn.axis})")
        if embed.regime != "psum" or (embed.cn.rows, embed.cn.cols) != (1, 25152 * 384):
            raise AssertionError(f"AdaLayer's embedding: {embed.regime}, {embed.cn}")
        res["vs_unsharded"] = sharded_vs_unsharded(torch, mesh, params, {"Table-3": (dims, plans),
                                                                         "AdaLayer": (ada_dims, ada_plans)}, lead)
        del model, params
        torch.cuda.empty_cache()

        # -- 6c. the sharded trainer: counted runs -----------------------------
        cfg = dataclasses.replace(cfg, n_layers=SHARD_TRAIN_LAYERS)
        data = ZipfLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=1024, global_batch=8, seed=0))

        def counted(label, trainer, steps=None):
            kernels.reset_launch_counts()
            logical.region_counts(reset=True)
            t0 = time.perf_counter()
            trainer.run(steps)
            torch.cuda.synchronize()
            c = kernels.launch_counts()
            regions = logical.region_counts(reset=True)
            say(f"[6c] {label}: {trainer.step} steps in {time.perf_counter() - t0:.1f} s, losses "
                f"{[round(m['loss'], 5) for m in trainer.metrics_log]}, launches "
                f"{ {k: v for k, v in c.items() if v} }, forward regions {regions}")
            # 12 heads and d_ff 3072 split over 2 model ranks: JAX's conditions hold everywhere
            if set(regions) != {"attn", "mlp"} or any(r["fallback"] or not r["parallel"] for r in regions.values()):
                raise AssertionError(f"{label}: forward regions {regions}")
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
        # one more step, profiled, with the forward's collectives timed (each
        # synchronizes the device before and after itself)
        mesh.timed = True
        mesh.collective_stats(reset=True)
        prof = profile_device(torch, lambda: t3.run(t3.step + 1), 1, step_ms, "sharded step")
        coll = mesh.collective_stats(reset=True)
        mesh.timed = False
        res["timing"] = dict(step_ms=step_ms, grad_allreduce_ms=allreduce_ms, busy_share=prof["busy_ms"] / step_ms,
                             top_kernels=prof["kernels"][:10], collectives=coll,
                             peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        say(f"[6e] sharded Table-3 SlimAdam step (4 ranks sharing one card over gloo, not a multi-GPU number): "
            f"{step_ms:.1f} ms per step; the gradient all-reduce alone ({n_grad:,} f32) {allreduce_ms:.1f} ms; the "
            f"forward's collectives in a timed step: "
            + ", ".join(f"{k} {v['calls']} calls {v['seconds'] * 1e3:.1f} ms" for k, v in coll.items()))
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
        n_cut = sum(p.numel() for p in guard.params.values())
        if last["step_skipped"] != 1.0 or last["nonfinite_count"] != n_cut:
            raise AssertionError(f"guarded NaN step: skipped {last['step_skipped']}, "
                                 f"non-finite {last['nonfinite_count']} of {n_cut}")
        same_tensors("guarded NaN step", before, state_copy(torch, guard._state()))
        say(f"[6c] guarded NaN step skipped on every rank, every one of the {n_cut:,} gradient entries counted "
            f"non-finite, every rank's parameters and optimizer shards bit-identical")
        res["guard"] = dict(skipped=last["step_skipped"], nonfinite=last["nonfinite_count"])
        del guard, before
        torch.cuda.empty_cache()
        # -- 6c. AdaLayer: every leaf's lines split across ranks, the embedding's
        # shard one 9,658,368-element line, through the psum pair on both routes
        for route, okw in (("grouped", {}), ("per_leaf", dict(megakernel=False))):
            ada = Trainer(cfg, "adalayer", 1e-3, data, TrainerConfig(total_steps=2, log_every=1, backend="fused",
                                                                     seed=0), optimizer_kw=okw)
            res[f"adalayer_{route}_launches"] = counted(f"AdaLayer, {route.replace('_', '-')} route", ada)
            res[f"adalayer_{route}_losses"] = [m["loss"] for m in ada.metrics_log]
            del ada
            torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_start
    out.put((rank, res))
    mesh.barrier()


def sharded_phase(torch, smi, rate, ranks=None):
    """Phase 6: the 4 ranks of a (data=2, model=2) mesh on this one card
    (``ranks``, started by ``start_ranks`` with ``mesh_rank``, which go on
    to phases 6f-6l; else spawned here for phase 6 alone) and what they
    report; then the unsharded port on the same batches and the unsharded
    restore of the mesh's checkpoint. A rank that fails ends the run with a
    non-zero code."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, ZipfLM
    from repro_torch.train import Trainer, TrainerConfig

    log(f"[6] sharded slice: full-width gpt_small on a (data=2, model=2) mesh, {SHARD_RANKS} ranks sharing this "
        f"card ({smi}), batch 8 x 1024, 4 rows a data group; its trainers cut to {SHARD_TRAIN_LAYERS} layers")
    alone = ranks is None
    if alone:
        torch.cuda.empty_cache()
        work = ROOT / "build" / "chip_smoke_sharded"
        ranks = start_ranks(work, sharded_rank, rate, str(work / "ckpt"))
    work = ranks["work"]
    ckpt_dir = str(work / "ckpt")
    t0 = ranks["mark"]
    try:
        results = collect_ranks(ranks["procs"], ranks["out"], "the sharded ranks")
        if alone:
            end_ranks(ranks)
    finally:
        if alone:
            kill_ranks(ranks)
    spawn_s = time.perf_counter() - t0
    ranks["mark"] = time.perf_counter()
    r0 = results[0]
    for r in range(1, SHARD_RANKS):
        for key in ("adam_losses", "slim_snr_losses", "rules", "slim_losses", "adalayer_grouped_losses",
                    "adalayer_per_leaf_losses"):
            if results[r][key] != r0[key]:
                raise AssertionError(f"rank {r} reports other {key} than rank 0")

    # The unsharded port on the same batches and rules, and its restore.
    cfg = dataclasses.replace(get_config("gpt_small"), n_layers=SHARD_TRAIN_LAYERS)
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
    # AdaLayer's first step at lr 1e-3 is g / rms(g) over each whole block and
    # lifts the loss from 10.99 to ~15: the loss after it moves by ~2e-3 with the
    # order in which the gradient is summed, which the unsharded port shows
    # against itself when the same batch is summed as 2 micro-batches. Its
    # preconditioner is held to the unsharded one on equal gradients in 6b.
    for accum in (1, 2):
        tr = Trainer(cfg, "adalayer", 1e-3, data, TrainerConfig(total_steps=2, log_every=1, backend="fused", seed=0),
                     grad_accum=accum)
        tr.run()
        ref[f"adalayer x{accum}"] = [m["loss"] for m in tr.metrics_log]
        del tr
        torch.cuda.empty_cache()
    own = max(abs(a - b) / abs(b) for a, b in zip(ref["adalayer x2"], ref["adalayer x1"]))
    ada_tol = max(TOL_SHARDED_LOSS, 2 * own)
    log(f"[6c] adalayer losses unsharded {ref['adalayer x1']}, as 2 micro-batches {ref['adalayer x2']}: rel diff "
        f"{own:.3e}; the sharded runs are held to max({TOL_SHARDED_LOSS:.0e}, twice that) = {ada_tol:.3e}")
    for key in ("adalayer_grouped_losses", "adalayer_per_leaf_losses"):
        got = r0[key][:2]
        err = max(abs(a - b) / abs(b) for a, b in zip(got, ref["adalayer x1"]))
        log(f"[6c] {key[:-7]} losses sharded {got} unsharded {ref['adalayer x1']}: worst rel diff {err:.3e}")
        if err > ada_tol:
            raise AssertionError(f"sharded AdaLayer's losses differ from the unsharded port's by {err:.3e}")
    back = Trainer(cfg, "slim_snr", 1e-3, data, TrainerConfig(ckpt_dir=ckpt_dir, **tc), rules=rules)
    if back.step != 2 or crcs(torch, back._state()) != r0["ckpt_crc"]:
        raise AssertionError("the mesh's checkpoint restored unsharded differs from the mesh's gathered state")
    log("[6d] the mesh's checkpoint restored unsharded: every leaf's crc32 equals the gathered state's")
    del back
    torch.cuda.empty_cache()
    # the ranks' group keeps its rendezvous file here while they go on (6f-6l removes it)
    shutil.rmtree(work / "ckpt" if not alone else work, ignore_errors=True)

    def need(counts, names, label):
        for n in names:
            if counts[n] <= 0:
                raise AssertionError(f"{label}: {n} never launched")

    # every SNR candidate of gpt_small has its lines split on this mesh: B9 only
    need(r0["adam_launches"], ["snr_stats_centered_partial_batched", "mega_adam_update"], "sharded Adam run")
    need(r0["slim_launches"], ["mega_slim_partial_stats_batched", "mega_slim_finalize_batched"], "sharded SlimAdam")
    need(r0["per_leaf_launches"], ["slim_partial_stats_batched", "slim_finalize_batched"], "sharded per-leaf run")
    need(r0["adalayer_grouped_launches"], ["mega_slim_partial_stats_batched", "mega_slim_finalize_batched"],
         "sharded AdaLayer, grouped route")
    need(r0["adalayer_per_leaf_launches"], ["slim_partial_stats_batched", "slim_finalize_batched"],
         "sharded AdaLayer, per-leaf route")
    log(f"[6] sharded phase: ranks {spawn_s:.1f} s (rank 0 {r0['seconds']:.1f} s), total "
        f"{time.perf_counter() - t0:.1f} s")
    summary = {k: v for k, v in r0.items() if k != "ckpt_crc"}
    summary["timing"].update(busy_share_by_rank=[results[r]["timing"]["busy_share"] for r in sorted(results)],
                             peak_gib_by_rank=[results[r]["timing"]["peak_gib"] for r in sorted(results)])
    log(f"[6e] busy share by rank {[round(x, 3) for x in summary['timing']['busy_share_by_rank']]}, peak memory by "
        f"rank {[round(x, 2) for x in summary['timing']['peak_gib_by_rank']]} GiB ({smi})")
    summary.update(reference_losses=ref, loss_rel_err=worst, spawn_s=spawn_s,
                   kernel_err={k: max(results[r]["kernels"][k]["err"] for r in results) for k in r0["kernels"]})
    return summary


# -- the forward on the mesh: tensor, sequence and expert parallelism, GPipe (phase 6f-6j; 6k below)

# Full-width cases on the (data=2, model=2) mesh: (layers kept, None for the
# whole model; global rows; sequence; lr). Depth is the only cut: 6f runs the
# whole-parameter path (Trainer), where each of the 4 ranks holds p, g and the
# whole update in f32, and the sharded update's megaplan buffers on top
# (olmoe's 2-layer cut, 1.05 B parameters, ran out of the card's 80 GB in the
# first step's update with 4 such ranks; its 1-layer cut keeps 0.62 B).
# gpt_small is cut to 2 of its 12 layers and falcon to 1 of its 64 to keep
# the whole run inside its time: every region still runs in its parallel
# form a layer a step. 6k trains the same cuts with each rank holding only
# its shards (SHARD_CASES).
TP_CASES = {"gpt_small": (2, 8, 1024, 1e-3), "olmoe_1b_7b": (1, 2, 2048, 1e-4),
            "falcon_mamba_7b": (1, 2, 2048, 1e-3)}
# The activation dtypes 6f runs each case in. olmoe's bf16 Table-3 run on
# this mesh is 6k's: the same cut, batches, regions and optimizer, held to
# the same split form and unsharded references, with the parameters kept as
# shards.
TP_DTYPES = {"gpt_small": ("float32", "bfloat16"), "olmoe_1b_7b": ("float32",),
             "falcon_mamba_7b": ("float32", "bfloat16")}
TP_REGIONS = {"gpt_small": ("attn", "mlp"), "olmoe_1b_7b": ("attn", "moe"), "falcon_mamba_7b": ("ssm",)}
TP_STEPS = 2                # steps a run: f32 Adam (SNR at the last), bf16 Table-3 SlimAdam
TOL_TP_GRAD = 1e-5          # f32: each leaf's first-step gradient, of its largest |g|, against the unsharded port
TP_REF_WORKERS = 2          # ranks that run the unsharded references at once (four f32 falcon Trainers overfill 80 GB)
PIPE_STAGES, PIPE_MICRO, PIPE_SEQ = 4, 8, 1024   # GPipe: one full-width gpt_small block a stage


def tp_case(torch, mesh, arch: str, dtype, lead: bool, keep: dict) -> dict:
    """One full-width case on the mesh in one activation dtype (6f-6h): the
    sharded Trainer (in f32 Adam measuring SNR, in bf16 Table-3 SlimAdam;
    TP_STEPS each, launch and region counters zeroed before and read after
    each run), in f32 also the first step's averaged gradients, as its
    optimizer receives them; then rank 0 alone runs the unsharded port on the same batches from the same
    weights (olmoe's with JAX's G = 2 dispatch groups) and holds the
    sharded run to it (:func:`tp_reference`). bf16 adds each step's
    host time, one profiled step (device busy share; the regions'
    collectives timed) and one gradient bucket's all-reduce. In f32
    ``keep[arch]`` gets what 6k holds its parameter-shard run to: the
    losses, this rank's cut of the first-step gradients by the parameter
    specs (on the host) and each leaf's largest |g|."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import rules_to_dims, table3_rules
    from repro_torch.data import DataConfig, ZipfLM
    from repro_torch.kernels import ssm_scan as sc
    from repro_torch.optim import fused as F
    from repro_torch.sharding import ShardingContext, logical, param_specs, use_sharding
    from repro_torch.sharding.shardspec import regime_counts
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.optim.base import GradientTransformation
    from repro_torch.train.step import AVERAGE_BUCKET, make_train_step

    say = log if lead else (lambda *a: None)
    layers, rows, seq, lr = TP_CASES[arch]
    cfg = dataclasses.replace(get_config(arch), dtype=dtype, **({"n_layers": layers} if layers else {}))
    f32 = dtype == torch.float32
    label = f"{arch} {'f32' if f32 else 'bf16'}"
    data = ZipfLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=rows, seed=0))
    gen = lambda: torch.Generator(device="cuda").manual_seed(0)   # noqa: E731
    res: dict = {"layers": cfg.n_layers}
    say(f"[6f] {label}: {cfg.n_layers} layers at full width, batch {rows} x {seq} ({rows // 2} row(s) a data group), "
        f"lr {lr}, through the sharded Trainer on the (data=2, model=2) mesh")
    first: dict = {}   # rank 0: the first step's whole averaged gradients, on the host
    # f32: Adam (its first-step gradients and losses, B9); bf16: Table 3
    # (B2 on its dense group, B1 or B12/B13 on the rest), the optimizer's
    # state and kernels being f32 in both
    res["optimizers"] = optimizers = ("adam",) if f32 else ("slim",)
    with use_sharding(ShardingContext(mesh)):
        for optimizer in optimizers:
            tc = TrainerConfig(total_steps=TP_STEPS, log_every=1, backend="fused", seed=0,
                               measure_snr=optimizer == "adam", snr_early_every=TP_STEPS)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            tr = Trainer(cfg, optimizer, lr, data, tc, gen=gen())
            if optimizer == "slim":
                dims = rules_to_dims(table3_rules(tr.meta), tr.meta)
                specs = param_specs(tr.meta, tr.params)
                plans = F.sharded_tree_plans(list(tr.params.values()), [dims[k] for k in tr.params],
                                             [specs[k] for k in tr.params], mesh)
                res["table3_regimes"] = regime_counts(plans)
            if optimizer == "adam" and f32:
                # the first step's averaged gradients, as the optimizer receives them
                specs, tx = param_specs(tr.meta, tr.params), tr.tx

                def update(grads, opt_state, params=None):
                    if arch not in keep:
                        keep[arch] = dict(layers=cfg.n_layers,
                                          grad_cut={k: mesh.shard(g, specs[k]).cpu() for k, g in grads.items()},
                                          grad_max={k: float(g.abs().max()) for k, g in grads.items()})
                        if lead:
                            first.update({k: g.detach().cpu() for k, g in grads.items()})
                    return tx.update(grads, opt_state, params)

                tr._train_step = make_train_step(tr.model, GradientTransformation(tx.init, update), mesh=mesh)
            kernels.reset_launch_counts()
            logical.region_counts(reset=True)
            sc.ssm_scan.channel_launches.clear()
            sc.ssm_scan_bwd.channel_launches.clear()
            step_ms, profiled = [], not f32 and optimizer == "slim"
            for k in range(1, TP_STEPS + 1):
                mesh.barrier()
                if profiled and k == TP_STEPS:
                    # the last step profiled, with the regions' collectives
                    # timed (each synchronizes the device before and after itself)
                    mesh.timed = True
                    mesh.collective_stats(reset=True)
                    prof = profile_device(torch, lambda: tr.run(k), 1, statistics.median(step_ms),
                                          f"{label} sharded step")
                    coll = mesh.collective_stats(reset=True)
                    mesh.timed = False
                    continue
                t0 = time.perf_counter()
                tr.run(k)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
            mesh.barrier()
            run = dict(losses=[m["loss"] for m in tr.metrics_log], launches=kernels.launch_counts(),
                       regions=logical.region_counts(reset=True), step_ms=step_ms,
                       scan_channels=dict(sc.ssm_scan.channel_launches),
                       bwd_channels=dict(sc.ssm_scan_bwd.channel_launches),
                       peak_gib=(torch.cuda.max_memory_allocated() - base) / 2**30)
            if profiled:
                run.update(profile=prof, collectives=coll)
                n_grad = sum(p.numel() for p in tr.params.values())
                flat = torch.zeros(min(AVERAGE_BUCKET, n_grad), device="cuda")
                mesh.barrier()
                t0 = time.perf_counter()
                mesh.psum(flat, tuple(mesh.shape))
                torch.cuda.synchronize()
                run["bucket_allreduce_ms"] = (time.perf_counter() - t0) * 1e3
                run["buckets"] = -(-n_grad // AVERAGE_BUCKET)
                del flat
            say(f"  {label} {optimizer}: losses {[round(x, 5) for x in run['losses']]}, steps "
                f"{[round(x, 1) for x in step_ms]} ms, peak {run['peak_gib']:.2f} GiB over the start, regions "
                f"{run['regions']}, launches { {k: v for k, v in run['launches'].items() if v} }")
            res[optimizer] = run
            if f32 and optimizer == "adam":
                keep[arch]["losses"] = run["losses"]
            del tr
            torch.cuda.empty_cache()
    res["ranks_peak_gib"] = max(res[o]["peak_gib"] for o in optimizers)
    mesh.barrier()
    ref = tp_reference(torch, mesh, cfg, data, lr, f32, first, res, label)
    if lead:
        res["reference"] = ref
    return res


def tp_reference(torch, mesh, cfg, data, lr, f32: bool, sharded_grads, res: dict, label: str):
    """On every rank, after :func:`tp_case`'s runs: the unsharded port's
    runs of its trainers, dealt out to the first TP_REF_WORKERS ranks (each
    run alone on its rank; the first, which checks the gradients, on rank
    0), on the same batches and weights (the MoE under a ``SpecMesh``
    with a ``data`` axis of 2: JAX's G = 2 dispatch groups), the first
    batch's gradients in f32, and the checks. Each trainer also runs in the
    split form (``tests/_torch_split.py``: the model ranks' partial sums
    added in one process, no collective), and in bf16 with the batch as 2
    micro-batches. f32: the sharded losses and the split form's against the
    unsharded port (1e-4), the first-step gradients (1e-5). bf16, where the
    mesh reduce-scatters bf16 partial sums and so rounds otherwise than one
    whole-width product: the sharded losses against the split form's at
    max(1e-4, twice what the unsharded port's own move as 2 micro-batches,
    the gradient all-reduce's other summation order); their distance from
    the unsharded port is reported. Rank 0 gathers the losses, checks and
    returns them; every other rank returns None."""
    import contextlib

    import torch.distributed as dist

    from repro_torch.sharding import ShardingContext, SpecMesh, use_sharding
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.train.step import make_grad_fn

    sys.path.insert(0, str(ROOT / "tests"))
    from _torch_split import split_regions

    ref: dict = {}
    gen = lambda: torch.Generator(device="cuda").manual_seed(0)   # noqa: E731
    plain = ShardingContext(SpecMesh({"data": 2})) if cfg.n_experts else None
    mesh_shape = dict(zip(SHARD_AXES, SHARD_SHAPE))
    split = lambda: split_regions(mesh_shape["model"], rows=mesh_shape["data"])   # noqa: E731
    orders = {"x1": (1, contextlib.nullcontext), "split": (1, split)}
    if not f32:
        orders["x2"] = (2, contextlib.nullcontext)
    runs = [(optimizer, order) for optimizer in res["optimizers"] for order in orders]
    for optimizer, order in runs[mesh.rank::TP_REF_WORKERS] if mesh.rank < TP_REF_WORKERS else ():
        accum, form = orders[order]
        with use_sharding(plain), form():
            tc = TrainerConfig(total_steps=TP_STEPS, log_every=1, backend="fused", seed=0)
            tr = Trainer(cfg, optimizer, lr, data, tc, grad_accum=accum, gen=gen())
            if f32 and optimizer == "adam" and order == "x1":
                grads, _ = make_grad_fn(tr.model)(tr.batch(0))
                worst = 0.0
                for k, g in grads.items():
                    want, got = g.detach().cpu().double(), sharded_grads[k].double()
                    scale = float(want.abs().max())
                    err = float((got - want).abs().max()) / scale if scale else float(got.abs().max())
                    worst = max(worst, err)
                    if err > TOL_TP_GRAD:
                        raise AssertionError(f"{label}: {k}'s sharded gradient {err:.3e} of its largest |g| "
                                             f"from the unsharded port's (tol {TOL_TP_GRAD:.0e})")
                ref["grad_rel_err"] = worst
                log(f"  {label}: first-step gradients, sharded against unsharded, every leaf within "
                    f"{worst:.3e} of its largest |g| (tol {TOL_TP_GRAD:.0e})")
                del grads
            tr.run()
            ref[f"{optimizer}_{order}"] = [m["loss"] for m in tr.metrics_log]
            del tr
            torch.cuda.empty_cache()
    parts = [None] * mesh.size
    dist.all_gather_object(parts, ref)
    if mesh.rank:
        return None
    ref = {k: v for part in parts for k, v in part.items()}

    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    ref["own_x2"] = 0.0 if f32 else max(rel(ref[f"{opt}_x2"], ref[f"{opt}_x1"]) for opt in res["optimizers"])
    tol = max(TOL_SHARDED_LOSS, 2 * ref["own_x2"])
    for optimizer in res["optimizers"]:
        got, x1, sp = res[optimizer]["losses"], ref[f"{optimizer}_x1"], ref[f"{optimizer}_split"]
        ref[f"{optimizer}_rel_err"] = err = rel(got, x1)
        ref[f"{optimizer}_rel_err_split"] = err_split = rel(got, sp)
        ref[f"{optimizer}_split_rel_err"] = split_err = rel(sp, x1)
        if f32:
            log(f"  {label} {optimizer} losses sharded {got} unsharded {x1} split form {sp}: sharded {err:.3e}, "
                f"split form {split_err:.3e} from unsharded (tol {TOL_SHARDED_LOSS:.0e})")
            bad = err > TOL_SHARDED_LOSS or split_err > TOL_SHARDED_LOSS
        else:
            log(f"  {label} {optimizer} losses sharded {got} split form {sp}: worst rel diff {err_split:.3e} (tol "
                f"max({TOL_SHARDED_LOSS:.0e}, twice the unsharded port's {ref['own_x2']:.3e} as 2 micro-batches) = "
                f"{tol:.3e}); from unsharded {x1}: sharded {err:.3e}, split form {split_err:.3e}")
            bad = err_split > tol
        if not all(map(math.isfinite, got)) or bad:
            raise AssertionError(f"{label} {optimizer}: sharded losses {got} outside the bar (unsharded {x1}, split "
                                 f"form {sp})")
    ref["tol"] = tol
    return ref


def tp_check(arch: str, r: dict, label: str) -> None:
    """A case's counts on one rank: every region of the model in its
    parallel form (forward and remat recompute, a layer a step) and none by
    the fallback; the optimizer kernels its plans imply; on the SSM case
    B15 twice a layer a step and the backward once, all on d_inner / 2
    channels."""
    n = r["layers"] * TP_STEPS * 2
    for optimizer in r["optimizers"]:
        run = r[optimizer]
        want = {k: {"parallel": n, "fallback": 0} for k in TP_REGIONS[arch]}
        if run["regions"] != want:
            raise AssertionError(f"{label} {optimizer}: regions {run['regions']}, expected {want}")
        c = run["launches"]
        if c["mega_adam_update"] < TP_STEPS:
            raise AssertionError(f"{label} {optimizer}: mega_adam_update launched {c['mega_adam_update']} times")
        if arch == "falcon_mamba_7b":
            d_l = 8192 // 2
            if run["scan_channels"] != {d_l: n} or run["bwd_channels"] != {d_l: n // 2}:
                raise AssertionError(f"{label} {optimizer}: B15 by channels {run['scan_channels']}, the backward "
                                     f"{run['bwd_channels']}; expected {n} and {n // 2} launches on {d_l}")
    if "adam" in r["optimizers"] and r["adam"]["launches"]["snr_stats_centered_partial_batched"] < 1:
        raise AssertionError(f"{label}: B9 never launched in the SNR measurement")
    if "slim" not in r:
        return
    slim, regimes = r["slim"]["launches"], r["table3_regimes"]
    if regimes["psum"] and (slim["mega_slim_partial_stats_batched"] < TP_STEPS
                            or slim["mega_slim_finalize_batched"] < TP_STEPS):
        raise AssertionError(f"{label}: {regimes['psum']} psum leaves but B12/B13 launched "
                             f"{slim['mega_slim_partial_stats_batched']}/{slim['mega_slim_finalize_batched']} times")


def gpipe_case(torch, mesh, lead: bool) -> dict:
    """6i: ``gpipe`` on a (4,) ``pipe`` mesh over the same 4 ranks, each
    stage one full-width gpt_small block (f32), PIPE_MICRO microbatches of
    1 x PIPE_SEQ: outputs against ``sequential_reference`` (1e-5 of the
    largest |y|) on every rank; the gradients of x and of the stage
    parameters of sum(out * cot) (each rank's loss divided by 4, summed over
    the ranks) against the sequential reference's on rank 0; the handoffs
    counted, the schedule's and the reference's time."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer
    from repro_torch.models.transformer import _slot_forward, _sub
    from repro_torch.sharding.pipeline import gpipe, sequential_reference

    pipe = make_mesh((PIPE_STAGES,), ("pipe",), device="cuda")
    cfg = dataclasses.replace(get_config("gpt_small"), n_layers=PIPE_STAGES, dtype=torch.float32)
    model = transformer.Transformer(cfg, device=torch.device("cuda"),
                                    gen=torch.Generator(device="cuda").manual_seed(3))
    stage_params = _sub(model.params, "blocks.slot_0.")
    slot = cfg.pattern[0]
    stage = lambda p, x: _slot_forward(cfg, slot, p, x)[0]   # noqa: E731
    g = torch.Generator(device="cuda").manual_seed(4)
    x = torch.randn((PIPE_MICRO, 1, PIPE_SEQ, cfg.d_model), generator=g, device="cuda").requires_grad_(True)
    cot = torch.randn(x.shape, generator=g, device="cuda")
    leaves = [x] + list(model.params.values())
    pipe.collective_stats(reset=True)
    pipe.barrier()
    t0 = time.perf_counter()
    out = gpipe(stage, stage_params, x, mesh=pipe)
    grads = torch.autograd.grad((out * cot).sum() / PIPE_STAGES, leaves, allow_unused=True)
    torch.cuda.synchronize()
    pipe.barrier()
    gpipe_ms = (time.perf_counter() - t0) * 1e3
    calls = {k: v["calls"] for k, v in pipe.collective_stats(reset=True).items()}
    grads = [None if gr is None else pipe.psum(gr, ("pipe",)) for gr in grads]
    res = dict(gpipe_ms=gpipe_ms, calls=calls)
    handoffs = PIPE_MICRO + PIPE_STAGES - 2
    if calls != {"ppermute": 2 * handoffs, "psum": 2}:
        raise AssertionError(f"gpipe: collectives {calls}, expected {2 * handoffs} handoffs and 2 psums")
    t0 = time.perf_counter()
    want = sequential_reference(stage, stage_params, x)
    want_grads = torch.autograd.grad((want * cot).sum(), leaves, allow_unused=True)
    torch.cuda.synchronize()
    res["sequential_ms"] = (time.perf_counter() - t0) * 1e3
    scale = float(want.abs().max())
    res["out_rel_err"] = float((out - want).abs().max()) / scale
    if res["out_rel_err"] > TOL_TP_GRAD:
        raise AssertionError(f"gpipe against the sequential reference: {res['out_rel_err']:.3e}")
    worst = 0.0
    for name, a, b in zip(["x"] + list(model.params), grads, want_grads):
        if (a is None) != (b is None):
            raise AssertionError(f"gpipe gradient of {name}: one side has none")
        if a is None:
            continue
        s = float(b.abs().max())
        worst = max(worst, float((a - b).abs().max()) / s if s else float(a.abs().max()))
    res["grad_rel_err"] = worst
    if worst > TOL_TP_GRAD:
        raise AssertionError(f"gpipe gradients against the sequential reference's: {worst:.3e}")
    if lead:
        log(f"[6i] GPipe, {PIPE_STAGES} stages of one full-width gpt_small block, {PIPE_MICRO} microbatches of 1 x "
            f"{PIPE_SEQ} (f32): outputs {res['out_rel_err']:.3e} and gradients {worst:.3e} of their largest from "
            f"sequential_reference's; {handoffs} handoffs each way; forward + backward {gpipe_ms:.1f} ms (4 ranks "
            f"on one card), sequential on one rank {res['sequential_ms']:.1f} ms")
    del model, out, grads, want, want_grads
    torch.cuda.empty_cache()
    return res


def momentless_case(torch, mesh, lead: bool) -> dict:
    """6j: moment-less SlimAdam (Table 3 on full-width gpt_small's leaves)
    sharded against unsharded on the same whole gradients, 2 updates: u and
    each rank's nu shards (2e-6), no first moment, no kernel launched (the
    plain math, as the JAX package routes it)."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import rules_to_dims, table3_rules
    from repro_torch.core.slim_adam import scale_by_slim_adam
    from repro_torch.models import Transformer
    from repro_torch.optim import fused as F
    from repro_torch.sharding import ShardingContext, param_specs, use_sharding
    from repro_torch.sharding.shardspec import regime_counts

    cfg = get_config("gpt_small")
    with use_sharding(ShardingContext(mesh)):
        model = Transformer(cfg, device=torch.device("cuda"), gen=torch.Generator(device="cuda").manual_seed(0))
        params, meta = model.params, model.meta
        specs = param_specs(meta, params)
    dims = rules_to_dims(table3_rules(meta), meta)
    names = list(params)
    plans = F.sharded_tree_plans(list(params.values()), [dims[k] for k in names], [specs[k] for k in names], mesh)
    grads = [{k: shard_inputs(torch, p.shape, 300 * s + i) for i, (k, p) in enumerate(params.items())}
             for s in range(2)]
    sharded = scale_by_slim_adam(dims, use_first_moment=False, backend="fused", mesh=mesh, param_specs=specs)
    plain = scale_by_slim_adam(dims, use_first_moment=False, backend="fused")
    with torch.no_grad():
        s_state, p_state = sharded.init(params), plain.init(params)
        kernels.reset_launch_counts()
        for g in grads:
            us, s_state = sharded.update(g, s_state)
            up, p_state = plain.update(g, p_state)
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
    if s_state.mu is not None or counts:
        raise AssertionError(f"moment-less SlimAdam: mu {type(s_state.mu)}, launches {counts}")
    worst = {"u": 0.0, "nu": 0.0}
    for k, pl in zip(names, plans):
        nu_spec = pl.nu_spec if pl.nu_spec is not None else pl.red_spec
        for what, a, b in (("u", us[k], up[k]), ("nu", s_state.nu[k], mesh.shard(p_state.nu[k], nu_spec))):
            err = float((a.double() - b.double()).abs().max())
            worst[what] = max(worst[what], err)
            if err > TOL_PSUM_ABS:
                raise AssertionError(f"moment-less {k} {what}: {err:.3e} above {TOL_PSUM_ABS:.0e}")
    if lead:
        log(f"[6j] moment-less SlimAdam (Table 3, full-width gpt_small's leaves) on the mesh against unsharded, 2 "
            f"updates: u {worst['u']:.3e}, owner-slice nu {worst['nu']:.3e} (tol {TOL_PSUM_ABS:.0e}); no first "
            f"moment; no kernel launched (plain math)")
    del model, params, grads, us, up, s_state, p_state
    torch.cuda.empty_cache()
    return dict(abs_err=worst, regimes=regime_counts(plans))


# -- parameter-shard storage (phase 6k) ------------------------------------------

# Full-width cases of 6k on the same (data=2, model=2) ranks, each rank
# holding only its shards of p, g, m, v and the update: (layers kept, None for
# the whole model; global rows; sequence; lr; the dtypes and optimizers run).
# Each repeats 6f's f32 Adam run from the same weights: olmoe at 6f's 1-layer
# cut, not the 2-layer cut that does not fit four whole-parameter ranks, to
# keep the whole run inside its time with 6m.
SHARD_CASES = {
    "gpt_small": (2, 8, 1024, 1e-3, (("float32", "adam"),)),
    "falcon_mamba_7b": (1, 2, 2048, 1e-3, (("float32", "adam"),)),
    "olmoe_1b_7b": (1, 2, 2048, 1e-4, (("float32", "adam"), ("bfloat16", "slim"))),
}
SHARD_STEPS = 2             # steps a run: Adam (SNR measured after the last in bf16), Table-3 SlimAdam
TOL_SHARD_LOSS = 1e-5       # f32 losses against the whole-parameter path: only the order of sums differs
# 6k's other optimizers under shard storage, f32, full-width gpt_small cut to
# (layers, global rows, sequence, lr): (optimizer, backend) each, against the
# whole-parameter Trainer on the same ranks; the first also checkpoints
# through the launcher at SHARD_OPT_STEPS and resumes (bit-equal losses).
SHARD_OPT_CUT = (2, 4, 512, 1e-3)
SHARD_OPT_CASES = (("adafactor", "fused"), ("sm3", "fused"), ("lion", "fused"), ("sgdm", "fused"), ("slim", "jnp"))
SHARD_OPT_STEPS = 2


def record_routes(torch, log_to: list):
    """Wrap ``mlp_moe.moe_route`` so every call appends its (expert ids
    (n, k), kept choices (n * k,)) to ``log_to`` as numpy arrays; returns
    the function that unwraps it."""
    from repro_torch.models import mlp_moe

    orig = mlp_moe.moe_route

    def route(p, xf, cfg, groups):
        r = orig(p, xf, cfg, groups)
        log_to.append((r.eidx.cpu().numpy(), torch.cat([dp.keep for dp in r.groups]).cpu().numpy()))
        return r

    mlp_moe.moe_route = route
    return lambda: setattr(mlp_moe, "moe_route", orig)


def forward_routes(calls: list, layers: int) -> list:
    """The forward's routing of each step from a step's calls (each layer's
    forward, then under remat its recompute in reverse): per step, per
    layer, (expert ids, kept)."""
    per = 2 * layers
    return [calls[s * per: s * per + layers] for s in range(len(calls) // per)]


def shard_run(torch, mesh, arch: str, dtype_name: str, optimizer: str, lead: bool, keep: dict, work) -> dict:
    """One 6k run on this rank: ``repro_torch.launch.train.build`` (weights
    drawn leaf by leaf from a CUDA generator seeded 0, as 6f's Trainer draws
    them, each kept as this rank's shard), the persistent bytes held
    against ``reckon_bytes`` (p, m, v; g's against p's), in f32 the first
    batch's gradient shards, SHARD_STEPS steps through ``launch.train``
    (launch and region counters zeroed before), after olmoe's Adam steps
    one SNR measurement of its moment shards (B9), in bf16 Table 3 its last step
    profiled; olmoe's bf16 routing recorded. f32 runs are held here to 6f's
    run of the same cut (``keep``); olmoe's gradient shards also go to
    ``work`` for the reference after the ranks exit."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import measure_tree_snr, rules_to_dims, table3_rules
    from repro_torch.data import DataConfig, ZipfLM
    from repro_torch.launch import train as launch
    from repro_torch.optim import fused as F
    from repro_torch.sharding import ShardingContext, logical, use_sharding
    from repro_torch.sharding.shardspec import regime_counts, spec_entries
    from repro_torch.optim.base import GradientTransformation
    from repro_torch.train.step import make_train_step
    from repro_torch.train.trainer import find_adam_nu

    say = log if lead else (lambda *a: None)
    layers, rows, seq, lr, _ = SHARD_CASES[arch]
    dtype = getattr(torch, dtype_name)
    cfg = dataclasses.replace(get_config(arch), dtype=dtype, **({"n_layers": layers} if layers else {}))
    ref = keep.get(arch) if dtype == torch.float32 else None
    ref = ref if ref is not None and ref["layers"] == cfg.n_layers else None
    label = f"{arch} {'f32' if dtype == torch.float32 else 'bf16'} {optimizer}"
    data = ZipfLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=rows, seed=0))
    quiet = lambda *a: None   # noqa: E731
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res: dict = {"layers": cfg.n_layers, "coords": dict(mesh.coords)}
    routes: list = []
    unwrap = record_routes(torch, routes) if arch == "olmoe_1b_7b" and dtype == torch.bfloat16 else None
    try:
        with use_sharding(ShardingContext(mesh)):
            run = launch.build(cfg, optimizer, lr, mesh, gen=torch.Generator(device="cuda").manual_seed(0))
            held, reckoned = run.persistent_bytes(), launch.reckon_bytes(cfg, optimizer, lr, mesh)
            if held != reckoned:
                raise AssertionError(f"{label}: rank {mesh.rank} holds {held} bytes, reckoned {reckoned}")
            res.update(bytes=held, n_params=sum(math.prod(s.shape) for s in cfg.abstract()[0].values()))
            if optimizer == "slim":
                dims = rules_to_dims(table3_rules(run.model.meta), run.model.meta)
                names = list(run.p_sh)
                res["regimes"] = regime_counts(F.sharded_tree_plans(
                    [run.model.params[k] for k in names], [dims[k] for k in names],
                    [run.p_sh[k].spec for k in names], mesh, param_shards=True))
            first: dict = {}
            if dtype == torch.float32:
                # the first step's gradient shards, as the optimizer receives them
                def update(grads, opt_state, params=None):
                    if not first:
                        first.update({k: g.detach().cpu() for k, g in grads.items()})
                    return run.tx.update(grads, opt_state, params)

                run = run._replace(step=make_train_step(run.model, GradientTransformation(run.tx.init, update),
                                                        mesh=mesh, grad_shardings=run.p_sh))
            routes.clear()
            kernels.reset_launch_counts()
            logical.region_counts(reset=True)
            profiled = dtype == torch.bfloat16 and optimizer == "slim"
            state, losses, step_ms = run.opt_state, [], []
            for k in range(SHARD_STEPS):
                mesh.barrier()
                step = lambda: launch.train(run._replace(opt_state=state), data, k + 1, start=k, log=quiet)  # noqa
                last = k == SHARD_STEPS - 1
                if last:
                    # the last step's collectives and launches, what the dry run (6k a) predicts
                    mesh.collective_stats(reset=True)
                    before = kernels.launch_counts()
                if profiled and last:
                    box = []
                    res["profile"] = profile_device(torch, lambda: box.append(step()), 1, statistics.median(step_ms),
                                                    f"{label} shard-storage step")
                    (row,), state = box[0]
                else:
                    t0 = time.perf_counter()
                    (row,), state = step()
                    torch.cuda.synchronize()
                    step_ms.append((time.perf_counter() - t0) * 1e3)
                if last:
                    stats = mesh.collective_stats(reset=True)
                    res["step_collectives"] = {k2: {"calls": int(v["calls"]), "bytes": int(v["bytes"])}
                                               for k2, v in stats.items()}
                    res["step_launches"] = {n: c - before[n] for n, c in kernels.launch_counts().items()
                                            if c != before[n]}
                    if profiled:
                        res["collectives"] = {k2: v["calls"] for k2, v in stats.items()}
                losses.append(row["loss"])
            if first:
                res["grad_bytes"] = sum(g.numel() * g.element_size() for g in first.values())
                if res["grad_bytes"] != held["params"]:
                    raise AssertionError(f"{label}: gradient shards {res['grad_bytes']} B, parameters "
                                         f"{held['params']} B")
                if ref is not None:
                    res["grad_rel_err"] = hold_grads(first, ref, label)
                if arch == "olmoe_1b_7b":
                    blocks = {k: [(d, mesh.group_index(axes) * g.shape[d], g.shape[d]) for d, axes in
                                  enumerate(spec_entries(run.p_sh[k].spec, g.ndim)) if axes]
                              for k, g in first.items()}
                    torch.save({"grads": first, "blocks": blocks}, work / f"grads_{arch}_{mesh.rank}.pt")
                first.clear()
            if arch == "olmoe_1b_7b" and optimizer == "adam":
                nu_specs = {k: s.spec for k, s in find_adam_nu(run.o_sh).items()}
                snr = measure_tree_snr(find_adam_nu(state), run.model.meta, backend="fused", mesh=mesh,
                                       param_specs=nu_specs)
                res["snr_leaves"] = len(snr)
            mesh.barrier()
            res.update(losses=losses, step_ms=step_ms, launches=kernels.launch_counts(),
                       regions=logical.region_counts(reset=True),
                       peak_gib=(torch.cuda.max_memory_allocated() - base) / 2**30)
            del run, state
    finally:
        if unwrap is not None:
            unwrap()
    if routes:
        res["routes"] = forward_routes(routes, cfg.n_layers)
    if not all(map(math.isfinite, res["losses"])):
        raise AssertionError(f"{label}: losses {res['losses']}")
    if ref is not None:
        want = ref["losses"]
        res["loss_rel_err"] = err = max(abs(a - b) / abs(b) for a, b in zip(res["losses"], want))
        if err > TOL_SHARD_LOSS:
            raise AssertionError(f"{label}: losses {res['losses']} against 6f's whole-parameter {want}: {err:.3e}")
    whole = 4 * res["n_params"]
    if ref is not None:
        say(f"  [6k] {label}: losses {res['losses']} against 6f's whole-parameter {ref['losses']}: "
            f"{res['loss_rel_err']:.3e} (tol {TOL_SHARD_LOSS:.0e}); first-step gradient shards within "
            f"{res['grad_rel_err']:.3e} of each leaf's largest |g| (tol {TOL_TP_GRAD:.0e})")
    say(f"  [6k] {label}: losses {[round(x, 6) for x in res['losses']]}, steps {[round(x, 1) for x in step_ms]} ms; "
        f"rank 0 holds p {held['params'] / 2**30:.3f} GiB, opt {held['opt'] / 2**30:.3f} GiB (= reckoned), peak "
        f"{res['peak_gib']:.2f} GiB over its start (whole-parameter ranks held p, g and u whole: "
        f"{3 * whole / 2**30:.3f} GiB); regions {res['regions']}; launches "
        f"{ {k: v for k, v in res['launches'].items() if v} }")
    torch.cuda.empty_cache()
    return res


def hold_grads(grads, ref: dict, label: str) -> float:
    """Each gradient shard against this rank's cut of the whole-parameter
    path's averaged gradient, of the leaf's largest |g| (TOL_TP_GRAD)."""
    worst = 0.0
    for k, g in grads.items():
        want = ref["grad_cut"][k].double()
        scale = ref["grad_max"][k]
        err = float((g.detach().cpu().double() - want).abs().max()) / scale if scale else float(g.abs().max())
        worst = max(worst, err)
        if err > TOL_TP_GRAD:
            raise AssertionError(f"{label}: {k}'s gradient shard {err:.3e} of its largest |g| from the whole-parameter "
                                 f"path's (tol {TOL_TP_GRAD:.0e})")
    return worst


def shard_cases(torch, mesh, lead: bool, keep: dict, work) -> dict:
    """Phase 6k on this rank: every SHARD_CASES run in turn."""
    out = {}
    for arch, (*_, runs) in SHARD_CASES.items():
        for dtype_name, optimizer in runs:
            t0 = time.perf_counter()
            r = shard_run(torch, mesh, arch, dtype_name, optimizer, lead, keep, work)
            r["seconds"] = time.perf_counter() - t0
            out[f"{arch} {dtype_name} {optimizer}"] = r
    return out


def shard_optimizers(torch, mesh, lead: bool, work) -> dict:
    """6k (b) and (c) on this rank: SHARD_OPT_CASES, each through
    ``launch.build`` (weights from a CUDA generator seeded 0, kept as this
    rank's shards; the optimizer with ``param_shards=True`` on the backend
    named) and ``launch.train`` for SHARD_OPT_STEPS steps, its bytes held
    against ``reckon_bytes``, its f32 losses against the whole-parameter
    ``Trainer`` on the same ranks from the same weights (TOL_SHARD_LOSS).
    The first case also checkpoints through the launcher at its last step
    (the shards gathered whole, rank 0 writes), runs on, and a fresh build
    restored from that checkpoint takes the same steps: losses bit-equal."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, ZipfLM
    from repro_torch.launch import train as launch
    from repro_torch.sharding import ShardingContext, use_sharding
    from repro_torch.train import Trainer, TrainerConfig

    say = log if lead else (lambda *a: None)
    layers, rows, seq, lr = SHARD_OPT_CUT
    cfg = dataclasses.replace(get_config("gpt_small"), dtype=torch.float32, n_layers=layers)
    data = ZipfLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=rows, seed=0))
    quiet = lambda *a: None   # noqa: E731
    seeded = lambda s=0: torch.Generator(device="cuda").manual_seed(s)   # noqa: E731
    ckpt = str(work / "shard_ckpt")
    n = SHARD_OPT_STEPS
    out = {}
    with use_sharding(ShardingContext(mesh)):
        for i, (optimizer, backend) in enumerate(SHARD_OPT_CASES):
            t0 = time.perf_counter()
            label = f"{optimizer} ({backend})"
            run = launch.build(cfg, optimizer, lr, mesh, backend=backend, gen=seeded())
            held = run.persistent_bytes()
            if held != launch.reckon_bytes(cfg, optimizer, lr, mesh, backend=backend):
                raise AssertionError(f"6k {label}: rank {mesh.rank} holds {held} bytes, not the reckoned count")
            rows_, state = launch.train(run, data, n, ckpt=ckpt if i == 0 else None, ckpt_every=n if i == 0 else 0,
                                        log=quiet)
            res = {"losses": [r["loss"] for r in rows_], "bytes": held}
            if i == 0:
                on, _ = launch.train(run._replace(opt_state=state), data, 2 * n, start=n, log=quiet)
                fresh = launch.build(cfg, optimizer, lr, mesh, backend=backend, gen=seeded(7))
                restored, extra = launch.restore(fresh, ckpt)
                again, _ = launch.train(fresh._replace(opt_state=restored), data, 2 * n, start=int(extra["step"]),
                                        log=quiet)
                res.update(continued=[r["loss"] for r in on], resumed=[r["loss"] for r in again])
                if res["resumed"] != res["continued"]:
                    raise AssertionError(f"6k {label}: resumed from the shard checkpoint {res['resumed']}, the run "
                                         f"went on {res['continued']}")
                say(f"  [6k] {label}: checkpointed through the launcher at step {n} (shards gathered whole, rank 0 "
                    f"wrote), restored into a fresh build: steps {n + 1}-{2 * n} {res['resumed']} bit-equal to the "
                    f"run's own")
                del fresh, restored
            del run, state
            torch.cuda.empty_cache()
            tr = Trainer(cfg, optimizer, lr, data, TrainerConfig(backend=backend, total_steps=n, log_every=1, seed=0),
                         gen=seeded())
            tr.run()
            res["whole"] = [m["loss"] for m in tr.metrics_log]
            del tr
            torch.cuda.empty_cache()
            res["rel_err"] = err = max(abs(a - b) / abs(b) for a, b in zip(res["losses"], res["whole"]))
            res["seconds"] = time.perf_counter() - t0
            say(f"  [6k] {label}, gpt_small cut to {layers} layers, {rows} x {seq}, f32: shard storage "
                f"{res['losses']}, whole-parameter {res['whole']}: {err:.3e} (tol {TOL_SHARD_LOSS:.0e}); rank 0 holds p "
                f"{held['params']:,} B, state {held['opt']:,} B (= reckoned); {res['seconds']:.1f} s")
            if not err <= TOL_SHARD_LOSS:
                raise AssertionError(f"6k {label}: shard storage {res['losses']} against the whole-parameter path "
                                     f"{res['whole']}: {err:.3e}")
            out[label] = res
    return out


# 6l: the decode step on the mesh in JAX's decode layout (make_serve_step
# under repro/launch/dryrun.py:204-217): full-width cuts (layers), rows
# (DECODE_ROWS // 2 a data rank) and a cache of DECODE_SEQ positions (half a
# model rank), DECODE_PROMPT prompt tokens then greedy steps, DECODE_STEPS in
# all, so the write crosses the model ranks' block boundary; (c) one step of
# olmoe's cut timed at decode_32k's cache length.
DECODE_CASES = {"olmoe_1b_7b": 2, "falcon_mamba_7b": 2}
DECODE_ROWS, DECODE_SEQ, DECODE_PROMPT, DECODE_STEPS = 4, 64, 12, 48
DECODE_LONG, DECODE_TIMED = 32768, 3
TOL_DECODE = 1e-5   # f32 logits and cache blocks against the unsharded port, of the largest magnitude
DECODE_PEAK_BAND = (0.96, 1.10)   # (e): the dry run's peak over each rank's measured one (6k's band)


def decode_cfg(torch, arch: str, dtype):
    """6l's config: the full-width ``arch`` cut to DECODE_CASES' layers, its
    activations and (the bf16 run: halving the gathers) parameters in
    ``dtype``."""
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config(arch), n_layers=DECODE_CASES[arch], dtype=dtype, param_dtype=dtype)


def serve_steps(torch, step, params, cache, tokens, steps: int):
    """``steps`` calls of a serve step: the columns of ``tokens`` fed first,
    then its own greedy tokens. Returns (logits (steps, B, V), next tokens
    (steps, B), the cache)."""
    logits, nexts, tok = [], [], None
    for t in range(steps):
        if t < tokens.shape[1]:
            tok = tokens[:, t:t + 1]
        tok, lg, cache = step(params, cache, tok)
        logits.append(lg[:, 0])
        nexts.append(tok[:, 0])
    return torch.stack(logits), torch.stack(nexts), cache


def step_held(torch, mesh, fn, held: dict) -> dict:
    """One decode step ``fn()`` measured as the dry run counts it: its
    collectives (calls and bytes by kind), its kernel launches, and its peak
    (the rank's ``held`` bytes, parameter shards and cache block, plus the
    most the step allocates above what was allocated before it)."""
    from repro_torch import kernels

    torch.cuda.synchronize()
    mesh.collective_stats(reset=True)
    before = kernels.launch_counts()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    stats = mesh.collective_stats(reset=True)
    return {"out": out, "bytes": held, "peak": sum(held.values()) + torch.cuda.max_memory_allocated() - base,
            "collectives": {k: {"calls": int(v["calls"]), "bytes": int(v["bytes"])} for k, v in stats.items()},
            "launches": {n: c - before[n] for n, c in kernels.launch_counts().items() if c != before[n]}}


def decode_case(torch, mesh, arch: str, dtype, lead: bool, keep: dict) -> dict:
    """6l (a)/(b) on this rank: ``arch``'s cut drawn whole on the card (a
    CUDA generator seeded 0), served unsharded (no context: one device),
    then as this rank's stored shards (``launch.train.stored_weights``) with
    its rows of the tokens and its block of the cache
    (``init_decode_cache`` under the context). f32: greedy, every step's
    logits (TOL_DECODE of max|logit|), tokens (equal) and the last cache
    blocks (TOL_DECODE) held against the unsharded run's cut; every region
    in its parallel form; B15's one-token form ``layers`` times a step.
    bf16: fed the unsharded run's tokens; greedy agreement and the logit gap
    reported, not held. The last step is measured for the dry run (e).
    ``keep['olmoe']``: (a)'s f32 shards for (c)."""
    from repro_torch import kernels
    from repro_torch.kernels import ssm_scan as sc
    from repro_torch.launch.train import stored_weights
    from repro_torch.models import transformer
    from repro_torch.sharding import ShardingContext, logical, use_sharding
    from repro_torch.train.step import make_serve_step

    say = log if lead else (lambda *a: None)
    f32 = dtype == torch.float32
    label = f"{arch} {'f32' if f32 else 'bf16'}"
    cfg = decode_cfg(torch, arch, dtype)
    step = make_serve_step(cfg)
    d = mesh.coords["data"]
    rows = slice(d * DECODE_ROWS // 2, (d + 1) * DECODE_ROWS // 2)
    whole, _ = cfg.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    prompt = torch.randint(0, cfg.vocab_size, (DECODE_ROWS, DECODE_PROMPT), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(5)).cuda()
    cache = transformer.init_decode_cache(cfg, DECODE_ROWS, DECODE_SEQ, dtype, device="cuda")
    ref_logits, ref_next, cache = serve_steps(torch, step, whole, cache, prompt, DECODE_STEPS)
    fed = prompt if f32 else torch.cat([prompt, ref_next[DECODE_PROMPT - 1:-1].T], dim=1)
    ctx = ShardingContext(mesh)
    with use_sharding(ctx):
        specs = transformer.decode_cache_specs(ctx, cache)
        ref_cut = {k: [mesh.shard(t, sp) for t, sp in zip(c, specs.slots[k])] for k, c in cache.slots.items()}
        del cache
        params = stored_weights(cfg, mesh, whole=whole)
        del whole
        torch.cuda.empty_cache()
        local = transformer.init_decode_cache(cfg, DECODE_ROWS, DECODE_SEQ, dtype, device="cuda")
        nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)   # noqa: E731
        held = {"params": nbytes(params.values()), "opt": 0,
                "cache": nbytes(t for c in local.slots.values() for t in c)}
        kernels.reset_launch_counts()
        logical.region_counts(reset=True)
        forms = dict(sc.ssm_scan.form_launches)
        mesh.barrier()
        t0 = time.perf_counter()
        logits, nexts, local = serve_steps(torch, step, params, local, fed[rows], DECODE_STEPS - 1)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        last = step_held(torch, mesh, lambda: step(params, local, nexts[-1:].T if f32 else
                                                  fed[rows, DECODE_STEPS - 1:]), held)
        nxt, lg, local = last.pop("out")
        logits, nexts = torch.cat([logits, lg[None, :, 0]]), torch.cat([nexts, nxt[None, :, 0]])
        regions = logical.region_counts(reset=True)
        launches = kernels.launch_counts()
        token = sc.ssm_scan.form_launches["token"] - forms["token"]
    want = ref_logits[:, rows]
    gap = float((logits.double() - want.double()).abs().max() / want.double().abs().max())
    agree = float((nexts == ref_next[:, rows]).float().mean())
    res = dict(layers=cfg.n_layers, n_params=cfg.param_count(), logit_gap=gap, agreement=agree, regions=regions,
               launches=launches, token_launches=token, step=last, seconds=seconds,
               ms_per_step=seconds * 1e3 / (DECODE_STEPS - 1))
    if f32:
        if gap > TOL_DECODE or not torch.equal(nexts, ref_next[:, rows]):
            raise AssertionError(f"6l {label} rank {mesh.rank}: logits {gap:.3e} of max|logit| from the unsharded "
                                 f"port's (tol {TOL_DECODE:.0e}), tokens agree {agree:.3f}")
        res["cache_err"] = 0.0
        for k, c in local.slots.items():
            for name, t, w in zip(c._fields, c, ref_cut[k]):
                if name == "index":
                    if not torch.equal(t, w):
                        raise AssertionError(f"6l {label} rank {mesh.rank}: cache {k} fill {t.tolist()}, the "
                                             f"unsharded run's {w.tolist()}")
                    continue
                err = float((t.double() - w.double()).abs().max() / max(float(w.double().abs().max()), 1e-30))
                res["cache_err"] = max(res["cache_err"], err)
                if err > TOL_DECODE:
                    raise AssertionError(f"6l {label} rank {mesh.rank}: cache {k}.{name} block {err:.3e} from the "
                                         f"unsharded cache's cut")
        kinds = {"olmoe_1b_7b": ("embed", "attn", "moe", "head"), "falcon_mamba_7b": ("embed", "ssm", "head")}[arch]
        per_step = {"attn": cfg.n_layers, "moe": cfg.n_layers, "ssm": cfg.n_layers, "embed": 1, "head": 1}
        want_regions = {f"decode_{k}": {"parallel": per_step[k] * DECODE_STEPS, "fallback": 0} for k in kinds}
        if regions != want_regions:
            raise AssertionError(f"6l {label} rank {mesh.rank}: regions {regions}, expected {want_regions}")
        mamba = cfg.n_layers if arch == "falcon_mamba_7b" else 0
        if token != mamba * DECODE_STEPS or launches.get("ssm_scan", 0) != mamba * DECODE_STEPS:
            raise AssertionError(f"6l {label} rank {mesh.rank}: B15's one-token form {token} times, launches "
                                 f"{launches.get('ssm_scan', 0)}, expected {mamba * DECODE_STEPS}")
        if arch == "olmoe_1b_7b":
            keep["olmoe"] = (cfg, params)
    say(f"  [6l] {label}, {cfg.n_layers} layers at full width, {DECODE_ROWS} rows ({DECODE_ROWS // 2} a data rank), "
        f"{DECODE_SEQ}-position cache ({DECODE_SEQ // 2} a model rank), {DECODE_PROMPT} prompt tokens + "
        f"{DECODE_STEPS - DECODE_PROMPT} {'greedy' if f32 else 'fed'} steps: logits {gap:.3e} of max|logit| from "
        f"the unsharded port, tokens agree {agree:.3f}"
        + (f", cache blocks {res['cache_err']:.3e}" if f32 else "") + f"; regions {regions}; B15 one-token "
        f"{token}; {res['ms_per_step']:.1f} ms a step (host clock, 4 ranks on one card over gloo); last step "
        f"collectives {last['collectives']}")
    if not f32:
        del params
    torch.cuda.empty_cache()
    return res


def decode_long(torch, mesh, lead: bool, keep: dict, smi: str) -> dict:
    """6l (c) on this rank: (a)'s f32 shards, decode_32k's cache length
    (DECODE_LONG positions, half a model rank; DECODE_ROWS rows, half a data
    rank), the cache filled to DECODE_LONG - 8: DECODE_TIMED steps timed on
    the host clock, synchronised, one after another; one more profiled
    (busy share); one measured for the dry run (collectives, peak)."""
    from repro_torch.models import transformer
    from repro_torch.sharding import ShardingContext, use_sharding
    from repro_torch.train.step import make_serve_step

    say = log if lead else (lambda *a: None)
    cfg, params = keep.pop("olmoe")
    step = make_serve_step(cfg)
    fill = DECODE_LONG - 8
    with use_sharding(ShardingContext(mesh)):
        cache = transformer.init_decode_cache(cfg, DECODE_ROWS, DECODE_LONG, torch.float32, device="cuda")
        for c in cache.slots.values():
            c.index.fill_(fill)
        cache = cache._replace(step=fill)
        nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)   # noqa: E731
        held = {"params": nbytes(params.values()), "opt": 0,
                "cache": nbytes(t for c in cache.slots.values() for t in c)}
        tok = torch.zeros((DECODE_ROWS // 2, 1), dtype=torch.int32, device="cuda")
        ms = []
        for _ in range(DECODE_TIMED):
            mesh.barrier()
            t0 = time.perf_counter()
            tok, _, cache = step(params, cache, tok)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        mesh.barrier()
        box = []
        prof = profile_device(torch, lambda: box.append(step(params, cache, tok)), 1, statistics.median(ms),
                              "6l (c) decode step")
        tok, _, cache = box[0]
        mesh.barrier()
        last = step_held(torch, mesh, lambda: step(params, cache, tok), held)
        last.pop("out")
    del params, cache
    torch.cuda.empty_cache()
    say(f"  [6l c] olmoe_1b_7b cut to {cfg.n_layers} layers, f32, a {DECODE_LONG}-position cache "
        f"({DECODE_LONG // 2} a model rank), {DECODE_ROWS // 2} rows a data rank ({smi}; 4 ranks on one card over "
        f"gloo, not a multi-GPU number): steps {[round(x, 1) for x in ms]} ms; busy share rank 0 "
        f"{prof['busy_ms'] / prof['wall_ms']:.3f}; collectives {last['collectives']}; peak "
        f"{last['peak'] / 2**30:.3f} GiB")
    return dict(step_ms=ms, busy_share=prof["busy_ms"] / prof["wall_ms"], top_kernels=prof["kernels"][:10],
                step=last)


def decode_cases(torch, mesh, lead: bool, smi: str) -> dict:
    """Phase 6l on this rank: (a) and (b) in f32 and bf16, then (c)."""
    keep: dict = {}
    out = {}
    for arch in DECODE_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            t0 = time.perf_counter()
            r = decode_case(torch, mesh, arch, dtype, lead, keep)
            r["seconds_all"] = time.perf_counter() - t0
            out[f"{arch} {'f32' if dtype == torch.float32 else 'bf16'}"] = r
            if arch == "olmoe_1b_7b" and dtype == torch.float32:
                out["long"] = decode_long(torch, mesh, lead, keep, smi)
    return out


def decode_summary(results: dict, recs: dict, smi: str) -> dict:
    """6l's report: every rank's greedy tokens and regions as checked on the
    rank; (e) each measured step against its dry run on every rank (bytes,
    collectives and launches equal; the peak within ``DECODE_PEAK_BAND`` of
    the rank's measured one); (c)'s busy
    share and peak by rank."""
    out = {"cases": {}, "dryrun": {}}
    r0 = results[0]["decode"]
    for key, run in r0.items():
        rec = recs[f"decode {key}"]
        ratios = []
        for r in results:
            step = results[r]["decode"][key]["step"]
            got = {"bytes": rec["persistent_bytes"], "collectives": rec["collectives"], "launches": rec["launches"]}
            want = {"bytes": step["bytes"], "collectives": step["collectives"], "launches": step["launches"]}
            for what in got:
                if got[what] != want[what]:
                    raise AssertionError(f"6l (e) {key} rank {r}: the dry run's {what} {got[what]}, the card's "
                                         f"{want[what]}")
            ratios.append(rec["peak_bytes"] / step["peak"])
            if not DECODE_PEAK_BAND[0] <= ratios[-1] <= DECODE_PEAK_BAND[1]:
                raise AssertionError(f"6l (e) {key} rank {r}: the dry run's peak {rec['peak_bytes']} is "
                                     f"{ratios[-1]:.4f}x the card's {step['peak']}, outside {DECODE_PEAK_BAND}")
        log(f"  [6l e] {key}: dry run on meta = every rank's step: bytes {rec['persistent_bytes']}, collectives "
            f"{rec['collectives']}, launches {rec['launches']}; peak predicted {rec['peak_bytes'] / 2**30:.3f} GiB, "
            f"ratio to each rank's measured {[round(x, 3) for x in ratios]}")
        out["dryrun"][key] = dict(peak_predicted=rec["peak_bytes"], peak_by_rank=[results[r]["decode"][key]["step"]
                                                                                 ["peak"] for r in results],
                                  ratios=ratios, step_s=rec["step_s"])
        row = {k: v for k, v in run.items() if k != "step"}
        if key == "long":
            row["busy_share_by_rank"] = [results[r]["decode"]["long"]["busy_share"] for r in results]
            row["peak_gib_by_rank"] = [results[r]["decode"]["long"]["step"]["peak"] / 2**30 for r in results]
            log(f"[6l c] {smi}: busy share by rank {[round(x, 3) for x in row['busy_share_by_rank']]}, peak by rank "
                f"{[round(x, 3) for x in row['peak_gib_by_rank']]} GiB")
        else:
            row["agreement_by_rank"] = [results[r]["decode"][key]["agreement"] for r in results]
            row["logit_gap_by_rank"] = [results[r]["decode"][key]["logit_gap"] for r in results]
        out["cases"][key] = row
    return out


def wrapper_forms(torch, gen) -> dict:
    """Phase 2: the thin 2-D wrappers over the batched kernels
    (``megaplan.mega_slim_update``, ``snr_stats.snr_stats_centered``,
    ``_partial`` and ``_major``) against their batched forms on one shape of
    the main path (gpt_small's (768, 3072) MLP matrix), bit for bit: each
    is one call of the same kernel."""
    from repro_torch.kernels import megaplan, snr_stats

    dev = torch.device("cuda")
    r, c = 768, 3072
    g = 1e-3 * torch.randn((r, c), generator=gen, device=dev)
    m = 1e-4 * torch.randn((r, c), generator=gen, device=dev)
    out = {}
    for axis in (1, 0):
        line = (r, 1) if axis == 1 else (1, c)
        v = 1e-6 * torch.rand(line, generator=gen, device=dev)
        bc1, bc2 = torch.full(line, 0.271, device=dev), torch.full(line, 0.142625, device=dev)
        kw = dict(axis=axis, with_snr=True, with_health=True)
        got = megaplan.mega_slim_update(g, m, v, bc1, bc2, **kw)
        want = [o[0] for o in megaplan.mega_slim_update_batched(g[None], m[None], v[None], bc1[None], bc2[None], **kw)]
        same_tensors(f"mega_slim_update axis {axis}", dict(enumerate(got)), dict(enumerate(want)))
        out[f"mega_slim_update axis {axis}"] = len(got)
    v = g.abs()
    for name, batched, axis in (("snr_stats_centered", snr_stats.snr_stats_centered_batched, 1),
                                ("snr_stats_centered_partial", snr_stats.snr_stats_centered_partial_batched, 1),
                                ("snr_stats_centered_major", snr_stats.snr_stats_centered_batched, 0)):
        got = getattr(snr_stats, name)(v)
        want = [o[0] for o in batched(v[None], axis=axis)]
        same_tensors(name, dict(enumerate(got)), dict(enumerate(want)))
        out[name] = len(got)
    log(f"[2] the 2-D wrappers on ({r}, {c}) against their batched kernels: bit-equal ({', '.join(out)})")
    return out


def dryrun_6k(path: Path) -> int:
    """6k (a) and 6l (e), in a process of its own (one default process
    group a process): ``repro_torch.launch.dryrun`` on a (data=2, model=2)
    mesh over the fake group, on ``meta``, for every SHARD_CASES run (the
    same config, rows, sequence, optimizer and fused backend, grad_accum 1)
    and every decode step of 6l (its config, rows, cache length and cache
    dtype); the records go to ``path`` as JSON. Needs no GPU and touches
    none."""
    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun

    mesh = dryrun.make_meta_mesh(SHARD_SHAPE, SHARD_AXES)
    recs = {}
    for arch, (layers, rows, seq, _, runs) in SHARD_CASES.items():
        for dtype_name, optimizer in runs:
            cfg = dataclasses.replace(get_config(arch), dtype=getattr(torch, dtype_name),
                                      **({"n_layers": layers} if layers else {}))
            recs[f"{arch} {dtype_name} {optimizer}"] = dryrun.run_cell(
                arch, "train_4k", "2x2", optimizer=optimizer, backend="fused", grad_accum=1, out_dir=None, mesh=mesh,
                cfg=cfg, seq=seq, global_batch=rows)
    # 6l (e): each decode step of 6l on the same mesh
    for arch in DECODE_CASES:
        for dtype_name in ("float32", "bfloat16"):
            cfg = decode_cfg(torch, arch, getattr(torch, dtype_name))
            recs[f"decode {arch} {'f32' if dtype_name == 'float32' else 'bf16'}"] = dryrun.run_cell(
                arch, "decode_32k", "2x2", out_dir=None, mesh=mesh, cfg=cfg, seq=DECODE_SEQ, global_batch=DECODE_ROWS,
                cache_dtype=cfg.dtype)
    recs["decode long"] = dryrun.run_cell("olmoe_1b_7b", "decode_32k", "2x2", out_dir=None, mesh=mesh,
                                          cfg=decode_cfg(torch, "olmoe_1b_7b", torch.float32), seq=DECODE_LONG,
                                          global_batch=DECODE_ROWS, cache_dtype=torch.float32)
    path.write_text(json.dumps(recs, default=str))
    return 0


def start_dryruns() -> dict:
    """The dry runs on ``meta`` that 6k (a), 6l (e) and 6m hold the card's
    steps to, each in a process of its own (``--dryrun-6k``, and
    ``--dryrun-6m`` for each LAUNCH_MESHES mesh; no GPU). Started after the
    build, they run beside the single-process phases, not beside the rank
    processes of 6f and 6m that need the host's cores. Returns {name:
    (process, JSON path, log path)}; a process still running when this
    script exits is killed."""
    import atexit
    import shutil

    work = ROOT / "build" / "chip_smoke_dry"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    argv = {"6k": ["--dryrun-6k"], **{kind: ["--dryrun-6m"] for kind in LAUNCH_MESHES}}
    jobs = {}
    for name, flag in argv.items():
        path, log_path = work / f"{name}.json", work / f"{name}.log"
        with open(log_path, "w") as out:
            proc = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), *flag, str(path)]
                                    + ([name] if name in LAUNCH_MESHES else []),
                                    stdout=out, stderr=subprocess.STDOUT)
        jobs[name] = (proc, path, log_path)
    atexit.register(lambda: [proc.kill() for proc, *_ in jobs.values() if proc.poll() is None])
    return jobs


def dryrun_records(jobs: dict, name: str) -> dict:
    """The records of ``start_dryruns``' job ``name``, once it has ended."""
    proc, path, log_path = jobs[name]
    if proc.wait(timeout=300) != 0:
        raise RuntimeError(f"the {name} dry run failed:\n{log_path.read_text()[-3000:]}")
    return json.loads(path.read_text())


def hold_dryrun(results: dict, recs: dict, smi: str) -> dict:
    """6k (a): each run's dry run against rank 0's measured run: the bytes a
    rank, the last step's collectives (calls and bytes by kind) and kernel
    launches equal; the predicted peak printed beside the measured one (not
    held: the dry run counts one step's live tensors, the run's peak spans
    its whole run)."""
    out = {}
    r0 = results[0]["shards"]
    for key, rec in recs.items():
        run = r0[key]
        got = {"bytes": rec["persistent_bytes"], "collectives": rec["collectives"], "launches": rec["launches"]}
        want = {"bytes": run["bytes"], "collectives": run["step_collectives"], "launches": run["step_launches"]}
        for what in got:
            if got[what] != want[what]:
                raise AssertionError(f"6k (a) {key}: the dry run's {what} {got[what]}, the card's {want[what]}")
        measured = run["peak_gib"] * 2**30
        ratio = rec["peak_bytes"] / measured
        log(f"  [6k a] {key}: dry run on meta (the fake group, no GPU; {rec['step_s']} s) = the card's step: bytes a "
            f"rank {rec['persistent_bytes']}, collectives {rec['collectives']}, launches {rec['launches']}; peak "
            f"predicted {rec['peak_bytes'] / 2**30:.3f} GiB, measured {measured / 2**30:.3f} GiB (the run's peak "
            f"over the rank's start; {smi}): ratio {ratio:.3f}")
        out[key] = dict(peak_predicted=rec["peak_bytes"], peak_measured=measured, ratio=ratio, step_s=rec["step_s"],
                        dot_flops=rec["dot_flops_per_dev"], roofline=rec["roofline"])
    return out


def group_routes(routes: list, groups: int, g: int) -> list:
    """Group ``g``'s part of routes over ``groups`` groups (group-major)."""
    return [[(e.reshape(groups, -1, e.shape[-1])[g], k.reshape(groups, -1)[g]) for e, k in step] for step in routes]


def route_flips(a: list, b: list) -> list:
    """Per step and layer: (expert choices that differ, kept choices that
    differ, drops in ``a``, drops in ``b``) between two routings of the same
    tokens."""
    return [[(int((ea != eb).sum()), int((ka != kb).sum()), int((~ka).sum()), int((~kb).sum()))
             for (ea, ka), (eb, kb) in zip(sa, sb)] for sa, sb in zip(a, b)]


def shard_reference(torch, results: dict, work, smi: str) -> dict:
    """After the ranks exit, on the whole card: olmoe_1b_7b's 6k cut
    through the unsharded port (JAX's G = 2 groups under a ``SpecMesh``)
    from the same weights and batches. f32: the ranks' losses (1e-5) and
    every rank's gradient shards against the cut of the unsharded first-step
    gradients (TOL_TP_GRAD of each leaf's largest |g|). bf16 Table 3: the
    losses against the split form's (``tests/_torch_split.py``) at
    6g's bar, max(1e-4, twice the unsharded port's own gap as 2
    micro-batches); the routing choices and drops that differ from the
    split form's and the unsharded port's at each step and layer."""
    import contextlib

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, ZipfLM
    from repro_torch.sharding import ShardingContext, SpecMesh, use_sharding
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.train.step import make_grad_fn

    sys.path.insert(0, str(ROOT / "tests"))
    from _torch_split import split_regions

    arch = "olmoe_1b_7b"
    layers, rows, seq, lr, runs = SHARD_CASES[arch]
    r0 = results[0]["shards"]
    out: dict = {}
    groups = ShardingContext(SpecMesh({"data": SHARD_SHAPE[0]}))
    split = lambda: split_regions(SHARD_SHAPE[1], rows=SHARD_SHAPE[0])   # noqa: E731
    for dtype_name, optimizer in runs:
        dtype = getattr(torch, dtype_name)
        cfg = dataclasses.replace(get_config(arch), dtype=dtype, n_layers=layers)
        data = ZipfLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=rows, seed=0))
        key = f"{arch} {dtype_name} {optimizer}"
        orders = {"x1": (1, contextlib.nullcontext)}
        if dtype == torch.bfloat16:
            orders.update(x2=(2, contextlib.nullcontext), split=(1, split))
        ref: dict = {}
        for order, (accum, form) in orders.items():
            calls: list = []
            unwrap = record_routes(torch, calls) if order != "x2" and dtype == torch.bfloat16 else None
            try:
                with use_sharding(groups), form():
                    tc = TrainerConfig(total_steps=SHARD_STEPS, log_every=1, backend="fused", seed=0)
                    tr = Trainer(cfg, optimizer, lr, data, tc, grad_accum=accum,
                                 gen=torch.Generator(device="cuda").manual_seed(0))
                    if dtype == torch.float32:
                        grads, _ = make_grad_fn(tr.model)(tr.batch(0))
                        ref["grad_rel_err"] = hold_saved_grads(torch, grads, work, arch, key)
                        del grads
                    calls.clear()
                    tr.run()
                    ref[order] = [m["loss"] for m in tr.metrics_log]
                    del tr
                    torch.cuda.empty_cache()
            finally:
                if unwrap is not None:
                    unwrap()
            if calls:
                ref[f"{order}_routes"] = forward_routes(calls, layers)
        got = r0[key]["losses"]
        rel = lambda a, b: max(abs(x - y) / abs(y) for x, y in zip(a, b))   # noqa: E731
        if dtype == torch.float32:
            ref["loss_rel_err"] = err = rel(got, ref["x1"])
            log(f"  [6k] {key}: losses shard storage {got}, unsharded {ref['x1']}: {err:.3e} (tol "
                f"{TOL_SHARD_LOSS:.0e}); gradient shards of every rank within {ref['grad_rel_err']:.3e} of each "
                f"leaf's largest |g| (tol {TOL_TP_GRAD:.0e})")
            if err > TOL_SHARD_LOSS:
                raise AssertionError(f"{key}: losses {got} against the unsharded port's {ref['x1']}")
        else:
            ref["own_x2"] = rel(ref["x2"], ref["x1"])
            out.setdefault("own_x2", []).append(ref["own_x2"])
        out[key] = ref
    tol = max(TOL_SHARDED_LOSS, 2 * max(out.get("own_x2", [0.0])))
    for dtype_name, optimizer in runs:
        key = f"{arch} {dtype_name} {optimizer}"
        ref = out[key]
        if dtype_name != "bfloat16":
            continue
        got = r0[key]["losses"]
        ref["rel_err_split"] = err = max(abs(x - y) / abs(y) for x, y in zip(got, ref["split"]))
        ref["rel_err_x1"] = max(abs(x - y) / abs(y) for x, y in zip(got, ref["x1"]))
        n_g = SHARD_SHAPE[0]
        whole = {order: ref.pop(f"{order}_routes") for order in ("split", "x1")}
        cut = {order: [group_routes(whole[order], n_g, g) for g in range(n_g)] for order in whole}
        flips = {}
        for r, res in results.items():
            routes, g = res["shards"][key].pop("routes"), res["shards"][key]["coords"]["data"]
            flips[r] = {order: route_flips(routes, cut[order][g]) for order in ("split", "x1")}
        split_x1 = [route_flips(cut["split"][g], cut["x1"][g]) for g in range(n_g)]
        ref.update(flips=flips, flips_split_x1=split_x1)
        log(f"  [6k] {key}: losses shard storage {got}, split form {ref['split']}, unsharded {ref['x1']}: {err:.3e} "
            f"from the split form (tol max({TOL_SHARDED_LOSS:.0e}, twice {max(out['own_x2']):.3e}) = {tol:.3e}), "
            f"{ref['rel_err_x1']:.3e} from unsharded")
        for r in (0, 2):
            log(f"    routing of rank {r}'s data group by step and layer, (expert choices that differ, kept choices "
                f"that differ, drops here, drops there): against the split form {flips[r]['split']}; against "
                f"unsharded {flips[r]['x1']}; the split form against unsharded (group "
                f"{results[r]['shards'][key]['coords']['data']}) "
                f"{split_x1[results[r]['shards'][key]['coords']['data']]}")
        if not err <= tol:
            raise AssertionError(f"{key}: losses {got} outside max(1e-4, twice the 2-micro-batch gap) = {tol:.3e} of "
                                 f"the split form's {ref['split']}")
    out["tol"] = tol
    return out


def shard_summary(torch, results: dict, work, smi: str) -> dict:
    """6k's report: every rank's losses equal; each case's bytes a rank
    (held = reckoned), peak over its start and time, printed for every
    rank; rank 0's bf16 Table-3 step and busy share; launches and regions
    (every region its parallel form, a layer a step forward and remat
    recompute; B2 each Adam step, B9 in the SNR measurement, B12/B13 each
    Table-3 step); then olmoe's references (:func:`shard_reference`)."""
    r0 = results[0]["shards"]
    out = {"cases": {}}
    for key, run in r0.items():
        for r in range(1, SHARD_RANKS):
            if results[r]["shards"][key]["losses"] != run["losses"]:
                raise AssertionError(f"6k {key}: rank {r} reports other losses than rank 0")
        n = run["layers"] * SHARD_STEPS * 2
        arch, optimizer = key.split()[0], key.split()[2]
        want = {k: {"parallel": n, "fallback": 0} for k in TP_REGIONS[arch]}
        if run["regions"] != want:
            raise AssertionError(f"6k {key}: regions {run['regions']}, expected {want}")
        c = run["launches"]
        need = {"mega_adam_update": SHARD_STEPS}
        if optimizer == "slim" and run["regimes"]["psum"]:
            need.update(mega_slim_partial_stats_batched=SHARD_STEPS, mega_slim_finalize_batched=SHARD_STEPS)
        if "snr_leaves" in run:
            need["snr_stats_centered_partial_batched"] = 1
        short = {k: c.get(k, 0) for k, v in need.items() if c.get(k, 0) < v}
        if short:
            raise AssertionError(f"6k {key}: launches {short} below {need}")
        whole = 4 * run["n_params"]
        for r in sorted(results):
            x = results[r]["shards"][key]
            log(f"  [6k] {key} rank {r} {x['coords']}: p {x['bytes']['params']:,} B, g "
                f"{x.get('grad_bytes', x['bytes']['params']):,} B, m and v {x['bytes']['opt']:,} B (held = reckoned); "
                f"peak {x['peak_gib']:.3f} GiB over its start; whole-parameter ranks held p, g, u whole "
                f"({3 * whole:,} B) beside the same m, v shards; steps {[round(t, 1) for t in x['step_ms']]} ms, "
                f"{x['seconds']:.1f} s")
        row = {k: v for k, v in run.items() if k not in ("profile",)}
        row["peak_gib_by_rank"] = [results[r]["shards"][key]["peak_gib"] for r in sorted(results)]
        if "profile" in run:
            row["busy_share_by_rank"] = [results[r]["shards"][key]["profile"]["busy_ms"]
                                         / results[r]["shards"][key]["profile"]["wall_ms"] for r in sorted(results)]
            row["top_kernels"] = run["profile"]["kernels"][:10]
            log(f"  [6k] {key} step ({smi}; 4 ranks on one card over gloo, not a multi-GPU number): "
                f"{[round(t, 1) for t in run['step_ms']]} ms on the host clock, busy share by rank "
                f"{[round(x, 3) for x in row['busy_share_by_rank']]} against the first step's time; collectives "
                f"{run['collectives']}")
        out["cases"][key] = row
    out["reference"] = shard_reference(torch, results, work, smi)
    for key, ref in out["reference"].items():
        if isinstance(ref, dict) and "flips" in ref:
            out["cases"][key]["flips"] = ref.pop("flips")
    return out


def hold_saved_grads(torch, grads, work, arch: str, key: str) -> float:
    """Every rank's saved gradient shards against the cut of the unsharded
    gradients by the rank's blocks, of each leaf's largest |g|."""
    worst = 0.0
    for r in range(SHARD_RANKS):
        saved = torch.load(work / f"grads_{arch}_{r}.pt")
        for k, g in grads.items():
            want = g.detach()
            for d, start, length in saved["blocks"][k]:
                want = want.narrow(d, start, length)
            scale = float(g.abs().max())
            err = float((saved["grads"][k].cuda().double() - want.double()).abs().max()) / scale
            worst = max(worst, err)
            if err > TOL_TP_GRAD:
                raise AssertionError(f"{key}: rank {r}'s {k} gradient shard {err:.3e} of its largest |g| from the "
                                     f"unsharded port's (tol {TOL_TP_GRAD:.0e})")
        del saved
    return worst


def tp_rank(rank, rdv, out, rate, smi):
    """One rank of the (data=2, model=2) mesh on the card: phases 6f-6l.
    Rank 0 logs and holds the references; every rank checks its counts."""
    import datetime

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.launch.mesh import make_mesh

    t_start = time.perf_counter()
    if rank:
        sys.stdout = open(os.devnull, "w")
    mesh = make_mesh(SHARD_SHAPE, SHARD_AXES, device="cuda", init_method=f"file://{rdv}", rank=rank,
                     world_size=SHARD_RANKS, timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S))
    lead = rank == 0
    res: dict = {}
    keep: dict = {}
    for arch in TP_CASES:
        for dtype in (getattr(torch, name) for name in TP_DTYPES[arch]):
            label = f"{arch} {'f32' if dtype == torch.float32 else 'bf16'}"
            t0 = time.perf_counter()
            r = tp_case(torch, mesh, arch, dtype, lead, keep)
            tp_check(arch, r, label)
            r["seconds"] = time.perf_counter() - t0
            res[label] = r
    res["gpipe"] = gpipe_case(torch, mesh, lead)
    res["momentless"] = momentless_case(torch, mesh, lead)
    t0 = time.perf_counter()
    res["shards"] = shard_cases(torch, mesh, lead, keep, Path(rdv).parent)
    res["shard_optimizers"] = shard_optimizers(torch, mesh, lead, Path(rdv).parent)
    res["shards_seconds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["decode"] = decode_cases(torch, mesh, lead, smi)
    res["decode_seconds"] = time.perf_counter() - t0
    res["seconds"] = time.perf_counter() - t_start
    out.put((rank, res))
    mesh.barrier()


def tp_phase(torch, smi, rate, dry: dict, ranks=None):
    """Phases 6f-6l: the 4 ranks of a (data=2, model=2) mesh on this card
    (``ranks``, phase 6's, which ``mesh_rank`` takes on to these phases;
    else spawned here for 6f-6l alone) for the forward's tensor-, sequence-
    and expert-parallel regions, GPipe, moment-less SlimAdam,
    parameter-shard storage and the decode step; after they exit, olmoe's
    6k references on the whole card, the dry run held to 6k's and 6l's
    steps; then B15 and its backward at a rank's channel shard and B15's
    one-token form at a decode rank's. Returns (report, launches summed over
    rank 0's counted runs)."""
    import shutil

    cut = ", ".join(f"{arch} ({TP_CASES[arch][0] or 'all'} layers; {', '.join(TP_DTYPES[arch])})"
                    for arch in TP_CASES)
    log(f"[6f] the forward on the mesh: {cut} at full width, {SHARD_RANKS} ranks sharing this card "
        f"({smi}); GPipe; moment-less SlimAdam")
    if ranks is None:
        torch.cuda.empty_cache()
        ranks = start_ranks(ROOT / "build" / "chip_smoke_tp", tp_rank, rate, smi)
    work, t0 = ranks["work"], ranks["mark"]
    try:
        results = collect_ranks(ranks["procs"], ranks["out"], "the ranks of phase 6f")
        end_ranks(ranks)
    finally:
        kill_ranks(ranks)
    spawn_s = time.perf_counter() - t0
    r0 = results[0]
    t0 = time.perf_counter()
    shards = shard_summary(torch, results, work, smi)
    recs = dryrun_records(dry, "6k")
    shards["dryrun"] = hold_dryrun(results, {k: v for k, v in recs.items() if not k.startswith("decode ")}, smi)
    decode = decode_summary(results, recs, smi)
    log(f"[6l] decode on the mesh: {r0['decode_seconds']:.1f} s on the ranks")
    for r in range(1, SHARD_RANKS):
        losses = lambda res: {k: (v["losses"], v.get("resumed")) for k, v in res["shard_optimizers"].items()}  # noqa
        if losses(results[r]) != losses(r0):
            raise AssertionError(f"6k: rank {r} reports other losses for the other optimizers than rank 0")
    shards["optimizers"] = r0["shard_optimizers"]
    shutil.rmtree(work, ignore_errors=True)
    log(f"[6k] parameter-shard storage: {r0['shards_seconds']:.1f} s on the ranks, the references after them "
        f"{time.perf_counter() - t0:.1f} s")
    cases = [k for k in r0 if k not in ("gpipe", "momentless", "seconds", "shards", "shard_optimizers",
                                        "shards_seconds", "decode", "decode_seconds")]
    for r in range(1, SHARD_RANKS):
        for case in cases:
            for optimizer in r0[case]["optimizers"]:
                if results[r][case][optimizer]["losses"] != r0[case][optimizer]["losses"]:
                    raise AssertionError(f"rank {r} reports other {case} {optimizer} losses than rank 0")
    summary = {"cases": {}, "gpipe": r0["gpipe"], "momentless": r0["momentless"], "spawn_s": spawn_s,
               "shards": shards, "decode": decode}
    for case in cases:
        c = r0[case]
        row = dict(reference=c["reference"], layers=c["layers"], table3_regimes=c.get("table3_regimes"),
                   seconds=c["seconds"], peak_gib_by_rank=[results[r][case]["ranks_peak_gib"] for r in results])
        for optimizer in c["optimizers"]:
            row[optimizer] = {k: v for k, v in c[optimizer].items() if k != "profile"}
            if "profile" in c[optimizer]:
                prof = c[optimizer]["profile"]
                row[optimizer]["busy_share_by_rank"] = [results[r][case][optimizer]["profile"]["busy_ms"]
                                                        / results[r][case][optimizer]["profile"]["wall_ms"]
                                                        for r in results]
                row[optimizer]["top_kernels"] = prof["kernels"][:10]
                coll = ", ".join(f"{k} {v['calls']} calls {v['seconds'] * 1e3:.1f} ms"
                                 for k, v in c[optimizer]["collectives"].items())
                log(f"[6h] {case} sharded step ({smi}): {[round(x, 1) for x in c[optimizer]['step_ms']]} ms; busy "
                    f"share by rank {[round(x, 3) for x in row[optimizer]['busy_share_by_rank']]}; the regions' "
                    f"collectives {coll} (timed step, synchronized); one gradient bucket's all-reduce "
                    f"{c[optimizer]['bucket_allreduce_ms']:.1f} ms x {c[optimizer]['buckets']} buckets; peak by rank "
                    f"{[round(x, 2) for x in row['peak_gib_by_rank']]} GiB")
        summary["cases"][case] = row
    launches: dict = {}
    for case in cases:
        for optimizer in r0[case]["optimizers"]:
            for k, v in r0[case][optimizer]["launches"].items():
                launches[k] = launches.get(k, 0) + v
    for run in list(r0["shards"].values()) + [v for k, v in r0["decode"].items() if k != "long"]:
        for k, v in run["launches"].items():
            launches[k] = launches.get(k, 0) + v
    summary["scan_shard"] = scan_shard_timings(torch, rate, smi)
    summary["scan_token_shard"] = scan_token_shard(torch, rate, smi)
    log(f"[6f-6l] ranks {spawn_s:.1f} s (rank 0 {r0['seconds']:.1f} s)")
    return summary, launches


# -- 6m. the launcher on a mesh ------------------------------------------------------

# The harness's meshes with the production meshes' axes: ``main``'s
# ``make_production_mesh`` builds (data=16, model=16) or (pod=2, data=16,
# model=16), 256 or 512 ranks; in 6m's rank processes it builds these, the
# ranks sharing this card over gloo.
LAUNCH_MESHES = {"multi": ((2, 2, 2), ("pod", "data", "model")), "single": ((2, 2), ("data", "model"))}
LAUNCH_STEPS, LAUNCH_RESUME = 4, 2   # the multi job's steps; the single job resumes from this step's checkpoint
LAUNCH_SEQ, LAUNCH_BATCH, LAUNCH_LR = 128, 8, 3e-4   # the launcher's defaults, what 6m's argv leaves to them
LAUNCH_TIMEOUT_S = 300
LAUNCH_PEAK_BAND = DECODE_PEAK_BAND   # the dry run's peak over each rank's measured one (6l e)


def launch_argv(mesh_kind: str, ckpt) -> list:
    """The command line of 6m's jobs: ``python -m repro_torch.launch.train``'s
    flags, every other one left at its default (``--seq 128 --batch 8
    --optimizer slim --backend auto --lr 3e-4``, the full config)."""
    return ["--arch", "gpt_small", "--mesh", mesh_kind, "--steps", str(LAUNCH_STEPS), "--ckpt", str(ckpt),
            "--log-every", "1"]


def launch_rank(rank, world, port, out, mesh_kind, ckpt):
    """One rank of a 6m job, as torchrun starts it: ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT`` and ``OMP_NUM_THREADS=1``
    in the environment,
    then ``repro_torch.launch.train.main(argv)`` unchanged, with
    ``launch.mesh.make_production_mesh`` replaced by LAUNCH_MESHES' mesh of
    the same axes. What ``main`` prints is kept (the parent checks that only
    rank 0 logs); from ``train``'s call: each step's metrics and host ms
    (synchronised), the mesh, this rank's bytes of p, g (the optimizer's
    first gradient shards), m and v against ``reckon_bytes``; the job's
    first step's collectives and launches (the dry run counts a step from
    the state the job starts with), its last step's, that step profiled;
    each step's peak over what it started with (the held shards counted
    once) and what it left allocated; the kernel launches of the whole job
    (counts zeroed before ``main``); the seconds to the loop, in the steps
    and in the checkpoints between them."""
    import contextlib
    import io

    t_start = time.perf_counter()
    # torchrun's environment for a rank, OMP_NUM_THREADS=1 included (its default with several ranks a host)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port), OMP_NUM_THREADS="1")
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import kernels
    from repro_torch.checkpoint import store
    from repro_torch.launch import mesh as launch_mesh, train as launch
    from repro_torch.optim.base import GradientTransformation

    launch_mesh.make_production_mesh = lambda *, multi_pod=False, **kw: launch_mesh.make_mesh(
        *LAUNCH_MESHES["multi" if multi_pod else "single"], **kw)
    argv = launch_argv(mesh_kind, ckpt)
    backend = argv[argv.index("--backend") + 1] if "--backend" in argv else "auto"
    seen: dict = {"step_ms": [], "peaks": [], "kept": []}
    real_make_step, real_train = launch.make_train_step, launch.train

    def make_train_step(model, tx, **kw):
        def update(grads, opt_state, params=None):
            seen.setdefault("grad_bytes", sum(g.numel() * g.element_size() for g in grads.values()))
            return tx.update(grads, opt_state, params)

        return real_make_step(model, GradientTransformation(tx.init, update), **kw)

    def train(run, data, steps, *, start=0, **kw):
        mesh = run.mesh
        seen.update(run=run, start=start, held=run.persistent_bytes(), transport=mesh.transport_note(),
                    reckoned=launch.reckon_bytes(run.model.cfg, "slim", LAUNCH_LR, mesh, backend=backend),
                    to_loop_s=time.perf_counter() - t_start)
        step, at = run.step, [start]

        def counted(fn):
            """fn()'s collectives (calls and bytes by kind) and launches."""
            mesh.collective_stats(reset=True)
            before = kernels.launch_counts()
            out = fn()
            stats = mesh.collective_stats(reset=True)
            return out, {"collectives": {k: {"calls": int(v["calls"]), "bytes": int(v["bytes"])}
                                         for k, v in stats.items()},
                         "launches": {n: c - before[n] for n, c in kernels.launch_counts().items() if c != before[n]}}

        def measured(opt_state, batch):
            at[0] += 1
            torch.cuda.synchronize()
            held = run.persistent_bytes()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            if at[0] == steps:
                # the last step: its collectives and launches, profiled
                box = []
                with contextlib.redirect_stdout(io.StringIO()):
                    prof, seen["last"] = counted(lambda: profile_device(
                        torch, lambda: box.append(step(opt_state, batch)), 1,
                        statistics.median(seen["step_ms"]), "step"))
                seen["last"].update(busy_ms=prof["busy_ms"], top_kernels=prof["kernels"][:8])
                new = box[0]
            else:
                t0 = time.perf_counter()
                new, counts = counted(lambda: step(opt_state, batch))
                torch.cuda.synchronize()
                seen["step_ms"].append((time.perf_counter() - t0) * 1e3)
                if at[0] == start + 1:
                    # the job's first step, as the dry run counts one from this state
                    seen["first"] = dict(counts, bytes=held)
            # the step's peak over what it started with, the held shards counted once; and what it
            # left allocated beyond them (the first step's one-time buffers: cuBLAS's workspace, ...)
            seen["peaks"].append(sum(held.values()) + torch.cuda.max_memory_allocated() - base)
            seen["kept"].append(torch.cuda.memory_allocated() - base)
            return new

        t0 = time.perf_counter()
        rows, opt_state = real_train(run._replace(step=measured), data, steps, start=start, **kw)
        seen.update(rows=rows, train_s=time.perf_counter() - t0)
        return rows, opt_state

    launch.make_train_step, launch.train = make_train_step, train
    printed = io.StringIO()
    kernels.reset_launch_counts()
    with contextlib.redirect_stdout(printed):
        launch.main(argv)
    launches = {k: v for k, v in kernels.launch_counts().items() if v}
    run = seen["run"]
    state = dict(store.named_leaves(run.state()))
    moment = lambda part: sum(t.numel() * t.element_size() for k, t in state.items()   # noqa: E731
                              if k.startswith("opt.") and f".{part}." in f".{k}.")
    res = {"rank": rank, "coords": dict(run.mesh.coords), "mesh": dict(run.mesh.shape), "start": seen["start"],
           "rows": seen["rows"], "printed": printed.getvalue(), "transport": seen["transport"],
           "seconds": {"to_loop": seen["to_loop_s"], "loop": seen["train_s"],
                       "main": time.perf_counter() - t_start},
           "bytes": {"params": seen["held"]["params"], "grads": seen.get("grad_bytes"), "mu": moment("mu"),
                     "nu": moment("nu"), "opt": seen["held"]["opt"]},
           "reckoned": seen["reckoned"], "step_ms": seen["step_ms"], "first": seen["first"], "last": seen["last"],
           "peaks": seen["peaks"], "kept": seen["kept"], "launches": launches}
    import torch.distributed as dist

    dist.barrier()
    out.put((rank, res))
    dist.destroy_process_group()


def launch_job(mesh_kind: str, ckpt) -> dict:
    """One 6m job: a fresh process a rank of LAUNCH_MESHES[mesh_kind], all
    sharing this card, collected as ``collect_ranks`` collects 6f's."""
    import multiprocessing as mp
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    world = math.prod(LAUNCH_MESHES[mesh_kind][0])
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=run_rank, args=(launch_rank, r, world, port, out, mesh_kind, str(ckpt)))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        results = collect_ranks(procs, out, f"the ranks of 6m's {mesh_kind} job", deadline_s=LAUNCH_TIMEOUT_S)
        for p in procs:
            p.join(timeout=60)
        if any(p.exitcode != 0 for p in procs):
            raise RuntimeError(f"6m {mesh_kind}: rank exit codes {[p.exitcode for p in procs]}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
    return results


def dryrun_6m(path: Path, mesh_kind: str) -> int:
    """6m's dry run, in a process of its own (one fake group a process):
    ``repro_torch.launch.dryrun`` of the launcher's step (full gpt_small,
    Table-3 SlimAdam on the fused route, 8 x 128, grad_accum 1) as rank 0
    of ``mesh_kind``'s LAUNCH_MESHES mesh on ``meta``; the record goes to
    ``path`` as JSON. Needs no GPU and touches none."""
    import torch

    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun

    shape, axes = LAUNCH_MESHES[mesh_kind]
    rec = dryrun.run_cell("gpt_small", "train_4k", "x".join(map(str, shape)), optimizer="slim", backend="fused",
                          grad_accum=1, out_dir=None, mesh=dryrun.make_meta_mesh(shape, axes),
                          cfg=get_config("gpt_small"), seq=LAUNCH_SEQ, global_batch=LAUNCH_BATCH)
    path.write_text(json.dumps(rec, default=str))
    return 0


def launch_check(mesh_kind: str, results: dict, rec: dict, start: int, smi: str) -> dict:
    """6m's checks of one job, logged first and then each a failure that
    ends the run: every rank ran ``main`` on LAUNCH_MESHES' mesh from step
    ``start``, only rank 0 printed (a line a step), every rank the same
    losses; every rank's bytes of p, g, m and v equal ``reckon_bytes`` (g
    the parameters'); the dry run on ``meta`` equals every rank's first and
    last step in collectives and launches and its bytes, its peak within
    LAUNCH_PEAK_BAND of the second step's (each step's peak over what it
    started with; the first also allocates one-time buffers); every kernel
    the dry run predicts
    launched on every rank, B12 and B13 among them (the plan's psum
    groups)."""
    shape, axes = LAUNCH_MESHES[mesh_kind]
    want_mesh = dict(zip(axes, shape))
    ranks = [res for _, res in sorted(results.items())]
    r0 = ranks[0]
    losses = [row["loss"] for row in r0["rows"]]
    fails = [] if all(map(math.isfinite, losses)) else [f"losses {losses}"]
    want = {"collectives": rec["collectives"], "launches": rec["launches"]}
    # the job's second step: its first allocates one-time buffers beside the step's tensors
    # (cuBLAS's workspace and the like), which no dry run counts; reported beside it
    ratios = [rec["peak_bytes"] / res["peaks"][1] for res in ranks]
    first_ratios = [rec["peak_bytes"] / res["peaks"][0] for res in ranks]
    for r, res in enumerate(ranks):
        if res["mesh"] != want_mesh or res["start"] != start:
            fails.append(f"rank {r}: mesh {res['mesh']} from step {res['start']}")
        if [row["loss"] for row in res["rows"]] != losses:
            fails.append(f"rank {r}: losses {[row['loss'] for row in res['rows']]}, rank 0's {losses}")
        if r and res["printed"]:
            fails.append(f"rank {r} printed {res['printed'].splitlines()[:3]}")
        b, reckoned = res["bytes"], res["reckoned"]
        if (b["params"], b["grads"], b["opt"]) != (reckoned["params"], reckoned["params"], reckoned["opt"]):
            fails.append(f"rank {r}: bytes {b}, reckoned {reckoned}")
        if res["first"]["bytes"] != rec["persistent_bytes"]:
            fails.append(f"rank {r}: the dry run's bytes {rec['persistent_bytes']}, the card's "
                         f"{res['first']['bytes']}")
        for which in ("first", "last"):
            for what, value in want.items():
                if res[which][what] != value:
                    fails.append(f"rank {r}: the dry run's {what} {value}, the card's {which} step's "
                                 f"{res[which][what]}")
        if not LAUNCH_PEAK_BAND[0] <= ratios[r] <= LAUNCH_PEAK_BAND[1]:
            fails.append(f"rank {r}: the dry run's peak {rec['peak_bytes']} is {ratios[r]:.4f}x the card's second "
                         f"step's {res['peaks'][1]}, outside {LAUNCH_PEAK_BAND}")
        missing = sorted(k for k in set(rec["launches"]) | {"mega_slim_partial_stats_batched",
                                                            "mega_slim_finalize_batched"} if not res["launches"].get(k))
        if missing:
            fails.append(f"rank {r}: no launch of {missing} (launches {res['launches']})")
    steps = [f"step {s}:" for s in range(start + 1, LAUNCH_STEPS + 1)]
    if [ln.split(" loss")[0] for ln in r0["printed"].splitlines() if " loss " in ln] != steps:
        fails.append(f"rank 0 printed {r0['printed'].splitlines()}")
    for ln in r0["printed"].splitlines():
        log(f"  [6m {mesh_kind}] rank 0: {ln}")
    busy = [res["last"]["busy_ms"] / statistics.median(res["step_ms"]) for res in ranks]
    coll = r0["last"]["collectives"]
    seconds = {k: [round(res["seconds"][k], 1) for res in ranks] for k in r0["seconds"]}
    log(f"[6m] {mesh_kind} {want_mesh}: {r0['transport']} ({smi}; gloo on one card, not a multi-GPU number): steps "
        f"{[round(x, 1) for x in r0['step_ms']]} ms on rank 0's host clock (synchronised; the job's first step "
        f"first, the last step profiled and not among them), median by rank "
        f"{[round(statistics.median(res['step_ms']), 1) for res in ranks]} ms; busy share by rank "
        f"{[round(x, 4) for x in busy]}; a step's collectives "
        + ", ".join(f"{k} {v['calls']} calls {v['bytes']:,} B" for k, v in coll.items())
        + f"; seconds by rank {seconds} (to the loop: start, mesh, build, resume; the loop: steps and checkpoints)"
        f"; bytes a rank p {r0['bytes']['params']:,} g {r0['bytes']['grads']:,} m {r0['bytes']['mu']:,} v "
        f"{r0['bytes']['nu']:,} (reckoned {r0['reckoned']}); dry run: bytes {rec['persistent_bytes']}, launches "
        f"{rec['launches']}, peak {rec['peak_bytes'] / 2**30:.4f} GiB, ratio to each rank's second step "
        f"{[round(x, 4) for x in ratios]} (to its first {[round(x, 4) for x in first_ratios]}); rank 0's peaks by "
        f"step {r0['peaks']} B, left allocated by each step {r0['kept']} B; launches of the job on rank 0 "
        f"{r0['launches']}")
    if fails:
        raise AssertionError(f"6m {mesh_kind}: " + "; ".join(fails[:6]))
    return dict(losses=losses, step_ms_by_rank=[res["step_ms"] for res in ranks], busy_share_by_rank=busy,
                collectives=coll, bytes=r0["bytes"], peak_ratios=ratios, first_step_peak_ratios=first_ratios,
                peak_bytes_by_rank=[res["peaks"] for res in ranks], kept_bytes_rank0=r0["kept"], launches=r0["launches"],
                seconds_by_rank=seconds, top_kernels=r0["last"]["top_kernels"])


def launch_phase(torch, smi: str, dry: dict):
    """6m: ``python -m repro_torch.launch.train --mesh multi`` then
    ``--mesh single``, each rank a fresh process sharing this card. 8 ranks
    of (pod=2, data=2, model=2) run ``main`` on full-width, full-depth
    gpt_small for LAUNCH_STEPS steps with a checkpoint every step; 4 fresh
    ranks of (data=2, model=2) resume from its step-LAUNCH_RESUME checkpoint
    (the other steps' taken out of a copy of the directory) to step
    LAUNCH_STEPS: a checkpoint written on one mesh restored onto another.
    The dry run of each mesh's step on ``meta`` comes from ``dry``
    (:func:`start_dryruns`). After
    the ranks, the unsharded port on the whole card from the same weights
    (``Trainer``, a CPU generator seeded 0, as ``build`` draws them), once as
    one batch and once as 2 micro-batches. The losses of both jobs within
    max(1e-4, twice that 2-micro-batch gap) (6g's bf16 bar, relative) of the
    unsharded run's, steps 3-4 after the resume within the same bar of the
    uninterrupted multi job's. Returns (report, launches summed over rank
    0's jobs)."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, ZipfLM
    from repro_torch.train import Trainer, TrainerConfig

    work = ROOT / "build" / "chip_smoke_launch"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    torch.cuda.empty_cache()
    t_start = time.perf_counter()
    log(f"[6m] python -m repro_torch.launch.train {' '.join(launch_argv('multi', 'DIR'))}: 8 fresh ranks of "
        f"{dict(zip(*LAUNCH_MESHES['multi'][::-1]))} sharing this card ({smi})")
    t0 = time.perf_counter()
    multi = launch_job("multi", work / "multi")
    job_s = {"multi": time.perf_counter() - t0}
    # the single job starts from the multi job's step-LAUNCH_RESUME checkpoint alone
    src = work / "multi" / f"step_{LAUNCH_RESUME:08d}"
    shutil.copytree(src, work / "single" / src.name)
    (work / "single" / "LATEST").write_text(src.name)
    log(f"[6m] --mesh single: 4 fresh ranks resume the multi job's step-{LAUNCH_RESUME} checkpoint")
    t0 = time.perf_counter()
    single = launch_job("single", work / "single")
    job_s["single"] = time.perf_counter() - t0
    log(f"[6m] the jobs' wall time, spawn to exit: {', '.join(f'{k} {v:.1f} s' for k, v in job_s.items())}")
    recs = {kind: dryrun_records(dry, kind) for kind in LAUNCH_MESHES}
    ranks_s = time.perf_counter() - t_start
    report = {"multi": launch_check("multi", multi, recs["multi"], 0, smi),
              "single": launch_check("single", single, recs["single"], LAUNCH_RESUME, smi)}
    # the unsharded port on the whole card, the same weights and batches
    t0 = time.perf_counter()
    cfg = get_config("gpt_small")
    data = ZipfLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=LAUNCH_SEQ, global_batch=LAUNCH_BATCH))
    ref = {}
    for accum in (1, 2):
        tr = Trainer(cfg, "slim", LAUNCH_LR, data, TrainerConfig(total_steps=LAUNCH_STEPS, log_every=1,
                                                                 backend="fused"), grad_accum=accum)
        tr.run()
        ref[accum] = [m["loss"] for m in tr.metrics_log]
        del tr
        torch.cuda.empty_cache()

    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    gap = rel(ref[2], ref[1])
    tol = max(TOL_SHARDED_LOSS, 2 * gap)
    got, resumed = report["multi"]["losses"], report["single"]["losses"]
    errs = {"multi": rel(got, ref[1]), "single": rel(resumed, ref[1][LAUNCH_RESUME:]),
            "resume": rel(resumed, got[LAUNCH_RESUME:])}
    log(f"[6m] losses: multi {got}, single from step {LAUNCH_RESUME} {resumed}; unsharded port on the whole card "
        f"{ref[1]}, as 2 micro-batches {ref[2]} (gap {gap:.3e}); rel diff multi {errs['multi']:.3e}, single "
        f"{errs['single']:.3e}, resumed against the uninterrupted multi job {errs['resume']:.3e} (tol max("
        f"{TOL_SHARDED_LOSS:.0e}, 2 x gap) = {tol:.3e})")
    bad = {k: v for k, v in errs.items() if v > tol}
    if bad:
        raise AssertionError(f"6m: losses outside the bar {tol:.3e}: {bad}")
    shutil.rmtree(work, ignore_errors=True)
    report.update(reference=ref, gap=gap, tol=tol, errs=errs, ranks_s=ranks_s, job_s=job_s,
                  reference_s=time.perf_counter() - t0, dryrun={k: dict(peak_bytes=v["peak_bytes"],
                                                                        step_s=v["step_s"]) for k, v in recs.items()})
    log(f"[6m] the launcher on a mesh: ranks {ranks_s:.1f} s (a rank's main: multi "
        f"{max(report['multi']['seconds_by_rank']['main']):.1f} s, single "
        f"{max(report['single']['seconds_by_rank']['main']):.1f} s), the unsharded references "
        f"{report['reference_s']:.1f} s")
    launches: dict = {}
    for kind in ("multi", "single"):
        for k, v in report[kind]["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return report, launches


def scan_shard_timings(torch, rate: float, smi: str) -> dict:
    """B15's training form (keeping its tile states) and ``ssm_scan_bwd`` at
    a tensor-parallel rank's shape on falcon_mamba_7b's case: 1 row x 2048
    steps x 4096 channels (d_inner / 2), N 16, bf16, against their twins,
    timed beside their bounds."""
    from repro_torch.kernels import ssm_scan as sc

    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(11)
    b, s, d, n = 1, 2048, 8192 // 2, 16
    args = scan_case(torch, gen, b, s, d, n, torch.bfloat16)
    dy = torch.randn((b, s, d), generator=gen, device="cuda").to(torch.bfloat16)
    y, h, states = sc.ssm_scan(*args, keep_bounds=True)
    y_want, h_want = sc.ssm_scan_plain(*args)
    err_f = max(check("B15 shard y", y, y_want, TOL_LINE), check("B15 shard h", h, h_want, TOL_LINE))
    got = sc.ssm_scan_bwd(*args, dy, None, states=states)
    want = sc.ssm_scan_bwd_plain(*args, dy, None)
    err_b = max(check(f"bwd shard {name}", g, w, TOL_SSM_BWD_DX_BF16 if g.dtype == torch.bfloat16 else TOL_SSM_BWD)
                for name, g, w in zip(("dx", "ddt", "da", "db", "dc", "dd_skip", "dh0"), got, want))
    fwd_ms = timer(lambda: sc.ssm_scan(*args, keep_bounds=True), reps=10)
    bwd_ms = timer(lambda: sc.ssm_scan_bwd(*args, dy, None, states=states), reps=10)
    fwd_plain = timer(lambda: sc.ssm_scan_plain(*args), reps=1)
    bwd_plain = timer(lambda: sc.ssm_scan_bwd_plain(*args, dy, None), reps=1)
    fwd_bound, fwd_by = scan_bound(args, rate)
    bwd_bound, bwd_by = scan_bwd_bound(args, dy, None, got, rate)
    log(f"[6f] at a rank's channel shard (1 x {s} x {d}, N {n}, bf16; {smi}): B15's training form {fwd_ms:.4f} ms "
        f"(plain {fwd_plain:.4f}, bound {fwd_bound:.4f} {fwd_by}); ssm_scan_bwd {bwd_ms:.4f} ms (plain "
        f"{bwd_plain:.4f}, bound {bwd_bound:.4f} {bwd_by}); errors {err_f:.3e} / {err_b:.3e}")
    del args, dy, y, h, states, got, want, timer
    torch.cuda.empty_cache()
    return dict(shape=[b, s, d, n], fwd_ms=fwd_ms, fwd_plain_ms=fwd_plain, fwd_bound_ms=fwd_bound, fwd_err=err_f,
                bwd_ms=bwd_ms, bwd_plain_ms=bwd_plain, bwd_bound_ms=bwd_bound, bwd_err=err_b)


def scan_token_shard(torch, rate: float, smi: str) -> dict:
    """6l (d): B15's one-token form at a decode rank's channels on
    falcon_mamba_7b (2 rows, S = 1, 4096 of 8192 channels, N 16, f32, a
    random h0) against its plain twin, twice bit for bit, timed beside its
    bound."""
    from repro_torch.kernels import ssm_scan as sc

    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(12)
    b, s, d, n = DECODE_ROWS // 2, 1, 8192 // 2, 16
    plan = sc.plan_scan(b, s, d, n, sms=torch.cuda.get_device_properties(0).multi_processor_count)
    args = scan_case(torch, gen, b, s, d, n, torch.float32)
    y, h = sc.ssm_scan(*args)
    y2, h2 = sc.ssm_scan(*args)
    same_tensors("B15 one-token shard", {"y": y, "h": h}, {"y": y2, "h": h2})
    y_want, h_want = sc.ssm_scan_plain(*args)
    err = max(check("B15 one-token shard y", y, y_want, TOL_LINE), check("B15 one-token shard h", h, h_want, TOL_LINE))
    ms = timer(lambda: sc.ssm_scan(*args), reps=20)
    plain = timer(lambda: sc.ssm_scan_plain(*args), reps=5)
    bound, by = scan_bound(args, rate)
    log(f"[6l d] B15 at a decode rank's channels ({b} x {s} x {d}, N {n}, f32; {smi}): {scan_form(plan)}, "
        f"{ms:.4f} ms (plain {plain:.4f}, bound {bound:.4f} {by}); error {err:.3e}")
    del args, y, h, y2, h2, y_want, h_want, timer
    torch.cuda.empty_cache()
    return dict(shape=[b, s, d, n], form=scan_form(plan), ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                err=err)


# -- the SSM serving path (phase 7) and the parameter-writing API (phase 8) -----------

# The SFUs evaluate exponentials: 16 per SM per clock on compute capability
# 9.0 (CUDA C++ Programming Guide, arithmetic instruction throughput), 132 SMs
# at the 1.98 GHz boost clock of the H100 SXM.
SFU_RATE = 132 * 16 * 1.98e9
TOL_SSM_LOGITS = 5e-2    # full-width logits, kernel against plain scan: bf16 activations through 4 Mamba layers
TOL_BF16_PARAM = 2.0**-8  # a bf16 p' may round one bf16 step apart where the f32 value straddles a boundary
# Phase 7 geometry: the eval batch, and the served prompts.
SSM_EVAL_SEQ, SSM_ROWS, SSM_PROMPT, SSM_NEW = 2048, 4, 64, 32


def scan_forms(sc, since=None) -> dict:
    """B15's calls by form (``ssm_scan.form_launches``: the one-token form,
    the sequence walk, the sequence walk that keeps its tile states), less
    ``since``'s."""
    now = dict(sc.ssm_scan.form_launches)
    return {k: v - (since or {}).get(k, 0) for k, v in now.items()}


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
    """Least time (ms) for one selective scan, and what sets it, from the
    inputs alone: the bytes (x, dt, B, C, a, d_skip, h0 read once; y and
    h_final written once) over the memory rate; its exponentials (one per
    timestep, channel and state) over the SFU rate; its other f32
    operations (6 per timestep, channel and state: dt*a, decay*h, dx*B,
    their sum, h*C, the sum of y) over the f32 rate."""
    x, dt, a, b_t, c_t, d_skip, h0 = args
    b, s, d = x.shape
    n = a.shape[1]
    nbytes = sum(t.numel() * t.element_size() for t in args) + 4 * (b * s * d + b * d * n)
    times = {"bytes": nbytes / rate, "operations": b * s * d * n / SFU_RATE}
    t_f32 = 6 * b * s * d * n / F32_RATE
    by = max(times, key=times.get)
    return max(times[by], t_f32) * 1e3, by


def scan_design_bound(args, rate: float, sms: int) -> float:
    """Least time (ms) of B15's design, which does more work than the
    function needs: :func:`scan_bound` with the carry walk's second pass
    over chunks 0..K-2 of the sequence form's plan (its exponentials, and 4
    f32 operations per timestep, channel and state) added. Reported beside
    the bound, never as it."""
    from repro_torch.kernels import ssm_scan as sc

    x, a = args[0], args[2]
    b, s, d = x.shape
    n = a.shape[1]
    plan = sc.plan_scan(b, s, d, n, sms=sms)
    carry = plan.steps(plan.chunks - 1)[0] if plan.form == sc.FORM_SEQ else 0
    bound, _ = scan_bound(args, rate)
    return max(bound, b * (s + carry) * d * n / SFU_RATE * 1e3, (6 * s + 4 * carry) * b * d * n / F32_RATE * 1e3)


def scan_form(plan) -> str:
    """A plan of B15 in words."""
    from repro_torch.kernels import ssm_scan as sc

    if plan.form == sc.FORM_TOKEN:
        return f"one-token form, {plan.out_grid[0]} x {plan.out_grid[1]} blocks"
    return (f"sequence form, {plan.chunks} chunks of {plan.chunk} steps, carry walk {plan.walk_grid}, "
            f"carry {plan.carry_blocks} blocks, output walk {plan.out_grid}")


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
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for case, (b, s) in (("eval", (1, SSM_EVAL_SEQ)), ("decode", (SSM_ROWS, 1))):
        args = scan_case(torch, gen, b, s, scfg.d_inner, scfg.d_state, torch.bfloat16)
        plan = sc.plan_scan(b, s, scfg.d_inner, scfg.d_state, sms=sms)
        (y, h), (y2, h2), (y_w, h_w) = sc.ssm_scan(*args), sc.ssm_scan(*args), sc.ssm_scan_plain(*args)
        torch.cuda.synchronize()
        errs = [check(f"{case} {what}", got, want, TOL_LINE) for what, got, want in (("y", y, y_w), ("h", h, h_w))]
        if not (torch.equal(y, y2) and torch.equal(h, h2)):
            raise AssertionError(f"ssm_scan {case}: two runs on one input differ")
        ms = timer(lambda: sc.ssm_scan(*args), reps=20)
        plain_ms = timer(lambda: sc.ssm_scan_plain(*args), reps=3)
        bound, by = scan_bound(args, rate)
        design = scan_design_bound(args, rate, sms)
        log(f"  {case} (B={b}, S={s}, D={scfg.d_inner}, N={scfg.d_state}): {scan_form(plan)}; two runs bit-equal")
        log(f"    kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound:.4f} ms ({by}, "
            f"{bound / ms:.1%} reached)  this design's least {design:.4f} ms ({design / ms:.1%} reached)  "
            f"library: none (no PyTorch call computes a selective scan)")
        held[case] = dict(err_y=errs[0], err_h=errs[1], ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                          design_bound_ms=design, form=scan_form(plan))
        del args, y, h, y2, h2, y_w, h_w
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
    forms = scan_forms(sc)
    t0 = time.perf_counter()
    loss = float(eval_step(batch)["loss"])
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_counts = kernels.launch_counts()
    forms = scan_forms(sc, since=forms)
    log(f"  make_eval_step on 1 x {SSM_EVAL_SEQ}: loss {loss:.4f} in {eval_s * 1e3:.1f} ms, launches "
        f"{ {k: v for k, v in eval_counts.items() if v} }, B15 forms {forms}")
    if not math.isfinite(loss):
        raise AssertionError(f"falcon_mamba_7b eval loss is not finite: {loss}")
    if eval_counts["ssm_scan"] != cfg.n_layers or sum(eval_counts.values()) != cfg.n_layers:
        raise AssertionError(f"eval launches {eval_counts}, expected ssm_scan {cfg.n_layers} and no other kernel")
    if forms != {"token": 0, "seq": cfg.n_layers, "seq_keep": 0}:
        raise AssertionError(f"eval B15 forms {forms}: the forward without a gradient keeps no tile states")
    prof = profile_device(torch, lambda: eval_step(batch), 1, eval_s * 1e3, "eval forward")
    scan_ms = sum(t for key, t in prof["kernels"] if key.startswith("ssm_") or "::ssm_" in key)
    log(f"  B15 in the eval forward: {scan_ms:.3f} ms of {prof['busy_ms']:.3f} ms device time "
        f"({scan_ms / prof['busy_ms']:.1%})")
    report["eval"] = dict(loss=loss, ms=eval_s * 1e3, launches=eval_counts, profile=prof, scan_ms=scan_ms)

    # -- 7d. the legacy serving loop -------------------------------------------
    prompts = ZipfLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=SSM_PROMPT, global_batch=SSM_ROWS,
                                seed=1)).batch(0)["tokens"]
    eng = Engine(cfg, model.params, ServeConfig(max_seq=2 * SSM_PROMPT, max_new_tokens=SSM_NEW))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    forms = scan_forms(sc)
    t0 = time.perf_counter()
    out = eng.generate(prompts)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen_counts = kernels.launch_counts()
    forms = scan_forms(sc, since=forms)
    steps = SSM_PROMPT + SSM_NEW - 1
    log(f"  Engine.generate: {SSM_ROWS} prompts x {SSM_PROMPT} tokens + {SSM_NEW} greedy in {gen_s:.2f} s, "
        f"{eng.decode_steps} decode steps, launches {({k: v for k, v in gen_counts.items() if v})}, B15 forms "
        f"{forms}")
    if forms != {"token": cfg.n_layers * steps, "seq": 0, "seq_keep": 0}:
        raise AssertionError(f"generate B15 forms {forms}: decode steps take the one-token form, no tile store")
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


SSM_TRAIN_ROWS, SSM_TRAIN_LAYERS, SSM_TRAIN_STEPS, SSM_GRAD_LAYERS = 2, 4, 4, 2
TOL_SSM_BWD = 1e-5        # ssm_scan_bwd against its twin: exp2 replay, warp-butterfly and in-order sums differ
TOL_SSM_BWD_DX_BF16 = TOL_SSM_BWD + 2.0**-8  # dx stored in bf16 (x's dtype): plus the rounding of that store
TOL_SSM_GRADS_F32 = 1e-3  # 2-layer full-width gradients, kernel against plain scan, f32 activations
TOL_SSM_GRADS_BF16 = 5e-2  # the same with the path's bf16 activations (bf16 rounding flips, as TOL_SSM_LOGITS)


def scan_bwd_bound(args, dy, dh_final, grads, rate: float):
    """Least time (ms) for one selective-scan backward, and what sets it:
    the bytes (every operand read once, every gradient written once, in
    their dtypes; of the forward's state only h0, which ``args`` holds: the
    tile states B15 keeps are this design's, not the function's) over the
    memory rate, or its operations: one exponential
    per (row, step, channel, state), A_t = exp(dt a), which the replay and
    the reverse recurrence share, over the SFU rate, and 18 f32 operations
    per (row, step, channel, state) over the f32 rate, counted as
    :func:`scan_bound` counts (a multiply-add is two): 4 to replay (dt*a,
    A*h, u*B, their sum), 14 in the reverse step (dy*C + carry, carry =
    A*dh, dlogA = carry*h, and the multiply-adds of the sums of dh*B,
    dlogA*a, dlogA*dt, dh*dt*x and h*dy)."""
    x, a = args[0], args[2]
    b, s, d = x.shape
    n = a.shape[1]
    ins = list(args) + [dy] + ([dh_final] if dh_final is not None else [])
    nbytes = sum(t.numel() * t.element_size() for t in ins + list(grads))
    elems = b * s * d * n
    times = {"bytes": nbytes / rate, "operations": max(elems / SFU_RATE, 18 * elems / F32_RATE)}
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def step_memory(torch, tr, forward, lm_loss, base: int) -> dict:
    """Where a training step's memory goes (GiB): what the trainer holds at
    rest over ``base``, the bytes allocated before it was built (parameters,
    and the rest: the optimizer's state), then one plain
    step by hand as ``train_step`` runs it: the forward and backward's peak
    over rest and the gradients they leave, then the optimizer update's
    peak over rest and gradients. The update is computed and discarded:
    ``tx.update`` writes new tensors, so the trainer's state is unchanged."""
    gib = 2**30
    torch.cuda.synchronize()
    rest = torch.cuda.memory_allocated()
    params = sum(p.numel() * p.element_size() for p in tr.params.values())
    torch.cuda.reset_peak_memory_stats()
    loss, _ = lm_loss(tr.model.cfg, tr.params, tr.batch(tr.step), forward)
    grads = torch.autograd.grad(loss, list(tr.params.values()))
    del loss
    torch.cuda.synchronize()
    grad_peak, held = torch.cuda.max_memory_allocated(), torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        updates, _ = tr.tx.update(dict(zip(tr.params, grads)), tr.opt_state, tr.params)
    torch.cuda.synchronize()
    update_peak = torch.cuda.max_memory_allocated()
    del updates, grads
    return dict(rest_gib=(rest - base) / gib, params_gib=params / gib, state_gib=(rest - base - params) / gib,
                grad_peak_gib=(grad_peak - rest) / gib, grads_gib=(held - rest) / gib,
                update_peak_gib=(update_peak - held) / gib)


def ssm_train_phase(torch, timer, rate: float, smi: str):
    """Phase 7f-7h: the SSM family's training path. ssm_scan_bwd against
    its twin at the training shape and a one-chunk shape; full-width
    falcon_mamba_7b cut to SSM_TRAIN_LAYERS layers trained through the
    Trainer with Adam (measuring SNR) and Table-3 SlimAdam; one step's
    gradients of a SSM_GRAD_LAYERS-layer cut through the kernels against
    the plain scan. Returns (report, the backward's entry of the kernels
    line)."""
    import dataclasses
    import functools

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import rules_to_dims, second_moment_savings, table3_rules
    from repro_torch.data import DataConfig, ZipfLM
    from repro_torch.kernels import megaplan, ssm_scan as sc
    from repro_torch.models import Transformer, forward
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.train.loss import lm_loss

    report: dict = {}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    cfg = get_config("falcon_mamba_7b")
    scfg = cfg.ssm_cfg()

    # -- 7f. ssm_scan_bwd against its plain twin -------------------------------
    log(f"[7f] ssm_scan_bwd at the training shape and a one-chunk shape against its plain twin, bound ({smi})")
    held = {}
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for case, (b, s) in (("train", (SSM_TRAIN_ROWS, SSM_EVAL_SEQ)), ("one_chunk", (SSM_ROWS, 256))):
        args = scan_case(torch, gen, b, s, scfg.d_inner, scfg.d_state, torch.bfloat16)
        dy = torch.randn((b, s, scfg.d_inner), generator=gen, device=dev).to(torch.bfloat16)
        dhf = torch.randn((b, scfg.d_inner, scfg.d_state), generator=gen, device=dev)
        _, h, states = sc.ssm_scan(*args, keep_bounds=True)
        fwd = sc.plan_scan(b, s, scfg.d_inner, scfg.d_state, sms=sms)
        plan = sc.plan_scan_bwd(b, s, scfg.d_inner, scfg.d_state)
        if (fwd.chunks > 1) != (case == "train"):
            raise AssertionError(f"ssm_scan_bwd {case}: the forward walks {fwd.chunks} chunks")
        run = lambda: sc.ssm_scan_bwd(*args, dy, dhf, states=states)      # noqa: E731
        got = sc.ssm_scan_bwd(*args, dy, dhf, states=states, with_final=True)
        again = run()
        want = sc.ssm_scan_bwd_plain(*args, dy, dhf)
        torch.cuda.synchronize()
        if got[0].dtype != args[0].dtype:
            raise AssertionError(f"ssm_scan_bwd {case}: dx in {got[0].dtype}, x in {args[0].dtype}")
        errs = [check(f"{case} {name}", g, w, TOL_SSM_BWD_DX_BF16 if g.dtype == torch.bfloat16 else TOL_SSM_BWD)
                for name, g, w in zip(("dx", "ddt", "da", "db", "dc", "dd_skip", "dh0"), got, want)]
        if not all(torch.equal(g, g2) for g, g2 in zip(got, again)):
            raise AssertionError(f"ssm_scan_bwd {case}: two runs on one input differ")
        if not torch.equal(got[-1], h):
            raise AssertionError(f"ssm_scan_bwd {case}: the replayed final state differs from B15's h_final")
        ms = timer(run, reps=10)
        plain_ms = timer(lambda: sc.ssm_scan_bwd_plain(*args, dy, dhf), reps=1)
        bound, by = scan_bwd_bound(args, dy, dhf, got[:-1], rate)
        # B15's training form with and without the tile store, in turns
        fwd_ms = {"keep": [], "plain": []}
        for form in ("keep", "plain", "plain", "keep"):
            fwd_ms[form].append(timer(lambda k=form == "keep": sc.ssm_scan(*args, keep_bounds=k), reps=10))
        fwd_ms = {k: statistics.median(v) for k, v in fwd_ms.items()}
        shared = plan.shared_bytes(args[0].element_size())
        ws_bytes = {k: 4 * math.prod(shape) for k, shape in plan.workspace_shapes().items()}
        ws_bytes["states"] = states.numel() * states.element_size()
        log(f"  {case} (B={b}, S={s}, D={scfg.d_inner}, N={scfg.d_state}): the forward's {fwd.chunks} chunks keep "
            f"{plan.tiles} tile states a row ({ws_bytes['states']} B); walk {plan.walk_grid} blocks of {plan.warps} "
            f"warps ({plan.threads} threads, {plan.channels} channels a warp, {plan.blocks_per_sm} blocks an SM: "
            f"{plan.blocks_per_sm * sms} a wave), {shared} B shared a block, db/dc partials {ws_bytes['ws_bc']} B, "
            f"combine {plan.combine_blocks} blocks; two runs bit-equal, replayed final state equal to B15's h_final")
        log(f"    kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound:.4f} ms ({by}, {bound / ms:.1%} "
            f"reached)  library: none (no PyTorch call computes a selective scan's backward)")
        log(f"    B15's training form: {fwd_ms['keep']:.4f} ms with the tile store, {fwd_ms['plain']:.4f} ms without "
            f"(in turns; +{fwd_ms['keep'] - fwd_ms['plain']:.4f} ms)")
        held[case] = dict(err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, chunks=fwd.chunks,
                          tiles=plan.tiles, walk_grid=list(plan.walk_grid), warps=plan.warps,
                          blocks_per_sm=plan.blocks_per_sm, shared_bytes=shared, workspace_bytes=ws_bytes,
                          fwd_keep_ms=fwd_ms["keep"], fwd_ms=fwd_ms["plain"])
        del args, dy, dhf, h, states, got, again, want
    report["ssm_scan_bwd"] = held
    torch.cuda.empty_cache()

    # -- 7g. training: Adam with SNR, then Table-3 SlimAdam, through the Trainer --
    cut = dataclasses.replace(cfg, n_layers=SSM_TRAIN_LAYERS)
    data = ZipfLM(DataConfig(vocab_size=cut.vocab_size, seq_len=SSM_EVAL_SEQ, global_batch=SSM_TRAIN_ROWS, seed=0))
    log(f"[7g] full-width falcon_mamba_7b cut to {SSM_TRAIN_LAYERS} layers, batch {SSM_TRAIN_ROWS} x "
        f"{SSM_EVAL_SEQ}, bf16 activations, remat, backend='fused' ({smi})")
    runs, trainers = {}, {}
    for optimizer in ("adam", "slim"):
        tc = TrainerConfig(total_steps=SSM_TRAIN_STEPS, log_every=1, backend="fused", seed=0,
                           measure_snr=optimizer == "adam", snr_early_every=SSM_TRAIN_STEPS)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        # drawn on the host: drawn on the card, the draw's temporaries left the two live
        # trainers' memory too fragmented for the dense group's 4.13 GiB gather in the timing
        tr = Trainer(cut, optimizer, 1e-3, data, tc)
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in tr.params.values())
        if n_params != 687_591_424:
            raise AssertionError(f"the {SSM_TRAIN_LAYERS}-layer cut has {n_params} parameters, expected 687591424")
        rules = {} if optimizer == "adam" else table3_rules(tr.meta)
        dims = rules_to_dims(rules, tr.meta)
        leaves = list(tr.params.values())
        plan = megaplan.plan_megagroups([tuple(p.shape) for p in leaves], [p.dtype for p in leaves],
                                        [dims[k] for k in tr.params])
        dense = sum(g.kind == "dense" for g in plan.groups)
        cands = sum(len(m.candidate_ks()) for m in tr.meta.values())
        expect = {"ssm_scan": 2 * SSM_TRAIN_LAYERS * SSM_TRAIN_STEPS,
                  "ssm_scan_bwd": SSM_TRAIN_LAYERS * SSM_TRAIN_STEPS,
                  "mega_adam_update": dense * SSM_TRAIN_STEPS,
                  "mega_slim_update_batched": (len(plan.groups) - dense) * SSM_TRAIN_STEPS,
                  "snr_stats_centered_batched": cands if optimizer == "adam" else 0}
        torch.cuda.synchronize()
        init_peak = torch.cuda.max_memory_allocated()
        kernels.reset_launch_counts()
        forms = scan_forms(sc)
        step_peaks, wall = [], 0.0
        for k in range(1, SSM_TRAIN_STEPS + 1):   # a step at a time, for each step's peak
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            tr.run(k)
            torch.cuda.synchronize()
            wall += time.perf_counter() - t0
            step_peaks.append(torch.cuda.max_memory_allocated())
        counts = kernels.launch_counts()
        forms = scan_forms(sc, since=forms)
        losses = [m["loss"] for m in tr.metrics_log]
        peak = (max(init_peak, *step_peaks) - base) / 2**30
        for k, want in expect.items():
            if counts[k] != want:
                raise AssertionError(f"SSM {optimizer}: {k} launched {counts[k]} times, expected {want} (2 B15 "
                                     f"launches a layer a step under remat)")
        others = {k: v for k, v in counts.items() if v and k not in expect}
        if others:
            raise AssertionError(f"SSM {optimizer}: unexpected launches {others}")
        # every forward of a training step keeps its tile states (the checkpoint's first pass too, whose
        # saved states remat drops), and the backward replays only from them: it has no other form
        if forms != {"token": 0, "seq": 0, "seq_keep": expect["ssm_scan"]}:
            raise AssertionError(f"SSM {optimizer}: B15 forms {forms}; every training forward keeps its tile states")
        if len(losses) != SSM_TRAIN_STEPS or not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"SSM {optimizer}: losses {losses} not finite or not falling")
        inner = tr.opt_state.inner_states[1]
        nu_bytes = sum(t.numel() * t.element_size() for t in inner.nu.values())
        sav = second_moment_savings(tr.params, tr.meta, rules)
        log(f"  {optimizer}: {n_params} parameters (init {init_s:.1f} s), {SSM_TRAIN_STEPS} steps in {wall:.2f} s, "
            f"losses {[round(x, 4) for x in losses]}, launches { {k: v for k, v in counts.items() if v} }, B15 forms "
            f"{forms} (each ssm_scan_bwd replays from kept tile states), "
            f"peak memory {peak:.2f} GiB, second moments {nu_bytes / 2**30:.4f} GiB "
            f"({sav['saved_fraction']:.4%} saved; {len(plan.groups)} megaplan groups)")
        mem = step_memory(torch, tr, forward, lm_loss, base)
        mem["step_peaks_gib"] = [(p - base) / 2**30 for p in step_peaks]
        log(f"  {optimizer} memory (GiB over the start): each step's peak "
            f"{[round(x, 2) for x in mem['step_peaks_gib']]}; at rest {mem['rest_gib']:.2f} (parameters "
            f"{mem['params_gib']:.2f}, optimizer state {mem['state_gib']:.2f}); one plain step by hand: forward and "
            f"backward +{mem['grad_peak_gib']:.2f} over rest, gradients held {mem['grads_gib']:.2f}, the update "
            f"+{mem['update_peak_gib']:.2f} over rest and gradients ({smi})")
        runs[optimizer] = dict(losses=losses, wall_s=wall, init_s=init_s, launches=counts, forms=forms, peak_gib=peak,
                               memory=mem, nu_bytes=nu_bytes, savings=sav,
                               groups=[(g.kind, g.batch, g.rows, g.cols, g.axis) for g in plan.groups])
        if optimizer == "adam":
            if tr.snr.steps != [SSM_TRAIN_STEPS]:
                raise AssertionError(f"SNR measured at steps {tr.snr.steps}, expected [{SSM_TRAIN_STEPS}]")
            derived = {k: (list(v) if v else None) for k, v in tr.derive_slim_rules().items()}
            t3 = {k: (list(v) if v else None) for k, v in table3_rules(tr.meta).items()}
            for label, r in (("derived from Adam's SNR", derived), ("Table 3", t3)):
                log(f"  rules {label} for the ssm leaves: { {k: v for k, v in r.items() if '.ssm.' in k} }")
            runs["derived_rules"] = derived
            tr.tc.measure_snr = False
        trainers[optimizer] = tr
    # step times in turns (a s s a ...), then where one step's device time goes
    med, raw = in_turns(torch, {f"{o}_step_ms": (lambda t=t: t.run(t.step + 1)) for o, t in trainers.items()},
                        rounds=2)
    log(f"  step time, in turns: Adam {med['adam_step_ms']:.2f} ms, SlimAdam {med['slim_step_ms']:.2f} ms = "
        f"{SSM_TRAIN_ROWS * SSM_EVAL_SEQ / med['slim_step_ms'] * 1e3:.0f} tokens/s ({smi})")
    runs["timing"] = dict(med, raw=raw)
    for o, t in trainers.items():
        prof = profile_device(torch, lambda t=t: t.run(t.step + 1), 1, med[f"{o}_step_ms"], f"{o} step")
        bwd_ms = sum(v for k, v in prof["kernels"] if "ssm_bwd" in k)
        fwd_ms = sum(v for k, v in prof["kernels"] if ("ssm_chunk" in k or "ssm_carry" in k or "ssm_token" in k))
        log(f"  {o}: device busy {prof['busy_ms'] / med[f'{o}_step_ms']:.1%} of the step; ssm_scan_bwd "
            f"{bwd_ms:.3f} ms, B15 {fwd_ms:.3f} ms of {prof['busy_ms']:.3f} ms device time")
        runs[f"{o}_profile"] = dict(prof, ssm_bwd_ms=bwd_ms, ssm_fwd_ms=fwd_ms)
    report["train"] = runs
    del trainers, tr, inner
    torch.cuda.empty_cache()

    # -- 7h. one step's gradients, kernels against the plain scan -------------
    batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch(100).items()}
    report["grads"] = {}
    for dtype, tol in ((torch.float32, TOL_SSM_GRADS_F32), (torch.bfloat16, TOL_SSM_GRADS_BF16)):
        small = dataclasses.replace(cfg, n_layers=SSM_GRAD_LAYERS, dtype=dtype)
        log(f"[7h] {SSM_GRAD_LAYERS}-layer full-width cut, {str(dtype)[6:]} activations: one step's gradients "
            f"through ssm_scan/ssm_scan_bwd against the plain scan, tolerance {tol:.0e} of each leaf's max |g|")
        params = Transformer(small, device=dev, gen=torch.Generator(device=dev).manual_seed(1)).params
        grads = {}
        for impl in ("kernel", "plain"):
            counts = sc.ssm_scan.launches, sc.ssm_scan_bwd.launches
            loss, _ = lm_loss(small, params, batch, functools.partial(forward, ssm_impl=impl))
            grads[impl] = torch.autograd.grad(loss, list(params.values()))
            torch.cuda.synchronize()
            moved = sc.ssm_scan.launches - counts[0], sc.ssm_scan_bwd.launches - counts[1]
            if moved != ((2 * SSM_GRAD_LAYERS, SSM_GRAD_LAYERS) if impl == "kernel" else (0, 0)):
                raise AssertionError(f"gradients through impl={impl!r} launched (B15, backward) {moved}")
        worst = {}
        for name, g, w in zip(params, grads["kernel"], grads["plain"]):
            worst[name] = max_err(g, w)[1]
        name = max(worst, key=worst.get)
        log(f"  worst leaf {name}: rel {worst[name]:.3e}  tol {tol:.0e}  "
            f"{'ok' if worst[name] <= tol else 'FAIL'}; all leaves {len(worst)}")
        if not worst[name] <= tol:
            raise AssertionError(f"SSM gradients {dtype}: {name} differs by {worst[name]:.3e} > {tol:.0e}")
        report["grads"][str(dtype)] = worst
        del params, grads
        torch.cuda.empty_cache()

    t = held["train"]
    entry = {"name": "ssm_scan_bwd", "route": "cuda", "source": "src/repro_torch/kernels/csrc/ssm_scan_bwd.cu",
             "replaces": "src/repro/models/ssm.py:170 (plain jnp _selective_scan_bwd; no TPU kernel)",
             "launches": runs["adam"]["launches"]["ssm_scan_bwd"] + runs["slim"]["launches"]["ssm_scan_bwd"],
             "max_abs_err": max(h["err"] for h in held.values()), "ms": t["ms"], "plain_ms": t["plain_ms"],
             "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None}
    return report, entry


def param_phase(torch, timer, rate: float, smi: str, specs, t3_dims):
    """Phase 8: the parameter-writing API (B6, B7) and the plain line stats
    (B8) on full-width gpt_small's leaves and opt_speed's 4096 x 8192
    tensor. Returns (report, the three entries of the kernels line)."""
    from repro_torch import kernels
    from repro_torch.kernels import fused_adam as fa, megaplan, ops, slim_update as su, snr_stats as ss

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
    b7_forms = {}
    for name, (dims, plan, v_red) in slim.items():
        cn = plan.cn
        p3, g3, m3 = (ops.canon_apply(t, cn).contiguous() for t in leaves[name][:3])
        v3 = ops.canon_apply(v_red, cn, reduced_cols=True).contiguous()
        if p3.ndim == 2:
            p3, g3, m3, v3 = p3[None], g3[None], m3[None], v3[None]
        got = su.slim_update_batched(p3, g3, m3, v3, axis=cn.axis, **kw)
        same_tensors(f"slim_update_batched {name}: two runs", dict(enumerate(got)),
                     dict(enumerate(su.slim_update_batched(p3, g3, m3, v3, axis=cn.axis, **kw))))
        b7_forms[name] = f"{tuple(p3.shape)} axis {cn.axis}: {megaplan.last_plans['slim_update_batched'].describe()}"
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
        f"worst abs err {errs['slim_update_batched']:.3e}, each rerun bit for bit  ok; forms "
        + "; ".join(f"{k} {v}" for k, v in b7_forms.items()))
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
    def b8_time(v3, axis):
        n, red = v3.numel(), 2 if axis == 1 else 1
        return dict(ms=timer(lambda: ss.snr_stats_batched(v3, axis=axis), reps=5),
                    plain_ms=timer(lambda: ss.snr_stats_batched_plain(v3, axis=axis), reps=3),
                    bound_ms=max((4 * n + 8 * n // v3.shape[red]) / rate, 3 * n / F64_RATE) * 1e3,
                    library_ms=timer(lambda: torch.var_mean(v3, dim=red, correction=0), reps=5))

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    forms = {ss.FORM_WARP: "WARP", ss.FORM_SPLIT: "SPLIT", ss.FORM_MAJOR: "MAJOR"}
    snr_t, by_form = [], {}
    for name, v2 in lines.items():
        v3 = v2[None]
        snr_t.append(b8_time(v3, 1))
        form = forms[ss.plan_split(*v3.shape, 1, sms=sms, aligned=v3.data_ptr() % 16 == 0).form]
        by_form.setdefault(f"{form} (main path)", []).append(snr_t[-1])
    snr_sum = total(snr_t)
    # B8's other forms, outside the counted run: the embedding's v as one
    # 38.6 M-element line (SPLIT) and reduced along its rows (MAJOR).
    emb = lines["embed"]
    for form, v3, axis in (("SPLIT", emb.reshape(1, 1, -1), 1), ("MAJOR", emb[None], 0)):
        plan = ss.plan_split(*v3.shape, axis, sms=sms, aligned=v3.data_ptr() % 16 == 0)
        if forms[plan.form] != form:
            raise AssertionError(f"snr_stats on {tuple(v3.shape)} axis {axis}: planned {forms[plan.form]}, not {form}")
        for a, b in zip(ss.snr_stats_batched(v3, axis=axis), ss.snr_stats_batched_plain(v3, axis=axis)):
            errs["snr_stats_batched"] = max(errs["snr_stats_batched"], max_err(a, b)[0])
            if max_err(a, b)[1] > TOL_LINE:
                raise AssertionError(f"snr_stats {form} {tuple(v3.shape)}: {max_err(a, b)} against its twin")
        by_form[f"{form} {tuple(v3.shape)} axis {axis}"] = [b8_time(v3, axis)]
    for form, items in by_form.items():
        t = total(items)
        log(f"  snr_stats_batched {form}, {len(items)} views: kernel {t['ms']:.4f} ms  plain {t['plain_ms']:.4f} ms  "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_ms'] / t['ms']:.1%} reached)  var_mean {t['library_ms']:.4f} ms")
    snr_by_form = {form: total(items) for form, items in by_form.items()}
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
                  slim_forms=b7_forms, slim_leaves=dict(zip(slim, slim_t)), snr=snr_sum, snr_by_form=snr_by_form,
                  full=full_t)
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



# -- the paper's baselines and probes (phase 9) ------------------------------------

# benchmarks/resnet_snr.py's batch at CIFAR size; benchmarks/vocab_tail.py's full
# preset at its largest vocabulary.
RESNET_BATCH, RESNET_SIZE = 32, 32
LINEAR_VOCAB, LINEAR_D = 49152, 32


def second_moment_entries(opt_state) -> int:
    """Stored second-moment entries of any of the paper's optimizers, by
    state leaf name: Adam's and SlimAdam's nu, Adafactor's row and column
    statistics, SM3's accumulators (Lion and SGD-M keep none)."""
    from repro_torch.checkpoint import named_leaves

    return sum(t.numel() for n, t in named_leaves(opt_state)
               if any(f".{field}." in f".{n}." for field in ("nu", "vr", "vc", "accs")))


def state_bytes(opt_state) -> int:
    from repro_torch.checkpoint import named_leaves

    return sum(t.numel() * t.element_size() for _, t in named_leaves(opt_state))


def long_lines(torch, smi) -> dict:
    """B7, B10 and B12 on their split walk and B13 on the flat walk, on
    AdaLayer's 38,633,472-element embedding line (SPLIT), a rank's
    9,658,368-element embedding shard line of the (data=2, model=2) mesh
    (25,152 x 384; SPLIT) and ResNet-18's (1, 4608, 1536) axis-0 group
    (MAJOR). B10 with f32 and bf16 g, without the flags and with both; B13
    in the ek and the owner form, with bias corrections a line. Each against
    its twin, rerun bit for bit, its plan logged (``describe``) and timed
    beside its bound (each byte once), its design floor (B7 reads g twice
    where a split view's g outgrows the L2) and its twin; B13 also beside a
    device copy of m' into u (the bytes it streams), and counted: one
    launch a call."""
    from repro_torch.kernels import megaplan, slim_update
    from repro_torch.kernels.fused_adam import host_bias_corrections

    timer = Timer(torch)
    rate = mem_rate(torch.cuda.get_device_name(0))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    c1, c2 = host_bias_corrections(0.9, 0.95, 3)
    step = dict(lr=1e-3, wd=0.1, b1=0.9, b2=0.95, eps=1e-8)
    both = dict(with_snr=True, with_health=True)
    views = {"embedding line": ((1, 1, 50304 * 768), 1, megaplan.FORM_SPLIT),
             "shard line": ((1, 1, 25152 * 384), 1, megaplan.FORM_SPLIT),
             "resnet18 (1, 4608, 1536)": ((1, 4608, 1536), 0, megaplan.FORM_MAJOR)}
    b10_tols = {False: (TOL_ELEMENTWISE, TOL_LINE), True: (TOL_ELEMENTWISE, TOL_LINE, TOL_LINE, TOL_LINE,
                                                           TOL_ELEMENTWISE, TOL_LINE)}
    out = {}
    for label, (shape, axis, want_form) in views.items():
        line = (shape[0], shape[1], 1) if axis == 1 else (shape[0], 1, shape[2])
        n, lines = math.prod(shape), math.prod(line)
        g = 1e-3 * torch.randn(shape, generator=gen, device=dev)
        m = 1e-4 * torch.randn(shape, generator=gen, device=dev)
        p = torch.randn(shape, generator=gen, device=dev)
        v = 1e-6 * torch.rand(line, generator=gen, device=dev)
        ek = 1e-6 * torch.rand(line, generator=gen, device=dev)
        l1, l2 = (0.05 + torch.rand(line, generator=gen, device=dev) for _ in range(2))
        gb = g.to(torch.bfloat16)
        # label: (wrapper, run, plain, tolerances, bound bytes, whether a split pass 2 reads g again)
        cases = {
            "slim_update_batched": (
                "slim_update_batched",
                lambda: slim_update.slim_update_batched(p, g, m, v, axis=axis, count=3, **step),
                lambda: slim_update.slim_update_batched_plain(p, g, m, v, axis=axis, bc1=c1, bc2=c2, **step),
                (TOL_LINE, TOL_ELEMENTWISE, TOL_LINE), 20 * n + 8 * lines, True),
            "mega_slim_partial_stats_batched": (
                "mega_slim_partial_stats_batched",
                lambda: megaplan.mega_slim_partial_stats_batched(g, m, axis=axis, b1=0.9),
                lambda: megaplan.mega_slim_partial_stats_batched_plain(g, m, axis=axis, b1=0.9),
                (TOL_ELEMENTWISE, TOL_LINE), 12 * n + 4 * lines, False),
        }
        for gl, gg in (("f32", g), ("bf16", gb)):
            for fl, flags in (("base", {}), ("both flags", both)):
                # g, m read and m' written; part (and s1c, s2c, first) a line, the (2,) health
                nbytes = (8 + gg.element_size()) * n + (16 * lines + 8 if flags else 4 * lines)
                cases[f"slim_partial_stats_batched {gl} g, {fl}"] = (
                    "slim_partial_stats_batched",
                    lambda gg=gg, flags=flags: slim_update.slim_partial_stats_batched(gg, m, axis=axis, b1=0.9,
                                                                                      **flags),
                    lambda gg=gg, flags=flags: slim_update.slim_partial_stats_batched_plain(gg, m, axis=axis, b1=0.9,
                                                                                            **flags),
                    b10_tols[bool(flags)], nbytes, False)
        for form, e in (("ek", ek), ("owner", None)):
            # m' read and u written; v, bc1, bc2 (and ek read, v' written) a line
            cases[f"mega_slim_finalize_batched {form} form"] = (
                "mega_slim_finalize_batched",
                lambda e=e: megaplan.mega_slim_finalize_batched(m, v, l1, l2, axis=axis, ek=e, b2=0.95, eps=1e-8),
                lambda e=e: slim_update.slim_finalize_batched_plain(m, v, l1, l2, b2=0.95, eps=1e-8, ek=e),
                (TOL_ELEMENTWISE, TOL_ELEMENTWISE), 8 * n + (20 if e is not None else 12) * lines, False)
        for name, (wrapper, run, plain, tols, nbytes, rereads) in cases.items():
            fn = getattr(megaplan if wrapper.startswith("mega") else slim_update, wrapper)
            before = fn.launches
            got = run()
            got = got if isinstance(got, tuple) else (got,)
            want = plain()
            want = want if isinstance(want, tuple) else (want,)
            err = max(check(f"{name} {label} {shape} axis {axis} out {i}", a, w, tol)
                      for i, (a, w, tol) in enumerate(zip(got, want, tols)))
            if fn.launches != before + 1:
                raise AssertionError(f"{name} {label}: {fn.launches - before} launches counted for one call")
            floor_bytes = nbytes
            if wrapper == "mega_slim_finalize_batched":
                walk = slim_update.finalize_plan(m, axis, (v, ek, l1, l2)).describe()
            else:
                plan = megaplan.last_plans[wrapper]
                if plan.form != want_form:
                    raise AssertionError(f"{name} {label} {shape} axis {axis}: form {plan.describe()}, want "
                                         f"{('ROWS', 'SPLIT', 'MAJOR')[want_form]}")
                walk = plan.describe()
                if rereads and plan.nseg > 1 and 4 * n > L2_BYTES:   # B7's pass 2 reads g again
                    floor_bytes += 4 * n
            again = run()
            same_tensors(f"{name} {label}: two runs", dict(enumerate(got)),
                         dict(enumerate(again if isinstance(again, tuple) else (again,))))
            del got, want, again
            ms, plain_ms = timer(run, reps=5), timer(plain, reps=5)
            bound, floor = nbytes / rate * 1e3, floor_bytes / rate * 1e3
            row = dict(form=walk, err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, floor_ms=floor)
            extra = ""
            if wrapper == "mega_slim_finalize_batched":
                u = torch.empty_like(m)
                row["copy_ms"] = timer(lambda: u.copy_(m), reps=5)
                extra = f"  a device copy of m' into u {row['copy_ms']:.4f} ms"
                del u
            log(f"  {name} on the {label} {shape} axis {axis} [{walk}]: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                f"bound {bound:.4f} ms ({bound / ms:.1%})  floor {floor:.4f} ms ({floor / ms:.1%}){extra}; one "
                f"launch, reruns bit for bit ({smi})")
            out[f"{name} {label}"] = row
        del g, gb, m, p, v, ek, l1, l2
    del timer
    torch.cuda.empty_cache()
    return out


# Phase 9b trains full-width gpt_small cut to 4 of its 12 layers (as 3b-3f).
BASELINE_LAYERS = 4


def baselines_phase(torch, smi, cfg, meta, data, lr, derived, plan_for, hold_plan, held, group_key):
    """Phase 9: B1 held on the baseline rule sets' plans, the 12 optimizers
    through the Trainer on full-width gpt_small, ResNet-18, the linear LM and
    gpt_medium. Returns (report, launches of B1, B2 and B5 in the counted
    runs)."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import baselines, measure_tree_snr, rules_to_dims, second_moment_savings, table3_rules
    from repro_torch.core.labels import flatten_with_names
    from repro_torch.core.slim_adam import scale_by_slim_adam, slim_adam
    from repro_torch.data import linear_model_batches
    from repro_torch.kernels import megaplan
    from repro_torch.models import LinearLM, LinearLMConfig, ResNet, ResNetConfig, forward, linear_lm, resnet
    from repro_torch.optim import adamw
    from repro_torch.train import Trainer, TrainerConfig, find_adam_nu, make_train_step
    from repro_torch.train.loss import lm_loss
    from repro_torch.train.trainer import OPTIMIZERS, _SLIM_FAMILY, slim_rule_dims

    dev = torch.device("cuda")
    report: dict = {}
    launched = {"mega_slim_update_batched": 0, "mega_adam_update": 0, "snr_stats_centered_batched": 0}
    rules = {"slim": table3_rules(meta), "slim_snr": derived,
             **{n: getattr(baselines, f"{n}_rules")(meta) for n in ("adalayer", "adalayer_ln_tl", "adam_mini_v1",
                                                                     "adam_mini_v2")}}

    def counted(what, fn, expect):
        """Run ``fn`` with the launch counters zeroed before and read after;
        ``expect`` names the launches each kernel must show (None: none at all)."""
        kernels.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        want = {k: 0 for k in counts} if expect is None else expect
        for k, n in want.items():
            if counts[k] != n:
                raise AssertionError(f"{what}: {k} launched {counts[k]} times, expected {n}")
        for k in launched:
            launched[k] += counts[k]
        return out, {k: n for k, n in counts.items() if n}

    def finite(what, losses):
        if not losses or not all(map(math.isfinite, losses)):
            raise AssertionError(f"{what}: losses not finite: {losses}")

    def fused_vs_jnp(what, make, grads, state):
        """One update on each backend from the same state and gradients."""
        with torch.no_grad():
            uf, sf = make("fused").update(grads, state)
            uj, sj = make("jnp").update(grads, state)
        worst = {}
        for field, a, b in (("u", uf, uj), ("m", sf.mu, sj.mu), ("v", sf.nu, sj.nu)):
            worst[field] = max(max_err(a[k], b[k])[1] for k in a)
            if worst[field] > TOL_STEP:
                raise AssertionError(f"{what} fused vs jnp {field}: rel err {worst[field]:.3e} > {TOL_STEP:.0e}")
        log(f"  {what}: fused vs jnp, worst relative error u {worst['u']:.3e}  m {worst['m']:.3e}  "
            f"v {worst['v']:.3e}  tol {TOL_STEP:.0e}  ok")
        return worst

    def grads_of(model_cfg, params, batch, fwd):
        loss, _ = lm_loss(model_cfg, params, batch, fwd)
        return dict(zip(params, torch.autograd.grad(loss, list(params.values()))))

    # -- 9a. B1 on the baseline rule sets' plans --------------------------------------
    log("[9a] B1 on every group of the baseline rule sets' full-width gpt_small plans (B2 on their dense "
        "groups), each against its plain twin")
    plans = {}
    for name in ("adalayer", "adalayer_ln_tl", "adam_mini_v1", "adam_mini_v2"):
        plans[name] = plan = plan_for(rules[name])
        if plan.jnp_idx:
            raise AssertionError(f"{name}: leaves {plan.jnp_idx} left to the plain path")
        hold_plan(name, plan)
    line = held[("minor", 1, 1, 38633472, 1)]
    log(f"  B1 on AdaLayer's embedding as one 38,633,472-element line [{line['form']}]: {line['ms']:.4f} ms, bound "
        f"{line['bound_ms']:.4f} ms ({line['bound_ms'] / line['ms']:.1%} of it), floor with g read twice "
        f"{line['floor_ms']:.4f} ms ({line['floor_ms'] / line['ms']:.1%}), plain {line['plain_ms']:.4f} ms; B4 "
        f"{line['b4']['ms']:.4f} ms ({smi})")
    report["plans"] = {n: [held[group_key(g)] for g in p.groups] for n, p in plans.items()}
    totals = {}
    for name, plan in plans.items():
        slim = [held[group_key(g)] for g in plan.groups if g.kind != "dense"]
        totals[name] = {k: sum(h[k] for h in slim) for k in ("ms", "plain_ms", "bound_ms", "floor_ms")}
        t = totals[name]
        t["b4_ms"] = sum(h["b4"]["ms"] for h in slim)
        log(f"  {name}: B1 over its {len(slim)} slim groups {t['ms']:.4f} ms a step (bound {t['bound_ms']:.4f}, "
            f"floor {t['floor_ms']:.4f}, plain {t['plain_ms']:.4f}), B4 on the same views {t['b4_ms']:.4f} ms ({smi})")
    report["plan_totals"] = totals
    report["long_line"] = long_lines(torch, smi)

    # -- 9b. the 12 optimizers through the Trainer -------------------------------------
    # gpt_small's layers stack on one leaf each: the cut keeps every leaf and
    # plan group kind, and the rule sets, named by leaf and axis, are the same
    bcfg = dataclasses.replace(cfg, n_layers=BASELINE_LAYERS)
    bspecs = dict(flatten_with_names(bcfg.specs()))
    bmeta = {k: s.meta() for k, s in bspecs.items()}

    def cut_plan(rule_set):
        dims = rules_to_dims(rule_set, bmeta)
        return megaplan.plan_megagroups([s.shape for s in bspecs.values()], [torch.float32] * len(bspecs),
                                        [dims[k] for k in bspecs])

    log(f"[9b] the 12 optimizers on full-width gpt_small cut to {bcfg.n_layers} layers, batch 8 x 1024, bf16 "
        f"activations, backend='fused', 3 steps each")
    n_params = bcfg.param_count()
    trainers, runs = {}, {}
    for name in OPTIMIZERS:
        if name in _SLIM_FAMILY:
            plan = cut_plan(rules[name])
            dense = sum(g.kind == "dense" for g in plan.groups)
            expect = {"mega_adam_update": 3 * dense, "mega_slim_update_batched": 3 * (len(plan.groups) - dense),
                      "snr_stats_centered_batched": 0}
        elif name == "adam":
            expect = {"mega_adam_update": 3, "mega_slim_update_batched": 0, "snr_stats_centered_batched": 0}
        else:
            expect = None      # plain torch: no kernel at all
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        tr = Trainer(bcfg, name, lr, data, TrainerConfig(total_steps=3, log_every=1, backend="fused", seed=0),
                     rules=derived if name == "slim_snr" else None, gen=card_gen())
        t0 = time.perf_counter()
        _, counts = counted(name, tr.run, expect)
        wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        losses = [m["loss"] for m in tr.metrics_log]
        finite(name, losses)
        entries = second_moment_entries(tr.opt_state)
        run = dict(losses=losses, wall_s=wall, launches=counts, peak_gib=peak,
                   state_gib=state_bytes(tr.opt_state) / 2**30, second_moments=entries,
                   second_moment_savings=1.0 - entries / n_params)
        if name in _SLIM_FAMILY:
            saved = second_moment_savings(tr.params, tr.meta, rules[name])["saved_fraction"]
            if abs(saved - run["second_moment_savings"]) > 1e-12:
                raise AssertionError(f"{name}: state holds {entries} second moments, the rules save {saved}")
        log(f"  {name}: losses {[round(x, 4) for x in losses]}, launches {counts}, optimizer state "
            f"{run['state_gib']:.4f} GiB, second moments {entries} ({run['second_moment_savings']:.5%} saved), "
            f"peak memory {peak:.2f} GiB ({smi})")
        if name in _SLIM_FAMILY:
            dims = slim_rule_dims(name, tr.params, tr.meta, derived if name == "slim_snr" else None)
            run["fused_vs_jnp"] = fused_vs_jnp(name, lambda b, dims=dims: scale_by_slim_adam(dims, backend=b),
                                               grads_of(bcfg, tr.params, tr.batch(100), forward),
                                               tr.opt_state.inner_states[1])
        runs[name] = run
        trainers[name] = tr
    # Step times on the synchronised host clock, every optimizer in turns.
    med, raw = in_turns(torch, {n: (lambda tr=tr: tr.run(tr.step + 1)) for n, tr in trainers.items()}, rounds=2)
    for name in OPTIMIZERS:
        runs[name]["step_ms"], runs[name]["step_ms_blocks"] = med[name], raw[name]
    log(f"  step ms in turns ({smi}): " + ", ".join(f"{n} {med[n]:.2f}" for n in OPTIMIZERS))
    report["optimizers"] = runs
    del trainers
    torch.cuda.empty_cache()

    # -- 9c. ResNet-18 ----------------------------------------------------------------
    rcfg = ResNetConfig(classes=100)
    log(f"[9c] ResNet-18 (classes 100, width 64) at full width, synthetic_cifar batch {RESNET_BATCH} at "
        f"{RESNET_SIZE} x {RESNET_SIZE}")
    rspecs = dict(flatten_with_names(rcfg.specs()))
    rmeta = {k: s.meta() for k, s in rspecs.items()}
    n_res = sum(math.prod(s.shape) for s in rspecs.values())
    if n_res != 11_218_240:
        raise AssertionError(f"ResNet-18 has {n_res} parameters")
    t3 = rules_to_dims(table3_rules(rmeta), rmeta)
    rplan = megaplan.plan_megagroups([s.shape for s in rspecs.values()], [torch.float32] * len(rspecs),
                                     [t3[k] for k in rspecs])
    if rplan.jnp_idx or [g.kind for g in rplan.groups] != ["dense"] + ["major"] * 9:
        raise AssertionError(f"unexpected ResNet-18 Table-3 plan: {rplan.groups}")
    hold_plan("ResNet-18 Table-3", rplan)
    rslim = [held[group_key(g)] for g in rplan.groups if g.kind != "dense"]
    rtot = {k: sum(h[k] for h in rslim) for k in ("ms", "plain_ms", "bound_ms", "floor_ms")}
    rtot["b4_ms"] = sum(h["b4"]["ms"] for h in rslim)
    log(f"  ResNet-18: B1 over its 9 axis-0 groups {rtot['ms']:.4f} ms a step (bound {rtot['bound_ms']:.4f}, plain "
        f"{rtot['plain_ms']:.4f}), B4 on the same views {rtot['b4_ms']:.4f} ms ({smi})")
    gen = torch.Generator(device=dev).manual_seed(0)
    batches = [resnet.synthetic_cifar(gen, RESNET_BATCH, rcfg.classes, size=RESNET_SIZE) for _ in range(5)]
    n_cand = sum(len(m.candidate_ks()) for m in rmeta.values())
    res = {"params": n_res, "plan": [held[group_key(g)] for g in rplan.groups], "plan_total": rtot}

    def resnet_run(label, tx, expect):
        model = ResNet(rcfg, device=dev, gen=torch.Generator().manual_seed(0))
        step = make_train_step(model, tx, forward_fn=resnet.forward)
        state = tx.init(model.params)
        metrics = []

        def run():
            nonlocal state
            for b in batches[:4]:
                state, m = step(state, b)
                metrics.append(m)
            return measure_tree_snr(find_adam_nu(state), rmeta, backend="fused") if label == "adam" else None

        snr, counts = counted(f"ResNet-18 {label}", run, expect)
        losses = [float(m["loss"]) for m in metrics]
        finite(f"ResNet-18 {label}", losses)
        ms = host_ms(torch, lambda: step(state, batches[4]))
        log(f"  {label}: losses {[round(x, 4) for x in losses]}, launches {counts}, step {ms:.2f} ms ({smi})")
        return model, state, dict(losses=losses, launches=counts, step_ms=ms), snr

    _, _, res["adam"], snr = resnet_run("adam", adamw(1e-3, b2=0.999, weight_decay=0.01, backend="fused"),
                                        {"mega_adam_update": 4, "mega_slim_update_batched": 0,
                                         "snr_stats_centered_batched": n_cand})
    values = {f"{n}.{k}": float(v) for n, ks in snr.items() for k, v in ks.items()}
    if len(values) != n_cand or not all(map(math.isfinite, values.values())):
        raise AssertionError(f"ResNet-18 SNR: {len(values)} of {n_cand} candidates, {values}")
    res["snr"] = values
    log(f"  SNR of Adam's moments ({n_cand} candidates, B5): stem fan_out {values['stem.conv.fan_out']:.3f}, "
        f"head fan_in {values['head.fan_in']:.3f}, stage3_block1.conv2 fan_in "
        f"{values['stage3_block1.conv2.fan_in']:.3f}")
    model, state, res["slim"], _ = resnet_run(
        "slim", slim_adam(1e-3, t3, b2=0.999, weight_decay=0.01, backend="fused"),
        {"mega_adam_update": 4, "mega_slim_update_batched": 4 * 9, "snr_stats_centered_batched": 0})
    res["fused_vs_jnp"] = fused_vs_jnp("ResNet-18 Table-3 SlimAdam",
                                       lambda b: scale_by_slim_adam(t3, b2=0.999, backend=b),
                                       grads_of(rcfg, model.params, batches[4], resnet.forward),
                                       state.inner_states[1])
    del model, state, batches
    # A small input against a reference: a reduced ResNet on the card and on the CPU.
    scfg = ResNetConfig(stages=(1, 1), width=8, classes=10)
    small = {d: ResNet(scfg, device=d, gen=torch.Generator().manual_seed(1)) for d in ("cpu", "cuda")}
    batch = resnet.synthetic_cifar(torch.Generator().manual_seed(2), 8, scfg.classes, size=RESNET_SIZE)
    with torch.no_grad():
        got = small["cuda"]({k: v.to(dev) for k, v in batch.items()})[0].cpu()
        want = small["cpu"](batch)[0]
    res["reduced_card_vs_cpu"] = check("reduced ResNet (stages (1, 1), width 8) logits, card against CPU", got, want,
                                       TOL_CARD_FORWARD)
    report["resnet18"] = res
    torch.cuda.empty_cache()

    # -- 9d. the linear LM and gpt_medium ------------------------------------------------
    log(f"[9d] linear LM (vocab {LINEAR_VOCAB}, d {LINEAR_D}), 4 Adam steps and one SNR measurement")
    lm = LinearLM(LinearLMConfig(vocab_size=LINEAR_VOCAB, d_model=LINEAR_D), device=dev,
                  gen=torch.Generator().manual_seed(0))
    ldata = linear_model_batches(LINEAR_VOCAB, seq_len=32, batch=8, seed=0)
    tx = adamw(3e-3, b2=0.999, weight_decay=1e-4, backend="fused")
    step = make_train_step(lm, tx, forward_fn=linear_lm.forward)
    lstate = tx.init(lm.params)
    lmetrics = []

    def linear_run():
        nonlocal lstate
        for s in range(4):
            lstate, m = step(lstate, {k: torch.from_numpy(v).to(dev) for k, v in ldata.batch(s).items()})
            lmetrics.append(m)
        return measure_tree_snr(find_adam_nu(lstate), lm.meta, backend="fused")

    lsnr, counts = counted("linear LM", linear_run, {"mega_adam_update": 4, "mega_slim_update_batched": 0,
                                                     "snr_stats_centered_batched": 6})
    losses = [float(m["loss"]) for m in lmetrics]
    finite("linear LM", losses)
    lvalues = {f"{n}.{k}": float(v) for n, ks in lsnr.items() for k, v in ks.items()}
    if len(lvalues) != 6 or not all(map(math.isfinite, lvalues.values())):
        raise AssertionError(f"linear LM SNR: {lvalues}")
    log(f"  losses {[round(x, 4) for x in losses]}, launches {counts}; SNR head token dim (fan_out) "
        f"{lvalues['head.fan_out']:.3f}, embedding dim (fan_in) {lvalues['head.fan_in']:.3f}")
    report["linear_lm"] = dict(losses=losses, launches=counts, snr=lvalues)
    del lm, lstate, step
    torch.cuda.empty_cache()

    mcfg = get_config("gpt_medium")
    log(f"[9d] gpt_medium at full width ({mcfg.param_count():,} parameters), 2 Table-3 SlimAdam steps, "
        "batch 8 x 1024")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(mcfg, "slim", lr, data, TrainerConfig(total_steps=2, log_every=1, backend="fused", seed=0),
                 gen=card_gen())
    mdims = slim_rule_dims("slim", tr.params, tr.meta)
    mplan = megaplan.plan_megagroups([p.shape for p in tr.params.values()], [torch.float32] * len(mdims),
                                     list(mdims.values()))
    dense = sum(g.kind == "dense" for g in mplan.groups)
    t0 = time.perf_counter()
    _, counts = counted("gpt_medium", tr.run, {"mega_adam_update": 2 * dense,
                                               "mega_slim_update_batched": 2 * (len(mplan.groups) - dense),
                                               "snr_stats_centered_batched": 0})
    wall = time.perf_counter() - t0
    losses = [m["loss"] for m in tr.metrics_log]
    finite("gpt_medium", losses)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    log(f"  losses {[round(x, 4) for x in losses]}, launches {counts}, groups "
        f"{[(g.kind, g.batch, g.rows, g.cols) for g in mplan.groups]}, 2 steps in {wall:.2f} s, peak memory "
        f"{peak:.2f} GiB ({smi})")
    report["gpt_medium"] = dict(params=mcfg.param_count(), losses=losses, launches=counts, wall_s=wall, peak_gib=peak)
    del tr
    torch.cuda.empty_cache()
    return report, launched


# -- the mixture-of-experts and hybrid families (phases 10-12) -------------------------

# Phase 10 geometry: olmoe_1b_7b served at full width and depth, 8 slots, pages of 16.
MOE_SC = dict(max_seq=576, page_size=16, max_slots=8, prefill_chunk=128)
MOE_REQUESTS, MOE_NEW = 8, 32
# Phase 11: olmoe_1b_7b at full width cut to 1 of its 16 layers, ZipfLM 2 x 2048.
MOE_TRAIN_LAYERS, MOE_TRAIN_ROWS, MOE_TRAIN_SEQ, MOE_TRAIN_STEPS = 1, 2, 2048, 4
# Adam without warmup: at 1e-3 the first step moves the untied 2048-wide head's logits by several
# units and the loss jumps (11.3 to 19.8 on an H100); 1e-4 is a quarter of OLMoE's peak rate.
MOE_TRAIN_LR = 1e-4
TOL_MOE_LOGITS = 5e-2    # full-width logits, kernel against plain attention: bf16 activations through 16 layers
TOL_MOE_LOSS = 1e-4      # the first 2 training losses, fused backend against 'jnp' (one update apart)
TOL_DIY_LOSS = 1e-3      # reduced f32 jamba's first DIY_HELD probe losses, card (fused) against CPU (jnp)
DIY_HELD = 5


def moe_stages(torch, timer, p, x, cfg) -> dict:
    """Device time (``timer``) of each stage of one MoE layer's forward on
    x: the f32 router and softmax, the top-k sort and renormalisation, the
    routing cumsum and dispatch gather, the weights' casts to x's dtype,
    the experts' three bmm with the gated SiLU, the combine; and the whole
    layer as the decode steps run it (no aux loss)."""
    from repro_torch.models import mlp_moe as mm

    n, d = x.shape[0] * x.shape[1], x.shape[2]
    e, k = cfg.n_experts, cfg.top_k
    xf = x.reshape(n, d)
    cap = mm.moe_capacity(n, cfg)
    _, probs, gates, eidx = mm._router(xf, p["router"], k)
    dp = mm._dispatch_group(xf, eidx, e, k, cap)
    cast = {w: p[w].to(x.dtype) for w in ("w_up", "w_gate", "w_down")}
    y = mm._expert_ffn_dense(cast, dp.xg, cfg, x.dtype)

    stages = {
        "router": lambda: torch.softmax(xf.float() @ p["router"].float(), dim=-1),
        "sort": lambda: torch.sort(probs, dim=-1, descending=True, stable=True),
        "dispatch": lambda: mm._dispatch_group(xf, eidx, e, k, cap),
        "cast": lambda: [p[w].to(x.dtype) for w in ("w_up", "w_gate", "w_down")],
        "bmm": lambda: mm._expert_ffn_dense(cast, dp.xg, cfg, x.dtype),
        "combine": lambda: mm._combine(y, gates, dp),
    }
    out = {name: timer(fn, reps=5) for name, fn in stages.items()}
    out["layer"] = timer(lambda: mm.moe_forward(p, x, cfg, with_aux=False), reps=5)
    out.update(tokens=n, capacity=cap, dropped=int((~dp.keep).sum()))
    return out


B14_HELD: dict = {}   # every hold_b14 row of the run by tag; main reports it and takes the error's maximum once


def hold_b14(torch, timer, rate: float, gen, rng, label: str, *, heads: int, kv: int, hd: int, sc: dict) -> None:
    """B14 against its plain twin at one attention geometry: a decode batch
    of ``sc['max_slots']`` ragged rows (row 0 empty) and prefill chunks of
    ``sc['prefill_chunk']`` tokens at pos0 0 and 384 (100 valid), f32 and
    bf16 queries over a bf16 pool, each run twice and compared bit for bit,
    timed beside the bound and SDPA on K/V gathered dense. The rows go into
    B14_HELD."""
    from repro_torch.kernels import paged_attention as pa

    page, c = sc["page_size"], sc["prefill_chunk"]
    max_pages = -(-sc["max_seq"] // page)
    dec = rng.integers(65, sc["max_seq"] + 1, sc["max_slots"])
    dec[0] = 0
    cases = {"decode": dict(lengths=dec, alloc=dec, c=1),
             "prefill_pos0_0": dict(lengths=[c], alloc=[c], c=c),
             "prefill_pos0_384": dict(lengths=[384 + c], alloc=[384 + 100], c=c)}
    for case, kw in cases.items():
        for q_dtype in (torch.float32, torch.bfloat16):
            q, pool, table, lengths = paged_case(torch, gen, pool_dtype=torch.bfloat16, q_dtype=q_dtype, heads=heads,
                                                 kv=kv, hd=hd, page=page, max_pages=max_pages, **kw)
            args = (q, pool, table, lengths)
            tag = f"{label} {case} {str(q_dtype).split('.')[-1]} q bfloat16 pool"
            got, again, want = pa.paged_attention(*args), pa.paged_attention(*args), pa.paged_attention_plain(*args)
            torch.cuda.synchronize()
            err = check(tag, got.float(), want.float(), TOL_LINE if q_dtype == torch.float32 else TOL_BF16_OUT)
            if not torch.equal(got, again):
                raise AssertionError(f"{tag}: two runs of the kernel differ")
            if case == "decode" and got[0].any():
                raise AssertionError(f"{label} decode: the empty row's output is not exactly 0")
            plan = pa.plan_of(*args)
            ms = timer(lambda: pa.paged_attention(*args), reps=20)
            plain_ms = timer(lambda: pa.paged_attention_plain(*args), reps=5)
            lib_ms = timer(sdpa_call(torch, *args), reps=20)
            bound, by = paged_bound(*args, rate)
            log(f"  {tag}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bound:.4f} ms ({by})  SDPA "
                f"{lib_ms:.4f} ms  two runs bit-equal; form {plan.form}, {plan.blocks} blocks, {plan.pieces} pieces")
            B14_HELD[tag] = dict(case=case, q=str(q_dtype), err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                 bound_by=by, library_ms=lib_ms, plan=dataclasses.asdict(plan))
            del q, pool, table, lengths, args, got, again, want


def moe_serve_phase(torch, timer, rate: float, smi: str):
    """Phase 10: full-width, full-depth olmoe_1b_7b through the paged
    engine. Returns (report, launches of the counted run)."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.models import Transformer
    from repro_torch.models.transformer import PagedState, init_paged_pools, paged_decode_step, paged_prefill_chunk
    from repro_torch.serve import Engine, Request, ServeConfig

    report: dict = {}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    cfg = get_config("olmoe_1b_7b")
    page, c = MOE_SC["page_size"], MOE_SC["prefill_chunk"]
    max_pages = -(-MOE_SC["max_seq"] // page)
    kv, heads, hd = cfg.n_kv_heads, cfg.n_heads, cfg.hd

    # -- 10a. B14 at olmoe's geometry: 16 heads of 128 over 16 KV groups ---------
    log(f"[10a] paged_attention (B14) at olmoe_1b_7b's geometry ({heads} heads of {hd} over {kv} KV groups, pages of "
        f"{page}, {max_pages}-page rows) against its plain twin, bound, SDPA; each case twice, bit for bit ({smi})")
    rng = np.random.default_rng(5)
    hold_b14(torch, timer, rate, gen, rng, "olmoe", heads=heads, kv=kv, hd=hd, sc=MOE_SC)

    # -- 10b. the serving main path ---------------------------------------------
    t0 = time.perf_counter()
    model = Transformer(cfg, device=dev, gen=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.params.values())
    if n_params != 6_919_096_320 or n_params != cfg.param_count():
        raise AssertionError(f"olmoe_1b_7b has {n_params} parameters, expected 6919096320")
    params = model.params
    log(f"[10b] serving: full-width full-depth olmoe_1b_7b ({n_params} parameters, "
        f"{n_params * 4 / 1e9:.1f} GB f32 drawn on the card in {init_s:.1f} s), bf16 activations, {MOE_REQUESTS} "
        f"requests x {MOE_NEW} greedy tokens, {MOE_SC} ({smi})")
    eng = Engine(cfg, params, ServeConfig(**MOE_SC))
    del model
    prompt_lens = rng.integers(64, 513, MOE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, int(n), dtype=np.int32) for n in prompt_lens]
    rids = [eng.submit(Request(prompt=p, max_new_tokens=MOE_NEW)) for p in prompts]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    m = eng.metrics()
    log(f"  drained in {wall:.2f} s: {m.tokens_out} tokens, {m.decode_steps} decode steps, {m.prefill_chunks} "
        f"prefill chunks, mean TTFT {m.ttft_mean_s * 1e3:.1f} ms, mean TPOT {m.tpot_mean_s * 1e3:.2f} ms, launches "
        f"{ {k: v for k, v in counts.items() if v} } ({smi})")
    bad = [c_ for c_ in done.values() if c_.finish_reason != "length" or len(c_.tokens) != MOE_NEW]
    if len(done) != MOE_REQUESTS or bad or m.used_pages != 0:
        raise AssertionError(f"olmoe serving: {len(done)} completions, unfinished {[c_.id for c_ in bad]}, "
                             f"{m.used_pages} pages left")
    assert_clean(m, "phase 10")
    want_launches = cfg.n_layers * (m.decode_steps + m.prefill_chunks)
    if counts["paged_attention"] != want_launches or sum(counts.values()) != want_launches:
        raise AssertionError(f"olmoe launches {counts}, expected paged_attention {want_launches} and no other kernel")
    tokens = {i: done[r].tokens.tolist() for i, r in enumerate(rids)}
    run = dict(wall_s=wall, init_s=init_s, metrics=m.to_dict(), launches=counts, prompt_lens=prompt_lens.tolist())

    # Decode-step and prefill-chunk times outside the counted run: 8 rows
    # mid-generation in a pool of their own; a device profile of each; the
    # MoE layer's stages at the decode and prefill shapes.
    tl = [int(n) + MOE_NEW // 2 for n in prompt_lens]
    table, n_pages = page_table(torch, [n + 1 for n in tl], page, max_pages)
    pools = init_paged_pools(cfg, n_pages, page, torch.bfloat16, dev)
    state = PagedState(pools=pools, table=table, lengths=torch.tensor(tl, dtype=torch.int32, device=dev),
                       active=torch.ones(len(tl), dtype=torch.bool, device=dev))
    step_tokens = torch.randint(0, cfg.vocab_size, (len(tl), 1), device=dev)
    chunk = torch.randint(0, cfg.vocab_size, (1, c), device=dev)

    def decode():
        paged_decode_step(cfg, params, state, step_tokens)

    def prefill():
        paged_prefill_chunk(cfg, params, pools, table[:1], 256, c, chunk)

    decode()
    decode_ms = host_ms(torch, decode, 10)
    prefill()
    prefill_ms = host_ms(torch, prefill, 5)
    log(f"  decode step ({len(tl)} rows of {min(tl)}..{max(tl)} positions) {decode_ms:.3f} ms on the host = "
        f"{len(tl) / decode_ms * 1e3:.1f} tokens/s; prefill chunk ({c} tokens at pos0 256) {prefill_ms:.3f} ms")
    run.update(decode_step_ms=decode_ms, prefill_chunk_ms=prefill_ms,
               decode_profile=profile_device(torch, decode, 3, decode_ms, "decode step"),
               prefill_profile=profile_device(torch, prefill, 2, prefill_ms, "prefill chunk"))
    for what in ("decode", "prefill"):
        prof = run[f"{what}_profile"]
        b14 = sum(t for key, t in prof["kernels"] if "paged_" in key)
        run[f"{what}_b14_ms"] = b14
        log(f"  {what}: device busy {prof['busy_ms'] / prof['wall_ms']:.1%}; B14 {b14:.4f} ms of "
            f"{prof['busy_ms']:.3f} ms device time")
    p0 = {k.rsplit(".", 1)[1]: v[0] for k, v in params.items() if k.startswith("blocks.slot_0.moe.")}
    moe_cfg = cfg.moe_cfg()
    for what, n_tok in (("decode", len(tl)), ("prefill", c)):
        x = torch.randn((1, n_tok, cfg.d_model), generator=gen, device=dev).to(cfg.dtype)
        st = moe_stages(torch, timer, p0, x, moe_cfg)
        busy = run[f"{what}_profile"]["busy_ms"]
        run[f"{what}_moe_stages"] = st
        log(f"  MoE layer at the {what} shape ({n_tok} tokens, capacity {st['capacity']}): "
            + ", ".join(f"{k} {st[k]:.4f}" for k in ("router", "sort", "dispatch", "cast", "bmm", "combine"))
            + f" ms; the layer {st['layer']:.4f} ms x {cfg.n_layers} layers = {st['layer'] * cfg.n_layers:.3f} ms "
            f"({st['layer'] * cfg.n_layers / busy:.1%} of the {what}'s {busy:.3f} ms device time; L2 flushed)")
        del x
    del pools, state

    # The kernel path against the plain path from the same state: the first
    # prefill chunk's logits, then greedy tokens of the whole run.
    log(f"[10c] logits of the first prefill chunk through B14 against the plain twin, tolerance "
        f"{TOL_MOE_LOGITS:.0e} of max|logit|; greedy tokens through the plain twin against the engine's")
    table, n_pages = page_table(torch, [int(n) + MOE_NEW for n in prompt_lens], page, max_pages)
    pools_k = init_paged_pools(cfg, n_pages, page, torch.bfloat16, dev)
    pools_p = {k: v.clone() for k, v in pools_k.items()}
    first = torch.from_numpy(prompts[0][:c][None].copy()).to(dev)
    lk, _, _ = paged_prefill_chunk(cfg, params, pools_k, table[:1], 0, c, first)
    lp, _, _ = paged_prefill_chunk(cfg, params, pools_p, table[:1], 0, c, first, attn_impl="plain")
    prefill_rel = check("olmoe first prefill chunk logits", lk.float(), lp.float(), TOL_MOE_LOGITS) \
        / float(lp.float().abs().max())
    del pools_k, lk, lp
    plain_tokens = greedy_paged(torch, cfg, params, prompts, table, pools_p, c, MOE_NEW, "plain")
    agree = [next((j for j, (a, b) in enumerate(zip(tokens[i], plain_tokens[i])) if a != b), MOE_NEW)
             for i in range(MOE_REQUESTS)]
    same = sum(int(a == b) for i in range(MOE_REQUESTS) for a, b in zip(tokens[i], plain_tokens[i]))
    log(f"  first chunk logits rel {prefill_rel:.3e}; greedy tokens through the plain twin equal the engine's at "
        f"{same} of {MOE_REQUESTS * MOE_NEW} positions; agreeing prefixes {agree} of {MOE_NEW} (reported, not "
        f"required: a near tie in the router may flip an expert)")
    report["serving"] = dict(run, prefill_logits_rel=prefill_rel, tokens=tokens, plain_tokens=plain_tokens,
                             tokens_equal=same, agreeing_prefixes=agree)
    del pools_p, eng, params
    torch.cuda.empty_cache()

    # A small input against a reference: reduced f32 olmoe served on the card
    # (through B14) and on the CPU (plain twin), greedy.
    rcfg = get_reduced("olmoe_1b_7b")
    rparams = Transformer(rcfg, device="cpu", gen=torch.Generator().manual_seed(0)).params
    rprompts = [rng.integers(0, rcfg.vocab_size, n, dtype=np.int32) for n in rng.integers(5, 25, 6)]
    toks = {}
    for device in ("cuda", "cpu"):
        e = Engine(rcfg, rparams, ServeConfig(max_seq=64, page_size=8, max_slots=4, prefill_chunk=8), device=device)
        rids = [e.submit(Request(prompt=p, max_new_tokens=16)) for p in rprompts]
        d = e.run_until_drained()
        toks[device] = [d[r].tokens.tolist() for r in rids]
    if toks["cuda"] != toks["cpu"]:
        raise AssertionError(f"reduced olmoe: card and CPU tokens differ: {toks}")
    log(f"  reduced f32 olmoe_1b_7b: 6 requests x 16 tokens identical on the card and the CPU "
        f"(first {toks['cuda'][0][:8]})")
    report["reduced_card_vs_cpu_tokens"] = toks["cuda"]
    return report, counts


def greedy_paged(torch, cfg, params, prompts, table, pools, c: int, n_new: int, attn_impl: str) -> dict:
    """Greedy tokens of every prompt through the paged steps: each prompt
    prefilled chunk by chunk into its own table row, then all rows decoded
    together."""
    import numpy as np

    from repro_torch.models.transformer import PagedState, paged_decode_step, paged_prefill_chunk

    dev = table.device
    first = []
    for row, p in enumerate(prompts):
        for lo in range(0, len(p), c):
            buf = np.zeros((1, c), np.int32)
            n_valid = min(c, len(p) - lo)
            buf[0, :n_valid] = p[lo:lo + n_valid]
            logits, _, _ = paged_prefill_chunk(cfg, params, pools, table[row:row + 1], lo, n_valid,
                                               torch.from_numpy(buf).to(dev), attn_impl=attn_impl)
        first.append(int(logits[0, n_valid - 1].float().argmax()))
    out = {i: [t] for i, t in enumerate(first)}
    lengths = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device=dev)
    active = torch.ones(len(prompts), dtype=torch.bool, device=dev)
    tokens = torch.tensor(first, device=dev)[:, None]
    for _ in range(n_new - 1):
        logits, _, st = paged_decode_step(cfg, params, PagedState(pools, table, lengths, active), tokens,
                                          attn_impl=attn_impl)
        lengths, tokens = st.lengths, logits[:, -1].float().argmax(-1)[:, None]
        for i, t in enumerate(tokens[:, 0].tolist()):
            out[i].append(t)
    return out


def hold_b5_sums(torch, nu: dict, meta: dict, label: str) -> tuple:
    """B5's three sums (s1, s1c, s2c) against its plain twin (the same
    shift, f64 sums) on every candidate's view of the second moments ``nu``,
    held at TOL_LINE. Launches made here are comparisons, not the main
    path's. Returns (worst relative error, candidates held)."""
    from repro_torch.kernels import snr_stats
    from repro_torch.kernels.ops import canon_apply, canon_nd

    worst, n = 0.0, 0
    for name, v in nu.items():
        for axes in meta[name].candidate_ks().values():
            cn = canon_nd(tuple(v.shape), meta[name].dims_of(axes))
            v3 = canon_apply(v.float(), cn).contiguous()
            v3 = v3 if v3.ndim == 3 else v3[None]
            got = snr_stats.snr_stats_centered_batched(v3, axis=cn.axis)
            want = snr_stats.snr_stats_centered_batched_plain(v3, axis=cn.axis)
            worst = max(worst, *(max_err(a, w)[1] for a, w in zip(got, want)))
            n += 1
            del v3, got, want
    log(f"  {label}: B5's sums (s1, s1c, s2c) against the plain twin on all {n} candidates: worst relative error "
        f"{worst:.3e}  tol {TOL_LINE:.0e}")
    if not worst <= TOL_LINE:
        raise AssertionError(f"{label} B5 sums against the plain twin: {worst:.3e} above {TOL_LINE:.0e}")
    return worst, n


def moe_train_phase(torch, timer, rate: float, smi: str):
    """Phase 11: full-width olmoe_1b_7b cut to MOE_TRAIN_LAYERS layers
    trained through the Trainer: Adam measuring SNR, then Table-3
    SlimAdam; the first losses against the 'jnp' backend, one update of
    each and one SNR measurement against 'jnp' from the same state.
    Returns (report, launches summed over the counted runs)."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core import derive_rules, measure_tree_snr, rules_to_dims, second_moment_savings, table3_rules
    from repro_torch.core.slim_adam import scale_by_slim_adam
    from repro_torch.data import DataConfig, ZipfLM
    from repro_torch.kernels import megaplan
    from repro_torch.models import forward, mlp_moe
    from repro_torch.optim.adam import scale_by_adam
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.train.loss import lm_loss
    from repro_torch.train.step import make_train_step
    from repro_torch.train.trainer import make_optimizer

    report: dict = {}
    dev = torch.device("cuda")
    cut = dataclasses.replace(get_config("olmoe_1b_7b"), n_layers=MOE_TRAIN_LAYERS)
    data = ZipfLM(DataConfig(vocab_size=cut.vocab_size, seq_len=MOE_TRAIN_SEQ, global_batch=MOE_TRAIN_ROWS, seed=0))
    n_tok = MOE_TRAIN_ROWS * MOE_TRAIN_SEQ
    log(f"[11] full-width olmoe_1b_7b cut to {MOE_TRAIN_LAYERS} layers, batch {MOE_TRAIN_ROWS} x {MOE_TRAIN_SEQ}, "
        f"bf16 activations, remat, lr {MOE_TRAIN_LR}, expert capacity {mlp_moe.moe_capacity(n_tok, cut.moe_cfg())} "
        f"of {n_tok} tokens x top-{cut.top_k} over {cut.n_experts} experts ({smi})")

    runs, trainers, total = {}, {}, {}
    for optimizer in ("adam", "slim"):
        tc = TrainerConfig(total_steps=MOE_TRAIN_STEPS, log_every=1, backend="fused", seed=0,
                           measure_snr=optimizer == "adam", snr_early_every=MOE_TRAIN_STEPS)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tr = Trainer(cut, optimizer, MOE_TRAIN_LR, data, tc)   # on the host, as 7g's
        init_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in tr.params.values())
        if n_params != 625_612_800:
            raise AssertionError(f"the {MOE_TRAIN_LAYERS}-layer cut has {n_params} parameters, expected 625612800")
        rules = {} if optimizer == "adam" else table3_rules(tr.meta)
        dims = rules_to_dims(rules, tr.meta)
        leaves = list(tr.params.values())
        plan = megaplan.plan_megagroups([tuple(p.shape) for p in leaves], [p.dtype for p in leaves],
                                        [dims[k] for k in tr.params])
        dense = sum(g.kind == "dense" for g in plan.groups)
        cands = sum(len(m.candidate_ks()) for m in tr.meta.values())
        expect = {"mega_adam_update": dense * MOE_TRAIN_STEPS,
                  "mega_slim_update_batched": (len(plan.groups) - dense) * MOE_TRAIN_STEPS,
                  "snr_stats_centered_batched": cands if optimizer == "adam" else 0,
                  "paged_attention": 0}
        torch.cuda.synchronize()
        init_peak = torch.cuda.max_memory_allocated()
        if optimizer == "adam":
            # The first 2 losses of the same trainer's model through the plain 'jnp'
            # backend, for the fused run to hold; then the initial weights back.
            start = {k: p.detach().clone() for k, p in tr.params.items()}
            tx = make_optimizer("adam", MOE_TRAIN_LR, tr.params, tr.meta, backend="jnp")
            step, state, jnp_losses = make_train_step(tr.model, tx), tx.init(tr.params), []
            for k in range(2):
                state, metrics = step(state, tr.batch(k))
                jnp_losses.append(float(metrics["loss"]))
            tr.model.load_params(start)
            del start, tx, step, state, metrics
            torch.cuda.empty_cache()
        kernels.reset_launch_counts()
        step_peaks, wall, drops = [], 0.0, []
        for k in range(1, MOE_TRAIN_STEPS + 1):   # a step at a time, for each step's peak and drops
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with mlp_moe.count_drops() as dropped:
                tr.run(k)
            torch.cuda.synchronize()
            wall += time.perf_counter() - t0
            step_peaks.append(torch.cuda.max_memory_allocated())
            # remat: the forward and the backward's recompute route the same tokens alike
            d = [int(x) for x in dropped]
            if len(d) != 2 * MOE_TRAIN_LAYERS or d[:MOE_TRAIN_LAYERS] != d[MOE_TRAIN_LAYERS:][::-1]:
                raise AssertionError(f"{optimizer} step {k}: dropped choices {d} (forward, then the recompute)")
            drops.append(d[:MOE_TRAIN_LAYERS])
        counts = kernels.launch_counts()
        losses = [m["loss"] for m in tr.metrics_log]
        peak = (max(init_peak, *step_peaks) - base) / 2**30
        for name, want in expect.items():
            if counts[name] != want:
                raise AssertionError(f"olmoe {optimizer}: {name} launched {counts[name]} times, expected {want}")
        others = {k: v for k, v in counts.items() if v and k not in expect}
        if others:
            raise AssertionError(f"olmoe {optimizer}: unexpected launches {others}")
        if len(losses) != MOE_TRAIN_STEPS or not all(map(math.isfinite, losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"olmoe {optimizer}: losses {losses} not finite or not falling")
        for name, v in counts.items():
            total[name] = total.get(name, 0) + v
        inner = tr.opt_state.inner_states[1]
        nu_bytes = sum(t.numel() * t.element_size() for t in inner.nu.values())
        sav = second_moment_savings(tr.params, tr.meta, rules)
        log(f"  {optimizer}: {n_params} parameters (init {init_s:.1f} s), {MOE_TRAIN_STEPS} steps in {wall:.2f} s, "
            f"losses {[round(x, 4) for x in losses]}, routing choices dropped per layer and step {drops} of "
            f"{n_tok * cut.top_k}, launches { {k: v for k, v in counts.items() if v} }, peak memory {peak:.2f} GiB, "
            f"second moments {nu_bytes / 2**30:.4f} GiB ({sav['saved_fraction']:.4%} saved; {len(plan.groups)} "
            f"megaplan groups: {[(g.kind, g.batch, g.rows, g.cols) for g in plan.groups]})")
        mem = step_memory(torch, tr, forward, lm_loss, base)
        mem["step_peaks_gib"] = [(p - base) / 2**30 for p in step_peaks]
        log(f"  {optimizer} memory (GiB over the start): each step's peak "
            f"{[round(x, 2) for x in mem['step_peaks_gib']]}; at rest {mem['rest_gib']:.2f} (parameters "
            f"{mem['params_gib']:.2f}, optimizer state {mem['state_gib']:.2f}); one plain step by hand: forward and "
            f"backward +{mem['grad_peak_gib']:.2f} over rest, gradients held {mem['grads_gib']:.2f}, the update "
            f"+{mem['update_peak_gib']:.2f} over rest and gradients ({smi})")
        runs[optimizer] = dict(losses=losses, wall_s=wall, init_s=init_s, launches=counts, peak_gib=peak, memory=mem,
                               nu_bytes=nu_bytes, savings=sav, drops=drops,
                               groups=[(g.kind, g.batch, g.rows, g.cols, g.axis) for g in plan.groups])
        if optimizer == "adam":
            err = max(abs(a - b) / abs(b) for a, b in zip(losses[:2], jnp_losses))
            log(f"  the first 2 losses {losses[:2]} against backend='jnp' {jnp_losses}: worst relative difference "
                f"{err:.3e}  tol {TOL_MOE_LOSS:.0e}")
            if not err <= TOL_MOE_LOSS:
                raise AssertionError(f"olmoe: fused and jnp losses differ by {err:.3e}")
            runs["fused_vs_jnp_losses"] = dict(fused=losses[:2], jnp=jnp_losses, worst_rel=err)
            if tr.snr.steps != [MOE_TRAIN_STEPS]:
                raise AssertionError(f"SNR measured at steps {tr.snr.steps}, expected [{MOE_TRAIN_STEPS}]")
            derived = {k: (list(v) if v else None) for k, v in tr.derive_slim_rules().items()}
            t3 = {k: (list(v) if v else None) for k, v in table3_rules(tr.meta).items()}
            for label, r in (("derived from Adam's SNR", derived), ("Table 3", t3)):
                log(f"  rules {label} for the expert leaves: { {k: v for k, v in r.items() if '.moe.' in k} }")
            runs["derived_rules"] = derived
            tr.tc.measure_snr = False
        trainers[optimizer] = tr
    # step times in turns (a s s a ...), then where one step's device time goes
    med, raw = in_turns(torch, {f"{o}_step_ms": (lambda t=t: t.run(t.step + 1)) for o, t in trainers.items()},
                        rounds=2)
    log(f"  step time, in turns: Adam {med['adam_step_ms']:.2f} ms, SlimAdam {med['slim_step_ms']:.2f} ms = "
        f"{n_tok / med['slim_step_ms'] * 1e3:.0f} tokens/s ({smi})")
    runs["timing"] = dict(med, raw=raw)
    # One fused update of each optimizer against the plain 'jnp' backend from the same
    # state and gradients (B2, and B1 on the groups that hold the expert leaves), and one
    # SNR measurement of Adam's second moments (B5 on every candidate, the experts' too).
    tr = trainers["adam"]
    loss, _ = lm_loss(cut, tr.params, tr.batch(100), forward)
    grads = dict(zip(tr.params, torch.autograd.grad(loss, list(tr.params.values()))))
    del loss
    t3_dims = rules_to_dims(table3_rules(tr.meta), tr.meta)
    step_check = {}
    for label, make in (("adam", lambda b: scale_by_adam(b2=0.95, backend=b)),
                        ("slim", lambda b: scale_by_slim_adam(t3_dims, backend=b))):
        state = trainers[label].opt_state.inner_states[1]
        worst = {}
        with torch.no_grad():
            fused = make("fused").update(grads, state)
            fused = {"u": fused[0], "m": fused[1].mu, "v": fused[1].nu}
            plain = make("jnp").update(grads, state)
            plain = {"u": plain[0], "m": plain[1].mu, "v": plain[1].nu}
        for what in ("u", "m", "v"):
            worst[what] = max(max_err(fused[what][k], plain[what][k])[1] for k in fused[what])
        del fused, plain
        torch.cuda.empty_cache()
        log(f"  {label}: one fused update against 'jnp' from the same state and gradients: worst relative error "
            f"u {worst['u']:.3e}  m {worst['m']:.3e}  v {worst['v']:.3e}  tol {TOL_STEP:.0e}")
        if max(worst.values()) > TOL_STEP:
            raise AssertionError(f"olmoe {label} fused vs jnp: {worst} above {TOL_STEP:.0e}")
        step_check[label] = worst
    del grads
    nu = tr.opt_state.inner_states[1].nu
    snr = {b: {n: {k: float(v) for k, v in ks.items()} for n, ks in measure_tree_snr(nu, tr.meta, backend=b).items()}
           for b in ("fused", "jnp")}
    rel = sorted(((abs(snr["fused"][n][k] - v) / max(abs(v), 1e-30), n, k, snr["fused"][n][k], v)
                  for n, ks in snr["jnp"].items() for k, v in ks.items()), reverse=True)
    expert = [r for r in rel if ".moe." in r[1]]
    snr_err = expert[0][0]
    rules = {b: derive_rules(snr[b], tr.meta) for b in snr}
    # B5 shifts each line by its first entry; where that entry is far from the line's
    # mean (the vocabulary lines through token 0, ZipfLM's most frequent), the variance
    # it forms from f32 sums cancels (PERF.md §7): those are reported, not held.
    log(f"  SNR of Adam's second moments, B5 against 'jnp': {len(expert)} candidates on expert leaves, worst "
        f"relative difference {snr_err:.3e}  tol {TOL_SNR:.0e}; all {len(rel)} candidates' worst: "
        + "; ".join(f"{n} {k} fused {a:.6e} jnp {b:.6e}" for _, n, k, a, b in rel[:3])
        + f"; derived rules equal: {rules['fused'] == rules['jnp']}")
    if not snr_err <= TOL_SNR or rules["fused"] != rules["jnp"]:
        raise AssertionError(f"olmoe SNR fused vs jnp: expert candidates {snr_err:.3e}, rules equal "
                             f"{rules['fused'] == rules['jnp']}")
    n_cands = len(rel)
    # B5's three sums on every candidate, the 103 M embedding and head lines included
    sums_err, _ = hold_b5_sums(torch, nu, tr.meta, "olmoe")
    runs["fused_vs_jnp"] = dict(step_check, snr_expert_worst_rel=snr_err, snr_candidates=n_cands,
                                snr_worst=[r[1:] for r in rel[:3]], b5_sums_worst_rel=sums_err)
    for o, t in trainers.items():
        prof = profile_device(torch, lambda t=t: t.run(t.step + 1), 1, med[f"{o}_step_ms"], f"{o} step")
        mega = sum(v for k, v in prof["kernels"] if "mega_adam" in k or "slim_" in k)
        log(f"  {o}: device busy {prof['busy_ms'] / med[f'{o}_step_ms']:.1%} of the step; the megaplan's kernels "
            f"{mega:.3f} ms ({mega / prof['busy_ms']:.1%}) of {prof['busy_ms']:.3f} ms device time")
        runs[f"{o}_profile"] = dict(prof, megaplan_ms=mega)
    # The MoE layers' device time in a step: one layer's forward and its
    # forward + backward alone, at the step's shape (remat runs the forward twice).
    tr = trainers["adam"]
    moe_cfg = cut.moe_cfg()
    p0 = {k.rsplit(".", 1)[1]: v[0].detach().clone().requires_grad_(True) for k, v in tr.params.items()
          if k.startswith("blocks.slot_0.moe.")}
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn((MOE_TRAIN_ROWS, MOE_TRAIN_SEQ, cut.d_model), generator=gen, device=dev).to(cut.dtype)
    x.requires_grad_(True)
    dy = torch.randn(x.shape, generator=gen, device=dev).to(cut.dtype)

    def fwd():
        with torch.no_grad():
            mlp_moe.moe_forward(p0, x, moe_cfg)

    def fwd_bwd():
        y, aux = mlp_moe.moe_forward(p0, x, moe_cfg)
        torch.autograd.grad((y, aux), [x] + list(p0.values()), (dy, torch.ones_like(aux)))

    f_ms, fb_ms = timer(fwd, reps=5), timer(fwd_bwd, reps=5)
    moe_ms = MOE_TRAIN_LAYERS * (f_ms + fb_ms)
    stages = moe_stages(torch, timer, {k: v.detach() for k, v in p0.items()}, x.detach(), moe_cfg)
    busy = runs["adam_profile"]["busy_ms"]
    log(f"  MoE layer at the step's shape: forward {f_ms:.3f} ms, forward + backward {fb_ms:.3f} ms; a step's "
        f"{MOE_TRAIN_LAYERS} layers under remat {moe_ms:.3f} ms = {moe_ms / busy:.1%} of Adam's {busy:.3f} ms device "
        f"time; forward stages " + ", ".join(f"{k} {stages[k]:.4f}" for k in ("router", "sort", "dispatch", "cast",
                                                                               "bmm", "combine")) + " ms")
    runs["moe"] = dict(forward_ms=f_ms, forward_backward_ms=fb_ms, step_ms=moe_ms, share=moe_ms / busy,
                       stages=stages)
    report["train"] = runs
    del trainers, tr, inner, p0, x, dy
    torch.cuda.empty_cache()
    return report, total


def diy_phase(torch, smi: str):
    """Phase 12: the ``repro_torch.examples.diy_slim`` twin on reduced
    jamba (its hybrid period: Mamba and attention mixers, dense and MoE
    FFNs) with ``backend='fused'`` on the card, its probe's first
    DIY_HELD losses against the twin's probe run that far with 'jnp' on the
    CPU (the trainers draw the same weights from a CPU generator on either
    device). Returns (report, launches)."""
    import contextlib
    import io

    from repro_torch import kernels
    from repro_torch.configs import get_reduced
    from repro_torch.examples import diy_slim

    cfg = get_reduced("jamba_v01_52b")
    log(f"[12] examples/diy_slim.py's twin on reduced jamba_v01_52b "
        f"({[(s.mixer, s.ffn) for s in cfg.pattern]}), backend='fused' on the card against 'jnp' on the CPU ({smi})")
    buf = io.StringIO()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = diy_slim.run("fused", "cuda", log_every=1)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    wall = time.perf_counter() - t0
    text = buf.getvalue()
    with contextlib.redirect_stdout(io.StringIO()):
        cpu = diy_slim.run("jnp", "cpu", probe_steps=DIY_HELD, slim_steps=1, snr_every=DIY_HELD, log_every=1)
    lines = text.strip().splitlines()
    log(f"  the twin's run on the card: {wall:.1f} s; {lines[-2]}; {lines[-1]}; its SNR table begins:\n"
        + "\n".join("    " + line for line in lines[1:6]) + "\n    ...")
    probe = [m["loss"] for m in out["probe"].metrics_log]
    held = [m["loss"] for m in cpu["probe"].metrics_log]
    n_mamba = sum(s.mixer == "mamba" for s in cfg.pattern) * cfg.n_periods
    steps = len(out["probe"].metrics_log) + len(out["slim"].metrics_log)
    scans = n_mamba * steps    # reduced jamba trains without remat: one forward scan and one backward a layer a step
    never = [k for k in ("mega_adam_update", "mega_slim_update_batched", "snr_stats_centered_batched") if counts[k] < 1]
    if never or counts["ssm_scan"] != scans or counts["ssm_scan_bwd"] != scans:
        raise AssertionError(f"diy_slim on the card: launches {counts}; {never} never launched, B15 and ssm_scan_bwd "
                             f"expected {scans} each")
    err = max(abs(a - b) / abs(b) for a, b in zip(probe[:DIY_HELD], held))
    final = out["final"]["loss"]
    log(f"  launches { {k: v for k, v in counts.items() if v} }; probe losses card {probe[:DIY_HELD]} cpu {held}: "
        f"worst relative difference {err:.3e} tol {TOL_DIY_LOSS:.0e}; the probe's last {probe[-1]:.4f}, SlimAdam's "
        f"last {final:.4f}")
    if not err <= TOL_DIY_LOSS or not all(map(math.isfinite, probe + [final])) or not probe[-1] < probe[0]:
        raise AssertionError(f"diy_slim: card losses {probe} against the CPU's {held}")
    return dict(launches=counts, wall_s=wall, probe_losses=probe, cpu_losses=held, final_loss=final,
                rules={k: list(v) if v else None for k, v in out["rules"].items()}, savings=out["savings"],
                text=text), counts


# Phases 13-14: the rest of the dense zoo. 13 trains the two encoders
# (hubert_xlarge cut to ZOO_HUBERT_LAYERS, vit_small whole) and internvl2_26b cut to ZOO_VLM_LAYERS layers
# through make_train_step, and times the flash path; 14 serves qwen15_32b,
# command_r_35b and deepseek_67b at full width, depth-cut, through the paged
# engine and qwen15_32b's int8 KV cache through the legacy loop.
ZOO_STEPS = 3
ZOO_LR = 1e-4
ZOO_VLM_LAYERS = 2       # internvl2_26b: Adam's state at 2 layers would not fit; SlimAdam's does
ZOO_HUBERT_LAYERS = 6    # hubert_xlarge at full width, 6 of its 48 layers: the whole run's time (118,626,560 params)
ZOO_SERVE = (("qwen15_32b", 4, 3_659_637_760), ("command_r_35b", 2, 3_506_479_104), ("deepseek_67b", 2, 3_061_882_880))
ZOO_SC = dict(max_seq=576, page_size=16, max_slots=8, prefill_chunk=128)
ZOO_REQUESTS, ZOO_NEW = 4, 16
ZOO_INT8_ROWS, ZOO_INT8_PROMPT, ZOO_INT8_NEW = 2, 64, 16
TOL_ZOO_LOGITS = 5e-2    # full-width logits, kernel against plain attention: bf16 activations, 2-4 layers
INT8_REL, INT8_AGREE = 0.05, 0.95   # the JAX package's int8-cache bars (tests/test_arch_smoke.py)
TOL_INT8_DEQUANT = 1e-5  # int8 decode against its stored rows dequantized in f32: f32 summation order
INT8_ROUND = 0.5 + 1e-3  # a stored row within half a scale step of its K/V, plus f32 rounding


def zoo_train(torch, cfg, batch: dict, smi: str, *, n_params: int, derive: bool) -> tuple:
    """One model trained through ``make_train_step`` on one fixed batch:
    with ``derive``, ZOO_STEPS Adam steps (fused), one SNR measurement of
    its second moments through B5, ``derive_rules``, ZOO_STEPS SlimAdam
    steps with the derived rules, then ZOO_STEPS with Table 3's, each from
    the weights the last left; without, the Table-3 run alone. Launch
    counters are zeroed before each run and read after; the megaplan's
    groups say what each launches. After each run one update from its state
    on fresh gradients, fused against ``make_optimizer(..., backend='jnp')``
    (u, m', v' at TOL_STEP); after Adam's, B5's sums on every candidate
    against its plain twin. The losses must fall over Adam's and the
    derived rules' runs, or over the Table-3 run alone. Returns (report,
    launches summed over the runs)."""
    from repro_torch import kernels
    from repro_torch.core import derive_rules, measure_tree_snr, rules_to_dims, second_moment_savings, table3_rules
    from repro_torch.kernels import megaplan
    from repro_torch.models import Transformer, forward
    from repro_torch.train.loss import lm_loss
    from repro_torch.train.step import make_train_step
    from repro_torch.train.trainer import make_optimizer

    dev = torch.device("cuda")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Transformer(cfg, device=dev, gen=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = sum(p.numel() for p in model.params.values())
    if n != n_params or n != cfg.param_count():
        raise AssertionError(f"{cfg.name}: {n} parameters, expected {n_params}")
    params, meta = model.params, model.meta
    tokens = math.prod(batch["labels"].shape)
    report = dict(params=n, init_s=init_s, tokens=tokens)
    total: dict = {}
    t3 = ("slim_table3", table3_rules(meta))
    runs = (("adam", {}), ("slim_derived", None), t3) if derive else (t3,)
    losses_all, derived = [], None
    for name, rules in runs:
        if rules is None:     # SlimAdam with the rules Adam's SNR derived
            rules = derived
        opt = "adam" if name == "adam" else "slim_snr"
        tx = make_optimizer(opt, ZOO_LR, params, meta, backend="fused", rules=rules)
        dims = rules_to_dims(rules, meta)
        plan = megaplan.plan_megagroups([tuple(p.shape) for p in params.values()], [p.dtype for p in params.values()],
                                        [dims[k] for k in params])
        dense = sum(g.kind == "dense" for g in plan.groups)
        cands = sum(len(m.candidate_ks()) for m in meta.values())
        expect = {"mega_adam_update": dense * ZOO_STEPS,
                  "mega_slim_update_batched": (len(plan.groups) - dense) * ZOO_STEPS,
                  "snr_stats_centered_batched": cands if name == "adam" else 0}
        step, state = make_train_step(model, tx), tx.init(params)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        losses, host, peaks = [], [], []
        for _ in range(ZOO_STEPS):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
            peaks.append((torch.cuda.max_memory_allocated() - base) / 2**30)
        inner = state.inner_states[1]
        if name == "adam":
            t0 = time.perf_counter()
            snr = measure_tree_snr(inner.nu, meta, backend="fused")
            snr = {k: {lab: float(x) for lab, x in v.items()} for k, v in snr.items()}
            report["snr_measure_ms"] = (time.perf_counter() - t0) * 1e3
            report["snr"] = snr
            derived = derive_rules(snr, meta)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        for k, want in expect.items():
            if counts[k] != want:
                raise AssertionError(f"{cfg.name} {name}: {k} launched {counts[k]} times, expected {want}")
        others = {k: v for k, v in counts.items() if v and k not in expect}
        if others:
            raise AssertionError(f"{cfg.name} {name}: unexpected launches {others}")
        if not all(map(math.isfinite, losses)):
            raise AssertionError(f"{cfg.name} {name}: losses {losses}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        if name != "slim_table3" or not derive:
            # the losses must fall over Adam's run and the derived rules' (from Adam's weights), or
            # over the Table-3 run alone; a Table-3 run after those restarts the moments and is
            # held by its update against 'jnp' below
            losses_all += losses
        nu_bytes = sum(t.numel() * t.element_size() for t in inner.nu.values())
        sav = second_moment_savings(params, meta, rules)
        busy = ""
        if name == runs[0][0]:    # one step's device profile a model (hubert's takes ~17 s on the host)
            t0 = time.perf_counter()
            report["profile"] = prof = profile_device(torch, lambda: step(state, batch), 1,
                                                      statistics.median(host[1:]), f"{cfg.name} {name} step")
            prof["profile_s"] = time.perf_counter() - t0
            busy = (f"; device busy {prof['busy_ms']:.1f} of {prof['wall_ms']:.1f} ms "
                    f"({prof['busy_ms'] / prof['wall_ms']:.1%}; the profile took {prof['profile_s']:.1f} s)")
        log(f"  {cfg.name} {name}: steps {[round(x, 1) for x in host]} ms on the host ({tokens} tokens a step), "
            f"losses {[round(x, 4) for x in losses]}, launches { {k: v for k, v in counts.items() if v} }, peak "
            f"{max(peaks):.2f} GiB over the start, second moments {nu_bytes / 2**30:.4f} GiB "
            f"({sav['saved_fraction']:.4%} saved; {len(plan.groups)} megaplan groups, {dense} dense){busy} ({smi})")
        # one update from this run's state on fresh gradients: fused (B2, B1) against 'jnp'
        loss, _ = lm_loss(cfg, params, batch, forward)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        del loss
        worst = {}
        with torch.no_grad():
            got = {}
            for backend in ("fused", "jnp"):
                txb = tx if backend == "fused" else make_optimizer(opt, ZOO_LR, params, meta, backend="jnp",
                                                                   rules=rules)
                u, new = txb.update(grads, state, params)
                got[backend] = {"u": u, "m": new.inner_states[1].mu, "v": new.inner_states[1].nu}
                del u, new, txb
            for what in ("u", "m", "v"):
                worst[what] = max(max_err(got["fused"][what][k], got["jnp"][what][k])[1] for k in params)
        del got, grads
        torch.cuda.empty_cache()
        log(f"  {cfg.name} {name}: one update from this state, fused against backend='jnp' on the same gradients: "
            f"worst relative error u {worst['u']:.3e}  m {worst['m']:.3e}  v {worst['v']:.3e}  tol {TOL_STEP:.0e}")
        if max(worst.values()) > TOL_STEP:
            raise AssertionError(f"{cfg.name} {name} fused vs jnp: {worst} above {TOL_STEP:.0e}")
        report[name] = dict(losses=losses, host_ms=host, peak_gib=max(peaks), launches=counts, nu_bytes=nu_bytes,
                            savings=sav, groups=[(g.kind, g.batch, g.rows, g.cols, g.axis) for g in plan.groups],
                            rules={k: list(v) if v else None for k, v in rules.items()}, fused_vs_jnp=worst)
        if name == "adam":
            report["b5_sums_worst_rel"], report["b5_candidates"] = hold_b5_sums(torch, inner.nu, meta, cfg.name)
        del tx, step, state, inner
        torch.cuda.empty_cache()
    if not losses_all[-1] < losses_all[0]:
        raise AssertionError(f"{cfg.name}: losses {losses_all} do not fall on a repeated batch")
    if total.get("mega_slim_update_batched", 0) < 1:
        raise AssertionError(f"{cfg.name}: SlimAdam never launched mega_slim_update_batched")
    if derive:
        report["derived_rules"] = {k: list(v) for k, v in derived.items() if v}
        log(f"  {cfg.name}: rules derived from Adam's SNR after {ZOO_STEPS} steps: {report['derived_rules']}; "
            f"SNR measurement {report['snr_measure_ms']:.1f} ms on the host")
    del model, params
    torch.cuda.empty_cache()
    return report, total


def flash_timings(torch, timer, smi: str) -> dict:
    """``flash_attention``'s forward and backward at hubert_xlarge's and
    internvl2_26b's shapes (bf16), each beside one
    ``scaled_dot_product_attention`` call on the same tensors (a yardstick,
    not a port: JAX computes attention in plain jnp), and the two outputs'
    largest difference."""
    import torch.nn.functional as F

    from repro_torch.models import attention as tattn

    out = {}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(13)
    for name, (b, s, h, kv, hd, causal) in {"hubert_xlarge": (2, 4096, 16, 16, 80, False),
                                            "internvl2_26b": (1, 4352, 48, 8, 128, True)}.items():
        block = tattn._largest_block(s, 1024)
        q = torch.randn((b, s, h, hd), generator=gen, device=dev).to(torch.bfloat16).requires_grad_(True)
        k, v = (torch.randn((b, s, kv, hd), generator=gen, device=dev).to(torch.bfloat16).requires_grad_(True)
                for _ in range(2))
        dy = torch.randn((b, s, h, hd), generator=gen, device=dev).to(torch.bfloat16)

        def flash():
            return tattn.flash_attention(q, tattn._repeat_kv(k, h // kv), tattn._repeat_kv(v, h // kv), causal, block)

        def sdpa():
            return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                                  is_causal=causal, enable_gqa=True).transpose(1, 2)

        row = {"block": block}
        for label, fn in (("flash", flash), ("sdpa", sdpa)):
            with torch.no_grad():
                row[f"{label}_fwd_ms"] = timer(fn, reps=3)
            y = fn()
            row[f"{label}_bwd_ms"] = timer(lambda: torch.autograd.grad(y, (q, k, v), dy, retain_graph=True), reps=3)
            row[f"{label}_out"] = y.detach()
            del y
        diff = float((row.pop("flash_out").float() - row["sdpa_out"].float()).abs().max())
        row["max_abs_diff"] = diff / float(row.pop("sdpa_out").float().abs().max())
        log(f"  flash attention at {name}'s shape ({b} x {s}, {h} heads of {hd} over {kv} KV groups, "
            f"{'causal' if causal else 'non-causal'}, blocks of {block}, bf16): forward {row['flash_fwd_ms']:.3f} ms, "
            f"backward {row['flash_bwd_ms']:.3f} ms; SDPA {row['sdpa_fwd_ms']:.3f} / {row['sdpa_bwd_ms']:.3f} ms "
            f"({row['flash_fwd_ms'] / row['sdpa_fwd_ms']:.1f}x / {row['flash_bwd_ms'] / row['sdpa_bwd_ms']:.1f}x); "
            f"outputs {row['max_abs_diff']:.2e} of max apart ({smi})")
        out[name] = row
        del q, k, v, dy
        torch.cuda.empty_cache()
    return out


def zoo_train_phase(torch, timer, smi: str):
    """Phase 13: hubert_xlarge cut to ZOO_HUBERT_LAYERS layers and vit_small whole, Adam with SNR, then
    derived and Table-3 SlimAdam; internvl2_26b cut to ZOO_VLM_LAYERS layers
    at 256 frontend rows + 4096 tokens, Table-3 SlimAdam; each run's update
    held against 'jnp'; flash timings. Returns (report, launches)."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, ZipfLM

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    report, total = {}, {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    cfg = get_config("hubert_xlarge", n_layers=ZOO_HUBERT_LAYERS)
    log(f"[13a] hubert_xlarge at full width cut to {cfg.n_layers} of 48 layers (d {cfg.d_model}, {cfg.n_heads} "
        f"heads of {cfg.hd}, non-causal), 2 x 4096 frame embeddings (flash path, blocks of 1024), bf16, remat, lr {ZOO_LR}: Adam with "
        f"SNR, derived SlimAdam, Table-3 SlimAdam ({smi})")
    batch = {"frontend_embeds": torch.randn((2, 4096, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16),
             "labels": torch.randint(0, cfg.vocab_size, (2, 4096), generator=gen, device=dev)}
    report["hubert_xlarge"], counts = zoo_train(torch, cfg, batch, smi, n_params=118_626_560, derive=True)
    add(counts)

    cfg = get_config("vit_small")
    log(f"[13b] vit_small whole ({cfg.n_layers} layers, d {cfg.d_model}), 32 x 256 patches of {cfg.input_proj_dim} "
        f"(CIFAR at patch 2), learned positions, dense non-causal attention, bf16, remat: Adam with SNR, derived "
        f"SlimAdam, Table-3 SlimAdam ({smi})")
    batch = {"patches": torch.randn((32, 256, cfg.input_proj_dim), generator=gen, device=dev).to(torch.bfloat16),
             "labels": torch.randint(0, cfg.vocab_size, (32, 256), generator=gen, device=dev)}
    report["vit_small"], counts = zoo_train(torch, cfg, batch, smi, n_params=85_237_248, derive=True)
    add(counts)

    cfg = get_config("internvl2_26b", n_layers=ZOO_VLM_LAYERS)
    data = ZipfLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=4096, global_batch=1, seed=0)).batch(0)
    log(f"[13c] internvl2_26b at full width cut to {ZOO_VLM_LAYERS} of 48 layers, 1 x ({cfg.extra_embed_len} frontend "
        f"rows + 4096 ZipfLM tokens) = {cfg.extra_embed_len + 4096} positions (causal flash, GQA rep "
        f"{cfg.n_heads // cfg.n_kv_heads}), the loss on the text positions, Table-3 SlimAdam ({smi})")
    batch = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
    batch["frontend_embeds"] = torch.randn((1, cfg.extra_embed_len, cfg.d_model), generator=gen,
                                           device=dev).to(torch.bfloat16)
    report["internvl2_26b"], counts = zoo_train(torch, cfg, batch, smi, n_params=1_917_462_528, derive=False)
    add(counts)
    del batch
    torch.cuda.empty_cache()
    log("[13d] flash attention against one SDPA call (a yardstick)")
    report["flash"] = flash_timings(torch, timer, smi)
    return report, total


def zoo_serve_phase(torch, timer, rate: float, smi: str):
    """Phase 14: B14 at qwen15_32b's and at command_r_35b's / deepseek_67b's
    geometry; the three served at full width, depth-cut, through the paged
    engine; qwen15_32b's int8 KV cache through the legacy loop against the
    bf16 cache. Returns (report, launches of the counted runs)."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import Transformer
    from repro_torch.models.transformer import init_paged_pools, paged_prefill_chunk
    from repro_torch.serve import Engine, Request, ServeConfig

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(14)
    rng = np.random.default_rng(14)
    report: dict = {}
    total: dict = {}
    seen = set()
    for arch, layers, n_params in ZOO_SERVE:
        cfg = get_config(arch, n_layers=layers)
        geometry = (cfg.n_heads, cfg.n_kv_heads, cfg.hd)
        if geometry not in seen:
            seen.add(geometry)
            log(f"[14a] paged_attention (B14) at {arch}'s geometry ({cfg.n_heads} heads of {cfg.hd} over "
                f"{cfg.n_kv_heads} KV groups) against its plain twin, bound, SDPA; each case twice, bit for bit "
                f"({smi})")
            hold_b14(torch, timer, rate, gen, rng, arch, heads=cfg.n_heads, kv=cfg.n_kv_heads, hd=cfg.hd, sc=ZOO_SC)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = Transformer(cfg, device=dev, gen=torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n = sum(p.numel() for p in model.params.values())
        if n != n_params or n != cfg.param_count():
            raise AssertionError(f"{arch} at {layers} layers has {n} parameters, expected {n_params}")
        params = model.params
        log(f"[14b] {arch} at full width cut to {layers} layers ({n} parameters, {n * 4 / 1e9:.1f} GB f32 drawn on the "
            f"card in {init_s:.1f} s), bf16 activations, {ZOO_REQUESTS} requests x {ZOO_NEW} greedy tokens, {ZOO_SC}")
        eng = Engine(cfg, params, ServeConfig(**ZOO_SC))
        del model
        prompts = [rng.integers(0, cfg.vocab_size, int(k), dtype=np.int32) for k in rng.integers(64, 513, ZOO_REQUESTS)]
        rids = [eng.submit(Request(prompt=p, max_new_tokens=ZOO_NEW)) for p in prompts]
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        done = eng.run_until_drained()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = kernels.launch_counts()
        m = eng.metrics()
        bad = [c_ for c_ in done.values() if c_.finish_reason != "length" or len(c_.tokens) != ZOO_NEW]
        if len(done) != ZOO_REQUESTS or bad or m.used_pages != 0:
            raise AssertionError(f"{arch} serving: {len(done)} completions, unfinished {[c_.id for c_ in bad]}")
        assert_clean(m, f"phase 14 {arch}")
        want = cfg.n_layers * (m.decode_steps + m.prefill_chunks)
        if counts["paged_attention"] != want or sum(counts.values()) != want:
            raise AssertionError(f"{arch} launches {counts}, expected paged_attention {want} and no other kernel")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        # the first prefill chunk through B14 against the plain twin; a chunk's host and device time
        page, c = ZOO_SC["page_size"], ZOO_SC["prefill_chunk"]
        max_pages = -(-ZOO_SC["max_seq"] // page)
        table, n_pages = page_table(torch, [len(p) + ZOO_NEW for p in prompts], page, max_pages)
        pools_k = init_paged_pools(cfg, n_pages, page, torch.bfloat16, dev)
        pools_p = {k: v.clone() for k, v in pools_k.items()}
        first = torch.from_numpy(prompts[0][:c][None].copy()).to(dev)
        lk, _, _ = paged_prefill_chunk(cfg, params, pools_k, table[:1], 0, c, first)
        lp, _, _ = paged_prefill_chunk(cfg, params, pools_p, table[:1], 0, c, first, attn_impl="plain")
        rel = check(f"{arch} first prefill chunk logits", lk.float(), lp.float(), TOL_ZOO_LOGITS) \
            / float(lp.float().abs().max())
        prefill_ms = host_ms(torch, lambda: paged_prefill_chunk(cfg, params, pools_k, table[:1], 0, c, first), 3)
        prof = profile_device(torch, lambda: paged_prefill_chunk(cfg, params, pools_k, table[:1], 0, c, first), 2,
                              prefill_ms, "prefill chunk")
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        log(f"  drained in {wall:.2f} s: {m.tokens_out} tokens, {m.decode_steps} decode steps, {m.prefill_chunks} "
            f"prefill chunks, mean TTFT {m.ttft_mean_s * 1e3:.1f} ms, mean TPOT {m.tpot_mean_s * 1e3:.2f} ms; B14 "
            f"{counts['paged_attention']} launches; a {c}-token prefill chunk {prefill_ms:.2f} ms on the host, device "
            f"busy {prof['busy_ms'] / prefill_ms:.1%}; first chunk's logits {rel:.3e} of max from the plain twin's; "
            f"peak {peak:.2f} GiB over the start ({smi})")
        report[arch] = dict(layers=layers, params=n, init_s=init_s, wall_s=wall, metrics=m.to_dict(), launches=counts,
                            tokens={i: done[r].tokens.tolist() for i, r in enumerate(rids)}, prefill_logits_rel=rel,
                            prefill_chunk_ms=prefill_ms, prefill_profile=prof, peak_gib=peak)
        del pools_k, pools_p, lk, lp, eng
        torch.cuda.empty_cache()
        if arch == "qwen15_32b":
            report["int8_kv"] = int8_phase(torch, cfg, params, rng, smi)
        del params
        torch.cuda.empty_cache()
    return report, total


def int8_reference(torch, cfg, params, tokens, cache):
    """The int8 cache's decode in plain f32, teacher-forced over ``tokens``:
    at step t each layer attends over the rows [0, t] that the int8 path
    stored in ``cache`` (its cache after the same tokens), dequantized as
    int8 * scale in f32, through ``dense_attention``; the rest of the layer
    as ``decode_step`` runs it. Also returns the stored rows' largest
    distance from this path's own K/V in units of the stored row's scale
    (rounding to nearest keeps it at 1/2). Returns (logits (B, S, V) f32,
    that distance)."""
    from repro_torch.models import attention as tattn
    from repro_torch.models import transformer as tf
    from repro_torch.models.common import rotary_embedding

    rep = cfg.n_heads // cfg.n_kv_heads
    rows, dist = [], 0.0
    with torch.no_grad():
        for t in range(tokens.shape[1]):
            x = params["embed"][tokens[:, t:t + 1].long()].to(cfg.dtype)
            sincos = rotary_embedding(torch.tensor([t], device=tokens.device), cfg.hd, cfg.attn_cfg().rope_base)
            for period, i, slot, p in tf._layers(cfg, params):
                c = cache.slots[f"slot_{i}"]
                q, k, v = tattn._project_qkv(p["attn"], tf._norm(cfg, p["mixer_norm"], x), sincos)
                kd = c.k[period, :, :t + 1].float() * c.k_scale[period, :, :t + 1, :, None]
                vd = c.v[period, :, :t + 1].float() * c.v_scale[period, :, :t + 1, :, None]
                for new, deq, sc in ((k, kd, c.k_scale), (v, vd, c.v_scale)):
                    dist = max(dist, float(((deq[:, t:] - new.float()).abs() / sc[period, :, t:t + 1, :, None]).max()))
                o = tattn.dense_attention(q.float(), tattn._repeat_kv(kd, rep), tattn._repeat_kv(vd, rep),
                                          causal=False)
                x = x + torch.einsum("bshk,hkd->bsd", o.to(x.dtype), p["attn"]["wo"].to(x.dtype))
                x, _ = tf._ffn(cfg, slot, p, x, with_aux=False)
            rows.append(tf._logits(cfg, params, x)[:, 0].float())
    return torch.stack(rows, dim=1), dist


def int8_phase(torch, cfg, params, rng, smi: str) -> dict:
    """Phase 14c: qwen15_32b's ``optimized()`` (the int8 KV cache) at the
    served cut through ``Engine.generate``'s legacy loop, then the same
    tokens fed through ``decode_step``: in f32 activations, the int8 cache's
    logits against ``int8_reference`` (its stored rows dequantized in f32)
    within TOL_INT8_DEQUANT of max|logit|, and the stored rows within half a
    scale step of the K/V they quantize; in the path's bf16, the int8 against
    the bf16 cache within INT8_REL of max|logit|, and their greedy agreement
    above INT8_AGREE on the positions whose bf16 top-2 margin exceeds that
    measured deviation (the rest, random weights over a 152,064-row
    vocabulary with margins of a few % of max|logit|, are reported). Then
    the JAX test itself on the card: reduced f32 qwen15_32b (weights from
    seed 0), int8 decode against its forward, max|dlogit| / max|logit| <
    INT8_REL and greedy agreement > INT8_AGREE."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_optimized
    from repro_torch.models import Transformer, forward
    from repro_torch.models.transformer import decode_step, init_decode_cache
    from repro_torch.serve import Engine, ServeConfig

    qcfg = dataclasses.replace(get_optimized("qwen15_32b"), n_layers=cfg.n_layers)
    if qcfg != dataclasses.replace(cfg, kv_quant=True):
        raise AssertionError("qwen15_32b's optimized() differs from its config() by more than the int8 KV cache")
    max_seq = ZOO_INT8_PROMPT + ZOO_INT8_NEW
    prompts = rng.integers(0, cfg.vocab_size, (ZOO_INT8_ROWS, ZOO_INT8_PROMPT), dtype=np.int32)
    eng = Engine(qcfg, params, ServeConfig(max_seq=max_seq, max_new_tokens=ZOO_INT8_NEW))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.generate(prompts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    if out.shape != (ZOO_INT8_ROWS, max_seq) or eng.decode_steps != max_seq - 1 or counts:
        raise AssertionError(f"int8 legacy loop: out {tuple(out.shape)}, {eng.decode_steps} steps, launches {counts}")
    tokens = out.to(torch.device("cuda"))

    def teacher_forced(c, model_params, toks, dtype):
        cache = init_decode_cache(c, toks.shape[0], max_seq, dtype, device=toks.device)
        rows = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(toks.shape[1]):
            lg, cache = decode_step(c, model_params, cache, toks[:, t:t + 1])
            rows.append(lg[:, 0].float())
        torch.cuda.synchronize()
        nbytes = sum(t.numel() * t.element_size() for t in cache.slots["slot_0"][:4])
        return torch.stack(rows, dim=1), (time.perf_counter() - t0) / toks.shape[1] * 1e3, nbytes, cache

    # the int8 path in f32 against its stored rows dequantized in f32
    fcfg = dataclasses.replace(qcfg, dtype=torch.float32)
    f_int8, _, _, f_cache = teacher_forced(fcfg, params, tokens, torch.float32)
    f_ref, dist = int8_reference(torch, fcfg, params, tokens, f_cache)
    tight = float((f_int8 - f_ref).abs().max()) / float(f_ref.abs().max())
    del f_int8, f_ref, f_cache
    log(f"[14c] qwen15_32b optimized() (int8 KV) at {cfg.n_layers} layers, f32 activations: int8 decode logits against "
        f"the plain f32 path over the same stored rows dequantized (int8 * scale): max|dlogit| / max|logit| "
        f"{tight:.3e}  tol {TOL_INT8_DEQUANT:.0e}; stored rows within {dist:.4f} of a scale step of the K/V they "
        f"quantize (tol {INT8_ROUND})")
    if not (tight <= TOL_INT8_DEQUANT and dist <= INT8_ROUND):
        raise AssertionError(f"int8 KV cache at full width against its dequantized f32 twin: {tight:.3e}, "
                             f"rounding {dist:.4f}")
    a, int8_ms, int8_bytes, _ = teacher_forced(qcfg, params, tokens, torch.bfloat16)
    b, bf16_ms, bf16_bytes, _ = teacher_forced(cfg, params, tokens, torch.bfloat16)
    scale = float(b.abs().max())
    rel = float((a - b).abs().max()) / scale
    flips = a.argmax(-1) != b.argmax(-1)
    agree = 1.0 - float(flips.float().mean())
    top2 = b.topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]) / scale
    clear = margin > rel
    agree_clear = 1.0 - float(flips[clear].float().mean()) if clear.any() else float("nan")
    log(f"  through the legacy loop: {ZOO_INT8_ROWS} rows x {ZOO_INT8_PROMPT} + {ZOO_INT8_NEW} greedy in {wall:.2f} s "
        f"({eng.decode_steps} decode steps, no kernel); the same {max_seq} tokens teacher-forced in bf16, int8 against "
        f"bf16 cache: max|dlogit| / max|logit| {rel:.3e} (held < {INT8_REL}); greedy agreement {agree_clear:.4f} on the "
        f"{int(clear.sum())} of {clear.numel()} positions whose bf16 top-2 margin exceeds {rel:.3e} (held > "
        f"{INT8_AGREE}), {agree:.4f} on all; {int(flips.sum())} flips at margins {margin[flips].tolist()[:8]} of "
        f"max|logit| (median margin {float(margin.median()):.3e}); decode step {int8_ms:.2f} / {bf16_ms:.2f} ms on "
        f"the host; cache {int8_bytes} / {bf16_bytes} bytes ({smi})")
    if not (rel < INT8_REL and agree_clear > INT8_AGREE):
        raise AssertionError(f"int8 KV cache at full width: rel {rel:.3e}, agreement {agree_clear:.4f} on "
                             f"{int(clear.sum())} positions")
    # The JAX test's setting (tests/test_arch_smoke.py::test_int8_kv_cache_decode) on the card.
    rcfg = get_optimized("qwen15_32b", reduced=True)
    rparams = {k: v.to(tokens.device) for k, v in
               Transformer(rcfg, device="cpu", gen=torch.Generator().manual_seed(0)).params.items()}
    rtoks = torch.from_numpy(np.random.default_rng(1).integers(0, rcfg.vocab_size, (2, 12), dtype=np.int32))
    rtoks = rtoks.to(tokens.device)
    with torch.no_grad():
        full, _ = forward(rcfg, rparams, {"tokens": rtoks})
    dec, _, _, _ = teacher_forced(rcfg, rparams, rtoks, torch.float32)
    r_rel = float((dec - full.float()).abs().max()) / float(full.abs().max())
    r_agree = float((dec.argmax(-1) == full.argmax(-1)).float().mean())
    log(f"  the JAX test on the card: reduced f32 qwen15_32b, int8 decode against its forward: max|dlogit| / "
        f"max|logit| {r_rel:.3e} < {INT8_REL}, greedy agreement {r_agree:.4f} > {INT8_AGREE}")
    if not (r_rel < INT8_REL and r_agree > INT8_AGREE):
        raise AssertionError(f"int8 KV cache, reduced: rel {r_rel:.3e}, agreement {r_agree:.4f}")
    return dict(wall_s=wall, decode_steps=eng.decode_steps, dequant_rel=tight, round_dist=dist, rel=rel,
                agree_clear=agree_clear, clear_positions=int(clear.sum()), agree=agree, flips=int(flips.sum()),
                flip_margins=margin[flips].tolist(), median_margin=float(margin.median()), int8_step_ms=int8_ms,
                bf16_step_ms=bf16_ms, int8_cache_bytes=int8_bytes, bf16_cache_bytes=bf16_bytes, reduced_rel=r_rel,
                reduced_agree=r_agree, tokens=out.tolist())


# -- the serving fault layer and the jamba period (phase 15) -------------------------

# 15b: benchmarks/serve_drill.py's plan scaled to phase 5's 32 requests, whose
# clean run takes 189 decode steps and 246 prefill chunks (the scheduler's
# counts do not depend on the weights): kernel failures at decode steps 2, 60
# and 150 and prefill chunks 1 and 120, request 2 poisoned after 2 tokens, 400
# of the 799 pages squeezed over scheduler steps [1, 9), a 60 s stall at step
# 1 against the last request's 30 s deadline.
FAULT_PLAN_FULL = dict(kernel_fail_steps=(2, 60, 150), prefill_fail_chunks=(1, 120), poison_rids=(2,), poison_after=2,
                       squeeze_window=(1, 9), squeeze_pages=400, stall_steps=(1,), stall_s=60.0)
FAULT_DEADLINE_FULL_S = 30.0
# 15c: one full-width period of jamba_v01_52b (8 of its 32 layers: 7 Mamba,
# 1 attention, 4 MoE FFNs), served through make_serve_step.
JAMBA_LAYERS, JAMBA_PARAMS = 8, 13_295_235_072
JAMBA_ROWS, JAMBA_PROMPT, JAMBA_NEW = 4, 16, 16


def assert_clean(m, label: str) -> None:
    """A clean serving run degrades no step and applies no injection."""
    if m.degraded_steps or m.injected_stalls or m.injected_poison:
        raise AssertionError(f"{label}: degraded_steps {m.degraded_steps}, injected_stalls {m.injected_stalls}, "
                             f"injected_poison {m.injected_poison} in a run without a fault plan")


def serve_requests(cfg):
    """Phase 5's 32 requests: prompts of 64-1536 tokens from seed 0, 64 new
    tokens, greedy but for the last 4 (temperature 0.8, seeded)."""
    import numpy as np

    from repro_torch.serve import Request

    rng = np.random.default_rng(0)
    prompt_lens = rng.integers(64, 1537, SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, n, dtype=np.int32) for n in prompt_lens]
    return prompt_lens, [Request(prompt=p, max_new_tokens=SERVE_NEW, temperature=0.8 if i >= SERVE_GREEDY else 0.0,
                                 seed=i if i >= SERVE_GREEDY else None) for i, p in enumerate(prompts)]


def fault_phase(torch, rate: float, smi: str, clean_tokens):
    """Phase 15: the serving fault layer on the card (15a serve_drill's own
    run, 15b its plan on phase 5's full-width engine against phase 5's
    ``clean_tokens``), then 15c jamba_v01_52b's full-width period through
    ``make_serve_step``. Returns (report, launches of the counted runs)."""
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import decode_input_specs, get_config, get_reduced
    from repro_torch.kernels import paged_attention as pa, ssm_scan as sc
    from repro_torch.models import Transformer
    from repro_torch.models.transformer import decode_step, init_decode_cache
    from repro_torch.serve import Engine, Request, ServeConfig, ServeFaultPlan
    from repro_torch.serve.drill import DRILL_PLAN, DRILL_SC, MAX_SCHED_STEPS, admission_check, run_drill
    from repro_torch.train import make_serve_step

    dev = torch.device("cuda")
    report: dict = {}
    launches: dict = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

    # -- 15a. serve_drill's own run -------------------------------------------
    rcfg = get_reduced("gpt_small")
    log(f"[15a] serve_drill's run on the card: reduced f32 gpt_small (weights from seed 0), 6 requests of 8 tokens "
        f"(seed 1), {DRILL_SC}, {DRILL_PLAN}, the last request's deadline 5 s; clean run, then injected ({smi})")
    rparams = Transformer(rcfg, device="cpu", gen=torch.Generator().manual_seed(0)).params
    prompts = np.random.default_rng(1).integers(0, rcfg.vocab_size, (6, 8), dtype=np.int32)
    kernels.reset_launch_counts()
    res = run_drill(rcfg, rparams, [Request(prompt=p) for p in prompts], device=dev)
    counts = kernels.launch_counts()
    m = res.metrics
    want = rcfg.n_layers * (m.decode_steps + m.prefill_chunks - m.degraded_steps)
    log(f"  injected run: reasons {res.reasons}; {m.decode_steps} decode steps, {m.prefill_chunks} prefill chunks, "
        f"degraded {m.degraded_steps}, nan {m.nan_retired}, deadline {m.deadline_expired}, stalls "
        f"{m.injected_stalls}, preempted {m.preempted}, backoffs {m.livelock_backoffs}, {m.sched_steps} scheduler "
        f"steps (<= {MAX_SCHED_STEPS}); B14 launched {res.kernel_launches} times = {rcfg.n_layers} layers x "
        f"({m.decode_steps} + {m.prefill_chunks} - {m.degraded_steps}) = {want}")
    if res.failures or res.deviations:
        raise AssertionError(f"serve_drill's gates on the card: {res.failures + res.deviations}")
    if res.kernel_launches != want or sum(counts.values()) != counts["paged_attention"]:
        raise AssertionError(f"B14 launched {res.kernel_launches} times in the injected run, expected {want}; "
                             f"launches {counts}")
    adm = admission_check(rcfg, rparams, np.random.default_rng(1).integers(0, rcfg.vocab_size, (8, 8),
                                                                           dtype=np.int32), device=dev)
    if adm:
        raise AssertionError(f"serve_drill's admission check on the card: {adm}")
    log("  gates (a) drained, (b) greedy parity and the poisoned prefix, (c) no leak, (d) every injection counted: "
        "all hold; admission control: Rejected verdicts counted, the accepted drained")
    add(counts)
    report["drill"] = dict(metrics=m.to_dict(), reasons=res.reasons, tokens=res.tokens,
                           kernel_launches=res.kernel_launches, launches=counts)

    # -- 15b. the plan scaled to phase 5's full-width engine ------------------
    cfg = get_config("smollm_135m", n_layers=SERVE_LAYERS)
    plan = ServeFaultPlan(**FAULT_PLAN_FULL)
    log(f"[15b] the fault plan on phase 5's engine: full-width smollm_135m cut to {cfg.n_layers} layers (weights "
        f"from seed 0, as phase 5), its 32 "
        f"requests, {SERVE_SC}, {plan}, the last request's deadline {FAULT_DEADLINE_FULL_S} s; each degraded step's "
        f"logits held against the kernel's on the same state, tolerance {TOL_SERVE_LOGITS:.0e} of max|logit| ({smi})")
    params = Transformer(cfg, device=dev, gen=torch.Generator().manual_seed(0)).params
    _, reqs = serve_requests(cfg)
    compared, extra = [], [0]

    def observe(eng):
        """Rerun every degraded step or chunk through the kernel from the
        same pools, compare its logits, then restore the degraded state."""
        guarded = eng._guarded

        def checked(kind, index, run):
            def run_checked(impl):
                if impl != "plain":
                    return run(impl)
                pools = eng._device_pools()
                before = {k: v.clone() for k, v in pools.items()}
                out = run("plain")
                after = {k: v.clone() for k, v in pools.items()}
                for k, v in pools.items():
                    v.copy_(before[k])
                n0 = pa.paged_attention.launches
                ref = run("kernel")
                extra[0] += pa.paged_attention.launches - n0
                err = check(f"degraded {kind} #{index} logits against the kernel's", out[0].float(), ref[0].float(),
                            TOL_SERVE_LOGITS)
                compared.append(dict(kind=kind, index=index, rel=err / float(ref[0].float().abs().max())))
                for k, v in pools.items():
                    v.copy_(after[k])
                return out
            return guarded(kind, index, run_checked)

        eng._guarded = checked

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = run_drill(cfg, params, reqs, sc=ServeConfig(**SERVE_SC), plan=plan, deadline_s=FAULT_DEADLINE_FULL_S,
                    device=dev, clean_tokens=clean_tokens, on_engine=observe)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    m = res.metrics
    counted = res.kernel_launches - extra[0]
    want = cfg.n_layers * (m.decode_steps + m.prefill_chunks - m.degraded_steps)
    judged = [i for i in range(SERVE_REQUESTS) if i not in plan.poison_rids and i != SERVE_REQUESTS - 1]
    same = sum(int(a == b) for i in judged for a, b in zip(res.tokens[i], res.clean_tokens[i]))
    total = sum(len(res.clean_tokens[i]) for i in judged)
    log(f"  drained in {wall:.2f} s: {m.decode_steps} decode steps, {m.prefill_chunks} prefill chunks, degraded "
        f"{m.degraded_steps}, nan {m.nan_retired}, deadline {m.deadline_expired}, stalls {m.injected_stalls}, "
        f"preempted {m.preempted}, backoffs {m.livelock_backoffs}, {m.sched_steps} scheduler steps; B14 "
        f"{counted} launches = {cfg.n_layers} x ({m.decode_steps} + {m.prefill_chunks} - {m.degraded_steps}) (and "
        f"{extra[0]} to compare); tokens equal to phase 5's clean run at {same} of {total} positions of the "
        f"{len(judged)} requests neither poisoned nor past the deadline, {len(res.deviations)} requests deviate "
        f"(reported, not required: bf16 activations, random weights' near-ties) ({smi})")
    if res.failures:
        raise AssertionError(f"the fault plan at full width: {res.failures}")
    if counted != want or sum(counts.values()) != counts["paged_attention"]:
        raise AssertionError(f"B14 launched {counted} times in the injected run (less {extra[0]} to compare), "
                             f"expected {want}; launches {counts}")
    if len(compared) != m.degraded_steps:
        raise AssertionError(f"{len(compared)} degraded steps compared, {m.degraded_steps} degraded")
    launches["paged_attention"] = launches.get("paged_attention", 0) + counted
    report["full_width"] = dict(plan=FAULT_PLAN_FULL, deadline_s=FAULT_DEADLINE_FULL_S, wall_s=wall,
                                metrics=m.to_dict(), reasons=res.reasons, kernel_launches=counted,
                                compare_launches=extra[0], degraded_vs_kernel=compared, tokens_equal=same,
                                tokens_judged=total, deviations=res.deviations)
    del params, res
    torch.cuda.empty_cache()

    # -- 15c. jamba_v01_52b, one full-width period ------------------------------
    cut = get_config("jamba_v01_52b", n_layers=JAMBA_LAYERS)
    n_mamba = sum(s.mixer == "mamba" for s in cut.pattern) * cut.n_periods
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Transformer(cut, device=dev, gen=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = sum(p.numel() for p in model.params.values())
    p_bytes = sum(p.numel() * p.element_size() for p in model.params.values())
    if n != JAMBA_PARAMS or n != cut.param_count():
        raise AssertionError(f"jamba_v01_52b at {JAMBA_LAYERS} layers has {n} parameters, expected {JAMBA_PARAMS}")
    params = model.params
    del model
    log(f"[15c] jamba_v01_52b at full width, one period ({JAMBA_LAYERS} of 32 layers: {n_mamba} Mamba, 1 attention, "
        f"4 MoE FFNs; {n} parameters, {p_bytes / 2**30:.2f} GiB f32 drawn on the card in {init_s:.1f} s), bf16 "
        f"activations, {JAMBA_ROWS} prompts x {JAMBA_PROMPT} tokens + {JAMBA_NEW} greedy through make_serve_step "
        f"({smi})")
    prompts = np.random.default_rng(15).integers(0, cut.vocab_size, (JAMBA_ROWS, JAMBA_PROMPT), dtype=np.int32)
    toks = torch.from_numpy(prompts).to(dev)
    max_seq = JAMBA_PROMPT + JAMBA_NEW
    step = make_serve_step(cut)

    # The first step through B15 against the same step through its plain
    # twin (from a zero state), and the last prompt step (from the state the
    # kernel carried over the 15 before it), each from one cache.
    held = {}
    ck = init_decode_cache(cut, JAMBA_ROWS, max_seq, torch.bfloat16, device=dev)
    for t in range(JAMBA_PROMPT):
        if t in (0, JAMBA_PROMPT - 1):
            cp = type(ck)(slots={k: type(c)(*(x.clone() for x in c)) for k, c in ck.slots.items()}, step=ck.step)
            lp, _ = decode_step(cut, params, cp, toks[:, t:t + 1], ssm_impl="plain")
        _, lk, ck = step(params, ck, toks[:, t:t + 1])
        if t in (0, JAMBA_PROMPT - 1):
            held[f"step_{t}"] = check(f"jamba serve step {t}'s logits, B15 against its plain twin", lk.float(),
                                      lp.float(), TOL_SERVE_LOGITS) / float(lp.float().abs().max())
    first_rel = held["step_0"]
    del ck, cp, lk, lp

    cache = init_decode_cache(cut, JAMBA_ROWS, max_seq, torch.bfloat16, device=dev)
    steps = JAMBA_PROMPT + JAMBA_NEW - 1
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    forms0 = scan_forms(sc)
    per_step, out = [], []
    tok = toks[:, :1]
    t0 = time.perf_counter()
    for t in range(steps):
        if t < JAMBA_PROMPT:
            tok = toks[:, t:t + 1]
        f0 = scan_forms(sc)
        nxt, logits, cache = step(params, cache, tok)
        per_step.append(scan_forms(sc, since=f0))
        if t >= JAMBA_PROMPT - 1:
            out.append(nxt)
            tok = nxt
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    counts = kernels.launch_counts()
    forms = scan_forms(sc, since=forms0)
    new = torch.cat(out, dim=1).cpu()
    log(f"  {steps} serve steps in {serve_s:.2f} s; launches {({k: v for k, v in counts.items() if v})}, B15 forms "
        f"{forms}; tokens {new[0].tolist()}")
    if any(f != {"token": n_mamba, "seq": 0, "seq_keep": 0} for f in per_step):
        raise AssertionError(f"B15 forms per step {per_step}: want {n_mamba} one-token launches a step, no other form")
    if counts["ssm_scan"] != n_mamba * steps or sum(counts.values()) != counts["ssm_scan"]:
        raise AssertionError(f"jamba serve launches {counts}, expected ssm_scan {n_mamba * steps} and no other kernel")
    if tuple(new.shape) != (JAMBA_ROWS, JAMBA_NEW) or int(new.min()) < 0 or int(new.max()) >= cut.vocab_size \
            or not bool(torch.isfinite(logits.float()).all()) or cache.step != steps:
        raise AssertionError(f"jamba serve: tokens {tuple(new.shape)} / logits outside the contract")
    add(counts)

    # the legacy loop on the same prompts (the same greedy argmax: agreement reported)
    kernels.reset_launch_counts()
    eng = Engine(cut, params, ServeConfig(max_seq=max_seq, max_new_tokens=JAMBA_NEW), device=dev)
    legacy = eng.generate(prompts)[:, JAMBA_PROMPT:]
    leg_counts = kernels.launch_counts()
    agree = int((legacy == new).sum())
    if leg_counts["ssm_scan"] != n_mamba * steps or sum(leg_counts.values()) != leg_counts["ssm_scan"]:
        raise AssertionError(f"jamba legacy loop launches {leg_counts}, expected ssm_scan {n_mamba * steps}")
    add(leg_counts)
    log(f"  Engine.generate's legacy loop on the same prompts: {agree} of {legacy.numel()} tokens equal to "
        f"make_serve_step's; B15 {leg_counts['ssm_scan']} launches")
    del eng

    # a decode step's time and device profile (a cache of its own, 8 positions in)
    tcache = init_decode_cache(cut, JAMBA_ROWS, 64, torch.bfloat16, device=dev)
    for t in range(8):
        step(params, tcache, toks[:, t:t + 1])

    def decode():
        nonlocal tcache
        _, _, tcache = step(params, tcache, toks[:, :1])

    decode_ms = host_ms(torch, decode, 5)
    prof = profile_device(torch, decode, 2, decode_ms, "decode step")
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    cast_ms = sum(t for key, t in prof["kernels"] if "copy" in key.lower() or "cast" in key.lower())
    b15_ms = sum(t for key, t in prof["kernels"] if key.startswith("ssm_") or "::ssm_" in key)
    log(f"  decode step ({JAMBA_ROWS} rows): {decode_ms:.3f} ms on the host, {prof['busy_ms']:.3f} ms of device time "
        f"({prof['busy_ms'] / decode_ms:.1%} busy); copies and casts {cast_ms:.3f} ms, B15 {b15_ms:.4f} ms; "
        f"parameters {p_bytes / 2**30:.2f} GiB, peak {peak:.2f} GiB over the start ({smi})")

    # the whole 32-layer model's decode_32k step, sized on the meta device
    full = get_config("jamba_v01_52b")
    spec = decode_input_specs(full, "decode_32k")
    cache_bytes = sum(t.numel() * t.element_size() for slot in spec["cache"].slots.values() for t in slot)
    if any(t.device.type != "meta" for slot in spec["cache"].slots.values() for t in slot):
        raise AssertionError("decode_input_specs allocated a cache")
    log(f"  decode_input_specs(jamba_v01_52b, 'decode_32k'): tokens {tuple(spec['tokens'].shape)}, cache "
        f"{cache_bytes} bytes ({cache_bytes / 2**30:.2f} GiB) on the meta device, nothing allocated; the whole "
        f"model's {full.param_count()} parameters {full.param_count() * 4 / 2**30:.2f} GiB in f32")
    report["jamba"] = dict(layers=JAMBA_LAYERS, params=n, param_bytes=p_bytes, init_s=init_s,
                           first_step_logits_rel=first_rel, kernel_vs_plain_logits_rel=held, steps=steps,
                           serve_s=serve_s, launches=counts, forms=forms, tokens=new.tolist(),
                           legacy_tokens_equal=agree, decode_step_ms=decode_ms, profile=prof, cast_ms=cast_ms, b15_ms=b15_ms, peak_gib=peak,
                           decode_32k_cache_bytes=cache_bytes, full_params=full.param_count())
    del params, cache, tcache, logits
    torch.cuda.empty_cache()
    return report, launches


# -- the static contracts on the card (phase "contracts") -----------------------------
# Every pass of repro_torch.analysis (the card passes included), the ptxas
# resource rows, the dry run's kernel calls against the card's launches, the
# 16 wrappers rerun bit for bit, compute-sanitizer's racecheck where the
# machine has a working one, and the guarded step's launch-stable check.

CONTRACTS_BUDGET_S = 60
RACECHECK_TIMEOUT_S = 30
RACECHECK_DONE = "racecheck cases done"


def contract_cases(torch, gen, full: bool) -> dict:
    """{wrapper name: (fn, args, kwargs)} for each of the 16 kernel
    wrappers: at the main path's full-width shapes (``full``), or at small
    shapes that still reach every CUDA kernel of the wrapper's walk."""
    from repro_torch.kernels import fused_adam as fa, megaplan as mp, paged_attention as pa, slim_update as su
    from repro_torch.kernels import snr_stats as sn, ssm_scan as ss

    dev = torch.device("cuda")

    def r(*shape, scale=1e-3):
        return scale * torch.randn(shape, generator=gen, device=dev)

    def pos(*shape):
        return 1e-6 * torch.rand(shape, generator=gen, device=dev) + 1e-8

    if full:   # gpt_small's embedding line and blocks, opt_speed's 4096 x 8192, a rank's 9.66 M shard line
        g3, line, col = r(1, 4096, 8192), pos(1, 4096, 1), pos(1, 1, 8192)
        split, split_line = r(1, 1, 9_658_368), pos(1, 1, 1)
        major, major_line = r(12, 768, 2304), pos(12, 1, 2304)
        dense = r(245_760, 512)
        dense_line = torch.ones((245_760, 1), device=dev)
        leaf2 = r(50304, 768)
        paged = paged_case(torch, gen, lengths=[1000, 37, 2048, 513], alloc=[1000, 37, 2048, 513], c=1,
                           pool_dtype=torch.bfloat16, q_dtype=torch.bfloat16)
        scan = scan_case(torch, gen, 1, 2048, 8192, 16, torch.bfloat16)
    else:
        g3, line, col = r(1, 64, 96), pos(1, 64, 1), pos(1, 1, 96)
        split, split_line = r(1, 1, 40_000), pos(1, 1, 1)
        major, major_line = r(2, 300, 40), pos(2, 1, 40)
        dense = r(64, 512)
        dense_line = torch.ones((64, 1), device=dev)
        leaf2 = r(100, 64)
        paged = paged_case(torch, gen, lengths=[100, 7], alloc=[100, 7], c=1, pool_dtype=torch.float32)
        scan = scan_case(torch, gen, 1, 40, 256, 16, torch.float32)
    y, h, keep = ss.ssm_scan(*scan, keep_bounds=True)
    dy = torch.randn_like(y).to(scan[0].dtype)
    kw = dict(b1=0.9, b2=0.95, eps=1e-8)
    return {
        "mega_adam_update": (mp.mega_adam_update, (dense, dense.clone(), pos(*dense.shape), dense_line,
                                                    dense_line.clone()), dict(with_health=True, **kw)),
        "mega_slim_update_batched": (mp.mega_slim_update_batched, (split, split.clone(), split_line, split_line.clone(),
                                                                   split_line.clone()),
                                     dict(axis=1, with_snr=True, with_health=True, **kw)),
        "adam_precond": (fa.adam_precond, (leaf2, leaf2.clone(), pos(*leaf2.shape)),
                         dict(count=3, with_health=True, **kw)),
        "slim_precond_batched": (su.slim_precond_batched, (major, major.clone(), major_line),
                                 dict(axis=0, count=3, with_snr=True, with_health=True, **kw)),
        "snr_stats_centered_batched": (sn.snr_stats_centered_batched, (split.abs(),), dict(axis=1)),
        "paged_attention": (pa.paged_attention, paged, {}),
        "snr_stats_centered_partial_batched": (sn.snr_stats_centered_partial_batched, (major.abs(),), dict(axis=0)),
        "slim_partial_stats_batched": (su.slim_partial_stats_batched, (split, split.clone()),
                                       dict(axis=1, with_snr=True, with_health=True)),
        "slim_finalize_batched": (su.slim_finalize_batched, (g3, line), dict(axis=1, ek=line.clone(), count=3)),
        "mega_slim_partial_stats_batched": (mp.mega_slim_partial_stats_batched, (major, major.clone()),
                                            dict(axis=0, with_snr=True, with_health=True)),
        "mega_slim_finalize_batched": (mp.mega_slim_finalize_batched, (g3, col, col.clone(), col.clone()),
                                       dict(axis=0, ek=col.clone())),
        "fused_adam": (fa.fused_adam, (g3[0], g3[0].clone(), g3[0].clone(), pos(*g3[0].shape)),
                       dict(lr=1e-3, count=3, wd=0.1)),
        "slim_update_batched": (su.slim_update_batched, (g3, g3.clone(), g3.clone(), col), dict(axis=0, lr=1e-3, count=3)),
        "snr_stats_batched": (sn.snr_stats_batched, (g3,), dict(axis=1)),
        "ssm_scan": (ss.ssm_scan, scan, dict(keep_bounds=True)),
        "ssm_scan_bwd": (ss.ssm_scan_bwd, scan + (dy,), dict(states=keep)),
    }


def _outputs(out):
    return [t for t in (out if isinstance(out, (tuple, list)) else (out,)) if t is not None]


def racecheck_cases() -> int:
    """``python3 chip_smoke.py --racecheck-cases``: the small case of every
    wrapper once, synchronised, then the done line (the process
    compute-sanitizer instruments)."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    gen = torch.Generator(device="cuda").manual_seed(7)
    for name, (fn, args, kw) in contract_cases(torch, gen, full=False).items():
        fn(*args, **kw)
        torch.cuda.synchronize()
    log(RACECHECK_DONE)
    return 0


def racecheck() -> dict:
    """compute-sanitizer's racecheck over the small case of every wrapper,
    in a subprocess with its own time limit. Where the machine has no tool,
    or one that cannot instrument the card, it says so, and nothing counts
    as passed; a hazard, or cases that fail under a working tool, raise."""
    import shutil

    tool = shutil.which("compute-sanitizer") or "/usr/local/cuda/bin/compute-sanitizer"
    if not Path(tool).exists():
        return {"status": "absent", "detail": "compute-sanitizer is not installed on this machine"}
    run = subprocess.run([tool, "--tool", "racecheck", "--racecheck-report", "hazard", sys.executable,
                          str(ROOT / "chip_smoke.py"), "--racecheck-cases"],
                         capture_output=True, text=True, timeout=RACECHECK_TIMEOUT_S)
    text = run.stdout + run.stderr
    tool_errors = [l.strip("= ").strip() for l in text.splitlines() if l.startswith("=========") and "Error:" in l]
    if RACECHECK_DONE not in text:
        if tool_errors:
            return {"status": "unavailable", "detail": f"{tool} cannot instrument this card: {tool_errors[0]}"}
        raise AssertionError(f"racecheck: the cases did not run to their end (rc {run.returncode}):\n{text[-2000:]}")
    summary = [l.strip("= ").strip() for l in text.splitlines() if "RACECHECK SUMMARY" in l]
    if not summary or "0 hazards" not in summary[-1]:
        raise AssertionError(f"racecheck reported hazards: {summary}\n{text[-2000:]}")
    return {"status": "passed", "detail": summary[-1]}


def contracts_phase(torch, smi: str) -> dict:
    """Phase "contracts". Returns its report."""
    from repro_torch import kernels
    from repro_torch.analysis import PASS_NAMES, call_tools, kernelcheck
    from repro_torch.analysis.__main__ import DIFF_OUT, _run_pass, table
    from repro_torch.configs import get_config
    from repro_torch.core import table3_rules
    from repro_torch.kernels import build
    from repro_torch.train.trainer import make_optimizer

    t0 = time.perf_counter()
    report: dict = {}
    dev = torch.device("cuda")

    # (a) every pass of repro_torch.analysis, on this machine
    log("[contracts] (a) python -m repro_torch.analysis: every pass, the card passes (resources, launch-stable) "
        "on this card")
    results = [_run_pass(n, False, DIFF_OUT) for n in PASS_NAMES]
    log(table(results))
    report["passes"] = {r.name: dict(checks=r.checks, findings=[str(f) for f in r.findings], seconds=r.seconds)
                        for r in results}
    bad = [str(f) for r in results for f in r.findings]
    if bad:
        raise AssertionError(f"contracts: {len(bad)} finding(s): {bad[:10]}")

    # (b) the resource row of every CUDA symbol
    rows = kernelcheck.resources(build.resource_report())
    log(f"[contracts] (b) ptxas resources of {len(rows)} compiled kernels, by __global__ function ({smi}): "
        f"instantiations, registers a thread (most), spill stores / loads B (most), static + dynamic shared B "
        f"(most), blocks an SM (least)")
    by_kernel: dict = {}
    for r in rows:
        by_kernel.setdefault(r.kernel, []).append(r)
    summary = {}
    for name, rs in sorted(by_kernel.items()):
        summary[name] = dict(instantiations=len(rs), registers=max(r.registers for r in rs),
                             spill_stores=max(r.spill_stores for r in rs), spill_loads=max(r.spill_loads for r in rs),
                             static_smem=max(r.static_smem for r in rs), dynamic_smem=max(r.dynamic_smem for r in rs),
                             blocks_per_sm=min(r.blocks_per_sm for r in rs), threads=max(r.threads for r in rs))
        s = summary[name]
        log(f"    {name:26s} x{s['instantiations']:<3d} {s['registers']:3d} regs  spill {s['spill_stores']:3d}/"
            f"{s['spill_loads']:3d} B  smem {s['static_smem']:6d} + {s['dynamic_smem']:6d} B  "
            f"{s['blocks_per_sm']:2d} blocks/SM  {s['threads']} threads")
    report["resources"] = dict(by_kernel=summary, rows=[r._asdict() for r in rows])

    # (c) the dry run's kernel calls against the card's launches: full-width
    # gpt_small's Adam and Table-3 SlimAdam updates (phase 3's), the step's
    # every kernel launch (its forward and backward launch none)
    cfg = get_config("gpt_small")
    meta_params, meta = cfg.abstract()
    gen = torch.Generator(device=dev).manual_seed(11)
    params = {k: 0.02 * torch.randn(p.shape, generator=gen, device=dev) for k, p in meta_params.items()}
    grads = {k: 1e-3 * torch.randn(p.shape, generator=gen, device=dev) for k, p in params.items()}
    counts = {}
    for name, kw in (("adam", {}), ("slim", dict(rules=table3_rules(meta)))):
        tx_meta = make_optimizer(name, 3e-4, meta_params, meta, backend="fused", **kw)
        predicted = call_tools.kernel_call_counts(lambda g, s: tx_meta.update(g, s, meta_params),
                                                  call_tools.to_meta(grads), tx_meta.init(meta_params))
        tx = make_optimizer(name, 3e-4, params, meta, backend="fused", **kw)
        state = tx.init(params)
        before = kernels.launch_counts()
        with torch.no_grad():
            tx.update(grads, state, params)
        torch.cuda.synchronize()
        after = kernels.launch_counts()
        launched = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        log(f"[contracts] (c) gpt_small {name} update: dry run {predicted}, card {launched}")
        if predicted != launched or not launched:
            raise AssertionError(f"contracts (c): the dry run predicts {predicted}, the card launched {launched}")
        counts[name] = dict(meta=predicted, card=launched)
    report["dry_run_calls"] = counts
    del params, grads, state, tx
    torch.cuda.empty_cache()

    # (d) every wrapper twice on the same inputs: bit-equal outputs
    cases = contract_cases(torch, torch.Generator(device=dev).manual_seed(5), full=True)
    reruns = {}
    for name, (fn, args, kw) in cases.items():
        first = [t.clone() for t in _outputs(fn(*args, **kw))]
        second = _outputs(fn(*args, **kw))
        torch.cuda.synchronize()
        same = len(first) == len(second) and all(torch.equal(a, b) for a, b in zip(first, second))
        reruns[name] = dict(outputs=len(first), equal=same)
        if not same:
            raise AssertionError(f"contracts (d): {name} gave other bits on a rerun of the same inputs")
    if sorted(reruns) != sorted(fn.__name__ for fn in kernels.KERNELS):
        raise AssertionError(f"contracts (d): reran {sorted(reruns)}, not the 16 wrappers")
    log(f"[contracts] (d) the 16 wrappers rerun on the same full-width inputs: bit-equal "
        f"({sum(r['outputs'] for r in reruns.values())} outputs)")
    report["reruns"] = reruns
    del cases
    torch.cuda.empty_cache()

    # (e) compute-sanitizer's racecheck, one small case per wrapper
    race = racecheck()
    report["racecheck"] = race
    if race["status"] == "passed":
        log(f"[contracts] (e) racecheck: {race['detail']}")
    else:
        log(f"[contracts] (e) racecheck NOT RUN, not counted as passed: {race['detail']}")

    # (f) tracecheck's launch-stable check ran on this card in (a)
    ls = report["passes"]["launch-stable"]
    log(f"[contracts] (f) launch-stable on the card: {ls['checks']} check(s), {len(ls['findings'])} findings")
    report["seconds"] = time.perf_counter() - t0
    log(f"[contracts] phase done in {report['seconds']:.1f} s (budget {CONTRACTS_BUDGET_S} s)")
    return report


def main() -> int:
    if sys.argv[1:2] == ["--dryrun-6k"]:
        return dryrun_6k(Path(sys.argv[2]))
    if sys.argv[1:2] == ["--dryrun-6m"]:
        return dryrun_6m(Path(sys.argv[2]), sys.argv[3])
    if sys.argv[1:2] == ["--racecheck-cases"]:
        return racecheck_cases()
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
    dry = start_dryruns()

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
        the group's shape, then kernel, twin, bound and library times. A
        slim group's B1 also reruns bit for bit, and B4 (the per-leaf
        kernel on the same walk) is held, rerun and timed on it too."""
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
        got = run()
        errs = [check(f"{tag} {o}", a, w, tol) for o, a, w, tol in zip(("u", "m'", "v'"), got, plain(), tols)]
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
        if not dense:
            same_tensors(f"{tag}: two runs", dict(enumerate(got)), dict(enumerate(run())))
            held[key].update(slim_walk_row(torch, timer, rate, group, g, m, v), bit_equal=True)
        del g, m, v, args, got

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
    report["wrapper_forms"] = wrapper_forms(torch, gen)

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
    phase_s = report["phase_seconds"] = {}
    mark = [t_start]

    def stamp(name):
        """Log and keep the wall time since the previous stamp (the first: since the start, the build in it)."""
        now = time.perf_counter()
        phase_s[name] = now - mark[0]
        mark[0] = now
        log(f"  [phase {name}: {phase_s[name]:.1f} s; {now - t_start:.0f} s since the start]")

    stamp("1-3")
    rcfg = dataclasses.replace(cfg, n_layers=ROBUST_LAYERS)
    rspecs = dict(flatten_with_names(rcfg.specs()))
    rmeta = {k: s.meta() for k, s in rspecs.items()}
    rdims = rules_to_dims(table3_rules(rmeta), rmeta)
    rplan = megaplan.plan_megagroups([s.shape for s in rspecs.values()], [torch.float32] * len(rspecs),
                                     [rdims[k] for k in rspecs])
    report["robust"] = robust_phases(torch, timer, smi, rcfg, rspecs, rmeta, data, lr, rplan, rdims)
    stamp("3b-3f")
    report["serve"], paged_entry = serve_phases(torch, timer, rate, smi)
    stamp("4-5")
    del timer
    torch.cuda.empty_cache()
    # phases 6 and 6f-6l share their 4 rank processes (mesh_rank)
    mesh_work = ROOT / "build" / "chip_smoke_mesh"
    ranks = start_ranks(mesh_work, mesh_rank, rate, str(mesh_work / "ckpt"), smi)
    try:
        report["sharded"] = sharded = sharded_phase(torch, smi, rate, ranks)
        stamp("6")
        report["tp"], tp_launches = tp_phase(torch, smi, rate, dry, ranks)
    finally:
        kill_ranks(ranks)
    stamp("6f-6l")
    report["launch"], launch_launches = launch_phase(torch, smi, dry)
    stamp("6m")
    timer = Timer(torch)
    report["ssm"], ssm_entry = ssm_phase(torch, timer, rate, smi)
    stamp("7")
    report["ssm_train"], ssm_bwd_entry = ssm_train_phase(torch, timer, rate, smi)
    stamp("7f-7h")
    report["param_api"], param_entries = param_phase(torch, timer, rate, smi, specs, t3_dims)
    stamp("8")
    torch.cuda.empty_cache()
    report["baselines"], baseline_launches = baselines_phase(torch, smi, cfg, meta, data, lr, rules, plan_for,
                                                              hold_plan, held, group_key)
    stamp("9")
    torch.cuda.empty_cache()
    report["moe_serve"], moe_serve_launches = moe_serve_phase(torch, timer, rate, smi)
    stamp("10")
    report["moe_train"], moe_train_launches = moe_train_phase(torch, timer, rate, smi)
    stamp("11")
    report["diy_slim"], diy_launches = diy_phase(torch, smi)
    stamp("12")
    torch.cuda.empty_cache()
    report["zoo_train"], zoo_train_launches = zoo_train_phase(torch, timer, smi)
    stamp("13")
    report["zoo_serve"], zoo_serve_launches = zoo_serve_phase(torch, timer, rate, smi)
    stamp("14")
    del timer
    torch.cuda.empty_cache()
    report["faults"], fault_launches = fault_phase(torch, rate, smi, report["serve"]["serving"]["tokens"])
    stamp("15")
    report["contracts"] = contracts_phase(torch, smi)
    stamp("contracts")

    # -- 16. result lines -----------------------------------------------------
    # Times per step of the main path: B2 on Adam's one dense group, B1 summed
    # over the Table-3 plan's three slim groups, B5 over one SNR measurement.
    # Errors are the worst over every group phases 3 and 9 launched on, and
    # launches count both phases' runs.
    launches = {k: main["adam"]["launches"][k] + main["slim"]["launches"][k] + main["slim_snr"]["launches"][k]
                + baseline_launches.get(k, 0) for k in main["adam"]["launches"]}
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

    grouped_runs = ("slim_launches", "slim_snr_launches", "guard_launches", "adalayer_grouped_launches")
    per_leaf_runs = ("per_leaf_launches", "adalayer_per_leaf_launches")
    line["kernels"] += [
        sharded_entry("snr_stats_centered_partial_batched", "B9", "snr_stats.cu",
                      "src/repro/kernels/snr_stats.py:152",
                      sharded["adam_launches"]["snr_stats_centered_partial_batched"]),
        sharded_entry("slim_partial_stats_batched", "B10", "mega_slim.cu", "src/repro/kernels/slim_update.py:260",
                      sum(sharded[r]["slim_partial_stats_batched"] for r in per_leaf_runs)),
        sharded_entry("slim_finalize_batched", "B11", "slim_finalize.cu", "src/repro/kernels/slim_update.py:329",
                      sum(sharded[r]["slim_finalize_batched"] for r in per_leaf_runs)),
        sharded_entry("mega_slim_partial_stats_batched", "B12", "mega_slim.cu", "src/repro/kernels/megaplan.py:486",
                      sum(sharded[r]["mega_slim_partial_stats_batched"] for r in grouped_runs)),
        sharded_entry("mega_slim_finalize_batched", "B13", "slim_finalize.cu", "src/repro/kernels/megaplan.py:536",
                      sum(sharded[r]["mega_slim_finalize_batched"] for r in grouped_runs)),
    ]
    line["kernels"] += param_entries + [ssm_entry, ssm_bwd_entry]
    # Phases 10-15 launch B14 (olmoe, the dense zoo's serving, the fault
    # drills), B1, B2, B5 (olmoe training, diy_slim, the zoo's training), B15
    # (diy_slim, the jamba period) and the scan's backward (diy_slim), none
    # with a flag; phase 6f-6h's counted runs on rank 0 B1, B2, B5, B9, B12,
    # B13, and B15 and the backward on falcon's channel shards; 6m's two jobs
    # on rank 0 B2, B12 and B13.
    for e in line["kernels"]:
        e["launches"] += sum(c.get(e["name"], 0) for c in (moe_serve_launches, moe_train_launches, diy_launches,
                                                             zoo_train_launches, zoo_serve_launches, fault_launches,
                                                             tp_launches, launch_launches))
    report["b14_held"] = B14_HELD
    paged_entry["max_abs_err"] = max(paged_entry["max_abs_err"], *(h["err"] for h in B14_HELD.values()))
    paged_entry["olmoe_decode_ms"] = B14_HELD["olmoe decode bfloat16 q bfloat16 pool"]["ms"]
    if len(line["kernels"]) != len(kernels.KERNELS) + 2 or min(e["launches"] for e in line["kernels"]) < 1:
        raise AssertionError(f"kernels line: {len(line['kernels'])} entries (B1 and B2 with their flags as "
                             f"separate rows), launches {[e['launches'] for e in line['kernels']]}")
    report["kernels"] = line
    report["device"] = smi
    report["seconds"] = time.perf_counter() - t_start
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke_report.json").write_text(json.dumps(report, indent=1, default=str))
    log(f"[16] done in {report['seconds']:.0f} s, the kernels' build {report['build']['seconds']:.1f} s of it; "
        f"report in build/chip_smoke_report.json")
    log(json.dumps(line))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
