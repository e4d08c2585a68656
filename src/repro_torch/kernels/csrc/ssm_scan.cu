// Mamba-1 selective scan, forward: the recurrence of every Mamba layer.
//
// Replaces repro/kernels/ssm_scan.py:58 ssm_scan (kernel body _ssm_kernel
// :27, pallas_call :77), whose oracle is repro/models/ssm.py:140
// selective_scan. Per row b, channel d and state n, for t = 0..S-1:
//   h[n] <- exp(dt*a[d,n]) * h[n] + (dt*x) * B[b,t,n]
//   y[b,t,d] = sum_n h[n] * C[b,t,n] + d_skip[d] * x
// with dt = dt[b,t,d], x = x[b,t,d], h starting from h0[b,d,:]; returns y
// (B, S, D) and the final state (B, D, N), both f32. x, B and C may be f32
// or bf16 (the bf16 projections of the model's activations), dt, a, d_skip
// and h0 are f32; everything is computed in f32, as _ssm_kernel casts.
//
// Two forms, picked with their grids by a host planner from the shapes and
// the SM count alone (repro_torch/kernels/ssm_scan.py plan_scan):
//
// SEQUENCE form (S > 1: the eval forward, a prefill). The TPU kernel carries
// h through VMEM along a sequential grid axis; one CUDA block per (row,
// channel tile) walking the whole sequence leaves 64 blocks at B = 1, D =
// 8192, each warp a chain of 2048 steps. The recurrence is linear in h, so
// the sequence is cut into K chunks of L steps (L a multiple of kTile), as
// the JAX oracle composes its chunks (repro/models/ssm.py _scan_chunk's
// combine, carried by lax.scan), in three launches:
//   1. CARRY WALK over chunks 0..K-2, a block per (channel tile, chunk,
//      row), each thread one channel with all its states in registers:
//      chunk 0 from h0, the others from h = 0. Each writes its end state U
//      and its channel's sum of dt to a workspace slot (no y).
//   2. CARRY: a thread per (row, channel, state) composes, in chunk order,
//      slot[j] = exp2(a*log2e * sum dt[j]) * slot[j-1] + slot[j], so slot j
//      becomes the true state at the end of chunk j (the decay product of a
//      chunk is the exponential of its summed dt, as the oracle's).
//   3. OUTPUT WALK over chunks 0..K-1: chunk 0 from h0, chunk k from slot
//      k-1; it writes y and, in the last chunk, h_final. When a gradient is
//      wanted (the KEEP instantiation, a non-null `keep`), it also stores the
//      state at the start of every kTile-step tile, (B, ceil(S/16), D, NP)
//      f32, one coalesced row of NP floats a thread a tile: the backward
//      (ssm_scan_bwd.cu) replays each tile once from it. 134 MB at the
//      training shape (B 2, S 2048, D 8192, N 16). The eval forward and the
//      decode step run the instantiation without the store.
// K = 1 (short sequences, or rows x tiles that fill the card alone) is
// launch 3 alone. No float atomics and a fixed order: runs are
// bit-identical. The planner takes the most chunks whose output walk still
// fits kSeqMinBlocks blocks on every SM (a block's walk is a chain of
// dependent steps, so an SM with fewer blocks runs no faster), and one
// chunk when that is fewer than 3 (the two walks then cost what one chunk
// would): 8 chunks of 256 steps at the eval shape.
//
// ONE-TOKEN form (S = 1: every decode step). No shared memory, no barrier,
// no tile loop: kLanes lanes per (row, channel), each holding NP / kLanes
// states; a[d, :], h0 and h_out move as float4s where every channel's
// states are aligned (16-byte bases and N a multiple of 4), x and dt are
// one load per channel and B, C broadcast loads; two xor-shuffles join y.
//
// Bound. The function needs one exponential per (t, d, n); the SFUs
// evaluate 16 per SM per clock. At the eval shape (B=1, S=2048, D=8192,
// N=16) that takes ~0.064 ms, the bytes (x bf16, dt f32 read, y f32
// written, ~168 MB) ~0.050 ms: the bound is 0.064 ms. This design pays for
// its parallelism by evaluating the exponentials of chunks 0..K-2 twice
// (carry walk and output walk), (2K-1)/K of one pass: ~0.12 ms at K = 8 is
// the least this design can take, not the function's bound. At S = 1 the
// bound is bytes: a, h0 and h_out, ~4.5 MB at 4 rows, ~0.0015 ms, below a
// launch's latency.
//
// Choices, and why:
// - One thread per channel with all NP states in registers (the old kernel
//   split N over 4 lanes): the chunks give the parallelism, and a thread's
//   16 independent exponentials a step feed the SFUs with no shuffle; y is
//   an in-thread sum. Two lanes per channel (8 states each, twice the
//   warps) measured no faster.
// - States are padded to NP = 4, 8 or 16 (a = 0, B = C = 0 beyond N keep
//   those states at 0 and add 0 to y): three instantiations per dtype
//   instead of sixteen.
// - Tiles of kTile = 16 steps. x and dt of a tile (the per-channel streams)
//   go through a cp.async double buffer in shared memory, 16-byte copies
//   at offsets each thread computes once, where every row is aligned and
//   the channel tile whole; elsewhere (odd D, unaligned views, a chunk's
//   last tile) by plain loads and stores. B and C (kTile x NP values shared
//   by the block's channels) go through registers one tile ahead to a
//   shared double buffer, as f32. One barrier a tile. What probes on the
//   card showed: 64-bit index math and predicated loads per step cost as
//   much as the exponentials, so whole tiles load unpredicated from
//   running pointers; deeper rings, L2 prefetch and more blocks per SM did
//   not help; with the exponentials removed the walks keep most of their
//   time (dependent steps at 16 warps an SM), so the SFUs are not yet the
//   limit.
// - A chunk's last tile runs padded steps with dt = x = B = 0: decay 1, h
//   unchanged exactly, no store; so no guarded second copy of the tile.
// - exp(dt*a) = ex2.approx(dt * (a*log2e)), one SFU instruction; products
//   and sums contract to FMAs. Neither the _rn splitting nor expf is needed
//   for the 1e-5 (relative to max |twin|) tolerance: both forms stay within
//   it, and the chunked order means no form is bit-equal to the twin.
#include "common.cuh"

namespace {

constexpr int kSeqThreads = 128;   // sequence form: channels per block, one a thread
constexpr int kSeqMinBlocks = 4;   // blocks per SM the planner counts on (<= 128 registers a thread)
constexpr int kTile = 16;          // steps a tile
constexpr int kStages = 2;         // tiles of x and dt in shared memory: the cp.async double buffer
constexpr int kTokenThreads = 256; // one-token form: threads per block ...
constexpr int kLanes = 4;          // ... and lanes per channel
constexpr int kCarryThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kFormToken = 0, kFormSeq = 1;

struct ScanArgs {
  const void* x;
  const float* dt;
  const float* a;
  const void* bt;
  const void* ct;
  const float* dskip;
  const float* h0;
  float* y;
  float* hout;
  float* carry;   // (batch, chunks - 1, dim, n): chunk end states
  float* dtsum;   // (batch, chunks - 1, dim): each chunk's sum of dt
  float* keep;    // (batch, ceil(seq / kTile), dim, NP): every tile's start state, or null
  long long batch, seq, dim, chunk;
  int n, chunks, vec;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned sm = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sm), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float load_f(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, long long i) { return __bfloat162float(p[i]); }

// One step for NP states: h <- exp2(dt*a2)*h + (dt*x)*B; returns sum_n h*C
// (OUT) or 0. bs and cs: the step's NP values of B and C in shared memory.
template <int NP, bool OUT>
__device__ __forceinline__ float state_step(float (&h)[NP], const float (&a2)[NP], float dtv, float xv,
                                            const float* bs, const float* cs) {
  const float dx = dtv * xv;
  float acc = 0.f;
#pragma unroll
  for (int q = 0; q < NP / 4; ++q) {
    const float4 b4 = reinterpret_cast<const float4*>(bs)[q];
    const float bq[4] = {b4.x, b4.y, b4.z, b4.w};
    float cq[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (OUT) {
      const float4 c4 = reinterpret_cast<const float4*>(cs)[q];
      cq[0] = c4.x, cq[1] = c4.y, cq[2] = c4.z, cq[3] = c4.w;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = 4 * q + r;
      h[m] = fmaf(ex2(dtv * a2[m]), h[m], dx * bq[r]);
      if constexpr (OUT) acc = fmaf(h[m], cq[r], acc);
    }
  }
  return acc;
}

// The sequence form's walk of chunk blockIdx.y of row blockIdx.z over
// channels blockIdx.x * kSeqThreads + threadIdx.x: the carry walk (OUT =
// false, launch 1) or the output walk (OUT = true, launch 3), which with
// KEEP also stores each tile's start state.
template <typename T, int NP, bool OUT, bool KEEP = false>
__global__ void __launch_bounds__(kSeqThreads, kSeqMinBlocks) ssm_chunk_walk(const ScanArgs p) {
  static_assert(OUT || !KEEP, "only the output walk keeps tile states");
  constexpr int kStage = kTile * NP;  // B (and C) values of a tile
  constexpr int kPer = (kStage + kSeqThreads - 1) / kSeqThreads;
  __shared__ __align__(16) T sx[kStages][kTile][kSeqThreads];
  __shared__ __align__(16) float sd[kStages][kTile][kSeqThreads];
  __shared__ __align__(16) float sb[2][kStage];
  __shared__ __align__(16) float sc[2][OUT ? kStage : 4];
  const int tid = threadIdx.x;
  const long long d0 = (long long)blockIdx.x * kSeqThreads;
  const long long d = d0 + tid;
  const long long k = blockIdx.y;
  const long long b = blockIdx.z;
  const long long seq = p.seq, dim = p.dim;
  const int n = p.n;
  const bool live = d < dim;
  const long long t0 = k * p.chunk;
  const long long t1 = min(seq, t0 + p.chunk);
  const long long slots = p.chunks - 1;

  const float* start = nullptr;  // chunk 0 starts from h0; the output walk's chunk k from slot k-1
  if (k == 0) {
    start = p.h0 + (b * dim + d) * n;
  } else if (OUT) {
    start = p.carry + ((b * slots + k - 1) * dim + d) * n;
  }
  float h[NP], a2[NP];
#pragma unroll
  for (int m = 0; m < NP; ++m) {
    const bool on = live && m < n;
    a2[m] = on ? p.a[d * n + m] * kLog2e : 0.f;
    h[m] = (on && start != nullptr) ? start[m] : 0.f;
  }
  const float dsk = (OUT && live) ? p.dskip[d] : 0.f;

  // x and dt of a tile go to the next ring slot: by 16-byte cp.async over
  // the block's channels where every row is aligned and whole (vec), else
  // (a ragged channel tile, a chunk's last tile, odd shapes) by plain loads
  // and stores, zero past the chunk. One commit group a tile. A thread's
  // chunks of a tile sit at fixed offsets from the tile's first row,
  // computed once.
  constexpr int kXc = kSeqThreads * (int)sizeof(T) / 16, kDc = kSeqThreads * 4 / 16;  // 16-byte chunks a row
  constexpr int kXPer = kTile * kXc / kSeqThreads, kDPer = kTile * kDc / kSeqThreads;
  static_assert(kTile * kXc % kSeqThreads == 0 && kTile * kDc % kSeqThreads == 0, "whole chunks a thread");
  const bool vec = p.vec && dim % 8 == 0 && d0 + kSeqThreads <= dim;  // uniform across the block
  long long xoff[kXPer], doff[kDPer];
  unsigned xso[kXPer], dso[kDPer];
#pragma unroll
  for (int i = 0; i < kXPer; ++i) {
    const int c = tid + i * kSeqThreads;
    xoff[i] = (c / kXc) * dim * (long long)sizeof(T) + (c % kXc) * 16;
    xso[i] = (c / kXc) * kSeqThreads * (unsigned)sizeof(T) + (c % kXc) * 16;
  }
#pragma unroll
  for (int i = 0; i < kDPer; ++i) {
    const int c = tid + i * kSeqThreads;
    doff[i] = (c / kDc) * dim * 4LL + (c % kDc) * 16;
    dso[i] = (c / kDc) * kSeqThreads * 4u + (c % kDc) * 16;
  }
  const T* xg = static_cast<const T*>(p.x) + b * seq * dim + d0;  // the row's channel d0 at step 0
  const float* dg = p.dt + b * seq * dim + d0;
  long long tn = t0;  // the next tile to issue
  int next_slot = 0;
  auto issue = [&]() {
    if (tn < t1) {
      const char* xrow = reinterpret_cast<const char*>(xg + tn * dim);
      const char* drow = reinterpret_cast<const char*>(dg + tn * dim);
      char* xs = reinterpret_cast<char*>(sx[next_slot]);
      char* ds = reinterpret_cast<char*>(sd[next_slot]);
      if (vec && tn + kTile <= t1) {
#pragma unroll
        for (int i = 0; i < kXPer; ++i) cp_async16(xs + xso[i], xrow + xoff[i]);
#pragma unroll
        for (int i = 0; i < kDPer; ++i) cp_async16(ds + dso[i], drow + doff[i]);
      } else {
        const int rem = live ? (int)min(t1 - tn, (long long)kTile) : 0;
#pragma unroll
        for (int s = 0; s < kTile; ++s) {
          sx[next_slot][s][tid] = s < rem ? xg[(tn + s) * dim + tid] : T{};
          sd[next_slot][s][tid] = s < rem ? dg[(tn + s) * dim + tid] : 0.f;
        }
      }
      tn += kTile;
      next_slot = next_slot == kStages - 1 ? 0 : next_slot + 1;
    }
    cp_async_commit();
  };
  // B and C of a tile (kTile x NP values, zero past N and the chunk) go
  // through registers, one tile ahead, to a double buffer: value e = tid +
  // j * kSeqThreads of a tile is (step e / NP, state e % NP).
  long long bcoff[kPer];
  bool bcon[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = tid + j * kSeqThreads;
    bcon[j] = e < kStage && e % NP < n;
    bcoff[j] = (b * seq + t0 + e / NP) * n + e % NP;
  }
  auto load_bc = [&](long long tt, float (&bv)[kPer], float (&cv)[kPer]) {
    const long long rem = t1 - tt;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = tid + j * kSeqThreads;
      const bool in = bcon[j] && e / NP < rem;
      const long long i = bcoff[j] + (tt - t0) * n;
      bv[j] = in ? load_f(static_cast<const T*>(p.bt), i) : 0.f;
      cv[j] = (OUT && in) ? load_f(static_cast<const T*>(p.ct), i) : 0.f;
    }
  };
  auto stage_bc = [&](int buf, const float (&bv)[kPer], const float (&cv)[kPer]) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = tid + j * kSeqThreads;
      if (e < kStage) {
        sb[buf][e] = bv[j];
        if constexpr (OUT) sc[buf][e] = cv[j];
      }
    }
  };

#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) issue();
  float bv[kPer], cv[kPer];
  load_bc(t0, bv, cv);
  stage_bc(0, bv, cv);
  float* yq = p.y + (b * seq + t0) * dim + d;
  float* kq = nullptr;  // KEEP: this thread's row of the chunk's first tile
  if constexpr (KEEP) kq = p.keep + ((b * ((seq + kTile - 1) / kTile) + t0 / kTile) * dim + d) * NP;
  float sdt = 0.f;
  int slot = 0, buf = 0;
  for (long long tt = t0; tt < t1; tt += kTile) {
    if constexpr (KEEP) {
      if (live) {
#pragma unroll
        for (int q = 0; q < NP / 4; ++q) {
          reinterpret_cast<float4*>(kq)[q] = make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
        }
      }
      kq += dim * NP;
    }
    cp_async_wait<kStages - 2>();  // this thread's copies of this tile have landed
    __syncthreads();               // everyone's have; the last tile's slot and B/C buffer are free
    issue();
    const bool more = tt + kTile < t1;
    if (more) load_bc(tt + kTile, bv, cv);
    const float* bs = sb[buf];
    const float* cs = OUT ? sc[buf] : nullptr;
    const int rem = live ? (int)min(t1 - tt, (long long)kTile) : 0;
#pragma unroll
    for (int s = 0; s < kTile; ++s) {
      const float xv = load_f(&sx[slot][s][tid], 0), dv = sd[slot][s][tid];
      const float acc = state_step<NP, OUT>(h, a2, dv, xv, bs + s * NP, OUT ? cs + s * NP : nullptr);
      if constexpr (OUT) {
        if (s < rem) yq[s * dim] = fmaf(dsk, xv, acc);
      } else {
        sdt += dv;
      }
    }
    if (more) stage_bc(buf ^ 1, bv, cv);
    yq += kTile * dim;
    slot = slot == kStages - 1 ? 0 : slot + 1;
    buf ^= 1;
  }
  cp_async_wait<0>();

  if (!live) return;
  float* dst;
  if constexpr (OUT) {
    if (k != p.chunks - 1) return;
    dst = p.hout + (b * dim + d) * n;
  } else {
    dst = p.carry + ((b * slots + k) * dim + d) * n;
    p.dtsum[(b * slots + k) * dim + d] = sdt;
  }
#pragma unroll
  for (int m = 0; m < NP; ++m) {
    if (m < n) dst[m] = h[m];
  }
}

// Launch 2: slot j <- exp2(a2 * dtsum[j]) * slot[j-1] + slot[j], j = 1 ..
// chunks - 2 in order, a thread per (row, channel, state); the next slot's
// loads are issued before this one's store.
__global__ void __launch_bounds__(kCarryThreads) ssm_carry(const ScanArgs p) {
  const long long per_row = p.dim * p.n;
  const long long i = (long long)blockIdx.x * kCarryThreads + threadIdx.x;
  if (i >= p.batch * per_row) return;
  const long long b = i / per_row, r = i % per_row, d = r / p.n;
  const long long slots = p.chunks - 1;
  const float a2 = p.a[r] * kLog2e;
  float* c = p.carry + b * slots * per_row + r;
  const float* sd = p.dtsum + b * slots * p.dim + d;
  float h = c[0];
  float u = c[per_row], s = sd[p.dim];
  for (long long j = 1; j < slots; ++j) {
    float un = 0.f, sn = 0.f;
    if (j + 1 < slots) {
      un = c[(j + 1) * per_row];
      sn = sd[(j + 1) * p.dim];
    }
    h = fmaf(ex2(a2 * s), h, u);
    c[j * per_row] = h;
    u = un;
    s = sn;
  }
}

// The one-token form: S = 1, lane `lane` of the kLanes of channel d holds
// states n0 .. n0 + KS - 1.
template <typename T, int NP>
__global__ void __launch_bounds__(kTokenThreads) ssm_token(const ScanArgs p) {
  constexpr int KS = NP / kLanes;
  const int lane = threadIdx.x % kLanes;
  const long long d = (long long)blockIdx.x * (kTokenThreads / kLanes) + threadIdx.x / kLanes;
  const long long b = blockIdx.y;
  const long long dim = p.dim;
  const int n = p.n;
  const bool live = d < dim;
  const int n0 = lane * KS;
  const long long i = b * dim + d;  // x, dt, y at (b, 0, d)
  const float xv = live ? load_f(static_cast<const T*>(p.x), i) : 0.f;
  const float dtv = live ? p.dt[i] : 0.f;
  const float dsk = live ? p.dskip[d] : 0.f;
  const float* ap = p.a + d * n + n0;
  const float* hp = p.h0 + i * n + n0;
  float av[KS], hv[KS], bv[KS], cv[KS];
  bool quad = false;  // a lane's four states as one 16-byte load and store
  if constexpr (KS == 4) {
    quad = p.vec && live && n % 4 == 0 && n0 + KS <= n;  // 16-byte bases and rows of n floats
    if (quad) {
      const float4 a4 = *reinterpret_cast<const float4*>(ap);
      const float4 h4 = *reinterpret_cast<const float4*>(hp);
      av[0] = a4.x, av[1] = a4.y, av[2] = a4.z, av[3] = a4.w;
      hv[0] = h4.x, hv[1] = h4.y, hv[2] = h4.z, hv[3] = h4.w;
    }
  }
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    const bool on = live && n0 + j < n;
    if (!quad) {
      av[j] = on ? ap[j] : 0.f;
      hv[j] = on ? hp[j] : 0.f;
    }
    bv[j] = on ? load_f(static_cast<const T*>(p.bt), b * n + n0 + j) : 0.f;
    cv[j] = on ? load_f(static_cast<const T*>(p.ct), b * n + n0 + j) : 0.f;
  }
  const float dx = dtv * xv;
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    hv[j] = fmaf(ex2(dtv * (av[j] * kLog2e)), hv[j], dx * bv[j]);
    acc = fmaf(hv[j], cv[j], acc);
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  if (live && lane == 0) p.y[i] = fmaf(dsk, xv, acc);
  float* out = p.hout + i * n + n0;
  if constexpr (KS == 4) {
    if (quad) {
      *reinterpret_cast<float4*>(out) = make_float4(hv[0], hv[1], hv[2], hv[3]);
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    if (live && n0 + j < n) out[j] = hv[j];
  }
}

template <typename T, int NP>
int launch(const ScanArgs& p, cudaStream_t s) {
  if (p.chunks == 0) {  // the one-token form
    dim3 grid((unsigned)((p.dim + kTokenThreads / kLanes - 1) / (kTokenThreads / kLanes)), (unsigned)p.batch);
    ssm_token<T, NP><<<grid, kTokenThreads, 0, s>>>(p);
    return (int)cudaGetLastError();
  }
  const unsigned tiles = (unsigned)((p.dim + kSeqThreads - 1) / kSeqThreads);
  if (p.chunks > 1) {
    ssm_chunk_walk<T, NP, false><<<dim3(tiles, (unsigned)(p.chunks - 1), (unsigned)p.batch), kSeqThreads, 0, s>>>(p);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (p.chunks > 2) {
      const long long cells = p.batch * p.dim * p.n;
      ssm_carry<<<(unsigned)((cells + kCarryThreads - 1) / kCarryThreads), kCarryThreads, 0, s>>>(p);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  const dim3 grid(tiles, (unsigned)p.chunks, (unsigned)p.batch);
  if (p.keep != nullptr) {
    ssm_chunk_walk<T, NP, true, true><<<grid, kSeqThreads, 0, s>>>(p);
  } else {
    ssm_chunk_walk<T, NP, true><<<grid, kSeqThreads, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_np(const ScanArgs& p, cudaStream_t s) {
  if (p.n <= 4) return launch<T, 4>(p, s);
  if (p.n <= 8) return launch<T, 8>(p, s);
  return launch<T, 16>(p, s);
}

}  // namespace

// x, b_t, c_t: contiguous (batch, seq, dim) and (batch, seq, n), all f32
// (in_bf16 = 0) or all bf16 (in_bf16 = 1); dt: contiguous f32 (batch, seq,
// dim); a: f32 (dim, n); d_skip: f32 (dim,); h0, h_out: f32 (batch, dim, n);
// y: f32 (batch, seq, dim). 1 <= n <= 16; batch < 65536. form, chunk and
// chunks are plan_scan's plan: the one-token form (seq == 1) ignores chunk
// and chunks; the sequence form walks chunks = ceil(seq / chunk) chunks and,
// when chunks > 1, needs carry (batch, chunks - 1, dim, n) and dt_sum
// (batch, chunks - 1, dim) f32 workspaces. keep: null, or (sequence form
// only) f32 (batch, ceil(seq / 16), dim, NP), 16-byte aligned, NP = n
// padded to 4, 8 or 16, which receives the state at the start of every
// 16-step tile (padded states 0). vec: x, dt, a, h0 and h_out start on
// 16-byte boundaries. Returns the cudaError_t of the launches.
extern "C" int repro_ssm_scan(const void* x, int in_bf16, const float* dt, const float* a, const void* b_t,
                              const void* c_t, const float* d_skip, const float* h0, float* y, float* h_out,
                              float* carry, float* dt_sum, float* keep, long long batch, long long seq,
                              long long dim, int n, int form, long long chunk, int chunks, int vec, void* stream) {
  if (batch < 1 || batch > 65535 || seq < 1 || dim < 1 || n < 1 || n > 16) return (int)cudaErrorInvalidValue;
  if (form == kFormToken) {
    if (seq != 1 || keep != nullptr) return (int)cudaErrorInvalidValue;
    chunks = 0;
  } else if (form != kFormSeq || chunk < 1 || chunks < 1 || chunks > 65535 ||
             (seq + chunk - 1) / chunk != chunks || (chunks > 1 && (carry == nullptr || dt_sum == nullptr)) ||
             (keep != nullptr && chunk % kTile != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  const ScanArgs p{x, dt, a, b_t, c_t, d_skip, h0, y, h_out, carry, dt_sum, keep, batch, seq, dim, chunk, n, chunks,
                  vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16) return launch_np<__nv_bfloat16>(p, s);
  return launch_np<float>(p, s);
}
