// Mamba-1 selective scan, backward: the gradients of every Mamba layer.
//
// Replaces no TPU kernel. The JAX package's backward is plain jnp, the
// custom VJP repro/models/ssm.py:170 _selective_scan_bwd, which XLA runs as
// a lax.associative_scan over each chunk. PyTorch has no such primitive: a
// plain-torch backward walks the sequence from the host one step at a time
// (~15 launches a step, ~3 x 10^4 a layer at S = 2048). This kernel takes
// its place on the card; repro_torch/kernels/ssm_scan.py
// ssm_scan_bwd_plain is its plain twin.
//
// What it computes. The forward (ssm_scan.cu) is, per row b, channel d and
// state n, h_t = A_t h_{t-1} + u_t with A_t = exp(dt_t a), u_t = dt_t x_t
// B_t and y_t = sum_n h_t C_t + d_skip x_t. Given dy (B, S, D) and dh_final
// (B, D, N) (null: zero), the reverse recurrence is
//   dh_t = dy_t C_t + A_{t+1} dh_{t+1}      (dh_{S-1} = dy C + dh_final)
// and, with dlogA_t = dh_t h_{t-1} A_t:
//   dx_t  = dt_t sum_n dh_t B_t + d_skip dy_t
//   ddt_t = x_t sum_n dh_t B_t + sum_n dlogA_t a
//   da    = sum_{b,t} dlogA_t dt_t                       (D, N)
//   db_t  = sum_d dh_t dt_t x_t,  dc_t = sum_d h_t dy_t   (B, S, N)
//   dd    = sum_{b,t} dy_t x_t                           (D,)
//   dh0   = A_0 dh_0                                     (B, D, N)
// as _selective_scan_bwd does (repro/models/ssm.py:196-239). x, B, C and
// dy are f32 or bf16 (one dtype), dt, a, d_skip and dh_final f32;
// everything is computed in f32. dx is stored in x's dtype (rounded once,
// as that function's cast does), every other output in f32.
//
// Two launches, planned on the host (ssm_scan.py plan_scan_bwd):
//   1. WALK, a block per (kChannels = 32 channels, row) of W = NP / 4 warps,
//      L = NP / 4 lanes a channel with 4 of its NP states each (N = 16: 4
//      warps of 8 channels). The forward kept the state at the start of
//      every 16-step tile (ssm_scan.cu's KEEP output walk), so the walk takes
//      the tiles in reverse and replays each once: from its kept state, B15's
//      step h <- A*h + (dt*x)*B with A = exp2(dt*a2), a2 = a*log2e, in B15's
//      operation order, so the replayed final state equals the forward's
//      h_final bit for bit (an optional output, for the tests). The replay
//      keeps the tile's A_t (in registers, the tile unrolled, its first
//      steps' in shared memory) and the states before each of its steps in
//      shared memory (the state after the last in registers); the reverse
//      recurrence then runs over the tile with no exponential. A step's two
//      sums over states (dh B and dlogA a, for dx and ddt) join the lanes by
//      xor-shuffles, and the channel's first lane puts dx and ddt in a
//      shared tile that the block writes as rows. da and dd accumulate in
//      registers over the steps (a row's partial). db and dc, sums over
//      channels, are reduced over the warp a step at a time by a fixed
//      butterfly over the lanes that hold the same states, which leaves each
//      of the 2 * NP sums on its own lane (in a register for the tile); at
//      the tile's end the warps' sums go to shared memory and the block adds
//      them in warp order, one store per (row, step, sum) and block.
//   2. COMBINE, a thread per output: db and dc summed over the blocks, da
//      and dd over the rows, each in index order.
// No float atomics and a fixed order everywhere: two runs give equal bits.
//
// Staging. x, dt and dy of a tile are whole coalesced rows of the block's
// 32 channels, copied by 16-byte cp.async into a double buffer from offsets
// each thread computes once, the next tile's copies in flight while this
// tile runs; where a row is not whole or aligned (odd D, the ragged channel
// block, the sequence's last tile) by plain loads. B and C (16 x NP values
// the block's channels share) go through registers one tile ahead to a
// shared double buffer as f32, as in B15; they and the tile's kept state
// load into registers halfway through the tile before.
//
// Why this shape. A channel's steps form one dependent chain, so the walk's
// parallelism is B x D x L lanes (65,536 at the training shape, B = 2, D =
// 8192, N = 16: 2048 warps, 512 blocks). The walk is bound by its issued
// instructions and their latency, not by the SFUs or bytes, so the design
// evaluates the function's one exponential an element once (a one-warp
// walk that replayed each chunk to find its tiles' states, then each tile,
// then formed A_t again in the reverse step took 2.3705 ms, chip_smoke
// phase 7f, NVIDIA H100 80GB HBM3, 700 W), stages B/C once a block, adds
// the block's warps' db/dc sums before one store (134 MB of partials, not
// 537), and writes dx and ddt as rows. The launch bound asks for 16 warps
// an SM (128 registers a lane), so the training shape's 512 blocks take
// one wave of 528. A_t of a tile's last steps lives in registers and of its
// first kSharedA<T> steps in shared memory (the most that keeps 4 blocks an
// SM within 228 KB: 56,320 bytes a block with bf16 operands, 57,344 with
// f32). Builds of this source with other bounds, timed in turns on that
// card at the training shape, ran slower with 12 warps an SM (170
// registers, all of A_t in registers: 1.3 waves) or 8 (1.9 waves), and a
// little slower with all of A_t in registers, though under the
// 128-register bound ptxas spills (120 bytes of stores, 188 of loads a lane
// in the bf16, N = 16 walk; chip_smoke.py's build report). A chunk-parallel
// reverse carry is not needed to fill the card (one wave already), and its
// extra walk for the chunks' carries would add an exponential an element.
//
// Bound, at the training shape. One exponential per (row, step, channel,
// state), 0.128 ms over the SFUs' 16 per SM per clock; 18 f32 operations
// per element (4 to replay, 14 in the reverse step), 0.144 ms at the f32
// rate; the bytes (x, dt, dy read, dx in x's dtype and ddt written), 0.143
// ms.
//
// Padded states (N -> NP = 4, 8 or 16): a = 0 and B = C = 0 there and the
// kept states are 0, so h and dh stay exactly 0 and the padded sums hold
// exact zeros; they are never written. Padded steps (past S in the last
// tile) have dt = x = dy = B = C = 0: A = 1, so h and the carry pass through
// them unchanged, and what they would store is never written.
#include "common.cuh"

namespace {

constexpr int kTile = 16;          // steps a tile: the forward keeps the state at the start of each
constexpr int kChannels = 32;      // channels a block
constexpr int kStages = 2;         // x, dt, dy tiles in shared memory: the cp.async double buffer
constexpr int kWarpsPerSM = 16;    // warps an SM the launch bound makes room for (<= 128 registers a lane)
// A tile's first steps whose A_t waits in shared memory, not in registers:
// the most that keeps 4 blocks of 4 warps an SM within its 228 KB.
template <typename T>
constexpr int kSharedA = 8 / (int)sizeof(T);
constexpr int kCombineThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

struct BwdArgs {
  const void* x;
  const float* dt;
  const float* a;
  const void* bt;
  const void* ct;
  const float* dskip;
  const float* states;  // (batch, tiles, dim, NP): the state at the start of every tile (the forward's)
  const void* dy;
  const float* dhf;     // (batch, dim, n) or null
  void* dx;             // x's dtype
  float* ddt;
  float* da;
  float* db;
  float* dc;
  float* dd;
  float* dh0;
  float* hlast;         // replayed final state (batch, dim, n), or null
  float* ws_bc;         // (batch, seq, blocks, 2 * NP): the blocks' db / dc sums
  float* ws_a;          // (batch, dim, n): rows' da
  float* ws_d;          // (batch, dim): rows' dd
  long long batch, seq, dim;
  int n, tiles, blocks, vec;
};

// A block's shared memory. hs: each lane's states before the tile's steps
// 0 .. 15 (the kept state, then the replay's), then, at the tile's end, the
// warp's db/dc sums [step][2 * NP] in its own slots; as: each lane's A_t of
// the tile's first kSharedA<T> steps.
template <typename T, int NP>
struct Shared {
  static constexpr int W = NP / 4;
  float4 hs[W][kTile][32];
  float4 as[W][kSharedA<T>][32];
  T sx[kStages][kTile][kChannels];
  float sdt[kStages][kTile][kChannels];
  T sdy[kStages][kTile][kChannels];
  float sb[2][kTile * NP];
  float sc[2][kTile * NP];
  float sddt[kTile][kChannels];
  T sdx[kTile][kChannels];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned sm = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sm), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float load_f(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, long long i) { return __bfloat162float(p[i]); }
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float& dst, float v) { dst = v; }
__device__ __forceinline__ void put(__nv_bfloat16& dst, float v) { dst = __float2bfloat16_rn(v); }

// kTile rows of ROW bytes from global rows `pitch` bytes apart into a
// shared tile of ROW-byte rows, by 16-byte cp.async over the block's
// threads.
template <int ROW, int THREADS>
__device__ __forceinline__ void copy_rows(void* dst, const void* src, long long pitch, int tid) {
  constexpr int kC = ROW / 16, kTotal = kTile * kC;
#pragma unroll
  for (int c = tid; c < kTotal; c += THREADS) {
    cp_async16(static_cast<char*>(dst) + (c / kC) * ROW + (c % kC) * 16,
               static_cast<const char*>(src) + (c / kC) * pitch + (c % kC) * 16);
  }
}

// The same from shared to global memory, as 16-byte stores.
template <int ROW, int THREADS>
__device__ __forceinline__ void store_rows(void* dst, const void* src, long long pitch, int tid) {
  constexpr int kC = ROW / 16, kTotal = kTile * kC;
#pragma unroll
  for (int c = tid; c < kTotal; c += THREADS) {
    *reinterpret_cast<float4*>(static_cast<char*>(dst) + (c / kC) * pitch + (c % kC) * 16) =
        *reinterpret_cast<const float4*>(static_cast<const char*>(src) + (c / kC) * ROW + (c % kC) * 16);
  }
}

// The sum of each of a lane's 8 values (db, dc of its 4 states) over the
// warp's channels, the lanes that agree in lane % L. Three reduce-scatter
// levels over lane bits 4, 3, 2 (lanes with the bit set keep the upper
// half, each adding its partner's copy), then xor levels over the channel
// bits below 2 (offsets 2 .. L). Lane l ends with the sum of its value
// l >> 2.
template <int H>
__device__ __forceinline__ void scatter_level(float (&v)[8], int lane) {
  constexpr int off = 4 * H;  // H = 4, 2, 1: lane bits 4, 3, 2
  const bool up = lane & off;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? v[i] : v[i + H];
    const float keep = up ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
  }
}

template <int L>
__device__ __forceinline__ float channel_sum(float (&v)[8], int lane) {
  scatter_level<4>(v, lane);
  scatter_level<2>(v, lane);
  scatter_level<1>(v, lane);
  float r = v[0];
#pragma unroll
  for (int off = 2; off >= L; off >>= 1) r += __shfl_xor_sync(0xffffffffu, r, off);
  return r;
}

template <typename T, int NP>
__global__ void __launch_bounds__(8 * NP, kWarpsPerSM / (NP / 4)) ssm_bwd_walk(const BwdArgs p) {
  constexpr int L = NP / 4;                 // lanes a channel
  constexpr int W = NP / 4;                 // warps a block
  constexpr int kThreads = 32 * W;
  constexpr int C = 32 / L;                 // channels a warp
  constexpr int V = 2 * NP;                 // db and dc sums a step
  constexpr int kBC = kTile * NP;           // B (or C) values of a tile
  constexpr int kPer = kBC / kThreads;      // ... a thread stages
  static_assert(C * W == kChannels && kBC % kThreads == 0, "a block is kChannels channels");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Shared<T, NP>& sm = *reinterpret_cast<Shared<T, NP>*>(smem_raw);

  const int tid = threadIdx.x;
  const int w = tid / 32, lane = tid % 32;
  const int ch = lane / L, q = lane % L;    // the lane's channel in the warp, and its 4 states 4q ..
  const int cb = w * C + ch;                // ... its channel in the block
  const long long d0 = (long long)blockIdx.x * kChannels;
  const long long d = d0 + cb;
  const long long b = blockIdx.y;
  const long long seq = p.seq, dim = p.dim;
  const int n = p.n;
  const bool live = d < dim;
  const bool vec = p.vec && dim % 8 == 0 && d0 + kChannels <= dim;  // uniform across the block

  float a2[4], am[4], carry[4], da[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = 4 * q + r;
    const bool on = live && m < n;
    am[r] = on ? p.a[d * n + m] : 0.f;
    a2[r] = am[r] * kLog2e;
    carry[r] = (on && p.dhf != nullptr) ? p.dhf[(b * dim + d) * n + m] : 0.f;
    da[r] = 0.f;
  }
  const float dsk = live ? p.dskip[d] : 0.f;
  float dd = 0.f;

  // The row's channel d0 at step 0, and this lane's kept state of tile 0.
  const T* xg = static_cast<const T*>(p.x) + b * seq * dim + d0;
  const float* dtg = p.dt + b * seq * dim + d0;
  const T* dyg = static_cast<const T*>(p.dy) + b * seq * dim + d0;
  T* dxg = static_cast<T*>(p.dx) + b * seq * dim + d0;
  float* ddtg = p.ddt + b * seq * dim + d0;
  const float* kst = p.states + (b * p.tiles * dim + d) * NP + 4 * q;

  // x, dt and dy of tile i into ring slot `slot`: whole rows by cp.async
  // where the block's rows are whole and aligned, else plain loads, zero
  // past the sequence and the channels. One commit group a tile.
  auto issue = [&](int i, int slot) {
    const long long tt = (long long)i * kTile;
    const int rem = (int)min((long long)kTile, seq - tt);
    if (vec && rem == kTile) {
      copy_rows<kChannels * sizeof(T), kThreads>(sm.sx[slot], xg + tt * dim, dim * (long long)sizeof(T), tid);
      copy_rows<kChannels * 4, kThreads>(sm.sdt[slot], dtg + tt * dim, dim * 4LL, tid);
      copy_rows<kChannels * sizeof(T), kThreads>(sm.sdy[slot], dyg + tt * dim, dim * (long long)sizeof(T), tid);
    } else {
#pragma unroll
      for (int e = tid; e < kTile * kChannels; e += kThreads) {
        const int st = e / kChannels, c = e % kChannels;
        const bool on = st < rem && d0 + c < dim;
        const long long o = (tt + st) * dim + c;
        sm.sx[slot][st][c] = on ? xg[o] : T{};
        sm.sdt[slot][st][c] = on ? dtg[o] : 0.f;
        sm.sdy[slot][st][c] = on ? dyg[o] : T{};
      }
    }
    cp_async_commit();
  };
  // B and C of tile i (value e = tid + j * kThreads is (step e / NP, state
  // e % NP)), zero past N and the sequence, through registers.
  auto load_bc = [&](int i, float (&bv)[kPer], float (&cv)[kPer]) {
    const long long tt = (long long)i * kTile;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = tid + j * kThreads;
      const bool in = e % NP < n && tt + e / NP < seq;
      const long long o = (b * seq + tt + e / NP) * n + e % NP;
      bv[j] = in ? load_f(static_cast<const T*>(p.bt), o) : 0.f;
      cv[j] = in ? load_f(static_cast<const T*>(p.ct), o) : 0.f;
    }
  };
  auto stage_bc = [&](int buf, const float (&bv)[kPer], const float (&cv)[kPer]) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      sm.sb[buf][tid + j * kThreads] = bv[j];
      sm.sc[buf][tid + j * kThreads] = cv[j];
    }
  };
  auto load_state = [&](int i) {
    return live ? *reinterpret_cast<const float4*>(kst + (long long)i * dim * NP) : make_float4(0.f, 0.f, 0.f, 0.f);
  };

  const int last = p.tiles - 1;
  float bv[kPer], cv[kPer];
  issue(last, 0);
  load_bc(last, bv, cv);
  stage_bc(0, bv, cv);
  float4 hn = load_state(last);
  int slot = 0, buf = 0;
  for (int i = last; i >= 0; --i) {
    const long long tt = (long long)i * kTile;
    const int rem = (int)min((long long)kTile, seq - tt);
    cp_async_wait_all();  // this thread's copies of tile i have landed
    __syncthreads();      // everyone's have; the last tile's sums, rows and slots are free
    if (i > 0) issue(i - 1, slot ^ 1);  // tile i-1's x, dt, dy, in flight while tile i runs
    const T* xs = &sm.sx[slot][0][cb];
    const float* dts = &sm.sdt[slot][0][cb];
    const T* dys = &sm.sdy[slot][0][cb];
    const float* bs = &sm.sb[buf][4 * q];
    const float* cs = &sm.sc[buf][4 * q];
    float4* hs = &sm.hs[w][0][lane];        // the state before step s at hs[s * 32]
    float4* as = &sm.as[w][0][lane];        // A_t of step s < kSharedA<T> at as[s * 32]

    // The replay: A_t into registers, the states before steps 0 .. 15 into
    // shared memory (the state after step 15 stays in registers).
    float A[kTile][4], h[4] = {hn.x, hn.y, hn.z, hn.w};
    hs[0] = hn;
#pragma unroll
    for (int s = 0; s < kTile; ++s) {
      const float dtv = dts[s * kChannels], xv = to_f(xs[s * kChannels]);
      const float dx = dtv * xv;
      const float4 b4 = *reinterpret_cast<const float4*>(bs + s * NP);
      const float bq[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        A[s][r] = ex2(dtv * a2[r]);
        h[r] = fmaf(A[s][r], h[r], dx * bq[r]);
      }
      if (s < kTile - 1) hs[(s + 1) * 32] = make_float4(h[0], h[1], h[2], h[3]);
      if (s < kSharedA<T>) as[s * 32] = make_float4(A[s][0], A[s][1], A[s][2], A[s][3]);
    }
    if (i == last && p.hlast != nullptr && live) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (4 * q + r < n) p.hlast[(b * dim + d) * n + 4 * q + r] = h[r];
      }
    }

    // The reverse recurrence over the tile's steps, with the states after
    // (hcur) and before (hprev) each step: only the carry chains one step
    // to the next. Tile i-1's B, C and kept state load halfway through.
    float sums[kTile];
    float hcur[4] = {h[0], h[1], h[2], h[3]};
#pragma unroll
    for (int s = kTile - 1; s >= 0; --s) {
      if (s == kTile / 2 && i > 0) {
        load_bc(i - 1, bv, cv);
        hn = load_state(i - 1);
      }
      const float4 hv = hs[s * 32];
      const float hprev[4] = {hv.x, hv.y, hv.z, hv.w};
      if (s < kSharedA<T>) {
        const float4 av = as[s * 32];
        A[s][0] = av.x, A[s][1] = av.y, A[s][2] = av.z, A[s][3] = av.w;
      }
      const float xv = to_f(xs[s * kChannels]), dtv = dts[s * kChannels], dyv = to_f(dys[s * kChannels]);
      const float dtx = dtv * xv;
      const float4 b4 = *reinterpret_cast<const float4*>(bs + s * NP);
      const float4 c4 = *reinterpret_cast<const float4*>(cs + s * NP);
      const float bq[4] = {b4.x, b4.y, b4.z, b4.w}, cq[4] = {c4.x, c4.y, c4.z, c4.w};
      float vals[8];
      float gx = 0.f, ga = 0.f;  // sum_n dh B, sum_n dlogA a
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float dh = fmaf(dyv, cq[r], carry[r]);
        const float dl = dh * hprev[r] * A[s][r];
        gx = fmaf(dh, bq[r], gx);
        ga = fmaf(dl, am[r], ga);
        da[r] = fmaf(dl, dtv, da[r]);
        vals[r] = dh * dtx;
        vals[4 + r] = hcur[r] * dyv;
        carry[r] = A[s][r] * dh;
      }
#pragma unroll
      for (int off = 1; off < L; off <<= 1) {
        gx += __shfl_xor_sync(0xffffffffu, gx, off);
        ga += __shfl_xor_sync(0xffffffffu, ga, off);
      }
      if (q == 0) {
        sm.sddt[s][cb] = fmaf(gx, xv, ga);
        put(sm.sdx[s][cb], fmaf(gx, dtv, dsk * dyv));
      }
      dd = fmaf(dyv, xv, dd);
      sums[s] = channel_sum<L>(vals, lane);
#pragma unroll
      for (int r = 0; r < 4; ++r) hcur[r] = hprev[r];
    }

    // The warp's db/dc sums into its own (read) state slots; then the
    // block adds its warps' in order and stores one value per (step, sum).
    __syncwarp();
    if ((lane & 3) < L) {  // value lane >> 2 of states 4 * (lane % L) ..
      const int v = lane >> 2;
      float* own = reinterpret_cast<float*>(&sm.hs[w][0][0]) + (v & 4 ? NP : 0) + 4 * q + (v & 3);
#pragma unroll
      for (int s = 0; s < kTile; ++s) own[s * V] = sums[s];
    }
    __syncthreads();
#pragma unroll
    for (int o = tid; o < kTile * V; o += kThreads) {
      const int s = o / V;
      if (s < rem) {
        float acc = 0.f;
#pragma unroll
        for (int u = 0; u < W; ++u) acc += reinterpret_cast<const float*>(&sm.hs[u][0][0])[o];
        p.ws_bc[((b * seq + tt + s) * p.blocks + blockIdx.x) * V + o % V] = acc;
      }
    }
    // dx and ddt of the tile as rows.
    if (vec && rem == kTile) {
      store_rows<kChannels * 4, kThreads>(ddtg + tt * dim, sm.sddt, dim * 4LL, tid);
      store_rows<kChannels * sizeof(T), kThreads>(dxg + tt * dim, sm.sdx, dim * (long long)sizeof(T), tid);
    } else {
#pragma unroll
      for (int e = tid; e < kTile * kChannels; e += kThreads) {
        const int st = e / kChannels, c = e % kChannels;
        if (st < rem && d0 + c < dim) {
          ddtg[(tt + st) * dim + c] = sm.sddt[st][c];
          dxg[(tt + st) * dim + c] = sm.sdx[st][c];
        }
      }
    }
    if (i > 0) stage_bc(buf ^ 1, bv, cv);
    slot ^= 1;
    buf ^= 1;
  }

  if (!live) return;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = 4 * q + r;
    if (m < n) {
      p.dh0[(b * dim + d) * n + m] = carry[r];
      p.ws_a[(b * dim + d) * n + m] = da[r];
    }
  }
  if (q == 0) p.ws_d[b * dim + d] = dd;
}

// Launch 2: a thread per output. db[b, t, m] and dc[b, t, m] sum the
// blocks' values NP-slot m and NP + m in block order; da and dd sum the
// rows in row order.
template <int NP>
__global__ void __launch_bounds__(kCombineThreads) ssm_bwd_combine(const BwdArgs p) {
  constexpr int V = 2 * NP;
  long long i = (long long)blockIdx.x * kCombineThreads + threadIdx.x;
  const long long n = p.n;
  const long long bc = p.batch * p.seq * 2 * n;
  if (i < bc) {
    const long long row = i / (2 * n);
    const int j = (int)(i % (2 * n));
    const bool is_c = j >= n;
    const int m = is_c ? j - (int)n : j;
    const float* src = p.ws_bc + row * p.blocks * V + (is_c ? NP : 0) + m;
    float s = 0.f;
#pragma unroll 8
    for (int k = 0; k < p.blocks; ++k) s += src[(long long)k * V];  // in order; 8 loads in flight
    (is_c ? p.dc : p.db)[row * n + m] = s;
    return;
  }
  i -= bc;
  if (i < p.dim * n) {
    float s = 0.f;
    for (long long r = 0; r < p.batch; ++r) s += p.ws_a[r * p.dim * n + i];
    p.da[i] = s;
    return;
  }
  i -= p.dim * n;
  if (i < p.dim) {
    float s = 0.f;
    for (long long r = 0; r < p.batch; ++r) s += p.ws_d[r * p.dim + i];
    p.dd[i] = s;
  }
}

template <typename T, int NP>
int launch(const BwdArgs& p, cudaStream_t s) {
  constexpr int kThreads = 8 * NP;
  constexpr int kBytes = (int)sizeof(Shared<T, NP>);
  static const cudaError_t attr =
      cudaFuncSetAttribute(ssm_bwd_walk<T, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (attr != cudaSuccess) return (int)attr;
  ssm_bwd_walk<T, NP><<<dim3((unsigned)p.blocks, (unsigned)p.batch), kThreads, kBytes, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long outs = p.batch * p.seq * 2 * p.n + p.dim * p.n + p.dim;
  ssm_bwd_combine<NP><<<(unsigned)((outs + kCombineThreads - 1) / kCombineThreads), kCombineThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_np(const BwdArgs& p, cudaStream_t s) {
  if (p.n <= 4) return launch<T, 4>(p, s);
  if (p.n <= 8) return launch<T, 8>(p, s);
  return launch<T, 16>(p, s);
}

}  // namespace

// x, b_t, c_t, dy: contiguous (batch, seq, dim) / (batch, seq, n) / (batch,
// seq, dim), all f32 (in_bf16 = 0) or all bf16 (in_bf16 = 1); dt f32 (batch,
// seq, dim); a f32 (dim, n); d_skip f32 (dim,); states f32 (batch, tiles,
// dim, NP), 16-byte aligned: the state at the start of every 16-step tile
// (ssm_scan.cu's KEEP output walk; padded states 0), NP = n padded to 4, 8
// or 16; dh_final f32 (batch, dim, n) or null. Outputs: dx (batch, seq,
// dim) in x's dtype; f32 ddt (batch, seq, dim), da (dim, n), db, dc (batch,
// seq, n), dd (dim,), dh0 (batch, dim, n), h_last (batch, dim, n) or null.
// Workspaces f32: ws_bc (batch, seq, blocks, 2 * NP), ws_a (batch, dim, n),
// ws_d (batch, dim). tiles = ceil(seq / 16), blocks = ceil(dim / 32)
// (plan_scan_bwd's). vec: x, dt, dy, dx and ddt start on 16-byte
// boundaries. 1 <= n <= 16; batch < 65536. Returns the cudaError_t of the
// launches.
extern "C" int repro_ssm_scan_bwd(const void* x, int in_bf16, const float* dt, const float* a, const void* b_t,
                                  const void* c_t, const float* d_skip, const float* states, const void* dy,
                                  const float* dh_final, void* dx, float* ddt, float* da, float* db, float* dc,
                                  float* dd, float* dh0, float* h_last, float* ws_bc, float* ws_a, float* ws_d,
                                  long long batch, long long seq, long long dim, int n, int tiles, int blocks,
                                  int vec, void* stream) {
  if (batch < 1 || batch > 65535 || seq < 1 || dim < 1 || n < 1 || n > 16 || states == nullptr ||
      tiles != (int)((seq + kTile - 1) / kTile) || blocks != (int)((dim + kChannels - 1) / kChannels)) {
    return (int)cudaErrorInvalidValue;
  }
  const BwdArgs p{x, dt, a, b_t, c_t, d_skip, states, dy, dh_final, dx, ddt, da, db, dc, dd, dh0, h_last,
                  ws_bc, ws_a, ws_d, batch, seq, dim, n, tiles, blocks, vec};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16) return launch_np<__nv_bfloat16>(p, s);
  return launch_np<float>(p, s);
}
