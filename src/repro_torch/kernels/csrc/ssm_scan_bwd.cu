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
// dy are f32 or bf16 (one dtype), dt, a, d_skip, h0 and dh_final f32;
// everything is computed in f32. dx is stored in x's dtype (rounded once,
// as that function's cast does), every other output in f32.
//
// Two launches, planned on the host (ssm_scan.py plan_scan_bwd):
//   1. WALK, a block of one warp per (32 / L channels, row): L = NP / 4
//      lanes a channel, each with 4 of its NP states in registers. It walks
//      the forward's chunks in reverse. Each chunk starts from the state
//      the forward kept at its start (h0, or the forward's carry slot k-1,
//      which its output walk started chunk k from). Pass 1 replays the
//      chunk forward and keeps the state at the start of each 16-step tile
//      in a workspace; pass 2 takes the tiles in reverse, replays the tile
//      from its start into shared memory (the state after every step) and
//      runs the reverse recurrence over it. The replay is B15's step,
//      h <- exp2(dt*a2)*h + (dt*x)*B with a2 = a*log2e, in its operation
//      order, so the replayed states equal the forward's bit for bit (the
//      replayed final state is an optional output, for the tests). A
//      step's two sums over states (dh B and dlogA a, for dx and ddt) join
//      the channel's lanes by xor-shuffles; dx and ddt are written a step
//      at a time by the channel's first lane; da and dd accumulate in
//      registers over the steps (a row's partial); db and dc, sums over
//      channels, are reduced over the warp a step at a time by a fixed
//      butterfly over the lanes that hold the same states, which leaves
//      each of the 2 * NP sums on its own lane, then stored as the warp's
//      partial.
//   2. COMBINE, a thread per output: db and dc summed over the warps, da
//      and dd over the rows, each in index order.
// No float atomics and a fixed order everywhere: two runs give equal bits.
//
// Why this shape. A channel's steps form one dependent chain, so the walk's
// parallelism is B x D x L lanes whatever the block (65,536 at the training
// shape, B = 2, D = 8192, N = 16: ~16 warps an SM). One-warp blocks let
// every SM take its share and need only __syncwarp. What chip_smoke.py's
// phase 7f showed at the training shape (NVIDIA H100 80GB HBM3, 700 W, one
// call a design): one thread a channel with all 16 states (~4 warps an SM,
// a 31-shuffle butterfly a step) 2.6305 ms; 4 lanes a channel 2.4669 ms;
// with whole tiles unrolled (below) 2.3627 ms. Four times the warps bought
// 6 %, so the walk is not short of parallelism: what holds it at ~6 % of
// its bound is not measured yet (no ncu on that machine). Under the launch
// bound ptxas gives a lane 128 registers and spills 8-32 bytes (stores;
// 12-64 bytes of loads, 8-32 bytes of stack) across the six walk
// instantiations (-Xptxas -v); the bf16, N = 16 one the model runs spills
// the most. The states of a tile live in shared memory
// ([step][state][lane]: conflict-free), since a lane's 16 x 4 replayed
// states would crowd the registers. The x, dt and dy of a tile are staged
// together (16 independent loads by each of the warp's first 32 / L
// lanes), so a tile pays one memory latency, not one a step. The replays
// run every tile's 16 steps (padded steps have dt = x = B = 0 and leave h
// unchanged, as in B15) and the reverse walk of a whole tile is unrolled:
// only the carry chains one step to the next, so a step's shuffles overlap
// the next step's loads and exponentials. The chunk-parallel reverse
// carry, the mirror of B15's three launches, is later work.
//
// Bound, at the training shape. The function needs one exponential per
// (row, step, channel, state): A_t serves the replay and the reverse step
// (_selective_scan_bwd forms log_decay once), 0.128 ms over the SFUs' 16
// per SM per clock; 18 f32 operations per element (4 to replay, 14 in the
// reverse step), 0.144 ms at the f32 rate; the bytes (x, dt, dy read, dx
// in x's dtype and ddt written), 0.143 ms. This design evaluates A_t three
// times an element (pass 1's replay, pass 2's replay, the reverse step):
// keeping pass 2's A_t beside hs in shared memory is the next design.
//
// Padded states (N -> NP = 4, 8 or 16): a = 0 and B = C = 0 there and the
// states start at 0, so h and dh stay exactly 0 and the padded sums hold
// exact zeros; they are never written.
#include "common.cuh"

namespace {

constexpr int kThreads = 32;          // a block: one warp
constexpr int kMinBlocks = 16;        // blocks an SM the planner counts on (<= 128 registers a lane)
constexpr int kTile = 16;             // steps a tile
constexpr int kCombineThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

struct BwdArgs {
  const void* x;
  const float* dt;
  const float* a;
  const void* bt;
  const void* ct;
  const float* dskip;
  const float* h0;
  const float* bounds;  // (batch, chunks - 1, dim, n): state at the end of chunk j (forward's carry)
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
  float* ws_h;          // (batch, chunk_tiles, dim, NP): tile start states of the current chunk
  float* ws_bc;         // (batch, seq, warps, 2 * NP): the warps' db / dc sums
  float* ws_a;          // (batch, dim, n): rows' da
  float* ws_d;          // (batch, dim): rows' dd
  long long batch, seq, dim, chunk;
  int n, chunks, chunk_tiles, warps;
};

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float load_f(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, long long i) { return __bfloat162float(p[i]); }
__device__ __forceinline__ void store_f(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, long long i, float v) { p[i] = __float2bfloat16_rn(v); }

// B15's step (ssm_scan.cu state_step without y) on a lane's 4 states:
// h <- exp2(dt*a2)*h + (dt*x)*B.
__device__ __forceinline__ void replay_step(float (&h)[4], const float (&a2)[4], float dtv, float xv,
                                            const float* bs) {
  const float dx = dtv * xv;
  const float4 b4 = *reinterpret_cast<const float4*>(bs);
  const float bq[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
  for (int r = 0; r < 4; ++r) h[r] = fmaf(ex2(dtv * a2[r]), h[r], dx * bq[r]);
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
__global__ void __launch_bounds__(kThreads, kMinBlocks) ssm_bwd_walk(const BwdArgs p) {
  constexpr int L = NP / 4;                 // lanes a channel
  constexpr int C = kThreads / L;           // channels a warp
  constexpr int kPer = kTile * NP / kThreads;
  static_assert(kTile * NP % kThreads == 0, "whole B/C values a lane");
  __shared__ __align__(16) float hs[kTile + 1][4][kThreads];  // state before step 0 .. after step 15
  __shared__ __align__(16) float sb[kTile][NP];
  __shared__ __align__(16) float sc[kTile][NP];
  __shared__ float sx[kTile][C], sdt[kTile][C], sdy[kTile][C];

  const int lane = threadIdx.x;
  const int ch = lane / L, q = lane % L;    // the lane's channel in the warp, and its 4 states 4q ..
  const long long d0 = (long long)blockIdx.x * C;
  const long long d = d0 + ch;
  const long long b = blockIdx.y;
  const long long seq = p.seq, dim = p.dim;
  const int n = p.n;
  const bool live = d < dim;
  const bool stager = lane < C && d0 + lane < dim;  // loads channel d0 + lane's x, dt, dy
  const T* xp = static_cast<const T*>(p.x) + b * seq * dim + d0 + lane;
  const float* dtp = p.dt + b * seq * dim + d0 + lane;
  const T* dyp = static_cast<const T*>(p.dy) + b * seq * dim + d0 + lane;
  T* dxp = static_cast<T*>(p.dx) + b * seq * dim + d;
  float* ddtp = p.ddt + b * seq * dim + d;
  float* wsh = p.ws_h + (b * p.chunk_tiles * dim + d) * NP + 4 * q;  // + tile * dim * NP
  const long long wsh_tile = dim * NP;

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

  // The tile's B (and C) as f32 and the warp's channels' x, dt (and dy),
  // zero past the tile's steps, past N and past the channels.
  auto stage = [&](long long tt, int rem, bool bwd) {
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = lane + j * kThreads;
      const int st = e / NP, m = e % NP;
      const bool on = st < rem && m < n;
      const long long i = (b * seq + tt + st) * n + m;
      sb[st][m] = on ? load_f(static_cast<const T*>(p.bt), i) : 0.f;
      if (bwd) sc[st][m] = on ? load_f(static_cast<const T*>(p.ct), i) : 0.f;
    }
    if (lane < C) {
#pragma unroll
      for (int st = 0; st < kTile; ++st) {
        const bool on = stager && st < rem;
        const long long o = (tt + st) * dim;
        sx[st][lane] = on ? load_f(xp, o) : 0.f;
        sdt[st][lane] = on ? dtp[o] : 0.f;
        if (bwd) sdy[st][lane] = on ? load_f(dyp, o) : 0.f;
      }
    }
    __syncwarp();
  };

  for (int k = p.chunks - 1; k >= 0; --k) {
    const long long t0 = (long long)k * p.chunk;
    const long long t1 = min(seq, t0 + p.chunk);
    const int tiles = (int)((t1 - t0 + kTile - 1) / kTile);
    const float* start = k == 0 ? p.h0 + (b * dim + d) * n
                                : p.bounds + ((b * (p.chunks - 1) + k - 1) * dim + d) * n;
    float h[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) h[r] = (live && 4 * q + r < n) ? start[4 * q + r] : 0.f;

    // Pass 1: replay the chunk, keeping each tile's start state.
    for (int i = 0; i < tiles; ++i) {
      const long long tt = t0 + (long long)i * kTile;
      const int rem = (int)min((long long)kTile, t1 - tt);
      if (live) *reinterpret_cast<float4*>(wsh + i * wsh_tile) = make_float4(h[0], h[1], h[2], h[3]);
      stage(tt, rem, false);
#pragma unroll
      for (int s = 0; s < kTile; ++s) replay_step(h, a2, sdt[s][ch], sx[s][ch], &sb[s][4 * q]);
    }
    if (k == p.chunks - 1 && p.hlast != nullptr && live) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (4 * q + r < n) p.hlast[(b * dim + d) * n + 4 * q + r] = h[r];
      }
    }

    // Pass 2: the tiles in reverse; replay each into shared memory, then
    // run the reverse recurrence over its steps.
    for (int i = tiles - 1; i >= 0; --i) {
      const long long tt = t0 + (long long)i * kTile;
      const int rem = (int)min((long long)kTile, t1 - tt);
      if (live) {
        const float4 v = *reinterpret_cast<const float4*>(wsh + i * wsh_tile);
        h[0] = v.x, h[1] = v.y, h[2] = v.z, h[3] = v.w;
      }
      stage(tt, rem, true);
#pragma unroll
      for (int r = 0; r < 4; ++r) hs[0][r][lane] = h[r];
#pragma unroll
      for (int s = 0; s < kTile; ++s) {
        replay_step(h, a2, sdt[s][ch], sx[s][ch], &sb[s][4 * q]);
#pragma unroll
        for (int r = 0; r < 4; ++r) hs[s + 1][r][lane] = h[r];
      }
      auto reverse_step = [&](int s) {
        const float xv = sx[s][ch], dtv = sdt[s][ch], dyv = sdy[s][ch];
        const float dtx = dtv * xv;
        const float4 b4 = *reinterpret_cast<const float4*>(&sb[s][4 * q]);
        const float4 c4 = *reinterpret_cast<const float4*>(&sc[s][4 * q]);
        const float bq[4] = {b4.x, b4.y, b4.z, b4.w}, cq[4] = {c4.x, c4.y, c4.z, c4.w};
        float vals[8];
        float gx = 0.f, ga = 0.f;  // sum_n dh B, sum_n dlogA a
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float dh = fmaf(dyv, cq[r], carry[r]);
          const float e = ex2(dtv * a2[r]);
          const float dl = dh * hs[s][r][lane] * e;
          gx = fmaf(dh, bq[r], gx);
          ga = fmaf(dl, am[r], ga);
          da[r] = fmaf(dl, dtv, da[r]);
          vals[r] = dh * dtx;
          vals[4 + r] = hs[s + 1][r][lane] * dyv;
          carry[r] = e * dh;
        }
#pragma unroll
        for (int off = 1; off < L; off <<= 1) {
          gx += __shfl_xor_sync(0xffffffffu, gx, off);
          ga += __shfl_xor_sync(0xffffffffu, ga, off);
        }
        const long long t = tt + s;
        if (live && q == 0) {
          ddtp[t * dim] = fmaf(gx, xv, ga);
          store_f(dxp, t * dim, fmaf(gx, dtv, dsk * dyv));
        }
        dd = fmaf(dyv, xv, dd);
        const float sum = channel_sum<L>(vals, lane);
        if ((lane & 3) < L) {  // one lane of each value: value lane >> 2 of states 4 * (lane % L) ..
          const int v = lane >> 2;
          p.ws_bc[((b * seq + t) * p.warps + blockIdx.x) * (2 * NP) + (v & 4 ? NP : 0) + 4 * q + (v & 3)] = sum;
        }
      };
      // Whole tiles unrolled, so a step's sums overlap the next step's
      // work (only carry chains the steps); a chunk's last tile in a loop.
      if (rem == kTile) {
#pragma unroll
        for (int s = kTile - 1; s >= 0; --s) reverse_step(s);
      } else {
        for (int s = rem - 1; s >= 0; --s) reverse_step(s);
      }
    }
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
// warps' values NP-slot m and NP + m in warp order; da and dd sum the rows
// in row order.
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
    const float* src = p.ws_bc + row * p.warps * V + (is_c ? NP : 0) + m;
    float s = 0.f;
#pragma unroll 8
    for (int w = 0; w < p.warps; ++w) s += src[(long long)w * V];  // in order; 8 loads in flight
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
  ssm_bwd_walk<T, NP><<<dim3((unsigned)p.warps, (unsigned)p.batch), kThreads, 0, s>>>(p);
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
// seq, dim); a f32 (dim, n); d_skip f32 (dim,); h0 f32 (batch, dim, n);
// bounds f32 (batch, chunks - 1, dim, n) when chunks > 1 (else ignored);
// dh_final f32 (batch, dim, n) or null. Outputs: dx (batch, seq, dim) in
// x's dtype; f32 ddt (batch, seq, dim), da (dim, n), db, dc (batch, seq,
// n), dd (dim,), dh0 (batch, dim, n), h_last (batch, dim, n) or null. Workspaces f32: ws_h (batch,
// chunk_tiles, dim, NP) 16-byte aligned, ws_bc (batch, seq, warps, 2 * NP),
// ws_a (batch, dim, n), ws_d (batch, dim), with NP = n padded to 4, 8 or 16.
// chunk, chunks, chunk_tiles and warps are plan_scan_bwd's: chunks =
// ceil(seq / chunk), chunk_tiles = ceil(min(chunk, seq) / 16), warps =
// ceil(dim / (128 / NP)). 1 <= n <= 16; batch < 65536. Returns the
// cudaError_t of the launches.
extern "C" int repro_ssm_scan_bwd(const void* x, int in_bf16, const float* dt, const float* a, const void* b_t,
                                  const void* c_t, const float* d_skip, const float* h0, const float* bounds,
                                  const void* dy, const float* dh_final, void* dx, float* ddt, float* da,
                                  float* db, float* dc, float* dd, float* dh0, float* h_last, float* ws_h,
                                  float* ws_bc, float* ws_a, float* ws_d, long long batch, long long seq,
                                  long long dim, int n, long long chunk, int chunks, int chunk_tiles, int warps,
                                  void* stream) {
  const int np = n <= 4 ? 4 : n <= 8 ? 8 : 16;
  const long long per_warp = kThreads / (np / 4);
  if (batch < 1 || batch > 65535 || seq < 1 || dim < 1 || n < 1 || n > 16 || chunk < 1 || chunks < 1 ||
      (seq + chunk - 1) / chunk != chunks || (chunks > 1 && bounds == nullptr) ||
      chunk_tiles != (int)(((chunk < seq ? chunk : seq) + kTile - 1) / kTile) ||
      warps != (int)((dim + per_warp - 1) / per_warp)) {
    return (int)cudaErrorInvalidValue;
  }
  const BwdArgs p{x, dt, a, b_t, c_t, d_skip, h0, bounds, dy, dh_final, dx, ddt, da, db, dc, dd, dh0, h_last,
                  ws_h, ws_bc, ws_a, ws_d, batch, seq, dim, chunk, n, chunks, chunk_tiles, warps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16) return launch_np<__nv_bfloat16>(p, s);
  return launch_np<float>(p, s);
}
