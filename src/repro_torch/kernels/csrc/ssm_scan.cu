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
// Bound: at the eval shape (B=1, S=2048, D=8192, N=16) the card must read x
// (bf16) and dt (f32) and write y (f32), ~168 MB, 0.050 ms at 3.35 TB/s;
// but every (t, d, n) needs one exponential, 268 M of them, and the SFUs
// that evaluate them (16 per SM per clock) take ~0.064 ms for that count.
// The kernel never materialises the (B, S, D, N) expansion of the state.
//
// Design. The TPU kernel's grid (batch, d tiles, sequence chunks) carries
// the state through VMEM scratch across the sequential chunk axis. Here
// kGroup = 4 adjacent lanes of a warp own one (row, channel): each keeps
// its ceil(N / 4) states of h (and of a[d, :]) in registers for the whole
// sequence, so nothing crosses a block boundary, and the lanes join their
// partial sums of y with two xor-shuffles per step. Splitting N across
// lanes gives 4 threads per channel: at B = 1, D = 8192, one thread per
// channel would leave 256 warps for the card's 528 SM sub-partitions and
// put all N exponentials and the N-term sum of y of a step in one
// thread's dependent chain. The sequence is walked kTile steps at a time:
// each thread first issues its kTile loads of x and dt (independent of h,
// so their latency overlaps), the block stages the tile's B and C (N
// values per step, shared by every channel of the row) in shared memory,
// then the steps run from registers and shared memory, a whole tile
// without branches so that its exponentials issue ahead of the recurrence
// and its shuffles are batched. The state update rounds each product and
// sum on its own (the _rn intrinsics), in _ssm_kernel's order, and the
// exponential is the accurate expf. The same kernel serves decode (S = 1,
// h0 from the cache). A block holds kChannels channels of one row.
#include "common.cuh"

namespace {

constexpr int kGroup = 4;                   // lanes per channel
constexpr int kChannels = 32;               // channels per block
constexpr int kThreads = kGroup * kChannels;
constexpr int kTile = 16;

template <typename T>
__device__ __forceinline__ float load_f(const T* p, long long i);
template <>
__device__ __forceinline__ float load_f<float>(const float* p, long long i) {
  return p[i];
}
template <>
__device__ __forceinline__ float load_f<__nv_bfloat16>(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}

// One timestep for a lane's K states (n0 .. n0 + K - 1 of N): the state
// update h <- exp(dt*a)*h + (dt*x)*B in _ssm_kernel's order, each product
// and sum rounded on its own; returns the lane's part of sum_n h*C.
template <int N, int K>
__device__ __forceinline__ float state_step(float (&h)[K], const float (&ad)[K], float dt, float x, const float* bs,
                                            const float* cs, int n0) {
  const float dx = __fmul_rn(dt, x);
  float part = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (n0 + k < N) {
      const float decay = expf(__fmul_rn(dt, ad[k]));
      h[k] = __fadd_rn(__fmul_rn(decay, h[k]), __fmul_rn(dx, bs[n0 + k]));
      part = __fadd_rn(part, __fmul_rn(h[k], cs[n0 + k]));
    }
  }
  return part;
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads) ssm_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                                                            const float* __restrict__ a, const T* __restrict__ bt,
                                                            const T* __restrict__ ct,
                                                            const float* __restrict__ dskip,
                                                            const float* __restrict__ h0, float* __restrict__ y,
                                                            float* __restrict__ hout, long long seq, long long dim) {
  constexpr int K = (N + kGroup - 1) / kGroup;  // states per lane
  __shared__ float sb[kTile * N];
  __shared__ float sc[kTile * N];
  const long long b = blockIdx.y;
  const int lane = threadIdx.x % kGroup;
  const long long d = (long long)blockIdx.x * kChannels + threadIdx.x / kGroup;
  const bool live = d < dim;
  const int n0 = lane * K;

  float h[K], ad[K];
  float dsk = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const bool on = live && n0 + k < N;
    h[k] = on ? h0[(b * dim + d) * N + n0 + k] : 0.f;
    ad[k] = on ? a[d * N + n0 + k] : 0.f;
  }
  if (live) dsk = dskip[d];
  for (long long t0 = 0; t0 < seq; t0 += kTile) {
    const long long steps = seq - t0 < kTile ? seq - t0 : kTile;
    float xr[kTile], dr[kTile];
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const long long i = (b * seq + t0 + j) * dim + d;
      xr[j] = (live && j < steps) ? load_f<T>(x, i) : 0.f;
      dr[j] = (live && j < steps) ? dt[i] : 0.f;
    }
    __syncthreads();  // the previous tile's B and C are no longer read
    const long long base = (b * seq + t0) * N;
    for (int i = threadIdx.x; i < kTile * N; i += kThreads) {
      const bool in = i < steps * N;
      sb[i] = in ? load_f<T>(bt, base + i) : 0.f;
      sc[i] = in ? load_f<T>(ct, base + i) : 0.f;
    }
    __syncthreads();
    if (steps == kTile) {
      // A whole tile runs without branches: the steps' exponentials depend
      // on dt alone and can be issued ahead of the recurrence, which is one
      // product and one sum per state and step, and the shuffles of the
      // tile's sums of y are batched after it.
      float acc[kTile];
#pragma unroll
      for (int j = 0; j < kTile; ++j) acc[j] = state_step<N, K>(h, ad, dr[j], xr[j], sb + j * N, sc + j * N, n0);
#pragma unroll
      for (int j = 0; j < kTile; ++j) acc[j] = __fadd_rn(acc[j], __shfl_xor_sync(0xffffffffu, acc[j], 1));
#pragma unroll
      for (int j = 0; j < kTile; ++j) acc[j] = __fadd_rn(acc[j], __shfl_xor_sync(0xffffffffu, acc[j], 2));
      if (live && lane == 0) {
#pragma unroll
        for (int j = 0; j < kTile; ++j) y[(b * seq + t0 + j) * dim + d] = __fadd_rn(acc[j], __fmul_rn(dsk, xr[j]));
      }
    } else {
      // The last, partial tile (and decode, S = 1): only its steps run.
      // The guard is uniform across the block, so every lane reaches the
      // shuffles; the unrolled j keeps xr and dr in registers.
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        if (j < steps) {
          float acc = state_step<N, K>(h, ad, dr[j], xr[j], sb + j * N, sc + j * N, n0);
          acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, 1));
          acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, 2));
          if (live && lane == 0) y[(b * seq + t0 + j) * dim + d] = __fadd_rn(acc, __fmul_rn(dsk, xr[j]));
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (live && n0 + k < N) hout[(b * dim + d) * N + n0 + k] = h[k];
  }
}

template <typename T, int N>
int launch_n(const void* x, const float* dt, const float* a, const void* bt, const void* ct, const float* dskip,
             const float* h0, float* y, float* hout, long long batch, long long seq, long long dim, cudaStream_t s) {
  dim3 grid((unsigned)((dim + kChannels - 1) / kChannels), (unsigned)batch);
  ssm_scan_kernel<T, N><<<grid, kThreads, 0, s>>>(static_cast<const T*>(x), dt, a, static_cast<const T*>(bt),
                                                  static_cast<const T*>(ct), dskip, h0, y, hout, seq, dim);
  return (int)cudaGetLastError();
}

// N = 1..16: one instantiation per state size.
template <typename T, int N = 1>
int launch(const void* x, const float* dt, const float* a, const void* bt, const void* ct, const float* dskip,
           const float* h0, float* y, float* hout, long long batch, long long seq, long long dim, int n,
           cudaStream_t s) {
  if constexpr (N > 16) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (n == N) return launch_n<T, N>(x, dt, a, bt, ct, dskip, h0, y, hout, batch, seq, dim, s);
    return launch<T, N + 1>(x, dt, a, bt, ct, dskip, h0, y, hout, batch, seq, dim, n, s);
  }
}

}  // namespace

// x, b_t, c_t: contiguous (batch, seq, dim) and (batch, seq, n), all f32
// (in_bf16 = 0) or all bf16 (in_bf16 = 1); dt: contiguous f32 (batch, seq,
// dim); a: f32 (dim, n); d_skip: f32 (dim,); h0, h_out: f32 (batch, dim, n);
// y: f32 (batch, seq, dim). 1 <= n <= 16; batch < 65536. Returns
// the cudaError_t of the launch.
extern "C" int repro_ssm_scan(const void* x, int in_bf16, const float* dt, const float* a, const void* b_t,
                              const void* c_t, const float* d_skip, const float* h0, float* y, float* h_out,
                              long long batch, long long seq, long long dim, int n, void* stream) {
  if (batch < 1 || batch > 65535 || seq < 1 || dim < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_bf16) return launch<__nv_bfloat16>(x, dt, a, b_t, c_t, d_skip, h0, y, h_out, batch, seq, dim, n, s);
  return launch<float>(x, dt, a, b_t, c_t, d_skip, h0, y, h_out, batch, seq, dim, n, s);
}
