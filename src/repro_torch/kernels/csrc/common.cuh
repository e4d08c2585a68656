// Shared helpers for the optimizer and SNR kernels (plain C entry points,
// loaded with ctypes by repro_torch/kernels/build.py).
//
// Every arithmetic step that the TPU kernels perform as a separate rounded
// f32 operation is written here with the _rn intrinsics, so nvcc does not
// contract a*b+c into an FMA: the kernels then round exactly where their
// plain PyTorch twins round, and elementwise outputs agree bit for bit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {

// m' = b1*m + (1-b1)*g and the second-moment EMA v' = b2*v + (1-b2)*e,
// each product and sum rounded on its own (the TPU kernels' operation order).
__device__ __forceinline__ float ema(float b, float x, float one_minus_b, float y) {
  return __fadd_rn(__fmul_rn(b, x), __fmul_rn(one_minus_b, y));
}

// u = (m'/bc1) / (sqrt(v'/bc2) + eps), IEEE division and square root
// (the build never passes --use_fast_math).
__device__ __forceinline__ float precond(float m_new, float bc1, float v_new, float bc2, float eps) {
  return __fdiv_rn(__fdiv_rn(m_new, bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v_new, bc2)), eps));
}

// One dense Adam element, in the TPU kernels' operation order:
// m' = b1*m + (1-b1)*g, v' = b2*v + ((1-b2)*g)*g, u = precond(m', v').
__device__ __forceinline__ void adam_elem(float b1, float omb1, float b2, float omb2, float eps, float g, float m,
                                          float v, float c1, float c2, float& u, float& m_new, float& v_new) {
  m_new = ema(b1, m, omb1, g);
  v_new = __fadd_rn(__fmul_rn(b2, v), __fmul_rn(__fmul_rn(omb2, g), g));
  u = precond(m_new, c1, v_new, c2, eps);
}

// Bias corrections: one per line (megaplan groups) or one scalar (per leaf).
template <bool SCALAR_BC>
__device__ __forceinline__ float bc_at(const float* bc, long long line) {
  if constexpr (SCALAR_BC) {
    return bc[0];
  } else {
    return bc[line];
  }
}

// A gradient element as f32, from an f32 or a bf16 buffer.
template <typename G>
__device__ __forceinline__ float load_g(const void* p, long long i);
template <>
__device__ __forceinline__ float load_g<float>(const void* p, long long i) {
  return static_cast<const float*>(p)[i];
}
template <>
__device__ __forceinline__ float load_g<__nv_bfloat16>(const void* p, long long i) {
  return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

// Per-line statistics that ride a pass over g (the with_snr / with_health
// outputs). x2 is g*g rounded to f32 and f the line's shift (g^2 at the
// line's first entry):
//   SNR:    s1c = sum (x2 - f), s2c = sum (x2 - f)^2, differences rounded
//           in f32 as the TPU kernel rounds them, sums in f64 (lines reach
//           tens of millions of entries);
//   HEALTH: nf = count of non-finite g, ss = sum of x2 over finite g (f64).
template <bool SNR, bool HEALTH>
struct LineStats {
  double s1c = 0.0, s2c = 0.0, nf = 0.0, ss = 0.0;
  __device__ __forceinline__ void add(float x, float x2, float f) {
    if constexpr (SNR) {
      const double d = (double)__fsub_rn(x2, f);
      s1c += d;
      s2c += d * d;
    }
    if constexpr (HEALTH) {
      if (isfinite(x)) {
        ss += (double)x2;
      } else {
        nf += 1.0;
      }
    }
  }
};

// float4 loads need 16-byte aligned addresses.
inline bool aligned16(const void* p) { return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0; }

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
  for (int offset = 16; offset > 0; offset >>= 1) x += __shfl_xor_sync(0xffffffffu, x, offset);
  return x;
}

// Sum of one value per thread over a 1-D block (blockDim.x a multiple of 32,
// at most 1024). Every thread returns the total. `smem` holds >= 32 values;
// the leading barrier lets a caller reuse it for a second reduction.
template <typename T>
__device__ T block_sum(T x, T* smem) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  x = warp_sum(x);
  __syncthreads();
  if (lane == 0) smem[warp] = x;
  __syncthreads();
  if (warp == 0) {
    T t = lane < n_warps ? smem[lane] : T(0);
    t = warp_sum(t);
    if (lane == 0) smem[0] = t;
  }
  __syncthreads();
  return smem[0];
}

// Threads per block for the strided (major, reduce-over-rows) layouts: a
// warp spans kStrip adjacent columns, so each row read is one 128-byte
// transaction, and kRowThreads warps split the rows of the strip.
constexpr int kStrip = 32;
constexpr int kRowThreads = 16;

// Threads of the one block that sums health partials.
constexpr int kReduceThreads = 1024;

namespace {

// The (2,) health accumulator [nonfinite count, finite sum of squares] from
// n per-block or per-line partials: one block, each thread summing a fixed
// stride of the partials in f64, then a fixed-order tree. Replaces the TPU
// kernels' shared accumulator, which zeroes on grid cell 0 and adds in grid
// order (fused_adam.py:118-126, slim_update.py:118-129): CUDA blocks run in
// no order, so each block writes its own partial and this second launch
// combines them, deterministically and without float atomics.
template <typename T>
__global__ void health_reduce_kernel(const T* nf, const T* ss, long long n, float* out) {
  __shared__ double smem[32];
  double a = 0.0, b = 0.0;
  for (long long i = threadIdx.x; i < n; i += blockDim.x) {
    a += (double)nf[i];
    b += (double)ss[i];
  }
  a = block_sum(a, smem);
  b = block_sum(b, smem);
  if (threadIdx.x == 0) {
    out[0] = (float)a;
    out[1] = (float)b;
  }
}

}  // namespace

}  // namespace repro_torch
