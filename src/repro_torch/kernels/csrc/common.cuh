// Shared helpers for the optimizer and SNR kernels (plain C entry points,
// loaded with ctypes by repro_torch/kernels/build.py).
//
// Every arithmetic step that the TPU kernels perform as a separate rounded
// f32 operation is written here with the _rn intrinsics, so nvcc does not
// contract a*b+c into an FMA: the kernels then round exactly where their
// plain PyTorch twins round, and elementwise outputs agree bit for bit.
#pragma once

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

}  // namespace repro_torch
