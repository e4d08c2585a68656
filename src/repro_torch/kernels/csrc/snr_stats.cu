// One-pass centered line statistics for the layer-wise SNR.
//
// Replaces repro/kernels/snr_stats.py:133 snr_stats_centered_batched (kernel
// body _snr_centered_kernel :81, launched by _stats_call :116) and, with the
// FIRST flag, snr_stats.py:152 snr_stats_centered_partial_batched (body
// _snr_centered_partial_kernel :89, same launcher). Per reduction line of a
// (B, R, C) second-moment view, with v0 the line's first entry along the
// reduction axis:
//   s1 = sum v,  s1c = sum (v - v0),  s2c = sum (v - v0)^2  (+ v0 itself)
// The shift keeps both centered sums O(spread) rather than O(magnitude), so
// the variance s2c/n - (s1c/n)^2 does not cancel for near-constant lines.
// The partial form emits v0 so that shards of one line split across ranks
// can rebase their sums to a common shift before the cross-rank sum
// (repro_torch/kernels/ref.py rebase_centered_stats).
//
// Bound: bytes, 4 B per element read once (outputs are 12 B per line, 16 B
// with v0: the flag is a template parameter, so it costs the base form
// nothing). The
// differences v - v0 are rounded in f32 as the TPU kernel rounds them; the
// sums accumulate in f64, because lines reach 38.6 M elements (gpt_small's
// embed, K = both) and an f32 running sum over ~10^4 terms per thread would
// drift by more than the tolerance. f64 adds stay far below the memory time.
// Orientation as in mega_slim.cu: one block per contiguous line (axis 1), a
// strip of kStrip columns per block for strided lines (axis 0). A line is
// never split across blocks, so a very long line runs on one SM.
//
// The PLAIN flag replaces snr_stats.py:126 snr_stats_batched (body
// _snr_kernel :75, same launcher): per line s1 = sum v and s2 = sum v*v
// (v*v rounded in f32, as the TPU kernel squares; sums in f64), with no
// shift and no first entry. Bound: bytes, 4 B per element, 8 B per line.
#include "common.cuh"

namespace {

using repro_torch::block_sum;
using repro_torch::kRowThreads;
using repro_torch::kStrip;

// PLAIN: s1 and s2 = sum v*v land in s1 and s2c (s1c unused).
template <bool VEC, bool FIRST, bool PLAIN>
__global__ void snr_minor_kernel(const float* __restrict__ v, float* s1, float* s1c, float* s2c, float* first,
                                 long long cols) {
  __shared__ double smem[32];
  const long long line = blockIdx.x;
  const float* x = v + line * cols;
  const float x0 = x[0];
  double a1 = 0.0, a1c = 0.0, a2c = 0.0;
  if (VEC) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (long long j = threadIdx.x; j < cols / 4; j += blockDim.x) {
      const float4 e = x4[j];
      a1 += (double)e.x + (double)e.y + (double)e.z + (double)e.w;
      if (PLAIN) {
        a2c += (double)__fmul_rn(e.x, e.x) + (double)__fmul_rn(e.y, e.y) + (double)__fmul_rn(e.z, e.z) +
               (double)__fmul_rn(e.w, e.w);
      } else {
        const float d[4] = {__fsub_rn(e.x, x0), __fsub_rn(e.y, x0), __fsub_rn(e.z, x0), __fsub_rn(e.w, x0)};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          a1c += (double)d[k];
          a2c += (double)d[k] * (double)d[k];
        }
      }
    }
  } else {
    for (long long j = threadIdx.x; j < cols; j += blockDim.x) {
      const float e = x[j];
      a1 += (double)e;
      if (PLAIN) {
        a2c += (double)__fmul_rn(e, e);
      } else {
        const double d = (double)__fsub_rn(e, x0);
        a1c += d;
        a2c += d * d;
      }
    }
  }
  a1 = block_sum(a1, smem);
  if (!PLAIN) a1c = block_sum(a1c, smem);
  a2c = block_sum(a2c, smem);
  if (threadIdx.x == 0) {
    s1[line] = (float)a1;
    if (!PLAIN) s1c[line] = (float)a1c;
    s2c[line] = (float)a2c;
    if (FIRST) first[line] = x0;
  }
}

template <bool FIRST, bool PLAIN>
__global__ void snr_major_kernel(const float* __restrict__ v, float* s1, float* s1c, float* s2c, float* first,
                                 long long rows, long long cols) {
  __shared__ double part[3][kRowThreads][kStrip + 1];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const long long c = (long long)blockIdx.x * kStrip + tx;
  const long long b = blockIdx.y;
  const bool live = c < cols;
  const float* x = v + b * rows * cols;
  double a1 = 0.0, a1c = 0.0, a2c = 0.0;
  if (live) {
    const float x0 = x[c];
    for (long long r = ty; r < rows; r += kRowThreads) {
      const float e = x[r * cols + c];
      a1 += (double)e;
      if (PLAIN) {
        a2c += (double)__fmul_rn(e, e);
      } else {
        const double d = (double)__fsub_rn(e, x0);
        a1c += d;
        a2c += d * d;
      }
    }
  }
  part[0][ty][tx] = a1;
  part[1][ty][tx] = a1c;
  part[2][ty][tx] = a2c;
  __syncthreads();
  if (ty == 0 && live) {
    double t1 = 0.0, t1c = 0.0, t2c = 0.0;
    for (int k = 0; k < kRowThreads; ++k) {
      t1 += part[0][k][tx];
      t1c += part[1][k][tx];
      t2c += part[2][k][tx];
    }
    const long long li = b * cols + c;
    s1[li] = (float)t1;
    if (!PLAIN) s1c[li] = (float)t1c;
    s2c[li] = (float)t2c;
    if (FIRST) first[li] = x[c];
  }
}

template <bool FIRST, bool PLAIN = false>
void launch(const float* v, float* s1, float* s1c, float* s2c, float* first, long long batch, long long rows,
            long long cols, int axis, cudaStream_t s) {
  if (axis == 1) {
    const bool vec = cols % 4 == 0 && repro_torch::aligned16(v);
    const long long work = vec ? cols / 4 : cols;
    long long threads = ((work + 31) / 32) * 32;
    if (threads > 1024) threads = 1024;
    if (threads < 32) threads = 32;
    const unsigned lines = (unsigned)(batch * rows);
    if (vec) {
      snr_minor_kernel<true, FIRST, PLAIN><<<lines, (unsigned)threads, 0, s>>>(v, s1, s1c, s2c, first, cols);
    } else {
      snr_minor_kernel<false, FIRST, PLAIN><<<lines, (unsigned)threads, 0, s>>>(v, s1, s1c, s2c, first, cols);
    }
  } else {
    dim3 grid((unsigned)((cols + kStrip - 1) / kStrip), (unsigned)batch);
    dim3 block(kStrip, kRowThreads);
    snr_major_kernel<FIRST, PLAIN><<<grid, block, 0, s>>>(v, s1, s1c, s2c, first, rows, cols);
  }
}

}  // namespace

// v: contiguous f32 (batch, rows, cols). s1, s1c, s2c and first (null for the
// base form, else the partial form's v0 output): contiguous f32 (batch,
// kept), kept = rows for axis 1 and cols for axis 0. The caller guarantees
// batch*rows < 2^31 (axis 1) and batch < 65536 (axis 0). Returns the
// cudaError_t of the launch.
extern "C" int repro_snr_stats_centered(const float* v, float* s1, float* s1c, float* s2c, float* first,
                                        long long batch, long long rows, long long cols, int axis, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (first != nullptr) {
    launch<true>(v, s1, s1c, s2c, first, batch, rows, cols, axis, s);
  } else {
    launch<false>(v, s1, s1c, s2c, first, batch, rows, cols, axis, s);
  }
  return (int)cudaGetLastError();
}

// The plain line sums (B8): v as above; s1 and s2 (sum v*v): contiguous f32
// (batch, kept). Returns the cudaError_t of the launch.
extern "C" int repro_snr_stats(const float* v, float* s1, float* s2, long long batch, long long rows, long long cols,
                               int axis, void* stream) {
  launch<false, true>(v, s1, nullptr, s2, nullptr, batch, rows, cols, axis, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}
