// Fused SlimAdam precondition over a megaplan super-tensor.
//
// Replaces repro/kernels/megaplan.py:417 mega_slim_update_batched (kernel
// body _mega_slim_kernel :386, pallas_call :448), base outputs only (the
// with_snr / with_health flags are not ported yet). On the (B, R, C) view,
// per reduction line (axis 1: a row of C values; axis 0: a column of R):
//   ek = mean_line g^2,  v' = b2*v + (1-b2)*ek          (one value per line)
//   m' = b1*m + (1-b1)*g,  u = (m'/bc1) / (sqrt(v'/bc2) + eps)   (per element)
//
// Bound: bytes. g and m are read, u and m' written (16 B per element); the
// line operands v, bc1, bc2 and v' add 16 B per line. Each line is walked
// twice: pass 1 sums g^2, pass 2 writes. A line is at most a few tens of KB
// on the gpt_small path, so pass 2's read of g mostly hits L1/L2 and device
// memory sees g about once.
//   axis 1 (minor, contiguous lines): one block per line, threads stride the
//     line with float4 loads, a block reduction joins the partial sums.
//   axis 0 (major, lines strided by C): a block owns kStrip adjacent columns
//     of one batch slice, so a warp reads 128 contiguous bytes per row;
//     kRowThreads warps split the rows and combine their sums in shared
//     memory.
// Any line length works: nothing holds a whole line on chip.
#include "common.cuh"

namespace {

using repro_torch::block_sum;
using repro_torch::ema;
using repro_torch::kRowThreads;
using repro_torch::kStrip;
using repro_torch::precond;

struct SlimArgs {
  const float* g;
  const float* m;
  const float* v;
  const float* bc1;
  const float* bc2;
  float* u;
  float* m_out;
  float* v_out;
  long long batch, rows, cols;
  float inv_n, b1, omb1, b2, omb2, eps;
};

template <bool VEC>
__global__ void slim_minor_kernel(SlimArgs a) {
  __shared__ float smem[32];
  const long long line = blockIdx.x;
  const long long base = line * a.cols;
  const float* g = a.g + base;
  const float* m = a.m + base;
  float* u = a.u + base;
  float* mo = a.m_out + base;

  float s = 0.f;
  if (VEC) {
    const float4* g4 = reinterpret_cast<const float4*>(g);
    for (long long j = threadIdx.x; j < a.cols / 4; j += blockDim.x) {
      const float4 x = g4[j];
      s = fmaf(x.x, x.x, s);
      s = fmaf(x.y, x.y, s);
      s = fmaf(x.z, x.z, s);
      s = fmaf(x.w, x.w, s);
    }
  } else {
    for (long long j = threadIdx.x; j < a.cols; j += blockDim.x) s = fmaf(g[j], g[j], s);
  }
  const float total = block_sum(s, smem);
  const float ek = __fmul_rn(total, a.inv_n);
  const float v_new = ema(a.b2, a.v[line], a.omb2, ek);
  const float c1 = a.bc1[line];
  const float c2 = a.bc2[line];
  if (threadIdx.x == 0) a.v_out[line] = v_new;

  if (VEC) {
    const float4* g4 = reinterpret_cast<const float4*>(g);
    const float4* m4 = reinterpret_cast<const float4*>(m);
    float4* u4 = reinterpret_cast<float4*>(u);
    float4* mo4 = reinterpret_cast<float4*>(mo);
    for (long long j = threadIdx.x; j < a.cols / 4; j += blockDim.x) {
      const float4 x = g4[j];
      const float4 mm = m4[j];
      float4 mn, uu;
      mn.x = ema(a.b1, mm.x, a.omb1, x.x);
      mn.y = ema(a.b1, mm.y, a.omb1, x.y);
      mn.z = ema(a.b1, mm.z, a.omb1, x.z);
      mn.w = ema(a.b1, mm.w, a.omb1, x.w);
      uu.x = precond(mn.x, c1, v_new, c2, a.eps);
      uu.y = precond(mn.y, c1, v_new, c2, a.eps);
      uu.z = precond(mn.z, c1, v_new, c2, a.eps);
      uu.w = precond(mn.w, c1, v_new, c2, a.eps);
      mo4[j] = mn;
      u4[j] = uu;
    }
  } else {
    for (long long j = threadIdx.x; j < a.cols; j += blockDim.x) {
      const float mn = ema(a.b1, m[j], a.omb1, g[j]);
      mo[j] = mn;
      u[j] = precond(mn, c1, v_new, c2, a.eps);
    }
  }
}

__global__ void slim_major_kernel(SlimArgs a) {
  __shared__ float part[kRowThreads][kStrip + 1];
  __shared__ float line_v[kStrip];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const long long c = (long long)blockIdx.x * kStrip + tx;
  const long long b = blockIdx.y;
  const bool live = c < a.cols;
  const long long slice = b * a.rows * a.cols;
  const long long li = b * a.cols + c;  // line index in the (B, 1, C) operands

  float s = 0.f;
  if (live) {
    for (long long r = ty; r < a.rows; r += kRowThreads) {
      const float x = a.g[slice + r * a.cols + c];
      s = fmaf(x, x, s);
    }
  }
  part[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && live) {
    float t = 0.f;
    for (int k = 0; k < kRowThreads; ++k) t += part[k][tx];
    const float v_new = ema(a.b2, a.v[li], a.omb2, __fmul_rn(t, a.inv_n));
    line_v[tx] = v_new;
    a.v_out[li] = v_new;
  }
  __syncthreads();
  if (!live) return;
  const float v_new = line_v[tx];
  const float c1 = a.bc1[li];
  const float c2 = a.bc2[li];
  for (long long r = ty; r < a.rows; r += kRowThreads) {
    const long long i = slice + r * a.cols + c;
    const float mn = ema(a.b1, a.m[i], a.omb1, a.g[i]);
    a.m_out[i] = mn;
    a.u[i] = precond(mn, c1, v_new, c2, a.eps);
  }
}

}  // namespace

// g, m, u, m_out: contiguous f32 (batch, rows, cols). v, bc1, bc2, v_out:
// contiguous f32 lines, (batch, rows, 1) for axis 1 and (batch, 1, cols) for
// axis 0. inv_n = 1/line length; omb1/omb2 = 1-b1/1-b2 rounded by the
// caller. The caller guarantees batch*rows < 2^31 (axis 1) and batch < 65536
// (axis 0). Returns the cudaError_t of the launch.
extern "C" int repro_mega_slim_update(const float* g, const float* m, const float* v, const float* bc1,
                                      const float* bc2, float* u, float* m_out, float* v_out, long long batch,
                                      long long rows, long long cols, int axis, float inv_n, float b1, float omb1,
                                      float b2, float omb2, float eps, void* stream) {
  SlimArgs a{g, m, v, bc1, bc2, u, m_out, v_out, batch, rows, cols, inv_n, b1, omb1, b2, omb2, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (axis == 1) {
    const bool vec = cols % 4 == 0 && repro_torch::aligned16(g) && repro_torch::aligned16(m) &&
                     repro_torch::aligned16(u) && repro_torch::aligned16(m_out);
    long long work = vec ? cols / 4 : cols;
    long long threads = ((work + 31) / 32) * 32;
    if (threads > 1024) threads = 1024;
    if (threads < 32) threads = 32;
    const unsigned lines = (unsigned)(batch * rows);
    if (vec) {
      slim_minor_kernel<true><<<lines, (unsigned)threads, 0, s>>>(a);
    } else {
      slim_minor_kernel<false><<<lines, (unsigned)threads, 0, s>>>(a);
    }
  } else {
    dim3 grid((unsigned)((cols + kStrip - 1) / kStrip), (unsigned)batch);
    dim3 block(kStrip, kRowThreads);
    slim_major_kernel<<<grid, block, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}
