// Dense Adam over a megaplan super-tensor.
//
// Replaces repro/kernels/megaplan.py:351 mega_adam_update (kernel body
// _mega_adam_kernel :337, pallas_call :375): per element
//   m' = b1*m + (1-b1)*g,  v' = b2*v + (1-b2)*g*g,
//   u  = (m'/bc1) / (sqrt(v'/bc2) + eps)
// with bc1/bc2 given per row of the (rows, cols) view, and with with_health
// per row the count of non-finite g (nf) and the sum of g*g over the finite
// entries (ss).
//
// Bound: bytes. Each element reads g, m, v and writes u, m', v' (24 B); the
// bias lines add 8 B per row and the health lines 8 B more. There is no
// reuse to exploit, so the design only has to keep the memory system busy:
// a grid-stride loop in which neighbouring threads load neighbouring 16-byte
// float4s (cols % 4 == 0, so a float4 never straddles two rows). The bias
// pair of a row is loaded by the threads that touch the row; all but the
// first such load hit L1/L2, so device memory serves it once per row.
// The health form needs each row's sums, so there a block walks whole rows
// (grid-stride over rows, threads over a row's float4s) and reduces each row
// in shared memory; the base form keeps its own kernel unchanged.
#include "common.cuh"

namespace {

using repro_torch::adam_elem;
using repro_torch::block_sum;
using Health = repro_torch::LineStats<false, true>;

struct AdamArgs {
  const float* g;
  const float* m;
  const float* v;
  const float* bc1;
  const float* bc2;
  float* u;
  float* m_out;
  float* v_out;
  long long n;
  long long cols;
  float b1, omb1, b2, omb2, eps;
};

__device__ __forceinline__ void adam_one(const AdamArgs& a, float g, float m, float v, float c1, float c2,
                                         float& u, float& m_new, float& v_new) {
  adam_elem(a.b1, a.omb1, a.b2, a.omb2, a.eps, g, m, v, c1, c2, u, m_new, v_new);
}

__global__ void mega_adam_kernel(AdamArgs a) {
  const long long n4 = a.n >> 2;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const float4* g4 = reinterpret_cast<const float4*>(a.g);
  const float4* m4 = reinterpret_cast<const float4*>(a.m);
  const float4* v4 = reinterpret_cast<const float4*>(a.v);
  float4* u4 = reinterpret_cast<float4*>(a.u);
  float4* mo4 = reinterpret_cast<float4*>(a.m_out);
  float4* vo4 = reinterpret_cast<float4*>(a.v_out);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += stride) {
    const long long row = (i << 2) / a.cols;
    const float c1 = a.bc1[row];
    const float c2 = a.bc2[row];
    const float4 g = g4[i];
    const float4 m = m4[i];
    const float4 v = v4[i];
    float4 u, mo, vo;
    adam_one(a, g.x, m.x, v.x, c1, c2, u.x, mo.x, vo.x);
    adam_one(a, g.y, m.y, v.y, c1, c2, u.y, mo.y, vo.y);
    adam_one(a, g.z, m.z, v.z, c1, c2, u.z, mo.z, vo.z);
    adam_one(a, g.w, m.w, v.w, c1, c2, u.w, mo.w, vo.w);
    u4[i] = u;
    mo4[i] = mo;
    vo4[i] = vo;
  }
}

__global__ void mega_adam_health_kernel(AdamArgs a, float* nf_out, float* ss_out) {
  __shared__ double smem[32];
  const long long c4 = a.cols >> 2;
  const long long rows = a.n / a.cols;
  const float4* g4 = reinterpret_cast<const float4*>(a.g);
  const float4* m4 = reinterpret_cast<const float4*>(a.m);
  const float4* v4 = reinterpret_cast<const float4*>(a.v);
  float4* u4 = reinterpret_cast<float4*>(a.u);
  float4* mo4 = reinterpret_cast<float4*>(a.m_out);
  float4* vo4 = reinterpret_cast<float4*>(a.v_out);
  for (long long row = blockIdx.x; row < rows; row += gridDim.x) {
    const float c1 = a.bc1[row];
    const float c2 = a.bc2[row];
    Health h;
    for (long long j = threadIdx.x; j < c4; j += blockDim.x) {
      const long long i = row * c4 + j;
      const float4 g = g4[i];
      const float4 m = m4[i];
      const float4 v = v4[i];
      float4 u, mo, vo;
      adam_one(a, g.x, m.x, v.x, c1, c2, u.x, mo.x, vo.x);
      adam_one(a, g.y, m.y, v.y, c1, c2, u.y, mo.y, vo.y);
      adam_one(a, g.z, m.z, v.z, c1, c2, u.z, mo.z, vo.z);
      adam_one(a, g.w, m.w, v.w, c1, c2, u.w, mo.w, vo.w);
      u4[i] = u;
      mo4[i] = mo;
      vo4[i] = vo;
      h.add(g.x, __fmul_rn(g.x, g.x), 0.f);
      h.add(g.y, __fmul_rn(g.y, g.y), 0.f);
      h.add(g.z, __fmul_rn(g.z, g.z), 0.f);
      h.add(g.w, __fmul_rn(g.w, g.w), 0.f);
    }
    const double nf = block_sum(h.nf, smem);
    const double ss = block_sum(h.ss, smem);
    if (threadIdx.x == 0) {
      nf_out[row] = (float)nf;
      ss_out[row] = (float)ss;
    }
  }
}

}  // namespace

// All pointers are device pointers to contiguous f32 buffers: g, m, v, u,
// m_out, v_out hold rows*cols values (16-byte aligned, cols % 4 == 0, as the
// megaplan's 512-lane dense group always is), bc1/bc2 hold rows. nf/ss are
// the with_health row outputs (rows values each), or both null for the base
// form. blocks and threads: the grid, as megaplan.adam_grid sizes it (the
// base form strides its blocks over the float4 vectors, the health form
// over the rows, a block a row at a time; 32 to 256 threads). omb1 =
// 1-b1 and omb2 = 1-b2 come rounded from the caller (computed in double, as
// Python does before JAX rounds the constant). Returns the cudaError_t of
// the launch.
extern "C" int repro_mega_adam_update(const float* g, const float* m, const float* v, const float* bc1,
                                      const float* bc2, float* u, float* m_out, float* v_out, float* nf,
                                      float* ss, long long rows, long long cols, long long blocks, int threads,
                                      float b1, float omb1, float b2, float omb2, float eps, void* stream) {
  AdamArgs a{g, m, v, bc1, bc2, u, m_out, v_out, rows * cols, cols, b1, omb1, b2, omb2, eps};
  if (cols % 4 != 0 || !repro_torch::aligned16(g) || !repro_torch::aligned16(m) || !repro_torch::aligned16(v) ||
      !repro_torch::aligned16(u) || !repro_torch::aligned16(m_out) || !repro_torch::aligned16(v_out) ||
      (nf == nullptr) != (ss == nullptr) || blocks < 1 || threads < 32 || threads > 256 || threads % 32 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nf != nullptr) {
    mega_adam_health_kernel<<<(unsigned)blocks, (unsigned)threads, 0, s>>>(a, nf, ss);
  } else {
    mega_adam_kernel<<<(unsigned)blocks, (unsigned)threads, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}
