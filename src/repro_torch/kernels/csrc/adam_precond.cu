// Per-leaf dense Adam precondition with scalar bias corrections.
//
// Replaces repro/kernels/fused_adam.py:129 adam_precond (kernel body
// _adam_precond_kernel :108, pallas_call :166): per element of one leaf
// (any shape, contiguous)
//   m' = b1*m + (1-b1)*g,  v' = b2*v + (1-b2)*g*g,
//   u  = (m'/bc1) / (sqrt(v'/bc2) + eps)
// with bc1/bc2 scalars read from device memory (the step count is optimizer
// state; reading it on the host would wait for the device). g may be f32 or
// bf16; m, v and every output are f32. With with_health it also returns the
// leaf's (2,) [nonfinite count, finite sum of g*g].
//
// Bound: bytes. An element reads g (4 or 2 B), m, v and writes u, m', v':
// 24 B for f32 g. A grid-stride loop over float4s where g is f32 and every
// buffer 16-byte aligned with n % 4 == 0, over scalars otherwise (bf16 g,
// ragged leaves): ragged shapes need no padding, the loop's bound masks them.
// The TPU kernel's health accumulator is one (2,) block every grid cell adds
// into, which is race-free only because the TPU grid runs in order. Here
// each block reduces its own partial into scratch (f64) and a second launch
// of one block sums the partials in a fixed order (common.cuh,
// health_reduce_kernel): deterministic, no float atomics, and the partial
// count is the grid size the caller fixed from the leaf's size.
//
// The same file holds the parameter-writing form (B6, repro_fused_adam at
// the end): the same elementwise pass, writing p' where this one writes u.
#include "common.cuh"

namespace {

using repro_torch::adam_elem;
using repro_torch::block_sum;
using Health = repro_torch::LineStats<false, true>;
using repro_torch::load_g;

struct PrecondArgs {
  const void* g;
  const float* m;
  const float* v;
  const float* bc1;
  const float* bc2;
  float* u;
  float* m_out;
  float* v_out;
  double* partial;  // (2, blocks): nf partials, then ss partials (with_health)
  long long n;
  float b1, omb1, b2, omb2, eps;
};

template <typename G, bool VEC, bool HEALTH>
__global__ void adam_precond_kernel(PrecondArgs a) {
  const float c1 = *a.bc1;
  const float c2 = *a.bc2;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  Health h;
  if constexpr (VEC) {
    const float4* g4 = reinterpret_cast<const float4*>(a.g);
    const float4* m4 = reinterpret_cast<const float4*>(a.m);
    const float4* v4 = reinterpret_cast<const float4*>(a.v);
    float4* u4 = reinterpret_cast<float4*>(a.u);
    float4* mo4 = reinterpret_cast<float4*>(a.m_out);
    float4* vo4 = reinterpret_cast<float4*>(a.v_out);
    for (long long i = start; i < (a.n >> 2); i += stride) {
      const float4 g = g4[i];
      const float4 m = m4[i];
      const float4 v = v4[i];
      float4 u, mo, vo;
      adam_elem(a.b1, a.omb1, a.b2, a.omb2, a.eps, g.x, m.x, v.x, c1, c2, u.x, mo.x, vo.x);
      adam_elem(a.b1, a.omb1, a.b2, a.omb2, a.eps, g.y, m.y, v.y, c1, c2, u.y, mo.y, vo.y);
      adam_elem(a.b1, a.omb1, a.b2, a.omb2, a.eps, g.z, m.z, v.z, c1, c2, u.z, mo.z, vo.z);
      adam_elem(a.b1, a.omb1, a.b2, a.omb2, a.eps, g.w, m.w, v.w, c1, c2, u.w, mo.w, vo.w);
      u4[i] = u;
      mo4[i] = mo;
      vo4[i] = vo;
      if constexpr (HEALTH) {
        h.add(g.x, __fmul_rn(g.x, g.x), 0.f);
        h.add(g.y, __fmul_rn(g.y, g.y), 0.f);
        h.add(g.z, __fmul_rn(g.z, g.z), 0.f);
        h.add(g.w, __fmul_rn(g.w, g.w), 0.f);
      }
    }
  } else {
    for (long long i = start; i < a.n; i += stride) {
      const float g = load_g<G>(a.g, i);
      adam_elem(a.b1, a.omb1, a.b2, a.omb2, a.eps, g, a.m[i], a.v[i], c1, c2, a.u[i], a.m_out[i], a.v_out[i]);
      if constexpr (HEALTH) h.add(g, __fmul_rn(g, g), 0.f);
    }
  }
  if constexpr (HEALTH) {
    __shared__ double smem[32];
    const double nf = block_sum(h.nf, smem);
    const double ss = block_sum(h.ss, smem);
    if (threadIdx.x == 0) {
      a.partial[blockIdx.x] = nf;
      a.partial[gridDim.x + blockIdx.x] = ss;
    }
  }
}

template <typename G, bool VEC>
void launch(const PrecondArgs& a, long long blocks, float* health, cudaStream_t s) {
  if (health != nullptr) {
    adam_precond_kernel<G, VEC, true><<<(unsigned)blocks, 256, 0, s>>>(a);
    repro_torch::health_reduce_kernel<double>
        <<<1, repro_torch::kReduceThreads, 0, s>>>(a.partial, a.partial + blocks, blocks, health);
  } else {
    adam_precond_kernel<G, VEC, false><<<(unsigned)blocks, 256, 0, s>>>(a);
  }
}

// The parameter-writing form (B6): per element p' = p - lr*(u + wd*p),
// rounded to p's dtype, with m', v' as above; no u is written. Bias
// corrections arrive as host-rounded scalars (the count is static).
template <typename P>
__device__ __forceinline__ void store_param(void* out, long long i, float x);
template <>
__device__ __forceinline__ void store_param<float>(void* out, long long i, float x) {
  static_cast<float*>(out)[i] = x;
}
template <>
__device__ __forceinline__ void store_param<__nv_bfloat16>(void* out, long long i, float x) {
  static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float param_step(float p, float u, float lr, float wd) {
  const float upd = wd != 0.f ? __fadd_rn(u, __fmul_rn(wd, p)) : u;
  return __fsub_rn(p, __fmul_rn(lr, upd));
}

struct AdamWArgs {
  const void* p;
  const void* g;
  const float* m;
  const float* v;
  void* p_out;
  float* m_out;
  float* v_out;
  long long n;
  float lr, wd, c1, c2, b1, omb1, b2, omb2, eps;
};

template <typename P, typename G, bool VEC>
__global__ void fused_adam_kernel(AdamWArgs a) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (VEC) {
    const float4* p4 = reinterpret_cast<const float4*>(a.p);
    const float4* g4 = reinterpret_cast<const float4*>(a.g);
    const float4* m4 = reinterpret_cast<const float4*>(a.m);
    const float4* v4 = reinterpret_cast<const float4*>(a.v);
    float4* po4 = reinterpret_cast<float4*>(a.p_out);
    float4* mo4 = reinterpret_cast<float4*>(a.m_out);
    float4* vo4 = reinterpret_cast<float4*>(a.v_out);
    for (long long i = start; i < (a.n >> 2); i += stride) {
      const float4 p = p4[i];
      const float4 g = g4[i];
      const float4 m = m4[i];
      const float4 v = v4[i];
      float4 u, mo, vo, po;
      adam_elem(a.b1, a.omb1, a.b2, a.omb2, a.eps, g.x, m.x, v.x, a.c1, a.c2, u.x, mo.x, vo.x);
      adam_elem(a.b1, a.omb1, a.b2, a.omb2, a.eps, g.y, m.y, v.y, a.c1, a.c2, u.y, mo.y, vo.y);
      adam_elem(a.b1, a.omb1, a.b2, a.omb2, a.eps, g.z, m.z, v.z, a.c1, a.c2, u.z, mo.z, vo.z);
      adam_elem(a.b1, a.omb1, a.b2, a.omb2, a.eps, g.w, m.w, v.w, a.c1, a.c2, u.w, mo.w, vo.w);
      po.x = param_step(p.x, u.x, a.lr, a.wd);
      po.y = param_step(p.y, u.y, a.lr, a.wd);
      po.z = param_step(p.z, u.z, a.lr, a.wd);
      po.w = param_step(p.w, u.w, a.lr, a.wd);
      po4[i] = po;
      mo4[i] = mo;
      vo4[i] = vo;
    }
  } else {
    for (long long i = start; i < a.n; i += stride) {
      float u;
      adam_elem(a.b1, a.omb1, a.b2, a.omb2, a.eps, load_g<G>(a.g, i), a.m[i], a.v[i], a.c1, a.c2, u, a.m_out[i],
                a.v_out[i]);
      store_param<P>(a.p_out, i, param_step(load_g<P>(a.p, i), u, a.lr, a.wd));
    }
  }
}

}  // namespace

// Parameter-writing dense AdamW (B6). Replaces repro/kernels/fused_adam.py:58
// fused_adam (kernel body _adam_kernel :42, pallas_call :79): the
// elementwise pass above with a parameter write. Bound: bytes, p, g, m, v
// read and p', m', v' written, 28 B per element in f32 (7 passes). p, p_out:
// n contiguous f32 (p_bf16 = 0) or bf16 (p_bf16 = 1); g f32 or bf16
// (g_bf16); m, v, m_out, v_out f32. c1/c2 = 1 - b^t rounded in f32 by the
// caller. blocks: the grid of 256-thread blocks. Returns the cudaError_t.
extern "C" int repro_fused_adam(const void* p, int p_bf16, const void* g, int g_bf16, const float* m, const float* v,
                                void* p_out, float* m_out, float* v_out, long long n, long long blocks, float lr,
                                float wd, float c1, float c2, float b1, float omb1, float b2, float omb2, float eps,
                                void* stream) {
  if (blocks < 1) return (int)cudaErrorInvalidValue;
  AdamWArgs a{p, g, m, v, p_out, m_out, v_out, n, lr, wd, c1, c2, b1, omb1, b2, omb2, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)blocks;
  const bool vec = !p_bf16 && !g_bf16 && n % 4 == 0 && repro_torch::aligned16(p) && repro_torch::aligned16(g) &&
                   repro_torch::aligned16(m) && repro_torch::aligned16(v) && repro_torch::aligned16(p_out) &&
                   repro_torch::aligned16(m_out) && repro_torch::aligned16(v_out);
  if (vec) {
    fused_adam_kernel<float, float, true><<<grid, 256, 0, s>>>(a);
  } else if (p_bf16 && g_bf16) {
    fused_adam_kernel<__nv_bfloat16, __nv_bfloat16, false><<<grid, 256, 0, s>>>(a);
  } else if (p_bf16) {
    fused_adam_kernel<__nv_bfloat16, float, false><<<grid, 256, 0, s>>>(a);
  } else if (g_bf16) {
    fused_adam_kernel<float, __nv_bfloat16, false><<<grid, 256, 0, s>>>(a);
  } else {
    fused_adam_kernel<float, float, false><<<grid, 256, 0, s>>>(a);
  }
  return (int)cudaGetLastError();
}

// g: n contiguous values, f32 (g_bf16 = 0) or bf16 (g_bf16 = 1); m, v, u,
// m_out, v_out: n contiguous f32; bc1, bc2: one f32 each. blocks: the grid
// (256 threads a block), chosen by the caller; with health (a (2,) f32
// output, or null) partial holds 2*blocks f64 of scratch. Returns the
// cudaError_t of the launches.
extern "C" int repro_adam_precond(const void* g, int g_bf16, const float* m, const float* v, const float* bc1,
                                  const float* bc2, float* u, float* m_out, float* v_out, double* partial,
                                  float* health, long long n, long long blocks, float b1, float omb1, float b2,
                                  float omb2, float eps, void* stream) {
  if (blocks < 1 || (health != nullptr && partial == nullptr)) return (int)cudaErrorInvalidValue;
  PrecondArgs a{g, m, v, bc1, bc2, u, m_out, v_out, partial, n, b1, omb1, b2, omb2, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = !g_bf16 && n % 4 == 0 && repro_torch::aligned16(g) && repro_torch::aligned16(m) &&
                   repro_torch::aligned16(v) && repro_torch::aligned16(u) && repro_torch::aligned16(m_out) &&
                   repro_torch::aligned16(v_out);
  if (g_bf16) {
    launch<__nv_bfloat16, false>(a, blocks, health, s);
  } else if (vec) {
    launch<float, true>(a, blocks, health, s);
  } else {
    launch<float, false>(a, blocks, health, s);
  }
  return (int)cudaGetLastError();
}
