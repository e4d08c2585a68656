// Fused SlimAdam precondition over a (B, R, C) canonical view: the megaplan
// group kernel and the per-leaf kernel, and (the PARTIAL flag) pass 1 of the
// sharded psum pair, in the same two forms.
//
// Replaces
//   * repro/kernels/megaplan.py:417 mega_slim_update_batched (kernel body
//     _mega_slim_kernel :386, pallas_call :448): bias corrections given per
//     line; with_snr and with_health emit per-line outputs;
//   * repro/kernels/slim_update.py:154 slim_precond_batched (kernel body
//     _slim_precond_kernel :132, pallas_call :207): scalar bias corrections,
//     g f32 or bf16; with_snr emits per-line outputs, with_health one (2,)
//     accumulator.
// Per reduction line (axis 1: a row of C values; axis 0: a column of R):
//   ek = mean_line g^2,  v' = b2*v + (1-b2)*ek          (one value per line)
//   m' = b1*m + (1-b1)*g,  u = (m'/bc1) / (sqrt(v'/bc2) + eps)   (per element)
// with_snr:    s1c = sum (g^2 - f), s2c = sum (g^2 - f)^2, f = g^2 at the
//              line's first entry (centered_line_stats of g^2);
// with_health: nf = count of non-finite g, ss = sum g^2 over finite g.
// Both ride pass 1, which already reads every g of the line: no extra pass.
// The line sum of g^2 accumulates in f64 and rounds to f32 once: a thread's
// f32 running sum over a long line (the 38.6 M-element embedding line of a
// one-moment-per-block rule walks ~150 K elements a thread) drops every term
// below half an ulp of it, and with heavy-tailed gradients a few large
// entries make most terms that small (8e-5 relative error on u, measured).
// A DFMA per element costs nothing at this kernel's byte bound.
//
// Bound: bytes. g and m are read, u and m' written (16 B per f32 element);
// the line operands v, bc1, bc2 and v' add 16 B per line, each flag's two
// line outputs 8 B more. Each line is walked twice: pass 1 sums g^2, pass 2
// writes. A line is at most a few tens of KB on the gpt_small path, so pass
// 2's read of g mostly hits L1/L2 and device memory sees g about once.
//   axis 1 (minor, contiguous lines): one block per line, threads stride the
//     line with float4 loads, a block reduction joins the partial sums.
//   axis 0 (major, lines strided by C): a block owns kStrip adjacent columns
//     of one batch slice, so a warp reads 128 contiguous bytes per row;
//     kRowThreads warps split the rows and combine their sums in shared
//     memory.
// Any line length works: nothing holds a whole line on chip. The flags are
// template parameters, so the base form's instruction stream is the one it
// had before they existed. The per-leaf form's (2,) health accumulator
// reduces the per-line health outputs in a second launch (common.cuh,
// health_reduce_kernel) instead of the TPU's in-order grid accumulation.
//
// PARTIAL replaces
//   * repro/kernels/megaplan.py:486 mega_slim_partial_stats_batched (body
//     _mega_slim_partial_kernel :467, pallas_call :510): with_health emits
//     per-line outputs;
//   * repro/kernels/slim_update.py:260 slim_partial_stats_batched (body
//     _slim_partial_kernel :244, pallas_call :304): g f32 or bf16; with_health
//     one (2,) accumulator.
// When a leaf's reduction dims are split across ranks, a rank sees only a
// slice of each line, so the update splits around a cross-rank sum: this
// pass writes m' = b1*m + (1-b1)*g and the line's partial sum of g^2 (plus,
// with_snr, the centered sums and their shift f; with_health the health
// terms), all in pass 1's single walk over the line; the sum completes
// across ranks, and slim_finalize.cu applies the preconditioner. Bound:
// bytes, 12 B per f32 element (g, m read, m' written) plus 4 B per line,
// 12 B more per line with_snr, 8 B with_health.
//
// WRITE replaces repro/kernels/slim_update.py:74 slim_update_batched (body
// _slim_kernel :56, pallas_call :103), the parameter-writing per-leaf form:
// pass 2 writes p' = p - lr*(u + wd*p) in p's dtype (f32 or bf16) instead
// of u, with the bias corrections passed as host-rounded scalars (no
// launch forms them). Entry point repro_slim_update at the end of the file.
#include <type_traits>

#include "common.cuh"

namespace {

using repro_torch::bc_at;
using repro_torch::block_sum;
using repro_torch::ema;
using repro_torch::kRowThreads;
using repro_torch::kStrip;
using repro_torch::LineStats;
using repro_torch::load_g;
using repro_torch::precond;

struct SlimArgs {
  const void* g;
  const float* m;
  const float* v;
  const float* bc1;
  const float* bc2;
  float* u;
  float* m_out;
  float* v_out;
  float* s1c;  // with_snr line outputs, else null
  float* s2c;
  float* nf;   // with_health line outputs, else null
  float* ss;
  float* part;   // PARTIAL: the line sums of g^2, and with_snr the shift f
  float* first;
  long long batch, rows, cols;
  float inv_n, b1, omb1, b2, omb2, eps;
  // WRITE: the parameters in and out (f32 or bf16), the step's scalars,
  // and the bias corrections as host-rounded values (the step count is
  // static for the parameter-writing form).
  const void* p = nullptr;
  void* p_out = nullptr;
  float lr = 0.f, wd = 0.f, c1 = 1.f, c2 = 1.f;
};

// p' = p - lr*(u + wd*p) in f32, the Pallas kernels' order (the wd term only
// when wd != 0, as they add it only then).
__device__ __forceinline__ float param_step(float p, float u, float lr, float wd) {
  const float upd = wd != 0.f ? __fadd_rn(u, __fmul_rn(wd, p)) : u;
  return __fsub_rn(p, __fmul_rn(lr, upd));
}

template <typename P>
__device__ __forceinline__ void store_p(void* out, long long i, float x);
template <>
__device__ __forceinline__ void store_p<float>(void* out, long long i, float x) {
  static_cast<float*>(out)[i] = x;
}
template <>
__device__ __forceinline__ void store_p<__nv_bfloat16>(void* out, long long i, float x) {
  static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(x);
}

template <bool SNR, bool HEALTH>
__device__ __forceinline__ void write_line_stats(const SlimArgs& a, long long line, const LineStats<SNR, HEALTH>& t) {
  if constexpr (SNR) {
    a.s1c[line] = (float)t.s1c;
    a.s2c[line] = (float)t.s2c;
  }
  if constexpr (HEALTH) {
    a.nf[line] = (float)t.nf;
    a.ss[line] = (float)t.ss;
  }
}

template <typename G, bool VEC, bool SCALAR_BC, bool SNR, bool HEALTH, bool PARTIAL, typename P = float,
          bool WRITE = false>
__global__ void slim_minor_kernel(SlimArgs a) {
  static_assert(!VEC || std::is_same<G, float>::value, "float4 loads need f32 g");
  static_assert(!VEC || !WRITE || std::is_same<P, float>::value, "float4 parameter loads need f32 p");
  constexpr bool STATS = SNR || HEALTH;
  __shared__ double smem[32];
  const long long line = blockIdx.x;
  const long long base = line * a.cols;
  const float* m = a.m + base;
  float* mo = a.m_out + base;

  double s = 0.0;
  LineStats<SNR, HEALTH> st;
  float f = 0.f;
  if constexpr (SNR) {
    const float x0 = load_g<G>(a.g, base);
    f = __fmul_rn(x0, x0);
  }
  if constexpr (VEC) {
    const float4* g4 = reinterpret_cast<const float4*>(static_cast<const float*>(a.g) + base);
    for (long long j = threadIdx.x; j < a.cols / 4; j += blockDim.x) {
      const float4 x = g4[j];
      s = fma((double)x.x, (double)x.x, s);
      s = fma((double)x.y, (double)x.y, s);
      s = fma((double)x.z, (double)x.z, s);
      s = fma((double)x.w, (double)x.w, s);
      if constexpr (STATS) {
        st.add(x.x, __fmul_rn(x.x, x.x), f);
        st.add(x.y, __fmul_rn(x.y, x.y), f);
        st.add(x.z, __fmul_rn(x.z, x.z), f);
        st.add(x.w, __fmul_rn(x.w, x.w), f);
      }
      if constexpr (PARTIAL) {
        const float4 mm = reinterpret_cast<const float4*>(m)[j];
        float4 mn;
        mn.x = ema(a.b1, mm.x, a.omb1, x.x);
        mn.y = ema(a.b1, mm.y, a.omb1, x.y);
        mn.z = ema(a.b1, mm.z, a.omb1, x.z);
        mn.w = ema(a.b1, mm.w, a.omb1, x.w);
        reinterpret_cast<float4*>(mo)[j] = mn;
      }
    }
  } else {
    for (long long j = threadIdx.x; j < a.cols; j += blockDim.x) {
      const float x = load_g<G>(a.g, base + j);
      s = fma((double)x, (double)x, s);
      if constexpr (STATS) st.add(x, __fmul_rn(x, x), f);
      if constexpr (PARTIAL) mo[j] = ema(a.b1, m[j], a.omb1, x);
    }
  }
  const float total = (float)block_sum(s, smem);
  if constexpr (STATS) {
    if constexpr (SNR) {
      st.s1c = block_sum(st.s1c, smem);
      st.s2c = block_sum(st.s2c, smem);
    }
    if constexpr (HEALTH) {
      st.nf = block_sum(st.nf, smem);
      st.ss = block_sum(st.ss, smem);
    }
    if (threadIdx.x == 0) write_line_stats(a, line, st);
  }
  if constexpr (PARTIAL) {
    if (threadIdx.x == 0) {
      a.part[line] = total;
      if constexpr (SNR) a.first[line] = f;
    }
    return;
  }
  const float ek = __fmul_rn(total, a.inv_n);
  const float v_new = ema(a.b2, a.v[line], a.omb2, ek);
  float c1, c2;
  if constexpr (WRITE) {
    c1 = a.c1;
    c2 = a.c2;
  } else {
    c1 = bc_at<SCALAR_BC>(a.bc1, line);
    c2 = bc_at<SCALAR_BC>(a.bc2, line);
  }
  if (threadIdx.x == 0) a.v_out[line] = v_new;

  if constexpr (VEC) {
    const float4* g4 = reinterpret_cast<const float4*>(static_cast<const float*>(a.g) + base);
    const float4* m4 = reinterpret_cast<const float4*>(m);
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
      if constexpr (WRITE) {
        const float4 pp = reinterpret_cast<const float4*>(static_cast<const float*>(a.p) + base)[j];
        float4 po;
        po.x = param_step(pp.x, uu.x, a.lr, a.wd);
        po.y = param_step(pp.y, uu.y, a.lr, a.wd);
        po.z = param_step(pp.z, uu.z, a.lr, a.wd);
        po.w = param_step(pp.w, uu.w, a.lr, a.wd);
        reinterpret_cast<float4*>(static_cast<float*>(a.p_out) + base)[j] = po;
      } else {
        reinterpret_cast<float4*>(a.u + base)[j] = uu;
      }
    }
  } else {
    for (long long j = threadIdx.x; j < a.cols; j += blockDim.x) {
      const float mn = ema(a.b1, m[j], a.omb1, load_g<G>(a.g, base + j));
      mo[j] = mn;
      const float uu = precond(mn, c1, v_new, c2, a.eps);
      if constexpr (WRITE) {
        store_p<P>(a.p_out, base + j, param_step(load_g<P>(a.p, base + j), uu, a.lr, a.wd));
      } else {
        a.u[base + j] = uu;
      }
    }
  }
}

template <typename G, bool SCALAR_BC, bool SNR, bool HEALTH, bool PARTIAL, typename P = float, bool WRITE = false>
__global__ void slim_major_kernel(SlimArgs a) {
  constexpr bool STATS = SNR || HEALTH;
  __shared__ double part[kRowThreads][kStrip + 1];
  __shared__ float line_v[kStrip];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const long long c = (long long)blockIdx.x * kStrip + tx;
  const long long b = blockIdx.y;
  const bool live = c < a.cols;
  const long long slice = b * a.rows * a.cols;
  const long long li = b * a.cols + c;  // line index in the (B, 1, C) operands

  double s = 0.0;
  LineStats<SNR, HEALTH> st;
  float f = 0.f;
  if (live) {
    if constexpr (SNR) {
      const float x0 = load_g<G>(a.g, slice + c);
      f = __fmul_rn(x0, x0);
    }
    for (long long r = ty; r < a.rows; r += kRowThreads) {
      const long long i = slice + r * a.cols + c;
      const float x = load_g<G>(a.g, i);
      s = fma((double)x, (double)x, s);
      if constexpr (STATS) st.add(x, __fmul_rn(x, x), f);
      if constexpr (PARTIAL) a.m_out[i] = ema(a.b1, a.m[i], a.omb1, x);
    }
  }
  part[ty][tx] = s;
  if constexpr (STATS) {
    __shared__ double dpart[4][kRowThreads][kStrip + 1];
    dpart[0][ty][tx] = st.s1c;
    dpart[1][ty][tx] = st.s2c;
    dpart[2][ty][tx] = st.nf;
    dpart[3][ty][tx] = st.ss;
    __syncthreads();
    if (ty == 0 && live) {
      LineStats<SNR, HEALTH> t;
      for (int k = 0; k < kRowThreads; ++k) {
        t.s1c += dpart[0][k][tx];
        t.s2c += dpart[1][k][tx];
        t.nf += dpart[2][k][tx];
        t.ss += dpart[3][k][tx];
      }
      write_line_stats(a, li, t);
    }
  }
  __syncthreads();
  if constexpr (PARTIAL) {
    if (ty == 0 && live) {
      double t = 0.0;
      for (int k = 0; k < kRowThreads; ++k) t += part[k][tx];
      a.part[li] = (float)t;
      if constexpr (SNR) a.first[li] = f;
    }
    return;
  }
  if (ty == 0 && live) {
    double t = 0.0;
    for (int k = 0; k < kRowThreads; ++k) t += part[k][tx];
    const float v_new = ema(a.b2, a.v[li], a.omb2, __fmul_rn((float)t, a.inv_n));
    line_v[tx] = v_new;
    a.v_out[li] = v_new;
  }
  __syncthreads();
  if (!live) return;
  const float v_new = line_v[tx];
  float c1, c2;
  if constexpr (WRITE) {
    c1 = a.c1;
    c2 = a.c2;
  } else {
    c1 = bc_at<SCALAR_BC>(a.bc1, li);
    c2 = bc_at<SCALAR_BC>(a.bc2, li);
  }
  for (long long r = ty; r < a.rows; r += kRowThreads) {
    const long long i = slice + r * a.cols + c;
    const float mn = ema(a.b1, a.m[i], a.omb1, load_g<G>(a.g, i));
    a.m_out[i] = mn;
    const float uu = precond(mn, c1, v_new, c2, a.eps);
    if constexpr (WRITE) {
      store_p<P>(a.p_out, i, param_step(load_g<P>(a.p, i), uu, a.lr, a.wd));
    } else {
      a.u[i] = uu;
    }
  }
}

template <typename G, bool SCALAR_BC, bool SNR, bool HEALTH, bool PARTIAL>
void launch_flags(const SlimArgs& a, int axis, cudaStream_t s) {
  if (axis == 1) {
    bool vec = false;
    if constexpr (std::is_same<G, float>::value) {
      vec = a.cols % 4 == 0 && repro_torch::aligned16(a.g) && repro_torch::aligned16(a.m) &&
            repro_torch::aligned16(a.u) && repro_torch::aligned16(a.m_out);
    }
    long long work = vec ? a.cols / 4 : a.cols;
    long long threads = ((work + 31) / 32) * 32;
    if (threads > 1024) threads = 1024;
    if (threads < 32) threads = 32;
    const unsigned lines = (unsigned)(a.batch * a.rows);
    if constexpr (std::is_same<G, float>::value) {
      if (vec) {
        slim_minor_kernel<G, true, SCALAR_BC, SNR, HEALTH, PARTIAL><<<lines, (unsigned)threads, 0, s>>>(a);
        return;
      }
    }
    slim_minor_kernel<G, false, SCALAR_BC, SNR, HEALTH, PARTIAL><<<lines, (unsigned)threads, 0, s>>>(a);
  } else {
    dim3 grid((unsigned)((a.cols + kStrip - 1) / kStrip), (unsigned)a.batch);
    dim3 block(kStrip, kRowThreads);
    slim_major_kernel<G, SCALAR_BC, SNR, HEALTH, PARTIAL><<<grid, block, 0, s>>>(a);
  }
}

template <typename G, bool SCALAR_BC, bool PARTIAL = false>
void launch(const SlimArgs& a, int axis, cudaStream_t s) {
  const bool snr = a.s1c != nullptr;
  const bool health = a.nf != nullptr;
  if (snr && health) {
    launch_flags<G, SCALAR_BC, true, true, PARTIAL>(a, axis, s);
  } else if (snr) {
    launch_flags<G, SCALAR_BC, true, false, PARTIAL>(a, axis, s);
  } else if (health) {
    launch_flags<G, SCALAR_BC, false, true, PARTIAL>(a, axis, s);
  } else {
    launch_flags<G, SCALAR_BC, false, false, PARTIAL>(a, axis, s);
  }
}

// The parameter-writing per-leaf form: no flags, host-rounded bias
// corrections; float4 loads on contiguous lines when p and g are f32.
template <typename G, typename P>
void launch_write(const SlimArgs& a, int axis, cudaStream_t s) {
  if (axis == 1) {
    bool vec = false;
    if constexpr (std::is_same<G, float>::value && std::is_same<P, float>::value) {
      vec = a.cols % 4 == 0 && repro_torch::aligned16(a.g) && repro_torch::aligned16(a.m) &&
            repro_torch::aligned16(a.m_out) && repro_torch::aligned16(a.p) && repro_torch::aligned16(a.p_out);
    }
    long long work = vec ? a.cols / 4 : a.cols;
    long long threads = ((work + 31) / 32) * 32;
    if (threads > 1024) threads = 1024;
    if (threads < 32) threads = 32;
    const unsigned lines = (unsigned)(a.batch * a.rows);
    if constexpr (std::is_same<G, float>::value && std::is_same<P, float>::value) {
      if (vec) {
        slim_minor_kernel<G, true, true, false, false, false, P, true><<<lines, (unsigned)threads, 0, s>>>(a);
        return;
      }
    }
    slim_minor_kernel<G, false, true, false, false, false, P, true><<<lines, (unsigned)threads, 0, s>>>(a);
  } else {
    dim3 grid((unsigned)((a.cols + kStrip - 1) / kStrip), (unsigned)a.batch);
    dim3 block(kStrip, kRowThreads);
    slim_major_kernel<G, true, false, false, false, P, true><<<grid, block, 0, s>>>(a);
  }
}

// The per-leaf forms' (2,) health accumulator from their per-line lines.
void reduce_health(const SlimArgs& a, int axis, float* health, cudaStream_t s) {
  const long long n_lines = axis == 1 ? a.batch * a.rows : a.batch * a.cols;
  repro_torch::health_reduce_kernel<float><<<1, repro_torch::kReduceThreads, 0, s>>>(a.nf, a.ss, n_lines, health);
}

bool flags_paired(const float* x, const float* y) { return (x == nullptr) == (y == nullptr); }

}  // namespace

// Megaplan group form. g, m, u, m_out: contiguous f32 (batch, rows, cols).
// v, bc1, bc2, v_out and the optional line outputs s1c, s2c (with_snr) and
// nf, ss (with_health; null when off): contiguous f32 lines, (batch, rows, 1)
// for axis 1 and (batch, 1, cols) for axis 0. inv_n = 1/line length;
// omb1/omb2 = 1-b1/1-b2 rounded by the caller. The caller guarantees
// batch*rows < 2^31 (axis 1) and batch < 65536 (axis 0). Returns the
// cudaError_t of the launch.
extern "C" int repro_mega_slim_update(const float* g, const float* m, const float* v, const float* bc1,
                                      const float* bc2, float* u, float* m_out, float* v_out, float* s1c,
                                      float* s2c, float* nf, float* ss, long long batch, long long rows,
                                      long long cols, int axis, float inv_n, float b1, float omb1, float b2,
                                      float omb2, float eps, void* stream) {
  if (!flags_paired(s1c, s2c) || !flags_paired(nf, ss)) return (int)cudaErrorInvalidValue;
  SlimArgs a{g, m, v, bc1, bc2, u, m_out, v_out, s1c, s2c, nf, ss, nullptr, nullptr, batch, rows, cols, inv_n, b1,
             omb1, b2, omb2, eps};
  launch<float, false>(a, axis, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// Per-leaf form. As above, except: g is f32 (g_bf16 = 0) or bf16
// (g_bf16 = 1); bc1 and bc2 are one f32 each; with_health (health a (2,) f32
// output, else null) writes the per-line nf/ss into the caller's scratch
// lines nf_lines/ss_lines and then reduces them into health.
extern "C" int repro_slim_precond(const void* g, int g_bf16, const float* m, const float* v, const float* bc1,
                                  const float* bc2, float* u, float* m_out, float* v_out, float* s1c, float* s2c,
                                  float* nf_lines, float* ss_lines, float* health, long long batch,
                                  long long rows, long long cols, int axis, float inv_n, float b1, float omb1,
                                  float b2, float omb2, float eps, void* stream) {
  if (!flags_paired(s1c, s2c) || !flags_paired(nf_lines, ss_lines) || !flags_paired(nf_lines, health)) {
    return (int)cudaErrorInvalidValue;
  }
  SlimArgs a{g, m, v, bc1, bc2, u, m_out, v_out, s1c, s2c, nf_lines, ss_lines, nullptr, nullptr, batch, rows, cols,
             inv_n, b1, omb1, b2, omb2, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_bf16) {
    launch<__nv_bfloat16, true>(a, axis, s);
  } else {
    launch<float, true>(a, axis, s);
  }
  if (health != nullptr) reduce_health(a, axis, health, s);
  return (int)cudaGetLastError();
}

// Pass 1 of the psum pair, megaplan group form. g, m, m_out: contiguous f32
// (batch, rows, cols). part and the optional line outputs s1c, s2c, first
// (with_snr) and nf, ss (with_health; null when off): contiguous f32 lines,
// (batch, rows, 1) for axis 1 and (batch, 1, cols) for axis 0. part is the
// un-normalised line sum of g^2. Grid limits as above.
extern "C" int repro_mega_slim_partial_stats(const float* g, const float* m, float* m_out, float* part, float* s1c,
                                             float* s2c, float* first, float* nf, float* ss, long long batch,
                                             long long rows, long long cols, int axis, float b1, float omb1,
                                             void* stream) {
  if (!flags_paired(s1c, s2c) || !flags_paired(s1c, first) || !flags_paired(nf, ss)) {
    return (int)cudaErrorInvalidValue;
  }
  SlimArgs a{g, m, nullptr, nullptr, nullptr, nullptr, m_out, nullptr, s1c, s2c, nf, ss, part, first, batch, rows,
             cols, 0.f, b1, omb1, 0.f, 0.f, 0.f};
  launch<float, false, true>(a, axis, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// Pass 1 of the psum pair, per-leaf form. As the group form, except: g is
// f32 (g_bf16 = 0) or bf16 (g_bf16 = 1); with_health (health a (2,) f32
// output, else null) writes the per-line nf/ss into the caller's scratch
// lines nf_lines/ss_lines and then reduces them into health.
extern "C" int repro_slim_partial_stats(const void* g, int g_bf16, const float* m, float* m_out, float* part,
                                        float* s1c, float* s2c, float* first, float* nf_lines, float* ss_lines,
                                        float* health, long long batch, long long rows, long long cols, int axis,
                                        float b1, float omb1, void* stream) {
  if (!flags_paired(s1c, s2c) || !flags_paired(s1c, first) || !flags_paired(nf_lines, ss_lines) ||
      !flags_paired(nf_lines, health)) {
    return (int)cudaErrorInvalidValue;
  }
  SlimArgs a{g, m, nullptr, nullptr, nullptr, nullptr, m_out, nullptr, s1c, s2c, nf_lines, ss_lines, part, first,
             batch, rows, cols, 0.f, b1, omb1, 0.f, 0.f, 0.f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_bf16) {
    launch<__nv_bfloat16, false, true>(a, axis, s);
  } else {
    launch<float, false, true>(a, axis, s);
  }
  if (health != nullptr) reduce_health(a, axis, health, s);
  return (int)cudaGetLastError();
}

// Parameter-writing per-leaf form (SlimAdam that writes the parameters).
// Replaces repro/kernels/slim_update.py:74 slim_update_batched (kernel body
// _slim_kernel :56, pallas_call :103): the same line walk as
// repro_slim_precond, whose pass 2 writes p' = p - lr*(u + wd*p) (rounded to
// p's dtype) where the precondition form writes u. Bound: bytes, p, g, m
// read and p', m' written (20 B per f32 element, 14 B with bf16 p and g),
// plus 8 B per line. p, p_out: (batch, rows, cols), f32 (p_bf16 = 0) or
// bf16 (p_bf16 = 1); g f32 or bf16 (g_bf16); m, m_out f32; v, v_out lines
// as in repro_slim_precond. c1/c2: the bias corrections 1 - b^t, rounded in
// f32 by the caller (the count is a Python int in the JAX entry points).
extern "C" int repro_slim_update(const void* p, int p_bf16, const void* g, int g_bf16, const float* m,
                                 const float* v, void* p_out, float* m_out, float* v_out, long long batch,
                                 long long rows, long long cols, int axis, float inv_n, float lr, float wd, float c1,
                                 float c2, float b1, float omb1, float b2, float omb2, float eps, void* stream) {
  SlimArgs a{g, m, v, nullptr, nullptr, nullptr, m_out, v_out, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
             batch, rows, cols, inv_n, b1, omb1, b2, omb2, eps};
  a.p = p;
  a.p_out = p_out;
  a.lr = lr;
  a.wd = wd;
  a.c1 = c1;
  a.c2 = c2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_bf16 && p_bf16) {
    launch_write<__nv_bfloat16, __nv_bfloat16>(a, axis, s);
  } else if (g_bf16) {
    launch_write<__nv_bfloat16, float>(a, axis, s);
  } else if (p_bf16) {
    launch_write<float, __nv_bfloat16>(a, axis, s);
  } else {
    launch_write<float, float>(a, axis, s);
  }
  return (int)cudaGetLastError();
}
