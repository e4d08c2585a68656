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
// Bound: bytes. g and m are read, u and m' written (16 B per f32 element,
// 14 B with bf16 g); the line operands v, bc1, bc2 and v' add 16 B per line,
// each flag's two line outputs 8 B more. Each line is walked twice: pass 1
// sums g^2 (and the flags' sums), pass 2 writes m' and u once the line's v'
// is known. Where g fits in the 50 MB L2, pass 2's read of g hits it and
// device memory sees g once. A view whose g is larger cannot keep it on chip
// between the passes, and its floor is 20 B per f32 element, g read twice:
// AdaLayer's 38.6 M-element embedding line (154.5 MB of g) has a 16 B bound
// of 0.1845 ms and a 20 B floor of 0.2306 ms (3.35 TB/s).
//
// The walk cuts the work by bytes, not by line, on a 1-D grid that a
// host-side planner sizes (repro_torch/kernels/megaplan.py plan_slim: pure
// integer arithmetic, pieces of 64-256 KB of the 16 B an element moves,
// about 4 blocks per SM where the view has the bytes). Three forms:
//   ROWS   today's one-launch walk, kept where it already fills the card:
//          axis 1 (contiguous lines) one block per line when the line is
//          one piece, threads striding it with float4 loads and a block
//          reduction joining the sums; axis 0 (lines strided by C) one block
//          per kStrip adjacent columns of a batch slice, kRowThreads warps
//          splitting the rows, when those strips number 4 a SM or when
//          splitting rows would give no more blocks. Table 3's groups on
//          gpt_small (lines of 768 and 3072; (12, 768, 1536) on axis 0)
//          take it, with the instruction stream they had before.
//   SPLIT  axis 1, a line longer than a piece: cut into nseg segments of
//          seg elements (a multiple of 1024), a block of 256 threads each.
//   MAJOR  axis 0, strips too few: a block owns 128 adjacent columns (a
//          float4 per lane; 32 columns with 4-byte loads) over a chunk of
//          seg rows, its 8 warps interleaving the rows; the chunks split the
//          rows across blocks, so a B = 1 view with few columns fills the
//          card (ResNet-18's (1, 4608, 1536) group: 540 blocks, not 48).
// SPLIT and MAJOR are two CUDA launches. Pass 1 sums each piece's g^2 in f64
// (and, with the flags, the centered sums of g^2 shifted by g^2 at the
// line's first entry, which every piece loads, and the health terms) and
// writes those shares to an f64 workspace that the wrapper allocates. Pass 2
// combines each line's nseg g^2 shares in a fixed order, so every block of a
// line derives the bit-identical v'; the block holding the line's first
// piece also combines the flags' shares and writes v' and the line outputs;
// every block then writes m' and u over its own piece. No float atomics: a
// given input gives bit-identical outputs on every run. Pass 2 takes the
// pieces in reverse order, so its first blocks read the end of g that pass
// 1 left in L2. Two launches rather than one cooperative launch with a
// grid-wide barrier: a cooperative grid may not exceed the blocks the card
// holds at once, so it would cap the grid and walk pieces in a loop, while
// the second launch costs a few microseconds and keeps each pass a plain
// grid. The wrapper counts one launch per call; the per-leaf form's health
// reduction (below) adds one CUDA launch to any form.
// Loads are 16 B a thread for f32 g (8 B for bf16 g, four values) where the
// view is aligned and its inner size a multiple of 4, else 4-byte loads.
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
// terms), all in one walk over the line; the sum completes across ranks,
// and slim_finalize.cu applies the preconditioner. Bound: bytes, 12 B per
// f32 element (g, m read, m' written) plus 4 B per line, 12 B more per line
// with_snr, 8 B with_health; g is read once, so no floor stands above it.
// Both forms take plan_slim's grid: ROWS as above, or on SPLIT and MAJOR a
// first launch over the pieces that writes m' and each piece's f64 shares
// (pass 1 of B1 with an m' write, g and m read streaming), then a small
// combine launch that adds each line's shares in a fixed order (a warp a
// SPLIT line, a thread a MAJOR column, as snr_stats.cu's combine) and
// writes the f32 line outputs, the shift f included. The per-leaf form
// (B10) runs the group form's kernels on the same plan, so the two give
// equal bits on the same operands; its bf16 g moves four values as 8 bytes
// in the vector form, and its (2,) health reduces the combined per-line
// nf/ss lines in one more launch, as B4's does.
//
// WRITE replaces repro/kernels/slim_update.py:74 slim_update_batched (body
// _slim_kernel :56, pallas_call :103), the parameter-writing per-leaf form:
// pass 2 writes p' = p - lr*(u + wd*p) in p's dtype (f32 or bf16) instead
// of u, with the bias corrections passed as host-rounded scalars (no
// launch forms them). It takes B4's walk on plan_slim's grid: ROWS, or
// SPLIT / MAJOR with B4's pass 1 (no flags) and a pass 2 that reads p as
// well. Bound: 20 B per f32 element (p, g, m read, p', m' written); a split
// view whose g outgrows the L2 reads g twice, a 24 B floor. The vector
// form loads four p as 16 bytes (f32) or 8 bytes (bf16) and stores p' the
// same way; the 4-byte form moves one p a thread (4 or 2 bytes). Entry
// point repro_slim_update at the end of the file.
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

// The ROWS form: one block per axis-1 line, or per kStrip columns of an
// axis-0 batch slice (B1, B4, B7, B10 and B12 where the plan says so). vec
// (float4 loads of an axis-1 line) needs f32 g and, with WRITE, f32 p.
template <typename G, bool SCALAR_BC, bool SNR, bool HEALTH, bool PARTIAL, typename P = float, bool WRITE = false>
void launch_rows(const SlimArgs& a, int axis, bool vec, cudaStream_t s) {
  constexpr bool kF32 = std::is_same<G, float>::value && std::is_same<P, float>::value;
  vec = vec && kF32;
  if (axis == 1) {
    long long work = vec ? a.cols / 4 : a.cols;
    long long threads = ((work + 31) / 32) * 32;
    if (threads > 1024) threads = 1024;
    if (threads < 32) threads = 32;
    const unsigned lines = (unsigned)(a.batch * a.rows);
    if constexpr (kF32) {
      if (vec) {
        slim_minor_kernel<G, true, SCALAR_BC, SNR, HEALTH, PARTIAL, P, WRITE><<<lines, (unsigned)threads, 0, s>>>(a);
        return;
      }
    }
    slim_minor_kernel<G, false, SCALAR_BC, SNR, HEALTH, PARTIAL, P, WRITE><<<lines, (unsigned)threads, 0, s>>>(a);
  } else {
    dim3 grid((unsigned)((a.cols + kStrip - 1) / kStrip), (unsigned)a.batch);
    dim3 block(kStrip, kRowThreads);
    slim_major_kernel<G, SCALAR_BC, SNR, HEALTH, PARTIAL, P, WRITE><<<grid, block, 0, s>>>(a);
  }
}

// ---- B1, B4, B7, B10 and B12: the SPLIT and MAJOR forms ------------------------------

// These match the planner's constants in repro_torch/kernels/megaplan.py
// (and the split walk's in snr_stats.cu).
constexpr int kThreads = 256;  // every block of the SPLIT and MAJOR passes
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;     // loads in flight per thread
constexpr int kFormRows = 0, kFormSplit = 1, kFormMajor = 2;

// The plan of one call (plan_slim) and the f64 workspace of its shares:
// kCount planes of lines * nseg doubles, share k of line l at l * nseg + k
// (SPLIT) or at k * lines + l (MAJOR, so that a block's adjacent columns
// read adjacent doubles).
struct Walk {
  int form;
  bool vec;
  long long seg, nseg, blocks;
  double* part;
  long long combine_blocks = 0;  // B10's and B12's second launch (SlimPlan.combine_blocks)
};

// One piece's f64 shares of a line's sums: g^2 (as the ROWS form sums it,
// an FMA of the exact square), then with SNR s1c and s2c of g^2 shifted by
// f (differences rounded in f32), then with HEALTH the non-finite count and
// the finite sum of g^2 rounded in f32: LineStats's terms, in planes.
template <bool SNR, bool HEALTH>
struct Shares {
  static constexpr int kCount = 1 + (SNR ? 2 : 0) + (HEALTH ? 2 : 0);
  static constexpr int kNf = SNR ? 3 : 1;
  double v[kCount];
  __device__ __forceinline__ Shares() {
#pragma unroll
    for (int j = 0; j < kCount; ++j) v[j] = 0.0;
  }
  __device__ __forceinline__ void add(float x, float f) {
    v[0] = fma((double)x, (double)x, v[0]);
    if constexpr (SNR || HEALTH) {
      const float x2 = __fmul_rn(x, x);
      if constexpr (SNR) {
        const double d = (double)__fsub_rn(x2, f);
        v[1] += d;
        v[2] += d * d;
      }
      if constexpr (HEALTH) {
        if (isfinite(x)) {
          v[kNf + 1] += (double)x2;
        } else {
          v[kNf] += 1.0;
        }
      }
    }
  }
  __device__ __forceinline__ void add(const float4& x, float f) {
    add(x.x, f);
    add(x.y, f);
    add(x.z, f);
    add(x.w, f);
  }
};

// The first n values of v summed over the block in a fixed order (a
// shuffle tree in each warp, then the warps in turn); thread 0 gets the
// totals. The leading barrier lets a caller reuse smem.
__device__ __forceinline__ void block_total(double* v, int n, double (*smem)[kWarps]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int j = 0; j < n; ++j) {
    for (int off = 16; off > 0; off >>= 1) v[j] += __shfl_xor_sync(0xffffffffu, v[j], off);
  }
  __syncthreads();
  if (lane == 0) {
    for (int j = 0; j < n; ++j) smem[j][warp] = v[j];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int j = 0; j < n; ++j) {
      double t = 0.0;
      for (int w = 0; w < kWarps; ++w) t += smem[j][w];
      v[j] = t;
    }
  }
}

// Four consecutive g at element i (a multiple of 4) as f32, from one 16-byte
// (f32) or 8-byte (bf16: the upper half of an f32's bits) load. LAST: the
// data's last read (streaming, evict-first); otherwise a cached read, which
// pass 2 may find in L2.
template <typename G, bool LAST>
__device__ __forceinline__ float4 load_g4(const void* p, long long i) {
  if constexpr (std::is_same<G, float>::value) {
    const float4* q = reinterpret_cast<const float4*>(static_cast<const float*>(p) + i);
    if constexpr (LAST) {
      return __ldcs(q);
    } else {
      return *q;
    }
  } else {
    const uint2* q = reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(p) + i);
    uint2 r;
    if constexpr (LAST) {
      r = __ldcs(q);
    } else {
      r = *q;
    }
    return make_float4(__uint_as_float(r.x << 16), __uint_as_float(r.x & 0xffff0000u), __uint_as_float(r.y << 16),
                       __uint_as_float(r.y & 0xffff0000u));
  }
}

// The VEC form's four elements (a float4), or one, of g as f32 and of m.
template <typename G, bool VEC, bool LAST>
__device__ __forceinline__ typename std::conditional<VEC, float4, float>::type load_gv(const void* p, long long i) {
  if constexpr (VEC) {
    return load_g4<G, LAST>(p, i);
  } else {
    return load_g<G>(p, i);
  }
}

template <bool VEC>
__device__ __forceinline__ typename std::conditional<VEC, float4, float>::type load_mv(const float* p, long long i) {
  using T = typename std::conditional<VEC, float4, float>::type;
  return __ldcs(reinterpret_cast<const T*>(p + i));
}

// m' of one element, or of four, stored streaming (B12's pass 1).
__device__ __forceinline__ float4 ema4(const SlimArgs& a, const float4& x, const float4& m) {
  float4 mn;
  mn.x = ema(a.b1, m.x, a.omb1, x.x);
  mn.y = ema(a.b1, m.y, a.omb1, x.y);
  mn.z = ema(a.b1, m.z, a.omb1, x.z);
  mn.w = ema(a.b1, m.w, a.omb1, x.w);
  return mn;
}

__device__ __forceinline__ void store_m(const SlimArgs& a, long long i, float x, float m) {
  __stcs(a.m_out + i, ema(a.b1, m, a.omb1, x));
}

__device__ __forceinline__ void store_m(const SlimArgs& a, long long i, const float4& x, const float4& m) {
  __stcs(reinterpret_cast<float4*>(a.m_out + i), ema4(a, x, m));
}

__device__ __forceinline__ unsigned bf16_bits(float x) { return __bfloat16_as_ushort(__float2bfloat16_rn(x)); }

// Four p' at element i (a multiple of 4) in p's dtype, stored streaming:
// one 16-byte (f32) or 8-byte (bf16, the first value in the low half) store.
template <typename P>
__device__ __forceinline__ void stream_p4(void* out, long long i, const float4& x) {
  if constexpr (std::is_same<P, float>::value) {
    __stcs(reinterpret_cast<float4*>(static_cast<float*>(out) + i), x);
  } else {
    __stcs(reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) + i),
           make_uint2(bf16_bits(x.x) | (bf16_bits(x.y) << 16), bf16_bits(x.z) | (bf16_bits(x.w) << 16)));
  }
}

// m' and u (or, WRITE, p' from p) of one element, or of four (each with its
// own line values), stored streaming: no pass reads them again. p is unused
// unless WRITE.
template <typename P, bool WRITE>
__device__ __forceinline__ void update(const SlimArgs& a, long long i, float x, float m, float p,
                                       const float* v_new, const float* c1, const float* c2) {
  const float mn = ema(a.b1, m, a.omb1, x);
  __stcs(a.m_out + i, mn);
  const float uu = precond(mn, c1[0], v_new[0], c2[0], a.eps);
  if constexpr (WRITE) {
    store_p<P>(a.p_out, i, param_step(p, uu, a.lr, a.wd));
  } else {
    __stcs(a.u + i, uu);
  }
}

template <typename P, bool WRITE>
__device__ __forceinline__ void update(const SlimArgs& a, long long i, const float4& x, const float4& m,
                                       const float4& p, const float* v_new, const float* c1, const float* c2) {
  const float4 mn = ema4(a, x, m);
  float4 uu;
  uu.x = precond(mn.x, c1[0], v_new[0], c2[0], a.eps);
  uu.y = precond(mn.y, c1[1], v_new[1], c2[1], a.eps);
  uu.z = precond(mn.z, c1[2], v_new[2], c2[2], a.eps);
  uu.w = precond(mn.w, c1[3], v_new[3], c2[3], a.eps);
  __stcs(reinterpret_cast<float4*>(a.m_out + i), mn);
  if constexpr (WRITE) {
    float4 po;
    po.x = param_step(p.x, uu.x, a.lr, a.wd);
    po.y = param_step(p.y, uu.y, a.lr, a.wd);
    po.z = param_step(p.z, uu.z, a.lr, a.wd);
    po.w = param_step(p.w, uu.w, a.lr, a.wd);
    stream_p4<P>(a.p_out, i, po);
  } else {
    __stcs(reinterpret_cast<float4*>(a.u + i), uu);
  }
}

// The bias corrections of a line: WRITE's host-rounded scalars, else the
// line's (or, SCALAR_BC, the leaf's) values.
template <bool SCALAR_BC, bool WRITE>
__device__ __forceinline__ void line_bc(const SlimArgs& a, long long l, float& c1, float& c2) {
  if constexpr (WRITE) {
    c1 = a.c1;
    c2 = a.c2;
  } else {
    c1 = bc_at<SCALAR_BC>(a.bc1, l);
    c2 = bc_at<SCALAR_BC>(a.bc2, l);
  }
}

// v' of line l from its g^2 total (the ROWS form's arithmetic).
__device__ __forceinline__ float line_v(const SlimArgs& a, long long l, double total) {
  return ema(a.b2, a.v[l], a.omb2, __fmul_rn((float)total, a.inv_n));
}

template <bool SNR, bool HEALTH>
__device__ __forceinline__ void write_line_shares(const SlimArgs& a, long long l, const double* t) {
  if constexpr (SNR) {
    a.s1c[l] = (float)t[1];
    a.s2c[l] = (float)t[2];
  }
  if constexpr (HEALTH) {
    a.nf[l] = (float)t[Shares<SNR, HEALTH>::kNf];
    a.ss[l] = (float)t[Shares<SNR, HEALTH>::kNf + 1];
  }
}

// SPLIT pass 1: block b sums segment k = b % nseg (elements [k*seg,
// k*seg + seg) of the line, the last one shorter) of line b / nseg and
// writes its shares. seg is a multiple of 1024, so every segment of a
// vector-form line starts on a 4-element boundary. PARTIAL (B12's first
// launch) also writes m' over the segment, and reads g streaming, as no
// second pass reads it.
template <typename G, bool VEC, bool SNR, bool HEALTH, bool PARTIAL = false>
__global__ void __launch_bounds__(kThreads) slim_split_sum(SlimArgs a, Walk w) {
  using S = Shares<SNR, HEALTH>;
  using V = typename std::conditional<VEC, float4, float>::type;
  __shared__ double smem[S::kCount][kWarps];
  constexpr long long kPer = VEC ? 4 : 1;
  const long long line = (long long)blockIdx.x / w.nseg;
  const long long k = (long long)blockIdx.x % w.nseg;
  const long long begin = line * a.cols + k * w.seg;
  const long long n = min(w.seg, a.cols - k * w.seg) / kPer;
  float f = 0.f;
  if constexpr (SNR) {
    const float x0 = load_g<G>(a.g, line * a.cols);
    f = __fmul_rn(x0, x0);
  }
  S s;
  long long j = threadIdx.x;
  for (; j + (kUnroll - 1) * kThreads < n; j += kUnroll * kThreads) {
    V x[kUnroll], m[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      x[q] = load_gv<G, VEC, PARTIAL>(a.g, begin + (j + q * kThreads) * kPer);
      if constexpr (PARTIAL) m[q] = load_mv<VEC>(a.m, begin + (j + q * kThreads) * kPer);
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      s.add(x[q], f);
      if constexpr (PARTIAL) store_m(a, begin + (j + q * kThreads) * kPer, x[q], m[q]);
    }
  }
  for (; j < n; j += kThreads) {
    const V x = load_gv<G, VEC, PARTIAL>(a.g, begin + j * kPer);
    s.add(x, f);
    if constexpr (PARTIAL) store_m(a, begin + j * kPer, x, load_mv<VEC>(a.m, begin + j * kPer));
  }
  block_total(s.v, S::kCount, smem);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int p = 0; p < S::kCount; ++p) w.part[p * w.blocks + line * w.nseg + k] = s.v[p];
  }
}

// SPLIT pass 2: the same pieces in reverse block order. Every block sums
// its line's nseg g^2 shares in order (thread t takes shares t, t + 256,
// ..., then block_total), so all derive one v'; the block of segment 0
// also combines the flags' shares and writes v' and the line outputs.
// WRITE (B7) reads p as well and writes p' where B1 and B4 write u.
template <typename G, bool VEC, bool SCALAR_BC, bool SNR, bool HEALTH, typename P = float, bool WRITE = false>
__global__ void __launch_bounds__(kThreads) slim_split_apply(SlimArgs a, Walk w) {
  using S = Shares<SNR, HEALTH>;
  using V = typename std::conditional<VEC, float4, float>::type;
  __shared__ double smem[S::kCount][kWarps];
  __shared__ float shared_v;
  constexpr long long kPer = VEC ? 4 : 1;
  const long long b = w.blocks - 1 - (long long)blockIdx.x;
  const long long line = b / w.nseg;
  const long long k = b % w.nseg;
  const double* __restrict__ part = w.part + line * w.nseg;
  double t[S::kCount];
  t[0] = 0.0;
  for (long long q = threadIdx.x; q < w.nseg; q += kThreads) t[0] += part[q];
  block_total(t, 1, smem);
  if constexpr (S::kCount > 1) {
    if (k == 0) {
#pragma unroll
      for (int p = 1; p < S::kCount; ++p) {
        t[p] = 0.0;
        for (long long q = threadIdx.x; q < w.nseg; q += kThreads) t[p] += part[p * w.blocks + q];
      }
      block_total(t + 1, S::kCount - 1, smem);
    }
  }
  if (threadIdx.x == 0) {
    const float v_new = line_v(a, line, t[0]);
    shared_v = v_new;
    if (k == 0) {
      a.v_out[line] = v_new;
      write_line_shares<SNR, HEALTH>(a, line, t);
    }
  }
  __syncthreads();
  const float v1 = shared_v;
  float c11, c21;
  line_bc<SCALAR_BC, WRITE>(a, line, c11, c21);
  const float vv[4] = {v1, v1, v1, v1};
  const float c1[4] = {c11, c11, c11, c11};
  const float c2[4] = {c21, c21, c21, c21};
  const long long begin = line * a.cols + k * w.seg;
  const long long n = min(w.seg, a.cols - k * w.seg) / kPer;
  long long j = threadIdx.x;
  for (; j + (kUnroll - 1) * kThreads < n; j += kUnroll * kThreads) {
    V x[kUnroll], m[kUnroll], p[kUnroll] = {};
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      x[q] = load_gv<G, VEC, true>(a.g, begin + (j + q * kThreads) * kPer);
      m[q] = load_mv<VEC>(a.m, begin + (j + q * kThreads) * kPer);
      if constexpr (WRITE) p[q] = load_gv<P, VEC, true>(a.p, begin + (j + q * kThreads) * kPer);
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      update<P, WRITE>(a, begin + (j + q * kThreads) * kPer, x[q], m[q], p[q], vv, c1, c2);
    }
  }
  for (; j < n; j += kThreads) {
    const long long i = begin + j * kPer;
    V p = {};
    if constexpr (WRITE) p = load_gv<P, VEC, true>(a.p, i);
    update<P, WRITE>(a, i, load_gv<G, VEC, true>(a.g, i), load_mv<VEC>(a.m, i), p, vv, c1, c2);
  }
}

// MAJOR's pieces: block b holds row chunk k = b % nseg (rows [k*seg,
// k*seg + seg), seg a multiple of kWarps) of column tile b / nseg: batch
// entry tile / ctiles, columns from (tile % ctiles) * kTile. Lane l of each
// warp owns the kPer columns from l * kPer; warp w takes rows k*seg + w,
// + kWarps, ...
struct MajorPiece {
  long long k, b, c0;
  __device__ __forceinline__ MajorPiece(long long block, long long ctiles, long long nseg, int tile)
      : k(block % nseg), b(block / nseg / ctiles), c0((block / nseg) % ctiles * tile) {}
};

// A lane's row of its columns into their shares.
template <bool SNR, bool HEALTH>
__device__ __forceinline__ void add_columns(Shares<SNR, HEALTH>* s, const float4& x, const float* f) {
  s[0].add(x.x, f[0]);
  s[1].add(x.y, f[1]);
  s[2].add(x.z, f[2]);
  s[3].add(x.w, f[3]);
}
template <bool SNR, bool HEALTH>
__device__ __forceinline__ void add_columns(Shares<SNR, HEALTH>* s, float x, const float* f) {
  s[0].add(x, f[0]);
}

// MAJOR pass 1: each column's shares over the chunk, the warps' sums added
// in warp order in shared memory. PARTIAL (B12's first launch) also writes
// m' over the chunk and reads g streaming.
template <typename G, bool VEC, bool SNR, bool HEALTH, bool PARTIAL = false>
__global__ void __launch_bounds__(kThreads) slim_major_sum(SlimArgs a, Walk w, long long ctiles) {
  using S = Shares<SNR, HEALTH>;
  using V = typename std::conditional<VEC, float4, float>::type;
  constexpr int kPer = VEC ? 4 : 1;
  constexpr int kTile = 32 * kPer;
  __shared__ double smem[S::kCount][kWarps][kTile];
  const MajorPiece pc(blockIdx.x, ctiles, w.nseg, kTile);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long c = pc.c0 + (long long)lane * kPer;
  const long long slice = pc.b * a.rows * a.cols;
  S s[kPer];
  if (c < a.cols) {  // the vector form has cols % 4 == 0: a lane's columns are all live or none
    float f[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      f[q] = 0.f;
      if constexpr (SNR) {
        const float x0 = load_g<G>(a.g, slice + c + q);
        f[q] = __fmul_rn(x0, x0);
      }
    }
    const long long r_end = min(a.rows, (pc.k + 1) * w.seg);
    long long r = pc.k * w.seg + warp;
    for (; r + (kUnroll - 1) * kWarps < r_end; r += kUnroll * kWarps) {
      V x[kUnroll], m[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        x[u] = load_gv<G, VEC, PARTIAL>(a.g, slice + (r + u * kWarps) * a.cols + c);
        if constexpr (PARTIAL) m[u] = load_mv<VEC>(a.m, slice + (r + u * kWarps) * a.cols + c);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        add_columns(s, x[u], f);
        if constexpr (PARTIAL) store_m(a, slice + (r + u * kWarps) * a.cols + c, x[u], m[u]);
      }
    }
    for (; r < r_end; r += kWarps) {
      const long long i = slice + r * a.cols + c;
      const V x = load_gv<G, VEC, PARTIAL>(a.g, i);
      add_columns(s, x, f);
      if constexpr (PARTIAL) store_m(a, i, x, load_mv<VEC>(a.m, i));
    }
  }
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
#pragma unroll
    for (int p = 0; p < S::kCount; ++p) smem[p][warp][lane * kPer + q] = s[q].v[p];
  }
  __syncthreads();
  const long long cc = pc.c0 + threadIdx.x;
  if (threadIdx.x < kTile && cc < a.cols) {
    const long long lines = a.batch * a.cols;
    const long long slot = pc.k * lines + pc.b * a.cols + cc;
#pragma unroll
    for (int p = 0; p < S::kCount; ++p) {
      double t = 0.0;
      for (int v = 0; v < kWarps; ++v) t += smem[p][v][threadIdx.x];
      w.part[p * lines * w.nseg + slot] = t;
    }
  }
}

// MAJOR pass 2: the same pieces in reverse block order. Thread t < kTile
// sums column t's nseg g^2 shares in order, so every chunk of a column
// derives one v'; chunk 0's block also combines the flags' shares and
// writes v' and the line outputs. Then each lane updates its columns over
// the chunk's rows (WRITE: p' from p, as in the SPLIT pass 2).
template <typename G, bool VEC, bool SCALAR_BC, bool SNR, bool HEALTH, typename P = float, bool WRITE = false>
__global__ void __launch_bounds__(kThreads) slim_major_apply(SlimArgs a, Walk w, long long ctiles) {
  using S = Shares<SNR, HEALTH>;
  using V = typename std::conditional<VEC, float4, float>::type;
  constexpr int kPer = VEC ? 4 : 1;
  constexpr int kTile = 32 * kPer;
  __shared__ float shared_v[kTile];
  const MajorPiece pc(w.blocks - 1 - (long long)blockIdx.x, ctiles, w.nseg, kTile);
  const long long lines = a.batch * a.cols;
  const long long cc = pc.c0 + threadIdx.x;
  if (threadIdx.x < kTile && cc < a.cols) {
    const long long l = pc.b * a.cols + cc;
    double t[S::kCount];
    const int planes = pc.k == 0 ? S::kCount : 1;
    for (int p = 0; p < planes; ++p) {
      const double* __restrict__ share = w.part + p * lines * w.nseg + l;
      t[p] = 0.0;
      for (long long q = 0; q < w.nseg; ++q) t[p] += share[q * lines];
    }
    const float v_new = line_v(a, l, t[0]);
    shared_v[threadIdx.x] = v_new;
    if (pc.k == 0) {
      a.v_out[l] = v_new;
      write_line_shares<SNR, HEALTH>(a, l, t);
    }
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long c = pc.c0 + (long long)lane * kPer;
  if (c >= a.cols) return;
  float vv[kPer], c1[kPer], c2[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    vv[q] = shared_v[lane * kPer + q];
    line_bc<SCALAR_BC, WRITE>(a, pc.b * a.cols + c + q, c1[q], c2[q]);
  }
  const long long slice = pc.b * a.rows * a.cols;
  const long long r_end = min(a.rows, (pc.k + 1) * w.seg);
  long long r = pc.k * w.seg + warp;
  for (; r + (kUnroll - 1) * kWarps < r_end; r += kUnroll * kWarps) {
    V x[kUnroll], m[kUnroll], p[kUnroll] = {};
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = slice + (r + u * kWarps) * a.cols + c;
      x[u] = load_gv<G, VEC, true>(a.g, i);
      m[u] = load_mv<VEC>(a.m, i);
      if constexpr (WRITE) p[u] = load_gv<P, VEC, true>(a.p, i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      update<P, WRITE>(a, slice + (r + u * kWarps) * a.cols + c, x[u], m[u], p[u], vv, c1, c2);
    }
  }
  for (; r < r_end; r += kWarps) {
    const long long i = slice + r * a.cols + c;
    V p = {};
    if constexpr (WRITE) p = load_gv<P, VEC, true>(a.p, i);
    update<P, WRITE>(a, i, load_gv<G, VEC, true>(a.g, i), load_mv<VEC>(a.m, i), p, vv, c1, c2);
  }
}

// B12's second launch: each line's nseg shares added in a fixed order and
// rounded to f32 once, for part (the line sum of g^2) and the flags' line
// outputs; with SNR also the shift f = g^2 at the line's first entry. SPLIT
// (shares of line l at l * nseg + k): a warp a line, lane i adding shares
// i, i + 32, ... in turn, then the shuffle tree. MAJOR (at k * lines + l): a
// thread a column, adding shares 0, 1, ... in turn, so adjacent threads read
// adjacent doubles. No float atomics: the same input gives the same bits.
template <typename G, bool SNR, bool HEALTH, bool MAJOR>
__global__ void __launch_bounds__(kThreads) slim_partial_combine(SlimArgs a, Walk w, long long lines) {
  using S = Shares<SNR, HEALTH>;
  const long long np = lines * w.nseg;
  double t[S::kCount];
#pragma unroll
  for (int p = 0; p < S::kCount; ++p) t[p] = 0.0;
  long long l;
  if constexpr (MAJOR) {
    l = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (l >= lines) return;
    for (long long k = 0; k < w.nseg; ++k) {
#pragma unroll
      for (int p = 0; p < S::kCount; ++p) t[p] += w.part[p * np + k * lines + l];
    }
  } else {
    l = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (l >= lines) return;  // the whole warp: l is the warp's
    const int lane = threadIdx.x & 31;
    for (long long k = lane; k < w.nseg; k += 32) {
#pragma unroll
      for (int p = 0; p < S::kCount; ++p) t[p] += w.part[p * np + l * w.nseg + k];
    }
#pragma unroll
    for (int p = 0; p < S::kCount; ++p) {
      for (int off = 16; off > 0; off >>= 1) t[p] += __shfl_xor_sync(0xffffffffu, t[p], off);
    }
    if (lane != 0) return;
  }
  a.part[l] = (float)t[0];
  write_line_shares<SNR, HEALTH>(a, l, t);
  if constexpr (SNR) {
    const float x0 = load_g<G>(a.g, MAJOR ? l / a.cols * a.rows * a.cols + l % a.cols : l * a.cols);
    a.first[l] = __fmul_rn(x0, x0);
  }
}

constexpr long long tile_of(bool vec) { return vec ? 128 : 32; }

// B1, B4 and (WRITE) B7: pass 1, then pass 2 over the same pieces.
template <typename G, bool VEC, bool SCALAR_BC, bool SNR, bool HEALTH, typename P = float, bool WRITE = false>
void launch_pieces(const SlimArgs& a, const Walk& w, cudaStream_t s) {
  const unsigned grid = (unsigned)w.blocks;
  if (w.form == kFormSplit) {
    slim_split_sum<G, VEC, SNR, HEALTH><<<grid, kThreads, 0, s>>>(a, w);
    slim_split_apply<G, VEC, SCALAR_BC, SNR, HEALTH, P, WRITE><<<grid, kThreads, 0, s>>>(a, w);
  } else {
    const long long ctiles = (a.cols + tile_of(VEC) - 1) / tile_of(VEC);
    slim_major_sum<G, VEC, SNR, HEALTH><<<grid, kThreads, 0, s>>>(a, w, ctiles);
    slim_major_apply<G, VEC, SCALAR_BC, SNR, HEALTH, P, WRITE><<<grid, kThreads, 0, s>>>(a, w, ctiles);
  }
}

// B10 and B12: pass 1 with the m' write, then the combine of the line
// outputs.
template <typename G, bool VEC, bool SNR, bool HEALTH>
void launch_partial_pieces(const SlimArgs& a, const Walk& w, cudaStream_t s) {
  const unsigned grid = (unsigned)w.blocks;
  if (w.form == kFormSplit) {
    const long long lines = a.batch * a.rows;
    slim_split_sum<G, VEC, SNR, HEALTH, true><<<grid, kThreads, 0, s>>>(a, w);
    slim_partial_combine<G, SNR, HEALTH, false><<<(unsigned)w.combine_blocks, kThreads, 0, s>>>(a, w, lines);
  } else {
    const long long lines = a.batch * a.cols;
    const long long ctiles = (a.cols + tile_of(VEC) - 1) / tile_of(VEC);
    slim_major_sum<G, VEC, SNR, HEALTH, true><<<grid, kThreads, 0, s>>>(a, w, ctiles);
    slim_partial_combine<G, SNR, HEALTH, true><<<(unsigned)w.combine_blocks, kThreads, 0, s>>>(a, w, lines);
  }
}

// B1, B4, (PARTIAL) B10 and B12 and (WRITE) B7 on the plan's form: ROWS
// (one launch) or the two launches of SPLIT / MAJOR.
template <typename G, bool SCALAR_BC, bool SNR, bool HEALTH, bool PARTIAL, typename P = float, bool WRITE = false>
void launch_plan_flags(const SlimArgs& a, int axis, const Walk& w, cudaStream_t s) {
  if (w.form == kFormRows) {
    launch_rows<G, SCALAR_BC, SNR, HEALTH, PARTIAL, P, WRITE>(a, axis, w.vec, s);
  } else if constexpr (PARTIAL) {
    if (w.vec) {
      launch_partial_pieces<G, true, SNR, HEALTH>(a, w, s);
    } else {
      launch_partial_pieces<G, false, SNR, HEALTH>(a, w, s);
    }
  } else if (w.vec) {
    launch_pieces<G, true, SCALAR_BC, SNR, HEALTH, P, WRITE>(a, w, s);
  } else {
    launch_pieces<G, false, SCALAR_BC, SNR, HEALTH, P, WRITE>(a, w, s);
  }
}

template <typename G, bool SCALAR_BC, bool PARTIAL = false>
void launch_plan(const SlimArgs& a, int axis, const Walk& w, cudaStream_t s) {
  const bool snr = a.s1c != nullptr;
  const bool health = a.nf != nullptr;
  if (snr && health) {
    launch_plan_flags<G, SCALAR_BC, true, true, PARTIAL>(a, axis, w, s);
  } else if (snr) {
    launch_plan_flags<G, SCALAR_BC, true, false, PARTIAL>(a, axis, w, s);
  } else if (health) {
    launch_plan_flags<G, SCALAR_BC, false, true, PARTIAL>(a, axis, w, s);
  } else {
    launch_plan_flags<G, SCALAR_BC, false, false, PARTIAL>(a, axis, w, s);
  }
}

// Whether a plan's arguments describe a form this file has for the axis.
bool walk_ok(const Walk& w, int axis) {
  if (w.form == kFormRows) return w.nseg == 1;
  return w.form == (axis == 1 ? kFormSplit : kFormMajor) && w.nseg > 1 && w.seg > 0 && w.blocks > 0 &&
         w.part != nullptr;
}

// The combine's grid, sized by the caller: a warp a SPLIT line, a thread a
// MAJOR column, so it must reach every one of the view's lines.
bool combine_ok(const Walk& w, int axis, long long batch, long long rows, long long cols) {
  if (w.form == kFormRows) return true;
  const long long lines = batch * (axis == 1 ? rows : cols);
  return w.combine_blocks > 0 && w.combine_blocks * (w.form == kFormSplit ? kWarps : kThreads) >= lines;
}

// B7, the parameter-writing per-leaf form, on the plan's form: no flags,
// host-rounded bias corrections. ROWS takes float4 loads on contiguous
// lines when p and g are f32; SPLIT and MAJOR take four-element loads of
// any of the four dtype pairs where the plan says vec.
template <typename G, typename P>
void launch_write(const SlimArgs& a, int axis, const Walk& w, cudaStream_t s) {
  launch_plan_flags<G, true, false, false, false, P, true>(a, axis, w, s);
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
// for axis 1 and (batch, 1, cols) for axis 0. form, vec, seg, nseg and
// blocks are plan_slim's plan for this view; work holds (1 + 2 with_snr +
// 2 with_health) * lines * nseg doubles when nseg > 1 (else null). inv_n =
// 1/line length; omb1/omb2 = 1-b1/1-b2 rounded by the caller. The caller
// guarantees batch*rows < 2^31 (axis 1), batch < 65536 (axis 0) and
// blocks < 2^31. Returns the cudaError_t of the launches.
extern "C" int repro_mega_slim_update(const float* g, const float* m, const float* v, const float* bc1,
                                      const float* bc2, float* u, float* m_out, float* v_out, float* s1c,
                                      float* s2c, float* nf, float* ss, long long batch, long long rows,
                                      long long cols, int axis, int form, int vec, long long seg, long long nseg,
                                      long long blocks, double* work, float inv_n, float b1, float omb1, float b2,
                                      float omb2, float eps, void* stream) {
  const Walk w{form, vec != 0, seg, nseg, blocks, work};
  if (!flags_paired(s1c, s2c) || !flags_paired(nf, ss) || !walk_ok(w, axis)) return (int)cudaErrorInvalidValue;
  SlimArgs a{g, m, v, bc1, bc2, u, m_out, v_out, s1c, s2c, nf, ss, nullptr, nullptr, batch, rows, cols, inv_n, b1,
             omb1, b2, omb2, eps};
  launch_plan<float, false>(a, axis, w, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// Per-leaf form. As above, except: g is f32 (g_bf16 = 0) or bf16
// (g_bf16 = 1); bc1 and bc2 are one f32 each; with_health (health a (2,) f32
// output, else null) writes the per-line nf/ss into the caller's scratch
// lines nf_lines/ss_lines and then reduces them into health. vec: 16-byte
// loads of f32 g, 8-byte loads of four bf16 g.
extern "C" int repro_slim_precond(const void* g, int g_bf16, const float* m, const float* v, const float* bc1,
                                  const float* bc2, float* u, float* m_out, float* v_out, float* s1c, float* s2c,
                                  float* nf_lines, float* ss_lines, float* health, long long batch,
                                  long long rows, long long cols, int axis, int form, int vec, long long seg,
                                  long long nseg, long long blocks, double* work, float inv_n, float b1, float omb1,
                                  float b2, float omb2, float eps, void* stream) {
  const Walk w{form, vec != 0, seg, nseg, blocks, work};
  if (!flags_paired(s1c, s2c) || !flags_paired(nf_lines, ss_lines) || !flags_paired(nf_lines, health) ||
      !walk_ok(w, axis)) {
    return (int)cudaErrorInvalidValue;
  }
  SlimArgs a{g, m, v, bc1, bc2, u, m_out, v_out, s1c, s2c, nf_lines, ss_lines, nullptr, nullptr, batch, rows, cols,
             inv_n, b1, omb1, b2, omb2, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_bf16) {
    launch_plan<__nv_bfloat16, true>(a, axis, w, s);
  } else {
    launch_plan<float, true>(a, axis, w, s);
  }
  if (health != nullptr) reduce_health(a, axis, health, s);
  return (int)cudaGetLastError();
}

// Pass 1 of the psum pair, megaplan group form (B12). g, m, m_out:
// contiguous f32 (batch, rows, cols). part and the optional line outputs
// s1c, s2c, first (with_snr) and nf, ss (with_health; null when off):
// contiguous f32 lines, (batch, rows, 1) for axis 1 and (batch, 1, cols)
// for axis 0. part is the un-normalised line sum of g^2. form, vec, seg,
// nseg, blocks and work: plan_slim's plan and its workspace, as for
// repro_mega_slim_update (SPLIT and MAJOR are pass 1 with the m' write and
// the combine, on combine_blocks blocks: the plan's too). Grid limits as
// above.
extern "C" int repro_mega_slim_partial_stats(const float* g, const float* m, float* m_out, float* part, float* s1c,
                                             float* s2c, float* first, float* nf, float* ss, long long batch,
                                             long long rows, long long cols, int axis, int form, int vec,
                                             long long seg, long long nseg, long long blocks, double* work,
                                             long long combine_blocks, float b1, float omb1, void* stream) {
  const Walk w{form, vec != 0, seg, nseg, blocks, work, combine_blocks};
  if (!flags_paired(s1c, s2c) || !flags_paired(s1c, first) || !flags_paired(nf, ss) || !walk_ok(w, axis) ||
      !combine_ok(w, axis, batch, rows, cols)) {
    return (int)cudaErrorInvalidValue;
  }
  SlimArgs a{g, m, nullptr, nullptr, nullptr, nullptr, m_out, nullptr, s1c, s2c, nf, ss, part, first, batch, rows,
             cols, 0.f, b1, omb1, 0.f, 0.f, 0.f};
  launch_plan<float, false, true>(a, axis, w, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// Pass 1 of the psum pair, per-leaf form (B10). As the group form, on the
// same plan and kernels, except: g is f32 (g_bf16 = 0) or bf16 (g_bf16 =
// 1; vec: 8-byte loads of four bf16 g); with_health (health a (2,) f32
// output, else null) writes the per-line nf/ss into the caller's scratch
// lines nf_lines/ss_lines and then reduces them into health.
extern "C" int repro_slim_partial_stats(const void* g, int g_bf16, const float* m, float* m_out, float* part,
                                        float* s1c, float* s2c, float* first, float* nf_lines, float* ss_lines,
                                        float* health, long long batch, long long rows, long long cols, int axis,
                                        int form, int vec, long long seg, long long nseg, long long blocks,
                                        double* work, long long combine_blocks, float b1, float omb1,
                                        void* stream) {
  const Walk w{form, vec != 0, seg, nseg, blocks, work, combine_blocks};
  if (!flags_paired(s1c, s2c) || !flags_paired(s1c, first) || !flags_paired(nf_lines, ss_lines) ||
      !flags_paired(nf_lines, health) || !walk_ok(w, axis) || !combine_ok(w, axis, batch, rows, cols)) {
    return (int)cudaErrorInvalidValue;
  }
  SlimArgs a{g, m, nullptr, nullptr, nullptr, nullptr, m_out, nullptr, s1c, s2c, nf_lines, ss_lines, part, first,
             batch, rows, cols, 0.f, b1, omb1, 0.f, 0.f, 0.f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_bf16) {
    launch_plan<__nv_bfloat16, false, true>(a, axis, w, s);
  } else {
    launch_plan<float, false, true>(a, axis, w, s);
  }
  if (health != nullptr) reduce_health(a, axis, health, s);
  return (int)cudaGetLastError();
}

// Parameter-writing per-leaf form (SlimAdam that writes the parameters).
// Replaces repro/kernels/slim_update.py:74 slim_update_batched (kernel body
// _slim_kernel :56, pallas_call :103): the same walk as repro_slim_precond,
// whose pass 2 writes p' = p - lr*(u + wd*p) (rounded to p's dtype) where
// the precondition form writes u. Bound: bytes, p, g, m read and p', m'
// written (20 B per f32 element, 14 B with bf16 p and g), plus 8 B per line.
// p, p_out: (batch, rows, cols), f32 (p_bf16 = 0) or bf16 (p_bf16 = 1); g
// f32 or bf16 (g_bf16); m, m_out f32; v, v_out lines as in
// repro_slim_precond; form, vec, seg, nseg, blocks and work its plan (vec
// also needs p aligned for four-element loads). c1/c2: the bias corrections
// 1 - b^t, rounded in f32 by the caller (the count is a Python int in the
// JAX entry points).
extern "C" int repro_slim_update(const void* p, int p_bf16, const void* g, int g_bf16, const float* m,
                                 const float* v, void* p_out, float* m_out, float* v_out, long long batch,
                                 long long rows, long long cols, int axis, int form, int vec, long long seg,
                                 long long nseg, long long blocks, double* work, float inv_n, float lr, float wd,
                                 float c1, float c2, float b1, float omb1, float b2, float omb2, float eps,
                                 void* stream) {
  const Walk w{form, vec != 0, seg, nseg, blocks, work};
  if (!walk_ok(w, axis)) return (int)cudaErrorInvalidValue;
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
    launch_write<__nv_bfloat16, __nv_bfloat16>(a, axis, w, s);
  } else if (g_bf16) {
    launch_write<__nv_bfloat16, float>(a, axis, w, s);
  } else if (p_bf16) {
    launch_write<float, __nv_bfloat16>(a, axis, w, s);
  } else {
    launch_write<float, float>(a, axis, w, s);
  }
  return (int)cudaGetLastError();
}
