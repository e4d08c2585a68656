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
// Bound: bytes, 4 B per element read once, 12 B written per line (16 B with
// v0: the flag is a template parameter, so it costs the base form nothing).
// The differences v - v0 are rounded in f32 as the TPU kernel rounds them;
// the sums accumulate in f64, because lines reach 38.6 M elements (gpt_small's
// embed, K = both).
//
// The split walk meets the bound by cutting the work by bytes, not by line.
// A host-side planner (repro_torch/kernels/snr_stats.py plan_split) sizes a
// 1-D grid of 256-thread blocks, pieces of 64-256 KB sized for about 4
// blocks per SM where the view has the bytes, each block streaming one piece
// of the view, in one of three forms:
//   WARP   (axis 1, lines <= 4096 elements): a group of lanes per line, a
//          warp for lines of 128 float4s or more, fewer for shorter lines
//          so that each lane issues about kUnroll loads (8 lines a block at
//          32 lanes, up to 256), finished by shuffles within the group;
//   SPLIT  (axis 1, longer lines): a line cut into nseg segments, a block each;
//   MAJOR  (axis 0): a block covers 128 adjacent columns (one float4 per
//          lane, 512 B per row per warp) over a chunk of nseg rows, its 8
//          warps interleaving the rows; the chunks split the rows across
//          blocks, so a B = 1 view with few columns still fills the card.
// Every block that holds a piece of a line loads the line's v0 and shifts by
// it, so the pieces' (sum v, sum d, sum d^2) are shares of the same line sums
// and add without a rebase. A line in one piece (nseg == 1) is written
// directly; otherwise each piece writes its f64 shares to a workspace and a
// second launch of the same call sums each line's shares in a fixed order
// (no float atomics: a given input gives bit-identical outputs on every run).
// Loads are 16 B a thread, kUnroll in flight, through the streaming
// (evict-first) path since every byte is read once; views that are not
// 16-byte aligned or whose inner size is not a multiple of 4 take the same
// walk with 4-byte loads (32 columns a block in the major form).
//
// The PLAIN instantiation of the same walk replaces snr_stats.py:126
// snr_stats_batched (B8; body _snr_kernel :75, same launcher): per line
// s1 = sum v and s2 = sum v*v (v*v rounded in f32, as the TPU kernel
// squares; sums in f64), with no shift and no first entry. Bound: bytes,
// 4 B per element, 8 B per line. It takes plan_split's plan and the same
// fixed-order combine, with two sums in place of three.
#include "common.cuh"

namespace {

// ---- B5, B9 and B8: the split walk -------------------------------------------

// These match the planner's constants in repro_torch/kernels/snr_stats.py.
constexpr int kThreads = 256;  // every block of the split walk
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;     // loads in flight per thread
constexpr int kFormWarp = 0, kFormSplit = 1, kFormMajor = 2;

// What a walk sums per line: B5's centered sums (CENTERED), the same with
// the line's first entry (FIRST, B9), or B8's plain sums (PLAIN).
constexpr int kCentered = 0, kFirst = 1, kPlain = 2;

__device__ __forceinline__ float load(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float4 load(const float4* p) { return __ldcs(p); }

// One line's sums, or one piece's shares of them: CENTERED and FIRST
// (sum v, sum d, sum d^2) with d = v - v0 rounded in f32; PLAIN (sum v,
// sum v*v) with v*v rounded in f32. All in f64.
template <int KIND>
struct Sums {
  static constexpr int kCount = KIND == kPlain ? 2 : 3;
  double v[3] = {0.0, 0.0, 0.0};
  __device__ __forceinline__ void add(float e, float x0) {
    v[0] += (double)e;
    if constexpr (KIND == kPlain) {
      v[1] += (double)__fmul_rn(e, e);
    } else {
      const double d = (double)__fsub_rn(e, x0);
      v[1] += d;
      v[2] += d * d;
    }
  }
  __device__ __forceinline__ void add(const float4& e, float x0) {
    add(e.x, x0);
    add(e.y, x0);
    add(e.z, x0);
    add(e.w, x0);
  }
  // Sums over aligned groups of `group` lanes (a power of two <= 32): the
  // whole warp's sum at 32.
  __device__ __forceinline__ void group_reduce(int group = 32) {
    for (int off = group >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int j = 0; j < kCount; ++j) v[j] += __shfl_xor_sync(0xffffffffu, v[j], off);
    }
  }
};

// The line outputs (kCount sums of a Sums, and FIRST's v0).
struct Outs {
  float* s[3];
  float* first;
};

// The shift of a line whose first entry is at p (PLAIN has none).
template <int KIND, typename T>
__device__ __forceinline__ T shift_at(const float* p) {
  if constexpr (KIND == kPlain) {
    return T{};
  } else {
    return *reinterpret_cast<const T*>(p);
  }
}

// Adds x[i] for i = t, t + step, ... < n (T: float or float4), kUnroll loads
// issued before their sums.
template <typename T, int KIND>
__device__ __forceinline__ void walk(const T* __restrict__ x, long long n, int t, int step, float x0,
                                     Sums<KIND>& s) {
  long long i = t;
  for (; i + (long long)(kUnroll - 1) * step < n; i += (long long)kUnroll * step) {
    T e[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) e[u] = load(x + i + (long long)u * step);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) s.add(e[u], x0);
  }
  for (; i < n; i += step) s.add(load(x + i), x0);
}

// Where one piece's sums go: the line's outputs when the line is one piece,
// else share k of the line's nseg in the workspace (kCount planes of np =
// lines * nseg doubles). The first piece also writes v0 (FIRST).
template <int KIND>
__device__ __forceinline__ void emit(const Sums<KIND>& s, float x0, long long line, long long k, long long nseg,
                                     long long np, double* part, const Outs& o) {
  if (nseg == 1) {
#pragma unroll
    for (int j = 0; j < Sums<KIND>::kCount; ++j) o.s[j][line] = (float)s.v[j];
  } else {
#pragma unroll
    for (int j = 0; j < Sums<KIND>::kCount; ++j) part[j * np + line * nseg + k] = s.v[j];
  }
  if (KIND == kFirst && k == 0) o.first[line] = x0;
}

// WARP: lines of `cols` contiguous elements, `group` lanes per line (32 /
// group lines a warp; short lines take fewer lanes, so every lane loads).
template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads)
    snr_warp_lines(const float* __restrict__ v, Outs o, long long lines, long long cols, int group) {
  const int lane = threadIdx.x & 31;
  const long long line = ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * (32 / group) + lane / group;
  const bool live = line < lines;  // no early exit: the whole warp shuffles
  const float* x = v + line * cols;
  const float x0 = live ? shift_at<KIND, float>(x) : 0.f;
  Sums<KIND> s;
  if (live) {
    walk(reinterpret_cast<const T*>(x), cols / (long long)(sizeof(T) / sizeof(float)), lane % group, group, x0, s);
  }
  s.group_reduce(group);
  if (live && lane % group == 0) emit(s, x0, line, 0, 1, 0, nullptr, o);
}

// Thread 0 gets the block's total, summed over the warps in a fixed order.
template <int KIND>
__device__ __forceinline__ Sums<KIND> block_total(Sums<KIND> s, double (*smem)[kWarps]) {
  s.group_reduce();
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int j = 0; j < Sums<KIND>::kCount; ++j) smem[j][warp] = s.v[j];
  }
  __syncthreads();
  Sums<KIND> t;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarps; ++w) {
#pragma unroll
      for (int j = 0; j < Sums<KIND>::kCount; ++j) t.v[j] += smem[j][w];
    }
  }
  return t;
}

// SPLIT: block b holds segment b % nseg (elements [k*seg, k*seg + seg) of
// the line, the last one shorter) of line b / nseg. seg is a multiple of
// 1024, so the vector form's segments start 16-byte aligned.
template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads)
    snr_split_lines(const float* __restrict__ v, Outs o, long long cols, long long seg, long long nseg, long long np,
                    double* part) {
  __shared__ double smem[Sums<KIND>::kCount][kWarps];
  const long long line = (long long)blockIdx.x / nseg;
  const long long k = (long long)blockIdx.x % nseg;
  const float* x = v + line * cols;
  const float x0 = shift_at<KIND, float>(x);
  const long long begin = k * seg;
  const long long len = min(seg, cols - begin);
  constexpr long long kPer = sizeof(T) / sizeof(float);
  Sums<KIND> s;
  walk(reinterpret_cast<const T*>(x + begin), len / kPer, threadIdx.x, kThreads, x0, s);
  s = block_total(s, smem);
  if (threadIdx.x == 0) emit(s, x0, line, k, nseg, np, part, o);
}

template <int KIND>
__device__ __forceinline__ void add_columns(Sums<KIND>* s, float e, float x0) {
  s[0].add(e, x0);
}
template <int KIND>
__device__ __forceinline__ void add_columns(Sums<KIND>* s, const float4& e, const float4& x0) {
  s[0].add(e.x, x0.x);
  s[1].add(e.y, x0.y);
  s[2].add(e.z, x0.z);
  s[3].add(e.w, x0.w);
}

// MAJOR: block b holds row chunk k = b % nseg (rows [k*seg, k*seg + seg),
// seg a multiple of kWarps) of column tile b / nseg: batch entry tile /
// ctiles, columns from (tile % ctiles) * kTile. Lane l of each warp owns the
// kPer columns from l * kPer; warp w takes rows k*seg + w, + kWarps, ...;
// the warps' sums meet in shared memory and are added in warp order.
template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads)
    snr_major_columns(const float* __restrict__ v, Outs o, long long rows, long long cols, long long ctiles,
                      long long seg, long long nseg, long long np, double* part) {
  constexpr int kPer = sizeof(T) / sizeof(float);
  constexpr int kTile = 32 * kPer;
  constexpr int kCount = Sums<KIND>::kCount;
  __shared__ double smem[kCount][kWarps][kTile];
  const long long k = (long long)blockIdx.x % nseg;
  const long long tile = (long long)blockIdx.x / nseg;
  const long long b = tile / ctiles;
  const long long c0 = (tile % ctiles) * kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long c = c0 + (long long)lane * kPer;
  const float* x = v + b * rows * cols;
  Sums<KIND> s[kPer];
  if (c < cols) {  // the vector form has cols % 4 == 0: a lane's columns are all live or none
    const T x0 = shift_at<KIND, T>(x + c);
    const long long r_end = min(rows, (k + 1) * seg);
    long long r = k * seg + warp;
    for (; r + (long long)(kUnroll - 1) * kWarps < r_end; r += (long long)kUnroll * kWarps) {
      T e[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) e[u] = load(reinterpret_cast<const T*>(x + (r + u * kWarps) * cols + c));
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) add_columns(s, e[u], x0);
    }
    for (; r < r_end; r += kWarps) add_columns(s, load(reinterpret_cast<const T*>(x + r * cols + c)), x0);
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
#pragma unroll
    for (int q = 0; q < kCount; ++q) smem[q][warp][lane * kPer + j] = s[j].v[q];
  }
  __syncthreads();
  const long long cc = c0 + threadIdx.x;
  if (threadIdx.x < kTile && cc < cols) {
    Sums<KIND> t;
    for (int w = 0; w < kWarps; ++w) {
#pragma unroll
      for (int q = 0; q < kCount; ++q) t.v[q] += smem[q][w][threadIdx.x];
    }
    emit(t, shift_at<KIND, float>(x + cc), b * cols + cc, k, nseg, np, part, o);
  }
}

// Each line's nseg workspace shares, summed in a fixed order: a warp per
// line, lane l adding shares l, l + 32, ... in turn, then the shuffle tree.
template <int KIND>
__global__ void __launch_bounds__(kThreads)
    snr_combine(const double* __restrict__ part, long long lines, long long nseg, Outs o) {
  const long long line = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (line >= lines) return;
  const int lane = threadIdx.x & 31;
  const long long np = lines * nseg;
  const double* p = part + line * nseg;
  Sums<KIND> s;
  for (long long k = lane; k < nseg; k += 32) {
#pragma unroll
    for (int j = 0; j < Sums<KIND>::kCount; ++j) s.v[j] += p[j * np + k];
  }
  s.group_reduce();
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < Sums<KIND>::kCount; ++j) o.s[j][line] = (float)s.v[j];
  }
}

template <typename T, int KIND>
int launch_walk(const float* v, const Outs& o, double* part, long long batch, long long rows, long long cols,
                int form, int group, long long seg, long long nseg, long long blocks, long long combine_blocks,
                cudaStream_t s) {
  constexpr long long kTile = 32 * (sizeof(T) / sizeof(float));
  const long long lines = form == kFormMajor ? batch * cols : batch * rows;
  const long long np = lines * nseg;
  // the combine, a warp a line, must reach every line
  if (blocks < 1 || (nseg > 1 && combine_blocks * kWarps < lines)) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)blocks;
  if (form == kFormWarp) {
    snr_warp_lines<T, KIND><<<grid, kThreads, 0, s>>>(v, o, lines, cols, group);
  } else if (form == kFormSplit) {
    snr_split_lines<T, KIND><<<grid, kThreads, 0, s>>>(v, o, cols, seg, nseg, np, part);
  } else {
    snr_major_columns<T, KIND><<<grid, kThreads, 0, s>>>(v, o, rows, cols, (cols + kTile - 1) / kTile, seg, nseg,
                                                         np, part);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nseg == 1) return (int)err;
  snr_combine<KIND><<<(unsigned)combine_blocks, kThreads, 0, s>>>(part, lines, nseg, o);
  return (int)cudaGetLastError();
}

template <int KIND>
int launch_split(bool vec, const float* v, const Outs& o, double* part, long long batch, long long rows,
                 long long cols, int form, int group, long long seg, long long nseg, long long blocks,
                 long long combine_blocks, cudaStream_t s) {
  if (vec) {
    return launch_walk<float4, KIND>(v, o, part, batch, rows, cols, form, group, seg, nseg, blocks, combine_blocks,
                                     s);
  }
  return launch_walk<float, KIND>(v, o, part, batch, rows, cols, form, group, seg, nseg, blocks, combine_blocks, s);
}

}  // namespace

// B5 (first == null) and B9 (first: the v0 output). v: contiguous f32
// (batch, rows, cols); s1, s1c, s2c and first: contiguous f32 (batch, kept),
// kept = rows for the WARP and SPLIT forms (axis 1) and cols for MAJOR
// (axis 0). form, vec, group, seg, nseg, blocks and combine_blocks are
// plan_split's plan for this view; part holds 3 * lines * nseg doubles when
// nseg > 1 (else null). Returns the cudaError_t of the launches.
extern "C" int repro_snr_stats_centered(const float* v, float* s1, float* s1c, float* s2c, float* first,
                                        double* part, long long batch, long long rows, long long cols, int form,
                                        int vec, int group, long long seg, long long nseg, long long blocks,
                                        long long combine_blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Outs o{{s1, s1c, s2c}, first};
  if (first != nullptr) {
    return launch_split<kFirst>(vec != 0, v, o, part, batch, rows, cols, form, group, seg, nseg, blocks,
                                combine_blocks, s);
  }
  return launch_split<kCentered>(vec != 0, v, o, part, batch, rows, cols, form, group, seg, nseg, blocks,
                                 combine_blocks, s);
}

// The plain line sums (B8): v and the plan as above; s1 and s2 (sum v*v):
// contiguous f32 (batch, kept); part holds 2 * lines * nseg doubles when
// nseg > 1 (else null). Returns the cudaError_t of the launches.
extern "C" int repro_snr_stats(const float* v, float* s1, float* s2, double* part, long long batch, long long rows,
                               long long cols, int form, int vec, int group, long long seg, long long nseg,
                               long long blocks, long long combine_blocks, void* stream) {
  const Outs o{{s1, s2, nullptr}, nullptr};
  return launch_split<kPlain>(vec != 0, v, o, part, batch, rows, cols, form, group, seg, nseg, blocks,
                              combine_blocks, static_cast<cudaStream_t>(stream));
}
