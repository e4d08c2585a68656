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
//   WARP   (axis 1, lines <= 4096 elements): a warp per line, 8 lines a block,
//          finished by warp shuffles;
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
// The PLAIN kernels replace snr_stats.py:126 snr_stats_batched (B8; body
// _snr_kernel :75, same launcher): per line s1 = sum v and s2 = sum v*v (v*v
// rounded in f32, as the TPU kernel squares; sums in f64), with no shift and
// no first entry. Bound: bytes, 4 B per element, 8 B per line. They keep the
// one-block-per-line walk (a strip of kStrip columns per block for axis 0).
#include "common.cuh"

namespace {

using repro_torch::block_sum;
using repro_torch::kRowThreads;
using repro_torch::kStrip;
using repro_torch::warp_sum;

// ---- B5 and B9: the split walk ----------------------------------------------

// These match the planner's constants in repro_torch/kernels/snr_stats.py.
constexpr int kThreads = 256;  // every block of the split walk
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;     // loads in flight per thread
constexpr int kFormWarp = 0, kFormSplit = 1, kFormMajor = 2;

__device__ __forceinline__ float load(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float4 load(const float4* p) { return __ldcs(p); }

// One line's three sums, or one piece's shares of them.
struct Sums {
  double s1 = 0.0, s1c = 0.0, s2c = 0.0;
  __device__ __forceinline__ void add(float e, float x0) {
    s1 += (double)e;
    const double d = (double)__fsub_rn(e, x0);
    s1c += d;
    s2c += d * d;
  }
  __device__ __forceinline__ void add(const float4& e, float x0) {
    add(e.x, x0);
    add(e.y, x0);
    add(e.z, x0);
    add(e.w, x0);
  }
  __device__ __forceinline__ void warp_reduce() {
    s1 = warp_sum(s1);
    s1c = warp_sum(s1c);
    s2c = warp_sum(s2c);
  }
};

// Adds x[i] for i = t, t + step, ... < n (T: float or float4), kUnroll loads
// issued before their sums.
template <typename T>
__device__ __forceinline__ void walk(const T* __restrict__ x, long long n, int t, int step, float x0, Sums& s) {
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
// else share k of the line's nseg in the workspace (three planes of np =
// lines * nseg doubles). The first piece also writes v0 (FIRST).
template <bool FIRST>
__device__ __forceinline__ void emit(const Sums& s, float x0, long long line, long long k, long long nseg,
                                     long long np, double* part, float* s1, float* s1c, float* s2c, float* first) {
  if (nseg == 1) {
    s1[line] = (float)s.s1;
    s1c[line] = (float)s.s1c;
    s2c[line] = (float)s.s2c;
  } else {
    const long long i = line * nseg + k;
    part[i] = s.s1;
    part[np + i] = s.s1c;
    part[2 * np + i] = s.s2c;
  }
  if (FIRST && k == 0) first[line] = x0;
}

// WARP: lines of `cols` contiguous elements, a warp per line.
template <typename T, bool FIRST>
__global__ void __launch_bounds__(kThreads)
    snr_warp_lines(const float* __restrict__ v, float* s1, float* s1c, float* s2c, float* first, long long lines,
                   long long cols) {
  const long long line = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (line >= lines) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const float* x = v + line * cols;
  const float x0 = x[0];
  Sums s;
  walk(reinterpret_cast<const T*>(x), cols / (long long)(sizeof(T) / sizeof(float)), lane, 32, x0, s);
  s.warp_reduce();
  if (lane == 0) emit<FIRST>(s, x0, line, 0, 1, 0, nullptr, s1, s1c, s2c, first);
}

// Thread 0 gets the block's total, summed over the warps in a fixed order.
__device__ __forceinline__ Sums block_total(Sums s, double (*smem)[kWarps]) {
  s.warp_reduce();
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    smem[0][warp] = s.s1;
    smem[1][warp] = s.s1c;
    smem[2][warp] = s.s2c;
  }
  __syncthreads();
  Sums t;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarps; ++w) {
      t.s1 += smem[0][w];
      t.s1c += smem[1][w];
      t.s2c += smem[2][w];
    }
  }
  return t;
}

// SPLIT: block b holds segment b % nseg (elements [k*seg, k*seg + seg) of
// the line, the last one shorter) of line b / nseg. seg is a multiple of
// 1024, so the vector form's segments start 16-byte aligned.
template <typename T, bool FIRST>
__global__ void __launch_bounds__(kThreads)
    snr_split_lines(const float* __restrict__ v, float* s1, float* s1c, float* s2c, float* first, long long cols,
                    long long seg, long long nseg, long long np, double* part) {
  __shared__ double smem[3][kWarps];
  const long long line = (long long)blockIdx.x / nseg;
  const long long k = (long long)blockIdx.x % nseg;
  const float* x = v + line * cols;
  const float x0 = x[0];
  const long long begin = k * seg;
  const long long len = min(seg, cols - begin);
  constexpr long long kPer = sizeof(T) / sizeof(float);
  Sums s;
  walk(reinterpret_cast<const T*>(x + begin), len / kPer, threadIdx.x, kThreads, x0, s);
  s = block_total(s, smem);
  if (threadIdx.x == 0) emit<FIRST>(s, x0, line, k, nseg, np, part, s1, s1c, s2c, first);
}

__device__ __forceinline__ void add_columns(Sums* s, float e, float x0) { s[0].add(e, x0); }
__device__ __forceinline__ void add_columns(Sums* s, const float4& e, const float4& x0) {
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
template <typename T, bool FIRST>
__global__ void __launch_bounds__(kThreads)
    snr_major_columns(const float* __restrict__ v, float* s1, float* s1c, float* s2c, float* first, long long rows,
                      long long cols, long long ctiles, long long seg, long long nseg, long long np, double* part) {
  constexpr int kPer = sizeof(T) / sizeof(float);
  constexpr int kTile = 32 * kPer;
  __shared__ double smem[3][kWarps][kTile];
  const long long k = (long long)blockIdx.x % nseg;
  const long long tile = (long long)blockIdx.x / nseg;
  const long long b = tile / ctiles;
  const long long c0 = (tile % ctiles) * kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long c = c0 + (long long)lane * kPer;
  const float* x = v + b * rows * cols;
  Sums s[kPer];
  if (c < cols) {  // the vector form has cols % 4 == 0: a lane's columns are all live or none
    const T x0 = *reinterpret_cast<const T*>(x + c);
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
    smem[0][warp][lane * kPer + j] = s[j].s1;
    smem[1][warp][lane * kPer + j] = s[j].s1c;
    smem[2][warp][lane * kPer + j] = s[j].s2c;
  }
  __syncthreads();
  const long long cc = c0 + threadIdx.x;
  if (threadIdx.x < kTile && cc < cols) {
    Sums t;
    for (int w = 0; w < kWarps; ++w) {
      t.s1 += smem[0][w][threadIdx.x];
      t.s1c += smem[1][w][threadIdx.x];
      t.s2c += smem[2][w][threadIdx.x];
    }
    emit<FIRST>(t, x[cc], b * cols + cc, k, nseg, np, part, s1, s1c, s2c, first);
  }
}

// Each line's nseg workspace shares, summed in a fixed order: a warp per
// line, lane l adding shares l, l + 32, ... in turn, then the shuffle tree.
__global__ void __launch_bounds__(kThreads)
    snr_combine(const double* __restrict__ part, long long lines, long long nseg, float* s1, float* s1c,
                float* s2c) {
  const long long line = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (line >= lines) return;
  const int lane = threadIdx.x & 31;
  const long long np = lines * nseg;
  const double* p = part + line * nseg;
  Sums s;
  for (long long k = lane; k < nseg; k += 32) {
    s.s1 += p[k];
    s.s1c += p[np + k];
    s.s2c += p[2 * np + k];
  }
  s.warp_reduce();
  if (lane == 0) {
    s1[line] = (float)s.s1;
    s1c[line] = (float)s.s1c;
    s2c[line] = (float)s.s2c;
  }
}

template <typename T, bool FIRST>
int launch_walk(const float* v, float* s1, float* s1c, float* s2c, float* first, double* part, long long batch,
                 long long rows, long long cols, int form, long long seg, long long nseg, long long blocks,
                 cudaStream_t s) {
  constexpr long long kTile = 32 * (sizeof(T) / sizeof(float));
  const long long lines = form == kFormMajor ? batch * cols : batch * rows;
  const long long np = lines * nseg;
  const unsigned grid = (unsigned)blocks;
  if (form == kFormWarp) {
    snr_warp_lines<T, FIRST><<<grid, kThreads, 0, s>>>(v, s1, s1c, s2c, first, lines, cols);
  } else if (form == kFormSplit) {
    snr_split_lines<T, FIRST><<<grid, kThreads, 0, s>>>(v, s1, s1c, s2c, first, cols, seg, nseg, np, part);
  } else {
    snr_major_columns<T, FIRST><<<grid, kThreads, 0, s>>>(v, s1, s1c, s2c, first, rows, cols,
                                                          (cols + kTile - 1) / kTile, seg, nseg, np, part);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nseg == 1) return (int)err;
  snr_combine<<<(unsigned)((lines + kWarps - 1) / kWarps), kThreads, 0, s>>>(part, lines, nseg, s1, s1c, s2c);
  return (int)cudaGetLastError();
}

template <bool FIRST>
int launch_split(bool vec, const float* v, float* s1, float* s1c, float* s2c, float* first, double* part,
                 long long batch, long long rows, long long cols, int form, long long seg, long long nseg,
                 long long blocks, cudaStream_t s) {
  if (vec) {
    return launch_walk<float4, FIRST>(v, s1, s1c, s2c, first, part, batch, rows, cols, form, seg, nseg, blocks, s);
  }
  return launch_walk<float, FIRST>(v, s1, s1c, s2c, first, part, batch, rows, cols, form, seg, nseg, blocks, s);
}

// ---- B8: the plain line sums ------------------------------------------------

template <bool VEC>
__global__ void snr_plain_minor_kernel(const float* __restrict__ v, float* s1, float* s2, long long cols) {
  __shared__ double smem[32];
  const long long line = blockIdx.x;
  const float* x = v + line * cols;
  double a1 = 0.0, a2 = 0.0;
  if (VEC) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    for (long long j = threadIdx.x; j < cols / 4; j += blockDim.x) {
      const float4 e = x4[j];
      a1 += (double)e.x + (double)e.y + (double)e.z + (double)e.w;
      a2 += (double)__fmul_rn(e.x, e.x) + (double)__fmul_rn(e.y, e.y) + (double)__fmul_rn(e.z, e.z) +
            (double)__fmul_rn(e.w, e.w);
    }
  } else {
    for (long long j = threadIdx.x; j < cols; j += blockDim.x) {
      const float e = x[j];
      a1 += (double)e;
      a2 += (double)__fmul_rn(e, e);
    }
  }
  a1 = block_sum(a1, smem);
  a2 = block_sum(a2, smem);
  if (threadIdx.x == 0) {
    s1[line] = (float)a1;
    s2[line] = (float)a2;
  }
}

__global__ void snr_plain_major_kernel(const float* __restrict__ v, float* s1, float* s2, long long rows,
                                       long long cols) {
  __shared__ double part[2][kRowThreads][kStrip + 1];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const long long c = (long long)blockIdx.x * kStrip + tx;
  const long long b = blockIdx.y;
  const bool live = c < cols;
  const float* x = v + b * rows * cols;
  double a1 = 0.0, a2 = 0.0;
  if (live) {
    for (long long r = ty; r < rows; r += kRowThreads) {
      const float e = x[r * cols + c];
      a1 += (double)e;
      a2 += (double)__fmul_rn(e, e);
    }
  }
  part[0][ty][tx] = a1;
  part[1][ty][tx] = a2;
  __syncthreads();
  if (ty == 0 && live) {
    double t1 = 0.0, t2 = 0.0;
    for (int k = 0; k < kRowThreads; ++k) {
      t1 += part[0][k][tx];
      t2 += part[1][k][tx];
    }
    const long long li = b * cols + c;
    s1[li] = (float)t1;
    s2[li] = (float)t2;
  }
}

}  // namespace

// B5 (first == null) and B9 (first: the v0 output). v: contiguous f32
// (batch, rows, cols); s1, s1c, s2c and first: contiguous f32 (batch, kept),
// kept = rows for the WARP and SPLIT forms (axis 1) and cols for MAJOR
// (axis 0). form, vec, seg, nseg and blocks are plan_split's plan for this
// view; part holds 3 * lines * nseg doubles when nseg > 1 (else null).
// Returns the cudaError_t of the launches.
extern "C" int repro_snr_stats_centered(const float* v, float* s1, float* s1c, float* s2c, float* first,
                                        double* part, long long batch, long long rows, long long cols, int form,
                                        int vec, long long seg, long long nseg, long long blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (first != nullptr) {
    return launch_split<true>(vec != 0, v, s1, s1c, s2c, first, part, batch, rows, cols, form, seg, nseg, blocks, s);
  }
  return launch_split<false>(vec != 0, v, s1, s1c, s2c, first, part, batch, rows, cols, form, seg, nseg, blocks, s);
}

// The plain line sums (B8): v as above; s1 and s2 (sum v*v): contiguous f32
// (batch, kept). The caller guarantees batch*rows < 2^31 (axis 1) and batch
// < 65536 (axis 0). Returns the cudaError_t of the launch.
extern "C" int repro_snr_stats(const float* v, float* s1, float* s2, long long batch, long long rows, long long cols,
                               int axis, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (axis == 1) {
    const bool vec = cols % 4 == 0 && repro_torch::aligned16(v);
    const long long work = vec ? cols / 4 : cols;
    long long threads = ((work + 31) / 32) * 32;
    if (threads > 1024) threads = 1024;
    if (threads < 32) threads = 32;
    const unsigned lines = (unsigned)(batch * rows);
    if (vec) {
      snr_plain_minor_kernel<true><<<lines, (unsigned)threads, 0, s>>>(v, s1, s2, cols);
    } else {
      snr_plain_minor_kernel<false><<<lines, (unsigned)threads, 0, s>>>(v, s1, s2, cols);
    }
  } else {
    dim3 grid((unsigned)((cols + kStrip - 1) / kStrip), (unsigned)batch);
    dim3 block(kStrip, kRowThreads);
    snr_plain_major_kernel<<<grid, block, 0, s>>>(v, s1, s2, rows, cols);
  }
  return (int)cudaGetLastError();
}
