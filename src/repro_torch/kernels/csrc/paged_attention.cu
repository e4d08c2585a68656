// Ragged paged attention over a fused K/V page pool (decode and chunked
// prefill).
//
// Replaces repro/kernels/paged_attention.py:143 paged_attention (kernel body
// _paged_kernel :70, pallas_call :172). For row b with L = lengths[b] live
// positions, query i of the C-token chunk sits at q_abs = L - C + i and
// attends every key k_abs <= q_abs among the first max_pages * page
// positions of the row's page list; a query with no such key returns 0. K of
// group g lives on head row 2g of pool[page][pos], V on row 2g + 1, so one
// position's K and V for a group are 2 * hd contiguous elements. Query head h
// reads group h / rep.
//
// Bound: bytes. Each live K/V row is read once (4 flops per K/V element pair
// of a query, ~2 flops per byte at bf16 for decode), far below the card's
// operations-per-byte balance, so the design spends nothing to save flops:
// - one block per (batch row, KV group, tile of query tokens); the TPU
//   kernel's sequential page axis becomes a loop inside the block, so the
//   running max, denominator and accumulator stay in registers and shared
//   memory instead of round-tripping through device memory;
// - the block walks the row's positions in tiles of KEYS keys, reading each
//   position's page id from the table and staging K and V in shared memory
//   as f32. The next tile's 16-byte loads are issued into registers before
//   the current tile is computed, so the load latency overlaps the compute;
// - a block holds ROWS query rows (tokens x heads of its group), so each
//   staged K/V tile serves every query head of the group (GQA reuse). Each
//   thread's score and value loops are unrolled over its share of the ROWS
//   slots, live or not, so ROWS is compile-time and small: 4 where a block
//   needs no more (decode with rep <= 4), 8 for rep <= 8, else 32. Small
//   blocks also make more of them: a 128-token prefill chunk of smollm
//   (rep 3) runs 192 blocks of 2 tokens, not 39 of 10;
// - scores, online softmax and the value product run in f32. Masked scores
//   are -inf and their exponentials exactly 0, so a fully masked tile adds
//   nothing, and the output is acc / max(l, 1e-30) as in the JAX wrapper.
// Page ids outside [0, n_pages) read the null page 0 instead of memory
// outside the pool; the table walk stops at max_pages, so a prefill whose
// padded length passes the row's pages never reads past the table.
// This first kernel uses neither TMA nor wgmma, and splits no row's keys
// across blocks, so a decode step runs only B * KV blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;          // query rows (tokens x heads of a group) per block, at most
constexpr float kNegInit = -1e30f; // running-max start, as the TPU kernel's NEG_INF

struct Params {
  const void* q;
  const void* pool;
  const int* table;
  const int* lengths;
  void* out;
  int chunk, heads, kv, rep, page, max_pages, n_pages, tq, n_qtiles;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

// 16 bytes of T -> 16 / sizeof(T) floats.
__device__ __forceinline__ void unpack(const uint4& u, float* f, float) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float* f, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Keys per tile: the staged tile is at most 16 KB (128 bytes, eight 16-byte
// registers, per thread), and at most 64 keys.
template <typename PT, int HD>
constexpr int keys_per_tile() {
  return (16384 / (2 * HD * (int)sizeof(PT))) < 64 ? 16384 / (2 * HD * (int)sizeof(PT)) : 64;
}

template <int HD, int KEYS, int ROWS>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)ROWS * HD + (size_t)KEYS * (HD + 1) + (size_t)KEYS * HD
                          + (size_t)ROWS * (KEYS + 1) + 3 * ROWS);
}

template <typename QT, typename PT, int HD, int KEYS, int ROWS>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(Params p) {
  constexpr int KS = HD + 1;            // padded K row: lanes of a warp read 32 different keys
  constexpr int PS = KEYS + 1;          // padded score row
  constexpr int VEC = 16 / sizeof(PT);  // elements per 16-byte load
  constexpr int VPR = 2 * HD / VEC;     // 16-byte loads per position (K row then V row)
  constexpr int NV = (KEYS * VPR + kThreads - 1) / kThreads;
  constexpr int SSTEP = kThreads / KEYS;  // score phase: thread owns key tid % KEYS, rows tid / KEYS + k * SSTEP
  constexpr int NS = (ROWS + SSTEP - 1) / SSTEP;
  constexpr int RSTEP = kThreads / HD;    // value phase: thread owns column tid % HD, rows tid / HD + k * RSTEP
  constexpr int NACC = (ROWS + RSTEP - 1) / RSTEP;
  static_assert(kThreads % KEYS == 0 && kThreads % HD == 0 && HD % VEC == 0, "tile geometry");

  extern __shared__ float smem[];
  float* qs = smem;                   // [ROWS][HD], pre-scaled by 1/sqrt(hd)
  float* ks = qs + ROWS * HD;         // [KEYS][KS]
  float* vs = ks + KEYS * KS;         // [KEYS][HD]
  float* ps = vs + KEYS * HD;         // [ROWS][PS] scores, then probabilities
  float* row_m = ps + ROWS * PS;      // running max
  float* row_l = row_m + ROWS;        // running denominator
  float* row_c = row_l + ROWS;        // this tile's rescale factor

  const int tid = threadIdx.x;
  const int b = blockIdx.x / p.n_qtiles;
  const int c0 = (blockIdx.x % p.n_qtiles) * p.tq;
  const int g = blockIdx.y;
  const int n_tok = min(p.tq, p.chunk - c0);
  const int n_rows = n_tok * p.rep;
  const int q_first = p.lengths[b] - p.chunk + c0;  // absolute position of the block's first query
  // Keys any of the block's queries may see: k_abs <= q_first + n_tok - 1,
  // and no further than the table reaches.
  long long kend = (long long)q_first + n_tok;
  const long long reach = (long long)p.max_pages * p.page;
  kend = kend > reach ? reach : kend;
  const int n_keys = kend > 0 ? (int)kend : 0;
  const int n_tiles = (n_keys + KEYS - 1) / KEYS;

  // Query rows r = t * rep + i: token c0 + t, head g * rep + i.
  const QT* q = static_cast<const QT*>(p.q);
  for (int e = tid; e < n_rows * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    const long long off = (((long long)b * p.chunk + c0 + r / p.rep) * p.heads + g * p.rep + r % p.rep) * HD + d;
    qs[r * HD + d] = to_f32(q[off]) * p.scale;
  }
  if (tid < ROWS) {
    row_m[tid] = kNegInit;
    row_l[tid] = 0.f;
  }

  const PT* pool = static_cast<const PT*>(p.pool);
  const int* trow = p.table + (long long)b * p.max_pages;
  uint4 stage[NV];
  auto load_tile = [&](int tile) {
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int e = tid + n * kThreads;
      const int kabs = tile * KEYS + e / VPR;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (e < KEYS * VPR && kabs < n_keys) {
        int pg = trow[kabs / p.page];
        pg = (pg < 0 || pg >= p.n_pages) ? 0 : pg;
        const PT* row = pool + (((long long)pg * p.page + kabs % p.page) * 2 * p.kv + 2 * g) * HD;
        val = reinterpret_cast<const uint4*>(row)[e % VPR];
      }
      stage[n] = val;
    }
  };

  const int j_own = tid % KEYS, s_own = tid / KEYS;
  const int d_own = tid % HD, r_own = tid / HD;
  const int my_ns = n_rows > s_own ? (n_rows - s_own + SSTEP - 1) / SSTEP : 0;
  const int my_nacc = n_rows > r_own ? (n_rows - r_own + RSTEP - 1) / RSTEP : 0;
  float acc[NACC];
#pragma unroll
  for (int k = 0; k < NACC; ++k) acc[k] = 0.f;

  if (n_tiles > 0) load_tile(0);
  __syncthreads();
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * KEYS;
    // Stage the loaded tile as f32 (the previous tile's readers are done).
    __syncthreads();
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int e = tid + n * kThreads;
      if (e < KEYS * VPR) {
        const int j = e / VPR, col = (e % VPR) * VEC;
        float f[VEC];
        unpack(stage[n], f, PT());
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          if (col < HD) ks[j * KS + col + i] = f[i];
          else vs[j * HD + col - HD + i] = f[i];
        }
      }
    }
    __syncthreads();
    if (tile + 1 < n_tiles) load_tile(tile + 1);  // in flight during this tile's compute

    // Scores of the thread's key against its rows; -inf where masked.
    {
      float s[NS];
#pragma unroll
      for (int k = 0; k < NS; ++k) s[k] = 0.f;
      for (int d = 0; d < HD; ++d) {
        const float kd = ks[j_own * KS + d];
#pragma unroll
        for (int k = 0; k < NS; ++k)
          if (k < my_ns) s[k] += qs[(s_own + k * SSTEP) * HD + d] * kd;
      }
      const int kabs = k0 + j_own;
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        if (k < my_ns) {
          const int r = s_own + k * SSTEP;
          const bool live = kabs < n_keys && kabs <= q_first + r / p.rep;
          ps[r * PS + j_own] = live ? s[k] : -INFINITY;
        }
      }
    }
    __syncthreads();

    // Online softmax, one warp per row.
    {
      const int lane = tid & 31;
      for (int r = tid >> 5; r < n_rows; r += kWarps) {
        float mx = -INFINITY;
        for (int j = lane; j < KEYS; j += 32) mx = fmaxf(mx, ps[r * PS + j]);
        mx = warp_max(mx);
        const float m_old = row_m[r];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.f;
        for (int j = lane; j < KEYS; j += 32) {
          const float e = expf(ps[r * PS + j] - m_new);
          ps[r * PS + j] = e;
          sum += e;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float corr = expf(m_old - m_new);
          row_c[r] = corr;
          row_l[r] = row_l[r] * corr + sum;
          row_m[r] = m_new;
        }
      }
    }
    __syncthreads();

    // acc = acc * corr + P V over this tile's live keys.
    const int tile_keys = min(KEYS, n_keys - k0);
#pragma unroll
    for (int k = 0; k < NACC; ++k)
      if (k < my_nacc) acc[k] *= row_c[r_own + k * RSTEP];
    for (int j = 0; j < tile_keys; ++j) {
      const float v = vs[j * HD + d_own];
#pragma unroll
      for (int k = 0; k < NACC; ++k)
        if (k < my_nacc) acc[k] += ps[(r_own + k * RSTEP) * PS + j] * v;
    }
  }

  QT* out = static_cast<QT*>(p.out);
#pragma unroll
  for (int k = 0; k < NACC; ++k) {
    if (k < my_nacc) {
      const int r = r_own + k * RSTEP;
      const long long off =
          (((long long)b * p.chunk + c0 + r / p.rep) * p.heads + g * p.rep + r % p.rep) * HD + d_own;
      out[off] = from_f32<QT>(acc[k] / fmaxf(row_l[r], 1e-30f));
    }
  }
}

template <typename QT, typename PT, int HD, int ROWS>
int launch(Params p, int batch, cudaStream_t stream) {
  constexpr int KEYS = keys_per_tile<PT, HD>();
  constexpr size_t smem = smem_bytes<HD, KEYS, ROWS>();
  auto kernel = paged_attention_kernel<QT, PT, HD, KEYS, ROWS>;
  p.tq = ROWS / p.rep < p.chunk ? ROWS / p.rep : p.chunk;
  p.n_qtiles = (p.chunk + p.tq - 1) / p.tq;
  if (smem > 48 * 1024) {
    static bool opted_in = false;  // once per instantiation; a repeated call is harmless
    if (!opted_in) {
      const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
      opted_in = true;
    }
  }
  const dim3 grid((unsigned)(batch * p.n_qtiles), (unsigned)p.kv);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename QT, typename PT, int HD>
int dispatch_rows(const Params& p, int batch, cudaStream_t s) {
  if (p.rep * p.chunk <= 4) return launch<QT, PT, HD, 4>(p, batch, s);
  if (p.rep <= 8) return launch<QT, PT, HD, 8>(p, batch, s);
  return launch<QT, PT, HD, kRows>(p, batch, s);
}

template <typename QT, typename PT>
int dispatch_hd(const Params& p, int batch, int head_dim, cudaStream_t s) {
  switch (head_dim) {
    case 16: return dispatch_rows<QT, PT, 16>(p, batch, s);
    case 32: return dispatch_rows<QT, PT, 32>(p, batch, s);
    case 64: return dispatch_rows<QT, PT, 64>(p, batch, s);
    case 128: return dispatch_rows<QT, PT, 128>(p, batch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out: contiguous (batch, chunk, heads, head_dim), bf16 if q_bf16 else
// f32. pool: contiguous (n_pages, page, 2 * kv, head_dim), bf16 if pool_bf16
// else f32, 16-byte aligned. table: int32 (batch, max_pages). lengths: int32
// (batch,). head_dim in {16, 32, 64, 128}; heads / kv <= 32; batch * chunk
// < 2^31. Returns the cudaError_t of the launch.
extern "C" int repro_paged_attention(const void* q, int q_bf16, const void* pool, int pool_bf16, const int* table,
                                     const int* lengths, void* out, int batch, int chunk, int heads, int kv,
                                     int head_dim, int page, int max_pages, int n_pages, void* stream) {
  if (kv <= 0 || heads % kv || heads / kv > kRows || batch <= 0 || chunk <= 0 || page <= 0 || max_pages <= 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.pool = pool;
  p.table = table;
  p.lengths = lengths;
  p.out = out;
  p.chunk = chunk;
  p.heads = heads;
  p.kv = kv;
  p.rep = heads / kv;
  p.page = page;
  p.max_pages = max_pages;
  p.n_pages = n_pages;
  p.scale = 1.0f / sqrtf((float)head_dim);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_bf16) {
    return pool_bf16 ? dispatch_hd<__nv_bfloat16, __nv_bfloat16>(p, batch, head_dim, s)
                     : dispatch_hd<__nv_bfloat16, float>(p, batch, head_dim, s);
  }
  return pool_bf16 ? dispatch_hd<float, __nv_bfloat16>(p, batch, head_dim, s)
                   : dispatch_hd<float, float>(p, batch, head_dim, s);
}
