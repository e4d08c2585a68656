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
// What bounds each form, and what the design does about it:
// - Decode (C = 1) is bound by bytes: each live K/V row is read once for
//   ~4 flops per element pair and query head. One block per (row, group)
//   would run only B * KV blocks, each walking up to thousands of keys in
//   series. So the walk is split: the host planner (plan_paged in
//   kernels/paged_attention.py, shapes and the SM count only, never
//   lengths) cuts every (row, group, query tile) into pieces of whole
//   pages, several blocks per SM for full table rows. A piece that starts
//   past its row's live keys exits at once.
// - Each block stages its keys through a ring of kStages tiles of kKeys
//   keys in shared memory, filled by 16-byte cp.async.cg copies in the
//   pool's own type (a bf16 tile stays bf16), with kStages - 1 tiles in
//   flight while one is computed. Page ids outside [0, n_pages) read the
//   null page 0; keys past the piece's live end are zero-filled and masked.
// - Prefill is bound by operations (every query row meets every earlier
//   key). A block holds a tile of ROWS query rows (tokens x heads of its
//   group: 64 rows, 21 tokens at rep 3), so each staged K/V tile serves all
//   of them, and it walks keys only up to its last query's causal limit.
//   The key axis is split as for decode where the query tiles alone leave
//   SMs idle.
// - f32 queries run on the CUDA cores in f32 (their checks hold them to
//   1e-5 of the plain twin): each thread owns a small register tile of
//   scores (up to 4 rows x 4 keys) and of the value product (rows x one
//   16-byte column chunk), reading K and V from shared memory as 16-byte
//   vectors. A block's time is the dependent chain of its tiles more than
//   its bytes, so the 64-row (prefill) tile takes 8 warps, three blocks an
//   SM. Where q and the pool are both bf16 (the serving path's types)
//   and C > 1, QK^T and PV run on the tensor cores: mma.sync m16n8k16 bf16
//   with f32 accumulators, K and V fragments by ldmatrix from the ring, the
//   probabilities kept in registers as the A operand, and the running max,
//   sum and rescale in f32.
// - A split call writes each piece's (acc, m, l) in f32 to scratch, and a
//   second launch merges them by the rescaled online-softmax rule in piece
//   order, one thread per 4 output columns, so the output is bit-identical
//   from run to run (no float atomics). An unsplit call (one piece) writes
//   the output directly: one launch. Masked scores are -inf and their
//   exponentials exactly 0; a row with no live key gets l = 0 and acc = 0,
//   so the output acc / max(l, 1e-30), as in the JAX wrapper, is exactly 0
//   there.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kKeys = 32;          // keys per ring stage
constexpr int kStages = 4;         // ring depth: kStages - 1 tiles in flight
constexpr int kMmaRows = 64;       // query rows of a tensor-core block: 4 warps x 16
constexpr float kNegInit = -1e30f; // running-max start, as the TPU kernel's NEG_INF
constexpr int kFormCores = 0, kFormMma = 1;  // plan forms; match kernels/paged_attention.py

struct Params {
  const void* q;
  const void* pool;
  const int* table;
  const int* lengths;
  void* out;
  float* part_acc;  // (pieces, rows_total, hd) partial numerators, when pieces > 1
  float* part_ml;   // (pieces, rows_total, 2) partial (max, denominator)
  int chunk, heads, kv, rep, page, page_shift, max_pages, n_pages;  // page_shift: log2(page), or -1
  int tq, n_qtiles, ppp, pieces;
  long long rows_total;  // batch * chunk * heads
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

// 4 consecutive values (16-byte aligned for f32, 8-byte for bf16) as floats.
__device__ __forceinline__ float4 load4(const float* s) { return *reinterpret_cast<const float4*>(s); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* s) {
  const uint2 u = *reinterpret_cast<const uint2*>(s);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Bytes of one key in the ring: its K row then its V row in the pool's type,
// padded by 16 bytes so that 8 lanes reading 8 keys' 16-byte chunks at one
// offset hit distinct banks.
template <typename PT, int HD>
struct Ring {
  static constexpr int ROW = 2 * HD * (int)sizeof(PT) + 16;
  static constexpr int STAGE = kKeys * ROW;
  static constexpr int CPR = 2 * HD * (int)sizeof(PT) / 16;  // 16-byte chunks per key
  static constexpr int CHUNKS = kKeys * CPR;
  static_assert(CHUNKS % kThreads == 0, "ring geometry");
};

// The block's share: row b, group g, query tile [c0, c0 + n_tok), and the
// piece's live keys [k0, k1).
struct Work {
  int b, g, c0, n_tok, n_rows, q_first, piece, k0, k1;
};

// Keys the query tile starting at token c0 may see (k_abs < kend), no
// further than the table reaches; also the tile's first query position.
__device__ __forceinline__ int live_keys(const Params& p, int b, int c0, int n_tok, int* q_first) {
  const int qf = p.lengths[b] - p.chunk + c0;
  long long kend = (long long)qf + n_tok;
  const long long reach = (long long)p.max_pages * p.page;
  kend = kend > reach ? reach : kend;
  *q_first = qf;
  return kend > 0 ? (int)kend : 0;
}

// Block index = ((b * n_qtiles + qtile) * kv + g) * pieces + piece. The
// geometry needs no device read; the live end k1 needs lengths[b].
__device__ __forceinline__ Work work_of(const Params& p) {
  Work w;
  int rest = blockIdx.x;
  w.piece = rest % p.pieces;
  rest /= p.pieces;
  w.g = rest % p.kv;
  rest /= p.kv;
  const int qt = rest % p.n_qtiles;
  w.b = rest / p.n_qtiles;
  w.c0 = qt * p.tq;
  w.n_tok = min(p.tq, p.chunk - w.c0);
  w.n_rows = w.n_tok * p.rep;
  w.k0 = w.piece * p.ppp * p.page;
  return w;
}

__device__ __forceinline__ void set_live(const Params& p, Work& w) {
  w.k1 = min(live_keys(p, w.b, w.c0, w.n_tok, &w.q_first), w.k0 + p.ppp * p.page);
}

// The piece's first page ids, one per thread of the block: loaded before
// lengths is read so the two reads overlap, then kept in shared memory
// (ids outside [0, n_pages) become the null page 0).
struct PageIds {
  int id;
  __device__ __forceinline__ PageIds(const Params& p, const Work& w) : id(0) {
    const int first = w.piece * p.ppp;
    if ((int)threadIdx.x < min(p.ppp, p.max_pages - first))
      id = __ldg(p.table + (long long)w.b * p.max_pages + first + threadIdx.x);
  }
  __device__ __forceinline__ void store(const Params& p, int* ids) const {
    ids[threadIdx.x] = (id < 0 || id >= p.n_pages) ? 0 : id;
  }
};

// Output row of query row r (token c0 + r / rep, head g * rep + r % rep).
__device__ __forceinline__ long long out_row(const Params& p, const Work& w, int r) {
  return ((long long)w.b * p.chunk + w.c0 + r / p.rep) * p.heads + w.g * p.rep + r % p.rep;
}

// An unsplit tile with no live key: its outputs are exactly 0.
template <typename QT, int HD>
__device__ void write_zeros(const Params& p, const Work& w) {
  QT* out = static_cast<QT*>(p.out);
  for (int e = threadIdx.x; e < w.n_rows * HD; e += blockDim.x)
    out[out_row(p, w, e / HD) * HD + e % HD] = from_f32<QT>(0.f);
}

// Stage keys [kt0, kt0 + kKeys) of group g into one ring slot (NT
// threads); keys at or past the piece's end k1 are zero-filled. ``ids``
// holds the piece's first NT page ids.
template <typename PT, int HD, int NT>
__device__ __forceinline__ void load_stage(const Params& p, const Work& w, const int* ids, char* dst, int kt0) {
  using R = Ring<PT, HD>;
  const char* pool = static_cast<const char*>(p.pool);
  const int first = w.piece * p.ppp;
#pragma unroll
  for (int n = 0; n < (R::CHUNKS + NT - 1) / NT; ++n) {
    const int e = threadIdx.x + n * NT;
    if (R::CHUNKS % NT && e >= R::CHUNKS) break;
    const int j = e / R::CPR, cc = e % R::CPR;
    const int kabs = kt0 + j;
    const char* src = pool;
    int bytes = 0;
    if (kabs < w.k1) {
      const int pidx = p.page_shift >= 0 ? kabs >> p.page_shift : kabs / p.page;
      const int slot = pidx - first;
      int pg = slot < NT ? ids[slot] : __ldg(p.table + (long long)w.b * p.max_pages + pidx);
      pg = (pg < 0 || pg >= p.n_pages) ? 0 : pg;
      src = pool + (((long long)pg * p.page + (kabs - pidx * p.page)) * 2 * p.kv + 2 * w.g) * HD *
                       (long long)sizeof(PT) + cc * 16;
      bytes = 16;
    }
    cp_async16(dst + j * R::ROW + cc * 16, src, bytes);
  }
}

// The ring: tiles of the piece's keys, kStages - 1 in flight while
// ``compute(slot, first key)`` runs on the oldest. ``ids`` holds the piece's
// page ids (PageIds), stored before a barrier that precedes the call. Ends
// with every copy landed and a barrier, so the ring may be reused.
template <typename PT, int HD, int NT, typename F>
__device__ __forceinline__ void walk(const Params& p, const Work& w, const int* ids, char* ring, F&& compute) {
  using R = Ring<PT, HD>;
  const int n_tiles = (w.k1 - w.k0 + kKeys - 1) / kKeys;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_tiles) load_stage<PT, HD, NT>(p, w, ids, ring + s * R::STAGE, w.k0 + s * kKeys);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t landed for every thread; every thread is done with tile t - 1
    const int nt = t + kStages - 1;
    if (nt < n_tiles) load_stage<PT, HD, NT>(p, w, ids, ring + (nt % kStages) * R::STAGE, w.k0 + nt * kKeys);
    cp_async_commit();
    compute(ring + (t % kStages) * R::STAGE, w.k0 + t * kKeys);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// One query row's result: the output (unsplit) or the piece's partial.
// ``vals`` holds N consecutive columns from ``col``.
template <typename QT, int HD, int N>
__device__ __forceinline__ void emit(const Params& p, const Work& w, int r, int col, const float* vals, float m,
                                     float l, bool write_ml) {
  const long long orow = out_row(p, w, r);
  if (p.pieces == 1) {
    QT* out = static_cast<QT*>(p.out) + orow * HD + col;
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int v = 0; v < N; ++v) out[v] = from_f32<QT>(vals[v] / den);
    return;
  }
  const long long prow = (long long)w.piece * p.rows_total + orow;
  float* acc = p.part_acc + prow * HD + col;
#pragma unroll
  for (int v = 0; v < N; ++v) acc[v] = vals[v];
  if (write_ml) {
    p.part_ml[2 * prow] = m;
    p.part_ml[2 * prow + 1] = l;
  }
}

// ---- CUDA-core form (f32 arithmetic) -------------------------------------

// Threads of a CUDA-core block: 8 warps for the 64-row (prefill) tile, so
// each thread's share of a tile's products, and its latency, halves; three
// such blocks fit an SM (at most 85 registers a thread, which spills 16-92
// bytes in these instantiations and still ran the prefill chunk faster than
// two blocks an SM).
template <int ROWS>
__host__ __device__ constexpr int cores_threads() {
  return ROWS >= 64 ? 2 * kThreads : kThreads;
}

// Ring, then f32 queries (rows padded by 4 floats: the row groups of a
// warp read distinct banks), probabilities, three per-row values, page ids.
template <typename PT, int HD, int ROWS>
constexpr size_t cores_smem() {
  return (size_t)kStages * Ring<PT, HD>::STAGE +
         sizeof(float) * ((size_t)ROWS * (HD + 4) + (size_t)ROWS * (kKeys + 1) + 3 * ROWS) +
         sizeof(int) * cores_threads<ROWS>();
}

template <typename QT, typename PT, int HD, int ROWS>
__global__ void __launch_bounds__(cores_threads<ROWS>(), ROWS >= 64 ? 3 : 1)
    paged_cores_kernel(const __grid_constant__ Params p) {
  constexpr int NT = cores_threads<ROWS>();
  using R = Ring<PT, HD>;
  constexpr int DV = 16 / (int)sizeof(PT);         // elements per 16-byte chunk
  constexpr int KK = ROWS >= 16 ? 4 : ROWS / 4;     // scores: keys per thread
  constexpr int KTG = kKeys / KK;                   // scores: lanes sharing a row group
  constexpr int NG = NT / KTG;                      // scores: row groups
  constexpr int RR = ROWS / NG;                     // scores: rows per thread
  constexpr int QS = HD + 4;                        // padded query row
  constexpr bool SPLIT = RR * KK < 4;               // few accumulators: one partial dot per chunk
  constexpr int NCH = HD / DV;                      // values: chunks per V row
  constexpr int KS = ROWS * NCH >= NT ? 1 : NT / (ROWS * NCH);  // values: key phases
  constexpr int RSTEP = NT / (NCH * KS);
  constexpr int RVN = ROWS / RSTEP;                 // values: rows per thread
  constexpr int PS = kKeys + 1;
  static_assert(RR >= 1 && RVN >= 1 && ROWS % RSTEP == 0 && KTG <= 32 && HD % DV == 0, "tile geometry");

  extern __shared__ __align__(16) char smem[];
  char* ring = smem;
  float* qs = reinterpret_cast<float*>(smem + kStages * R::STAGE);  // [ROWS][QS], pre-scaled by 1/sqrt(hd)
  float* ps = qs + ROWS * QS;                                         // [ROWS][PS] probabilities
  float* row_c = ps + ROWS * PS;                                      // this tile's rescale factor
  float* row_m = row_c + ROWS;
  float* row_l = row_m + ROWS;
  int* ids = reinterpret_cast<int*>(row_l + ROWS);                    // [NT] page ids

  Work w = work_of(p);
  const PageIds pids(p, w);
  set_live(p, w);
  if (w.k0 >= w.k1) {  // a split tile's rows with no live key: the combine writes 0
    if (p.pieces == 1) write_zeros<QT, HD>(p, w);
    return;
  }
  // Each thread loads all its query vectors of 4 before it stores any.
  const int tid = threadIdx.x;
  constexpr int QV = (ROWS * HD / 4 + NT - 1) / NT;  // 4-element query vectors per thread
  float4 qv[QV];
#pragma unroll
  for (int k = 0; k < QV; ++k) {
    const int e = tid + k * NT, r = e / (HD / 4);
    qv[k] = r < w.n_rows ? load4(static_cast<const QT*>(p.q) + out_row(p, w, r) * HD + e % (HD / 4) * 4)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int k = 0; k < QV; ++k) {
    const int e = tid + k * NT, r = e / (HD / 4);
    if (r < ROWS) {
      const float4 x = qv[k];
      *reinterpret_cast<float4*>(qs + r * QS + e % (HD / 4) * 4) =
          make_float4(x.x * p.scale, x.y * p.scale, x.z * p.scale, x.w * p.scale);
    }
  }
  pids.store(p, ids);
  __syncthreads();

  const int tk = tid % KTG, tr = tid / KTG;  // scores: keys tk + i * KTG, rows tr + r * NG
  const int cc = tid % NCH, ks = (tid / NCH) % KS, rv = tid / (NCH * KS);  // values: rows rv + i * RSTEP
  float m_run[RR], l_run[RR];
#pragma unroll
  for (int r = 0; r < RR; ++r) {
    m_run[r] = kNegInit;
    l_run[r] = 0.f;
  }
  float acc[RVN][DV];
#pragma unroll
  for (int i = 0; i < RVN; ++i)
#pragma unroll
    for (int v = 0; v < DV; ++v) acc[i][v] = 0.f;

  walk<PT, HD, NT>(p, w, ids, ring, [&](const char* st, int kt0) {
    float s[RR][KK];
#pragma unroll
    for (int r = 0; r < RR; ++r)
#pragma unroll
      for (int i = 0; i < KK; ++i) s[r][i] = 0.f;
#pragma unroll
    for (int d0 = 0; d0 < HD; d0 += DV) {
      float kf[KK][DV];
#pragma unroll
      for (int i = 0; i < KK; ++i)
        unpack(*reinterpret_cast<const uint4*>(st + (tk + i * KTG) * R::ROW + d0 * (int)sizeof(PT)), kf[i], PT());
#pragma unroll
      for (int r = 0; r < RR; ++r) {
        float qf[DV];
        const float4* qv = reinterpret_cast<const float4*>(qs + (tr + r * NG) * QS + d0);
#pragma unroll
        for (int v4 = 0; v4 < DV / 4; ++v4) {
          const float4 x = qv[v4];
          qf[4 * v4] = x.x;
          qf[4 * v4 + 1] = x.y;
          qf[4 * v4 + 2] = x.z;
          qf[4 * v4 + 3] = x.w;
        }
#pragma unroll
        for (int i = 0; i < KK; ++i) {
          if (SPLIT) {  // a chunk's partial dot, then one add: shorter dependent chains
            float t = 0.f;
#pragma unroll
            for (int v = 0; v < DV; ++v) t = fmaf(qf[v], kf[i][v], t);
            s[r][i] += t;
          } else {
#pragma unroll
            for (int v = 0; v < DV; ++v) s[r][i] = fmaf(qf[v], kf[i][v], s[r][i]);
          }
        }
      }
    }
    // Online softmax; a row's KTG score lanes are adjacent lanes of one warp.
#pragma unroll
    for (int r = 0; r < RR; ++r) {
      const int row = tr + r * NG;
      const bool row_live = row < w.n_rows;
      const int q_abs = w.q_first + row / p.rep;
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < KK; ++i) {
        const int kabs = kt0 + tk + i * KTG;
        s[r][i] = (row_live && kabs < w.k1 && kabs <= q_abs) ? s[r][i] : -INFINITY;
        mx = fmaxf(mx, s[r][i]);
      }
#pragma unroll
      for (int o = KTG / 2; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_run[r], mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < KK; ++i) {
        const float e = expf(s[r][i] - m_new);
        ps[row * PS + tk + i * KTG] = e;
        sum += e;
      }
#pragma unroll
      for (int o = KTG / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float corr = expf(m_run[r] - m_new);
      l_run[r] = l_run[r] * corr + sum;
      m_run[r] = m_new;
      if (tk == 0) row_c[row] = corr;
    }
    __syncthreads();
    // acc = acc * corr + P V over the tile's live keys.
#pragma unroll
    for (int i = 0; i < RVN; ++i) {
      const float c = row_c[rv + i * RSTEP];
#pragma unroll
      for (int v = 0; v < DV; ++v) acc[i][v] *= c;
    }
    const int nk = min(kKeys, w.k1 - kt0);
#pragma unroll
    for (int jj = 0; jj < kKeys / KS; ++jj) {
      const int j = ks + jj * KS;
      if (j < nk) {
        float vf[DV];
        unpack(*reinterpret_cast<const uint4*>(st + j * R::ROW + HD * (int)sizeof(PT) + cc * 16), vf, PT());
#pragma unroll
        for (int i = 0; i < RVN; ++i) {
          const float pr = ps[(rv + i * RSTEP) * PS + j];
#pragma unroll
          for (int v = 0; v < DV; ++v) acc[i][v] = fmaf(pr, vf[v], acc[i][v]);
        }
      }
    }
  });

  if (tk == 0) {
#pragma unroll
    for (int r = 0; r < RR; ++r) {
      row_m[tr + r * NG] = m_run[r];
      row_l[tr + r * NG] = l_run[r];
    }
  }
  if (KS > 1) {  // join the key phases in a fixed order, through the idle ring
    float* red = reinterpret_cast<float*>(ring);
    if (ks > 0) {
#pragma unroll
      for (int i = 0; i < RVN; ++i)
#pragma unroll
        for (int v = 0; v < DV; ++v) red[((ks - 1) * ROWS + rv + i * RSTEP) * HD + cc * DV + v] = acc[i][v];
    }
    __syncthreads();
    if (ks == 0) {
      for (int k = 1; k < KS; ++k)
#pragma unroll
        for (int i = 0; i < RVN; ++i)
#pragma unroll
          for (int v = 0; v < DV; ++v) acc[i][v] += red[((k - 1) * ROWS + rv + i * RSTEP) * HD + cc * DV + v];
    }
  } else {
    __syncthreads();
  }
  if (ks == 0) {
#pragma unroll
    for (int i = 0; i < RVN; ++i) {
      const int row = rv + i * RSTEP;
      if (row < w.n_rows) emit<QT, HD, DV>(p, w, row, cc * DV, acc[i], row_m[row], row_l[row], cc == 0);
    }
  }
}

// ---- tensor-core form (bf16 q and pool) ----------------------------------

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int HD>
constexpr size_t mma_smem() {
  return (size_t)kStages * Ring<__nv_bfloat16, HD>::STAGE + sizeof(int) * kThreads;
}

// Warp w owns query rows [16 w, 16 w + 16) of the tile; lane holds rows
// g = lane / 4 and g + 8, columns 2 (lane % 4) + {0, 1} of each 8-wide tile.
template <int HD>
__global__ void __launch_bounds__(kThreads) paged_mma_kernel(const __grid_constant__ Params p) {
  using PT = __nv_bfloat16;
  using R = Ring<PT, HD>;
  constexpr int KT = HD / 16;  // k-steps of QK^T
  constexpr int NT = HD / 8;   // 8-column tiles of the output

  extern __shared__ __align__(16) char smem[];
  int* ids = reinterpret_cast<int*>(smem + kStages * R::STAGE);
  Work w = work_of(p);
  const PageIds pids(p, w);
  set_live(p, w);
  if (w.k0 >= w.k1) {  // a split tile's rows with no live key: the combine writes 0
    if (p.pieces == 1) write_zeros<PT, HD>(p, w);
    return;
  }
  pids.store(p, ids);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rows[2] = {warp * 16 + g, warp * 16 + g + 8};
  bool live[2];
  int q_abs[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    live[h] = rows[h] < w.n_rows;
    q_abs[h] = w.q_first + rows[h] / p.rep;
  }

  // Q as A fragments for every k-step, read once.
  const PT* q = static_cast<const PT*>(p.q);
  uint32_t qa[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int h = i & 1, col = kk * 16 + (i >> 1) * 8 + 2 * t;
      qa[kk][i] = live[h] ? *reinterpret_cast<const uint32_t*>(q + out_row(p, w, rows[h]) * HD + col) : 0u;
    }

  float m_run[2] = {kNegInit, kNegInit}, l_run[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  const int mat = lane >> 3, mrow = lane & 7;  // ldmatrix: this lane's matrix and row address
  __syncthreads();
  walk<PT, HD, kThreads>(p, w, ids, smem, [&](const char* st, int kt0) {
    const unsigned base = (unsigned)__cvta_generic_to_shared(st);
    float sc[4][4];  // 4 tiles of 8 keys
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];
        const int key = np * 16 + (mat >> 1) * 8 + mrow, col = kk * 16 + (mat & 1) * 8;
        ldmatrix_x4(b, base + key * R::ROW + col * 2);
        mma_bf16(sc[2 * np], qa[kk], b[0], b[1]);
        mma_bf16(sc[2 * np + 1], qa[kk], b[2], b[3]);
      }
    // Online softmax in f32 over the quad that shares a row.
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kabs = kt0 + n * 8 + 2 * t + e;
          float& s = sc[n][2 * h + e];
          s = (live[h] && kabs < w.k1 && kabs <= q_abs[h]) ? s * p.scale : -INFINITY;
          mx = fmaxf(mx, s);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[h], mx);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& s = sc[n][2 * h + e];
          s = expf(s - m_new);
          sum += s;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      corr[h] = expf(m_run[h] - m_new);
      l_run[h] = l_run[h] * corr[h] + sum;
      m_run[h] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }
    // P (bf16, from the score accumulators) times V (ldmatrix.trans).
#pragma unroll
    for (int kc = 0; kc < 2; ++kc) {
      const uint32_t pa[4] = {pack_bf16(sc[2 * kc][0], sc[2 * kc][1]), pack_bf16(sc[2 * kc][2], sc[2 * kc][3]),
                              pack_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1]),
                              pack_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3])};
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        const int key = kc * 16 + (mat & 1) * 8 + mrow, col = HD + (2 * np + (mat >> 1)) * 8;
        ldmatrix_x4_trans(b, base + key * R::ROW + col * 2);
        mma_bf16(acc[2 * np], pa, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], pa, b[2], b[3]);
      }
    }
  });

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!live[h]) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float vals[2] = {acc[n][2 * h], acc[n][2 * h + 1]};
      emit<PT, HD, 2>(p, w, rows[h], n * 8 + 2 * t, vals, m_run[h], l_run[h], n == 0 && t == 0);
    }
  }
}

// ---- the combine (split calls) -------------------------------------------

// One thread per 4 output columns of one query row: merge the live pieces'
// partials in piece order, out = acc / max(l, 1e-30).
template <typename QT>
__global__ void __launch_bounds__(kThreads) paged_combine_kernel(const __grid_constant__ Params p, int hd) {
  const int per_row = hd / 4;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long orow = idx / per_row;
  if (orow >= p.rows_total) return;
  const int col = (int)(idx % per_row) * 4;
  const int tok = (int)((orow / p.heads) % p.chunk);
  const int b = (int)(orow / ((long long)p.heads * p.chunk));
  const int c0 = tok / p.tq * p.tq;
  int q_first;
  const int kend = live_keys(p, b, c0, min(p.tq, p.chunk - c0), &q_first);
  const int span = p.ppp * p.page;
  const int n_live = min(p.pieces, (kend + span - 1) / span);
  constexpr int kBatch = 8;  // pieces whose loads are in flight together
  float m = kNegInit;
  for (int k0 = 0; k0 < n_live; k0 += kBatch) {
    float mk[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      mk[i] = k0 + i < n_live ? p.part_ml[2 * ((long long)(k0 + i) * p.rows_total + orow)] : kNegInit;
#pragma unroll
    for (int i = 0; i < kBatch; ++i) m = fmaxf(m, mk[i]);
  }
  float l = 0.f, a[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < n_live; k0 += kBatch) {
    float2 ml[kBatch];
    float4 x[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (k0 + i < n_live) {
        const long long prow = (long long)(k0 + i) * p.rows_total + orow;
        ml[i] = *reinterpret_cast<const float2*>(p.part_ml + 2 * prow);
        x[i] = *reinterpret_cast<const float4*>(p.part_acc + prow * hd + col);
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {  // in piece order
      if (k0 + i < n_live) {
        const float wk = expf(ml[i].x - m);
        l += ml[i].y * wk;
        a[0] += x[i].x * wk;
        a[1] += x[i].y * wk;
        a[2] += x[i].z * wk;
        a[3] += x[i].w * wk;
      }
    }
  }
  QT* out = static_cast<QT*>(p.out) + orow * hd + col;
  const float den = fmaxf(l, 1e-30f);
#pragma unroll
  for (int v = 0; v < 4; ++v) out[v] = from_f32<QT>(a[v] / den);
}

// ---- launch --------------------------------------------------------------

template <typename K>
int opt_in(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename QT, typename PT, int HD>
int launch_main(const Params& p, int form, int rows, unsigned blocks, cudaStream_t s) {
  if (form == kFormMma) {
    if constexpr (std::is_same<QT, __nv_bfloat16>::value && std::is_same<PT, __nv_bfloat16>::value) {
      if (rows != kMmaRows) return (int)cudaErrorInvalidValue;
      constexpr size_t smem = mma_smem<HD>();
      static const int rc = opt_in(paged_mma_kernel<HD>, smem);  // once per instantiation
      if (rc) return rc;
      paged_mma_kernel<HD><<<blocks, kThreads, smem, s>>>(p);
      return (int)cudaGetLastError();
    }
    return (int)cudaErrorInvalidValue;
  }
#define REPRO_CORES(ROWS)                                                  \
  case ROWS: {                                                             \
    constexpr size_t smem = cores_smem<PT, HD, ROWS>();                    \
    static const int rc = opt_in(paged_cores_kernel<QT, PT, HD, ROWS>, smem); \
    if (rc) return rc;                                                     \
    paged_cores_kernel<QT, PT, HD, ROWS><<<blocks, cores_threads<ROWS>(), smem, s>>>(p); \
    return (int)cudaGetLastError();                                        \
  }
  switch (rows) {
    REPRO_CORES(4)
    REPRO_CORES(16)
    REPRO_CORES(64)
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_CORES
}

template <typename QT, typename PT>
int launch_all(const Params& p, int head_dim, int form, int rows, unsigned blocks, unsigned combine_blocks,
               cudaStream_t s) {
  int rc;
  switch (head_dim) {
    case 16: rc = launch_main<QT, PT, 16>(p, form, rows, blocks, s); break;
    case 32: rc = launch_main<QT, PT, 32>(p, form, rows, blocks, s); break;
    case 64: rc = launch_main<QT, PT, 64>(p, form, rows, blocks, s); break;
    case 128: rc = launch_main<QT, PT, 128>(p, form, rows, blocks, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc || p.pieces == 1) return rc;
  paged_combine_kernel<QT><<<combine_blocks, kThreads, 0, s>>>(p, head_dim);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: contiguous (batch, chunk, heads, head_dim), bf16 if q_bf16 else
// f32, 16-byte aligned. pool: contiguous (n_pages, page, 2 * kv, head_dim),
// bf16 if pool_bf16 else f32, 16-byte aligned. table: int32 (batch,
// max_pages). lengths: int32 (batch,). part: f32 scratch of pieces * batch
// * chunk * heads * (head_dim + 2) floats, 16-byte aligned, when pieces >
// 1. The plan (form, rows, tq, ppp, pieces) comes from plan_paged in
// kernels/paged_attention.py. Launches the walk and, when pieces > 1, the
// combine; returns the cudaError_t of the launches.
extern "C" int repro_paged_attention(const void* q, int q_bf16, const void* pool, int pool_bf16, const int* table,
                                     const int* lengths, void* out, float* part, int batch, int chunk, int heads,
                                     int kv, int head_dim, int page, int max_pages, int n_pages, int form, int rows,
                                     int tq, int ppp, int pieces, void* stream) {
  if (kv <= 0 || heads % kv || batch <= 0 || chunk <= 0 || page <= 0 || max_pages <= 0 || tq <= 0 || ppp <= 0 ||
      pieces <= 0 || tq * (heads / kv) > rows || (long long)ppp * pieces < max_pages ||
      (long long)ppp * pieces * page >= (1LL << 31) || (pieces > 1 && part == nullptr) ||
      (form != kFormCores && form != kFormMma))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.pool = pool;
  p.table = table;
  p.lengths = lengths;
  p.out = out;
  p.rows_total = (long long)batch * chunk * heads;
  p.part_acc = part;
  p.part_ml = part ? part + (long long)pieces * p.rows_total * head_dim : nullptr;
  p.chunk = chunk;
  p.heads = heads;
  p.kv = kv;
  p.rep = heads / kv;
  p.page = page;
  p.page_shift = (page & (page - 1)) ? -1 : __builtin_ctz((unsigned)page);
  p.max_pages = max_pages;
  p.n_pages = n_pages;
  p.tq = tq;
  p.n_qtiles = (chunk + tq - 1) / tq;
  p.ppp = ppp;
  p.pieces = pieces;
  p.scale = 1.0f / sqrtf((float)head_dim);
  const long long blocks = (long long)batch * p.n_qtiles * kv * pieces;
  const long long combine = (p.rows_total * (head_dim / 4) + kThreads - 1) / kThreads;
  if (blocks >= (1LL << 31) || combine >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned nb = (unsigned)blocks, nc = (unsigned)combine;
  if (q_bf16) {
    return pool_bf16 ? launch_all<__nv_bfloat16, __nv_bfloat16>(p, head_dim, form, rows, nb, nc, s)
                     : launch_all<__nv_bfloat16, float>(p, head_dim, form, rows, nb, nc, s);
  }
  return pool_bf16 ? launch_all<float, __nv_bfloat16>(p, head_dim, form, rows, nb, nc, s)
                   : launch_all<float, float>(p, head_dim, form, rows, nb, nc, s);
}
