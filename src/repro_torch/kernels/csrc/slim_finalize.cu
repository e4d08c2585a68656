// Pass 2 of the sharded psum pair: the SlimAdam preconditioner from a
// completed reduced moment, over a (B, R, C) canonical view.
//
// Replaces
//   * repro/kernels/slim_update.py:329 slim_finalize_batched (kernel bodies
//     _slim_finalize_kernel :314, launched :374, and _slim_apply_line_kernel
//     :323, launched :365): scalar bias corrections from the step count
//     (the per-leaf form, B11);
//   * repro/kernels/megaplan.py:536 mega_slim_finalize_batched (bodies
//     _mega_finalize_ek_kernel :522, launched :568, and
//     _mega_finalize_owner_kernel :530, launched :559): bias corrections per
//     line, one megaplan group in one launch (the group form, B13).
// Both are repro_slim_finalize_flat. Per element of a reduction line (axis
// 1: a row; axis 0: a column), with the line's values read once a vector:
//   ek form:    v' = b2*v + (1-b2)*ek   (ek the cross-rank completed line
//               mean of g^2), written once per line;
//   owner form: v' given (the all-reduce already delivered it);
//   u = (m'/bc1) / (sqrt(v'/bc2) + eps).
//
// Bound: bytes, 8 B per element (m' read, u written) plus 12-20 B per line.
// The work is elementwise, so the kernel only has to stream m' and u at the
// memory rate and read each line value once. Operation order and the _rn
// intrinsics as in common.cuh, so u and v' match the plain twin bit for bit,
// and the group form matches the per-leaf form where its lines' bias
// corrections equal the count's.
//
// A block per line or per column strip leaves the card part idle: 144
// blocks of 24 dependent row loads on a (12, 384, 384) leaf, 96-thread
// blocks with one 16-byte load in flight on 384-column lines, one block for
// a rank's 9.66 M-element embedding shard line. Forming the bias
// corrections with torch took ~8 small launches a call. So:
//   * one flat walk over the view for both axes and both forms: a
//     grid-stride loop over tiles of kFlatThreads x kFlatUnroll vectors
//     (float4 where cols % 4 == 0 and the buffers are 16-byte aligned),
//     every thread with kFlatUnroll loads in flight, on a grid that
//     plan_finalize (slim_update.py) sizes to the work and to
//     kFlatBlocksPerSm blocks an SM. Vector j of the view lies in row
//     q = j / (cols/VEC) of the (B*R, C) matrix; its line is q on axis 1
//     (one line value for the vector) and b*C + c on axis 0, where a float4
//     spans 4 adjacent lines whose values come as one float4 through the
//     read-only path. In the ek form the thread holding a line's first
//     element (c == 0 on axis 1, r == 0 on axis 0) alone writes v';
//   * the per-leaf form's bias corrections from the step count in the
//     kernel: a 0-d int32 or int64 count on the device, read once a block by
//     its first thread, as 1 - b^t in f32 in the JAX package's order
//     (t = (float)count, powf, one rounded subtraction; no --use_fast_math,
//     so powf is the one torch calls on the card), or host-rounded f32
//     values when the count is a Python int. No torch operation runs around
//     the launch;
//   * the group form's bias corrections per line (the LINE_BC flag): read
//     beside v and ek, from the same line index, one value a vector on axis
//     1 and a float4 of 4 adjacent lines on axis 0. No count, no barrier.
#include "common.cuh"

namespace {

using repro_torch::ema;
using repro_torch::precond;

// plan_finalize's FLAT_THREADS, FLAT_UNROLL and FLAT_BLOCKS_PER_SM
// (slim_update.py). Two vectors a thread in flight: four spilled on axis 0
// in the ek form and were no faster on axis 1.
constexpr int kFlatThreads = 256;
constexpr int kFlatUnroll = 2;
constexpr int kFlatBlocksPerSm = 4;

struct FlatArgs {
  const float* m;      // m' (batch, rows, cols)
  const float* v;      // stored (ek form) or completed (owner form) moment lines
  const float* ek;     // ek form: completed line means of g^2, else null
  const float* bc1l;   // LINE_BC: the bias corrections, one a line like v; else null
  const float* bc2l;
  float* u;
  float* v_out;        // ek form: v' lines, else null
  const void* count;   // 0-d int32 (or int64) step count on the device, or null: bc1, bc2 given
  int count_is64;
  float bc1, bc2, b1, b2, omb2, eps;
  long long rows, cols, n;
};

// (1 - b1^t, 1 - b2^t) rounded as repro/kernels/fused_adam.py:29 rounds
// them: t = (float)count, b^t in f32, one subtraction.
__device__ __forceinline__ void bias_corrections(const FlatArgs& a, float* bc) {
  if (a.count == nullptr) {
    bc[0] = a.bc1;
    bc[1] = a.bc2;
    return;
  }
  const float t = a.count_is64 ? (float)*static_cast<const long long*>(a.count)
                               : (float)*static_cast<const int*>(a.count);
  bc[0] = __fsub_rn(1.0f, powf(a.b1, t));
  bc[1] = __fsub_rn(1.0f, powf(a.b2, t));
}

template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[N]) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
  } else {
    x[0] = *p;
  }
}

// Line values, through the read-only path.
template <int N>
__device__ __forceinline__ void load_line(const float* p, float (&x)[N]) {
  if constexpr (N == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
  } else {
    x[0] = __ldg(p);
  }
}

template <int N>
__device__ __forceinline__ void store_vec(float* p, const float (&x)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *p = x[0];
  }
}

// VEC elements a vector (4: float4), kFlatUnroll vectors a thread per tile,
// I the index type (32-bit below 2^31 elements). LINE_BC: the bias
// corrections are lines, loaded with v. Otherwise the tile loop's bound is
// uniform over the block (every block of plan_finalize's grid has a first
// tile), so the one barrier, which publishes the scalar corrections, sits
// after the first tile's loads are issued.
template <int VEC, bool EK, int AXIS, typename I, bool LINE_BC>
__global__ void __launch_bounds__(kFlatThreads, kFlatBlocksPerSm) finalize_flat_kernel(FlatArgs a) {
  constexpr int LV = AXIS == 1 ? 1 : VEC;  // line values a vector spans
  __shared__ float bc[2];
  if (!LINE_BC && threadIdx.x == 0) bias_corrections(a, bc);
  const I nv = (I)(a.n / VEC);
  const I row_v = (I)(a.cols / VEC);
  const I rows = (I)a.rows;
  const I tile = (I)kFlatThreads * kFlatUnroll;
  float c1 = 0.0f, c2 = 0.0f;
  bool have_bc = LINE_BC;
  for (I t0 = (I)blockIdx.x * tile; t0 < nv; t0 += (I)gridDim.x * tile) {
    float mm[kFlatUnroll][VEC], vl[kFlatUnroll][LV], el[kFlatUnroll][LV], b1l[kFlatUnroll][LV],
        b2l[kFlatUnroll][LV];
    I line[kFlatUnroll];
    bool first[kFlatUnroll];
#pragma unroll
    for (int k = 0; k < kFlatUnroll; ++k) {
      const I j = t0 + (I)(k * kFlatThreads + threadIdx.x);
      if (j < nv) {
        const I q = j / row_v;  // b*R + r
        const I cv = j - q * row_v;
        if constexpr (AXIS == 1) {
          line[k] = q;
          first[k] = cv == 0;
        } else {
          const I b = q / rows;
          line[k] = b * (I)a.cols + cv * VEC;
          first[k] = q == b * rows;
        }
        load_vec(a.m + (size_t)j * VEC, mm[k]);
        load_line(a.v + line[k], vl[k]);
        if constexpr (EK) load_line(a.ek + line[k], el[k]);
        if constexpr (LINE_BC) {
          load_line(a.bc1l + line[k], b1l[k]);
          load_line(a.bc2l + line[k], b2l[k]);
        }
      }
    }
    if (!have_bc) {
      __syncthreads();
      c1 = bc[0];
      c2 = bc[1];
      have_bc = true;
    }
#pragma unroll
    for (int k = 0; k < kFlatUnroll; ++k) {
      const I j = t0 + (I)(k * kFlatThreads + threadIdx.x);
      if (j < nv) {
        float vn[LV], uu[VEC];
#pragma unroll
        for (int i = 0; i < LV; ++i) vn[i] = EK ? ema(a.b2, vl[k][i], a.omb2, el[k][i]) : vl[k][i];
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const int li = LV == 1 ? 0 : i;
          if constexpr (LINE_BC) {
            uu[i] = precond(mm[k][i], b1l[k][li], vn[li], b2l[k][li], a.eps);
          } else {
            uu[i] = precond(mm[k][i], c1, vn[li], c2, a.eps);
          }
        }
        store_vec(a.u + (size_t)j * VEC, uu);
        if (EK && first[k]) store_vec(a.v_out + line[k], vn);
      }
    }
  }
}

template <int VEC, bool EK, int AXIS, bool LINE_BC>
void flat_index(const FlatArgs& a, bool wide, unsigned blocks, cudaStream_t s) {
  if (wide) {
    finalize_flat_kernel<VEC, EK, AXIS, unsigned long long, LINE_BC><<<blocks, kFlatThreads, 0, s>>>(a);
  } else {
    finalize_flat_kernel<VEC, EK, AXIS, unsigned, LINE_BC><<<blocks, kFlatThreads, 0, s>>>(a);
  }
}

template <int VEC, bool EK, bool LINE_BC>
void flat_axis(const FlatArgs& a, int axis, bool wide, unsigned blocks, cudaStream_t s) {
  if (axis == 1) {
    flat_index<VEC, EK, 1, LINE_BC>(a, wide, blocks, s);
  } else {
    flat_index<VEC, EK, 0, LINE_BC>(a, wide, blocks, s);
  }
}

template <int VEC, bool LINE_BC>
void flat_form(const FlatArgs& a, int axis, bool wide, unsigned blocks, cudaStream_t s) {
  if (a.ek != nullptr) {
    flat_axis<VEC, true, LINE_BC>(a, axis, wide, blocks, s);
  } else {
    flat_axis<VEC, false, LINE_BC>(a, axis, wide, blocks, s);
  }
}

template <int VEC>
void flat_bc(const FlatArgs& a, int axis, bool wide, unsigned blocks, cudaStream_t s) {
  if (a.bc1l != nullptr) {
    flat_form<VEC, true>(a, axis, wide, blocks, s);
  } else {
    flat_form<VEC, false>(a, axis, wide, blocks, s);
  }
}

}  // namespace

// m, u: contiguous f32 (batch, rows, cols). v, ek, v_out and bc1l, bc2l:
// contiguous f32 lines, (batch, rows, 1) for axis 1 and (batch, 1, cols) for
// axis 0; ek and v_out both set (ek form) or both null (owner form). bc1l
// and bc2l both set (the group form: bias corrections a line; count, bc1 and
// bc2 unused) or both null. Else count: a 0-d int32 (count_is64 = 0) or
// int64 (1) step count on the device, or null, and then bc1, bc2 are the
// bias corrections. omb2 = 1-b2 rounded by the caller. The plan is
// plan_finalize's: vec 4 needs cols % 4 == 0 and m, u (axis 0: also the
// lines) 16-byte aligned; wide for views of 2^31 elements or more; 1 <=
// blocks <= the vectors' tiles. Returns the cudaError_t of the launch.
extern "C" int repro_slim_finalize_flat(const float* m, const float* v, const float* ek, const float* bc1l,
                                        const float* bc2l, float* u, float* v_out, const void* count,
                                        int count_is64, float bc1, float bc2, float b1, float b2, float omb2,
                                        float eps, long long batch, long long rows, long long cols, int axis,
                                        int vec, int wide, long long blocks, void* stream) {
  if ((ek == nullptr) != (v_out == nullptr) || (bc1l == nullptr) != (bc2l == nullptr) || (vec != 1 && vec != 4) ||
      (axis != 0 && axis != 1) || cols % vec != 0 || blocks < 1 || blocks > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  FlatArgs a{m, v, ek, bc1l, bc2l, u, v_out, count, count_is64, bc1, bc2, b1, b2, omb2, eps, rows, cols,
             batch * rows * cols};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    flat_bc<4>(a, axis, wide != 0, (unsigned)blocks, s);
  } else {
    flat_bc<1>(a, axis, wide != 0, (unsigned)blocks, s);
  }
  return (int)cudaGetLastError();
}
