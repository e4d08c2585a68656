// Pass 2 of the sharded psum pair: the SlimAdam preconditioner from a
// completed reduced moment, over a (B, R, C) canonical view.
//
// Replaces
//   * repro/kernels/slim_update.py:329 slim_finalize_batched (kernel bodies
//     _slim_finalize_kernel :314, launched :374, and _slim_apply_line_kernel
//     :323, launched :365): scalar bias corrections;
//   * repro/kernels/megaplan.py:536 mega_slim_finalize_batched (bodies
//     _mega_finalize_ek_kernel :522, launched :568, and
//     _mega_finalize_owner_kernel :530, launched :559): bias corrections per
//     line, one megaplan group in one launch.
// Per element of a reduction line (axis 1: a row; axis 0: a column), with
// the line's value read once:
//   ek form:    v' = b2*v + (1-b2)*ek   (ek the cross-rank completed line
//               mean of g^2), written once per line;
//   owner form: v' given (the all-reduce already delivered it);
//   u = (m'/bc1) / (sqrt(v'/bc2) + eps).
//
// Bound: bytes, 8 B per element (m' read, u written) plus 12-20 B per line.
// The work is elementwise, so the kernel only has to stream m' and u at the
// memory rate and read each line value once: the layouts of mega_slim.cu,
// one block per contiguous line (axis 1, float4 loads and stores where
// aligned) or a strip of kStrip columns per block with kRowThreads row
// threads (axis 0). In the ek form the block's first thread alone writes v'
// (every thread of the line computes the same value from the same operands).
// Operation order and the _rn intrinsics as in common.cuh, so u matches the
// plain twin bit for bit.
#include "common.cuh"

namespace {

using repro_torch::bc_at;
using repro_torch::ema;
using repro_torch::kRowThreads;
using repro_torch::kStrip;
using repro_torch::precond;

struct FinalizeArgs {
  const float* m;    // m' (batch, rows, cols)
  const float* v;    // stored (ek form) or completed (owner form) moment lines
  const float* ek;   // ek form: completed line means of g^2, else null
  const float* bc1;  // one scalar or one per line
  const float* bc2;
  float* u;
  float* v_out;      // ek form: v' lines, else null
  long long batch, rows, cols;
  float b2, omb2, eps;
};

template <bool EK>
__device__ __forceinline__ float line_moment(const FinalizeArgs& a, long long line) {
  if constexpr (EK) {
    return ema(a.b2, a.v[line], a.omb2, a.ek[line]);
  } else {
    return a.v[line];
  }
}

template <bool VEC, bool EK, bool SCALAR_BC>
__global__ void finalize_minor_kernel(FinalizeArgs a) {
  const long long line = blockIdx.x;
  const long long base = line * a.cols;
  const float v_new = line_moment<EK>(a, line);
  if (EK && threadIdx.x == 0) a.v_out[line] = v_new;
  const float c1 = bc_at<SCALAR_BC>(a.bc1, line);
  const float c2 = bc_at<SCALAR_BC>(a.bc2, line);
  if constexpr (VEC) {
    const float4* m4 = reinterpret_cast<const float4*>(a.m + base);
    float4* u4 = reinterpret_cast<float4*>(a.u + base);
    for (long long j = threadIdx.x; j < a.cols / 4; j += blockDim.x) {
      const float4 mm = m4[j];
      float4 uu;
      uu.x = precond(mm.x, c1, v_new, c2, a.eps);
      uu.y = precond(mm.y, c1, v_new, c2, a.eps);
      uu.z = precond(mm.z, c1, v_new, c2, a.eps);
      uu.w = precond(mm.w, c1, v_new, c2, a.eps);
      u4[j] = uu;
    }
  } else {
    for (long long j = threadIdx.x; j < a.cols; j += blockDim.x) {
      a.u[base + j] = precond(a.m[base + j], c1, v_new, c2, a.eps);
    }
  }
}

template <bool EK, bool SCALAR_BC>
__global__ void finalize_major_kernel(FinalizeArgs a) {
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const long long c = (long long)blockIdx.x * kStrip + tx;
  const long long b = blockIdx.y;
  if (c >= a.cols) return;
  const long long li = b * a.cols + c;
  const float v_new = line_moment<EK>(a, li);
  if (EK && ty == 0) a.v_out[li] = v_new;
  const float c1 = bc_at<SCALAR_BC>(a.bc1, li);
  const float c2 = bc_at<SCALAR_BC>(a.bc2, li);
  const long long slice = b * a.rows * a.cols;
  for (long long r = ty; r < a.rows; r += kRowThreads) {
    const long long i = slice + r * a.cols + c;
    a.u[i] = precond(a.m[i], c1, v_new, c2, a.eps);
  }
}

template <bool EK, bool SCALAR_BC>
void launch(const FinalizeArgs& a, int axis, cudaStream_t s) {
  if (axis == 1) {
    const bool vec = a.cols % 4 == 0 && repro_torch::aligned16(a.m) && repro_torch::aligned16(a.u);
    long long threads = (((vec ? a.cols / 4 : a.cols) + 31) / 32) * 32;
    if (threads > 1024) threads = 1024;
    if (threads < 32) threads = 32;
    const unsigned lines = (unsigned)(a.batch * a.rows);
    if (vec) {
      finalize_minor_kernel<true, EK, SCALAR_BC><<<lines, (unsigned)threads, 0, s>>>(a);
    } else {
      finalize_minor_kernel<false, EK, SCALAR_BC><<<lines, (unsigned)threads, 0, s>>>(a);
    }
  } else {
    dim3 grid((unsigned)((a.cols + kStrip - 1) / kStrip), (unsigned)a.batch);
    dim3 block(kStrip, kRowThreads);
    finalize_major_kernel<EK, SCALAR_BC><<<grid, block, 0, s>>>(a);
  }
}

}  // namespace

// m, u: contiguous f32 (batch, rows, cols). v, ek, v_out: contiguous f32
// lines, (batch, rows, 1) for axis 1 and (batch, 1, cols) for axis 0; ek and
// v_out both set (ek form) or both null (owner form). bc1, bc2: one f32 each
// (scalar_bc = 1, the per-leaf form) or lines like v (scalar_bc = 0, the
// group form). omb2 = 1-b2 rounded by the caller. The caller guarantees
// batch*rows < 2^31 (axis 1) and batch < 65536 (axis 0). Returns the
// cudaError_t of the launch.
extern "C" int repro_slim_finalize(const float* m, const float* v, const float* ek, const float* bc1,
                                   const float* bc2, float* u, float* v_out, long long batch, long long rows,
                                   long long cols, int axis, float b2, float omb2, float eps, int scalar_bc,
                                   void* stream) {
  if ((ek == nullptr) != (v_out == nullptr)) return (int)cudaErrorInvalidValue;
  FinalizeArgs a{m, v, ek, bc1, bc2, u, v_out, batch, rows, cols, b2, omb2, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ek != nullptr) {
    if (scalar_bc) {
      launch<true, true>(a, axis, s);
    } else {
      launch<true, false>(a, axis, s);
    }
  } else if (scalar_bc) {
    launch<false, true>(a, axis, s);
  } else {
    launch<false, false>(a, axis, s);
  }
  return (int)cudaGetLastError();
}
