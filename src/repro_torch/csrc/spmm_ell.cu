// Row-ELL SpMM for Hopper: out[i, :] = sum_w vals[i, w] * x[cols[i, w], :].
//
// Replaces the TPU kernel src/repro/kernels/spmm.py::_spmm_ell (its Pallas
// body _kernel).  That kernel stages all of X in VMEM and gathers rows with
// a one-hot (block_rows, n) matrix fed to the MXU, so its X is bounded by
// on-chip memory.  Here the gather is a plain row read from device memory
// through L2: nothing of X is staged and n is unbounded.
//
// Bound on the H100: bytes.  Each nonzero moves one row of X (c values) for
// 2c flops, far below the card's ~20 flops per byte of f32 balance.  The
// design therefore spends its effort on the loads: a group of `tpr` lanes
// owns one output row, each lane covers VEC consecutive columns with one
// 16-byte load, so a group reads a row of X as contiguous, coalesced
// segments; small c packs several rows into one warp instead of idling
// lanes.  Sums run in f32 registers over w in slot order; pad slots
// (col 0 / val 0) add 0 * x[0] exactly as the reference does.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
    spmm_ell_kernel(const int* __restrict__ cols, const T* __restrict__ vals,
                    const T* __restrict__ x, T* __restrict__ out,
                    int64_t n_rows, int w, int c, int tpr) {
  const int64_t g = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t row = g / tpr;
  const int lane = (int)(g - row * tpr);
  if (row >= n_rows) return;
  const int* cr = cols + row * w;
  const T* vr = vals + row * w;
  for (int j0 = lane * VEC; j0 < c; j0 += tpr * VEC) {
    float acc[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
    for (int k = 0; k < w; ++k) {
      const float v = to_f32(vr[k]);
      float xv[VEC];
      load_vec<T, VEC>(x + (int64_t)cr[k] * c + j0, xv);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] = fmaf(v, xv[i], acc[i]);
    }
    store_vec<T, VEC>(out + row * c + j0, acc);
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* cols, const void* vals, const void* x,
                   void* out, int64_t n_rows, int w, int c,
                   cudaStream_t stream) {
  // threads per row: enough lanes to cover c in VEC-wide loads, a power
  // of two up to one warp, so groups never straddle a warp
  const int per_row = (c + VEC - 1) / VEC;
  int tpr = 1;
  while (tpr < per_row && tpr < 32) tpr *= 2;
  const int64_t threads = n_rows * tpr;
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  spmm_ell_kernel<T, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const int*>(cols), static_cast<const T*>(vals),
      static_cast<const T*>(x), static_cast<T*>(out), n_rows, w, c, tpr);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* cols, const void* vals, const void* x,
                     void* out, int64_t n_rows, int w, int c,
                     cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (aligned && c % kVec == 0) {
    return launch<T, kVec>(cols, vals, x, out, n_rows, w, c, stream);
  }
  return launch<T, 1>(cols, vals, x, out, n_rows, w, c, stream);
}

}  // namespace
}  // namespace repro_torch

// cols (n_rows, w) int32, vals (n_rows, w) and x (n, c) of one dtype,
// out (n_rows, c) of that dtype; all contiguous.  Returns the cudaError_t
// of the launch (0 on success).
extern "C" int spmm_ell_launch(const void* cols, const void* vals,
                               const void* x, void* out, int64_t n_rows,
                               int w, int c, int dtype, void* stream) {
  using namespace repro_torch;
  if (n_rows == 0 || c == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    return (int)dispatch<float>(cols, vals, x, out, n_rows, w, c, s);
  }
  if (dtype == kBF16) {
    return (int)dispatch<__nv_bfloat16>(cols, vals, x, out, n_rows, w, c, s);
  }
  return (int)cudaErrorInvalidValue;
}
