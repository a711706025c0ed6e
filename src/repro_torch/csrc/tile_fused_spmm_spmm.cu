// Wavefront 0 of fused SpMM-SpMM for Hopper.  Per uniform tile v of t rows
// and per column block [cb0, cb0 + cb):
//   D1_t[k, cb] = sum_w op1_vals[v, k, w] * C[op1_cols[v, k, w], cb]
//                 + d1_spill[v*t + k, cb]                 (f32 accumulation)
//   d1[v*t + k, cb] = D1_t[k, cb]                         (operand dtype)
//   rows0[v, j, cb] = sum_w vals0[v, j, w] * D1_t[cols0[v, j, w], cb]
// op-1 columns are global rows of C; cols0 are tile-local rows of D1_t.
//
// Replaces the TPU kernel
// src/repro/kernels/tile_fused_spmm_spmm.py::_tile_fused_spmm_spmm_wf0 (its
// Pallas body _kernel).  That kernel stages all of C in VMEM and densifies
// the op-1 rows into a (t, n) one-hot matrix per grid step, so n is
// bounded by on-chip memory.  Here the op-1 stage gathers rows of C from
// device memory / L2 by the ELL columns, so n is unbounded; the fused rows
// are gathered from the block's f32 D1_t slice in shared memory, as in the
// GeMM-SpMM kernel.
//
// Bound on the H100: bytes.  Every op-1 nonzero moves a row segment of C
// for 2 flops per value.  Design: consecutive threads take consecutive
// columns of one D1 row, so each C row segment is read coalesced and the
// op-1 column/value loads are warp broadcasts; the host picks cb so that
// t * cb * 4 bytes of D1_t fit in the 227 KB of shared memory.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads) tile_fused_spmm_spmm_wf0_kernel(
    const int* __restrict__ op1_cols, const T* __restrict__ op1_vals,
    const T* __restrict__ d1_spill, const int* __restrict__ cols0,
    const T* __restrict__ vals0, const T* __restrict__ c, T* __restrict__ d1,
    T* __restrict__ rows0, int t, int w1, int c_col, int j0, int w0,
    int cb_max) {
  extern __shared__ float d1_s[];  // (t, cb)
  const int64_t v = blockIdx.x;
  const int cb0 = blockIdx.y * cb_max;
  const int cb = min(cb_max, c_col - cb0);

  for (int e = threadIdx.x; e < t * cb; e += kThreads) {
    const int k = e / cb;
    const int jj = e - k * cb;
    const int64_t row = v * t + k;
    const int* oc = op1_cols + row * w1;
    const T* ov = op1_vals + row * w1;
    float acc = 0.f;
    for (int w = 0; w < w1; ++w) {
      acc = fmaf(to_f32(ov[w]), to_f32(c[(int64_t)oc[w] * c_col + cb0 + jj]),
                 acc);
    }
    const int64_t g = row * c_col + cb0 + jj;
    acc += to_f32(d1_spill[g]);
    d1_s[e] = acc;
    d1[g] = from_f32<T>(acc);
  }
  __syncthreads();

  fused_rows_from_tile<T>(cols0 + v * j0 * w0, vals0 + v * j0 * w0, d1_s,
                          rows0 + v * j0 * c_col, j0, w0, cb, c_col, cb0);
}

template <typename T>
cudaError_t launch(const void* op1_cols, const void* op1_vals,
                   const void* d1_spill, const void* cols0, const void* vals0,
                   const void* c, void* d1, void* rows0, int n_tiles, int t,
                   int w1, int c_col, int j0, int w0, int cb,
                   cudaStream_t stream) {
  const size_t smem = (size_t)t * cb * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      tile_fused_spmm_spmm_wf0_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_tiles, (c_col + cb - 1) / cb);
  tile_fused_spmm_spmm_wf0_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const int*>(op1_cols), static_cast<const T*>(op1_vals),
      static_cast<const T*>(d1_spill), static_cast<const int*>(cols0),
      static_cast<const T*>(vals0), static_cast<const T*>(c),
      static_cast<T*>(d1), static_cast<T*>(rows0), t, w1, c_col, j0, w0, cb);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// op1_cols (n_tiles, t, w1) int32 global rows of C; op1_vals (n_tiles, t,
// w1), d1_spill (n_tiles * t, c_col), vals0 (n_tiles, j0, w0), c (n, c_col)
// of one dtype; cols0 (n_tiles, j0, w0) int32 tile-local; outputs
// d1 (n_tiles * t, c_col) and rows0 (n_tiles, j0, c_col) of that dtype; all
// contiguous.  cb: column block width chosen by the caller.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int tile_fused_spmm_spmm_wf0_launch(
    const void* op1_cols, const void* op1_vals, const void* d1_spill,
    const void* cols0, const void* vals0, const void* c, void* d1,
    void* rows0, int n_tiles, int t, int w1, int c_col, int j0, int w0,
    int cb, int dtype, void* stream) {
  using namespace repro_torch;
  if (n_tiles == 0 || c_col == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    return (int)launch<float>(op1_cols, op1_vals, d1_spill, cols0, vals0, c,
                              d1, rows0, n_tiles, t, w1, c_col, j0, w0, cb, s);
  }
  if (dtype == kBF16) {
    return (int)launch<__nv_bfloat16>(op1_cols, op1_vals, d1_spill, cols0,
                                      vals0, c, d1, rows0, n_tiles, t, w1,
                                      c_col, j0, w0, cb, s);
  }
  return (int)cudaErrorInvalidValue;
}
