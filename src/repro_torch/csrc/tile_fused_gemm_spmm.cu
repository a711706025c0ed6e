// Wavefront 0 of fused GeMM-SpMM for Hopper.  Per uniform tile v of t rows
// and per column block [cb0, cb0 + cb):
//   D1_t[:, cb] = B[v*t:(v+1)*t, :] @ C[:, cb]          (f32 accumulation)
//   d1[v*t + r, cb]    = D1_t[r, cb]                    (operand dtype)
//   rows0[v, j, cb]    = sum_w vals0[v, j, w] * D1_t[cols0[v, j, w], cb]
// with tile-local columns, read from the f32 D1_t.
//
// Replaces the TPU kernel
// src/repro/kernels/tile_fused_gemm_spmm.py::_tile_fused_gemm_spmm_wf0 (its
// Pallas body _kernel).  There the fused rows densify the tile-local ELL
// into a (j0_max, t) one-hot matrix and multiply it with D1_t on the MXU.
// Here the block keeps its f32 D1_t slice in shared memory and gathers the
// fused rows straight from it after one __syncthreads(): the intermediate
// never round-trips device memory before its consumers run, which is the
// point of the fusion.
//
// Bound on the H100: at the GCN widths (b_col = 128) the GeMM does 256 flops
// per B row of 512 bytes, so bytes and f32 FMA throughput are close; this
// first version runs the product on the CUDA cores (no wgmma), so the FMA
// pipe bounds it.  Design: C[:, cb] is staged once per block in shared
// memory as f32; each thread owns an RM x RN register tile of D1_t (rows
// strided by the row groups, columns strided by the column groups, so
// neighbouring lanes touch neighbouring columns), reads B from device
// memory / L1 (every lane of a column group shares the B row: broadcast
// loads) and C from shared memory.  The host picks cb so that
// (t + b_col) * cb * 4 bytes fit in the 227 KB of shared memory.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kRM = 8;  // D1 rows per thread and pass
constexpr int kRN = 4;  // D1 columns per thread

template <typename T>
__global__ void __launch_bounds__(kThreads) tile_fused_gemm_spmm_wf0_kernel(
    const int* __restrict__ cols0, const T* __restrict__ vals0,
    const T* __restrict__ b, const T* __restrict__ c, T* __restrict__ d1,
    T* __restrict__ rows0, int t, int b_col, int c_col, int j0, int w0,
    int cb_max) {
  extern __shared__ float smem[];
  const int64_t v = blockIdx.x;
  const int cb0 = blockIdx.y * cb_max;
  const int cb = min(cb_max, c_col - cb0);
  float* c_s = smem;                             // (b_col, cb)
  float* d1_s = smem + (int64_t)b_col * cb_max;  // (t, cb)

  for (int e = threadIdx.x; e < b_col * cb; e += kThreads) {
    const int k = e / cb;
    const int jj = e - k * cb;
    c_s[e] = to_f32(c[(int64_t)k * c_col + cb0 + jj]);
  }
  __syncthreads();

  const int ncg = (cb + kRN - 1) / kRN;  // column groups
  const int nrg = kThreads / ncg;        // row groups
  const int cg = threadIdx.x % ncg;
  const int rg = threadIdx.x / ncg;
  const T* b_t = b + v * t * b_col;
  if (rg < nrg) {
    for (int r0 = 0; r0 < t; r0 += nrg * kRM) {
      float acc[kRM][kRN];
      const T* brow[kRM];
#pragma unroll
      for (int m = 0; m < kRM; ++m) {
        const int r = r0 + rg + m * nrg;
        brow[m] = b_t + (int64_t)(r < t ? r : 0) * b_col;  // r >= t: unused
#pragma unroll
        for (int n = 0; n < kRN; ++n) acc[m][n] = 0.f;
      }
      for (int k = 0; k < b_col; ++k) {
        float bv[kRM];
        float cv[kRN];
#pragma unroll
        for (int m = 0; m < kRM; ++m) bv[m] = to_f32(brow[m][k]);
#pragma unroll
        for (int n = 0; n < kRN; ++n) {
          const int jj = cg + n * ncg;
          cv[n] = jj < cb ? c_s[k * cb + jj] : 0.f;
        }
#pragma unroll
        for (int m = 0; m < kRM; ++m) {
#pragma unroll
          for (int n = 0; n < kRN; ++n) acc[m][n] = fmaf(bv[m], cv[n], acc[m][n]);
        }
      }
#pragma unroll
      for (int m = 0; m < kRM; ++m) {
        const int r = r0 + rg + m * nrg;
        if (r >= t) continue;
#pragma unroll
        for (int n = 0; n < kRN; ++n) {
          const int jj = cg + n * ncg;
          if (jj < cb) {
            d1_s[r * cb + jj] = acc[m][n];
            d1[(v * t + r) * c_col + cb0 + jj] = from_f32<T>(acc[m][n]);
          }
        }
      }
    }
  }
  __syncthreads();

  fused_rows_from_tile<T>(cols0 + v * j0 * w0, vals0 + v * j0 * w0, d1_s,
                          rows0 + v * j0 * c_col, j0, w0, cb, c_col, cb0);
}

template <typename T>
cudaError_t launch(const void* cols0, const void* vals0, const void* b,
                   const void* c, void* d1, void* rows0, int n_tiles, int t,
                   int b_col, int c_col, int j0, int w0, int cb,
                   cudaStream_t stream) {
  const size_t smem = (size_t)(b_col + t) * cb * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      tile_fused_gemm_spmm_wf0_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_tiles, (c_col + cb - 1) / cb);
  tile_fused_gemm_spmm_wf0_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const int*>(cols0), static_cast<const T*>(vals0),
      static_cast<const T*>(b), static_cast<const T*>(c), static_cast<T*>(d1),
      static_cast<T*>(rows0), t, b_col, c_col, j0, w0, cb);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// cols0 (n_tiles, j0, w0) int32 tile-local; vals0 (n_tiles, j0, w0),
// b (n_tiles * t, b_col), c (b_col, c_col) of one dtype; outputs
// d1 (n_tiles * t, c_col) and rows0 (n_tiles, j0, c_col) of that dtype; all
// contiguous.  cb: column block width chosen by the caller.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int tile_fused_gemm_spmm_wf0_launch(
    const void* cols0, const void* vals0, const void* b, const void* c,
    void* d1, void* rows0, int n_tiles, int t, int b_col, int c_col, int j0,
    int w0, int cb, int dtype, void* stream) {
  using namespace repro_torch;
  if (n_tiles == 0 || c_col == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    return (int)launch<float>(cols0, vals0, b, c, d1, rows0, n_tiles, t,
                              b_col, c_col, j0, w0, cb, s);
  }
  if (dtype == kBF16) {
    return (int)launch<__nv_bfloat16>(cols0, vals0, b, c, d1, rows0, n_tiles,
                                      t, b_col, c_col, j0, w0, cb, s);
  }
  return (int)cudaErrorInvalidValue;
}
