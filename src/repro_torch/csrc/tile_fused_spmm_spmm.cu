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
// are gathered from the block's f32 D1_t in shared memory by the stage the
// GeMM-SpMM kernel shares (common.cuh).
//
// Bound on the H100: bytes.  Every op-1 nonzero moves a row segment of C
// for 2 flops per value; over a banded graph the w1 rows a tile names
// overlap, so most of the gathered rows come from L2, and L2 bandwidth
// paces the op-1 stage.  d1_spill is dense (T0 * t, c_col) and read whole,
// though only the rows that spill lanes touch are non-zero.
//
// Design: one block a (tile, column block), two blocks an SM.  The block
// first copies its op-1 entries and fused-row entries into shared memory
// (8 loads in flight a thread), then each warp takes D1 rows: a row's
// columns go to consecutive lanes, 4 a lane (16-byte loads of C and of
// d1_spill for f32, 8-byte for bf16), and a lane issues the gathers of up
// to 16 entries (and the row's spill) before its first FMA, so many loads
// are in flight per warp.  D1_t is kept in shared memory in f32 and written
// to d1 in the operand dtype; the fused rows follow after one barrier.
// Rows or widths that are not multiples of 4 columns (or unaligned
// operands) take the same code one column a lane.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kGather = 16;  // op-1 gathers a lane issues before its FMAs

// bytes of the D1 block, rounded so the entries that follow it are 16-byte
// aligned
__host__ __device__ inline size_t d1_tile_bytes(int t, int cb) {
  return ((size_t)t * cb * sizeof(float) + 15) & ~size_t(15);
}

template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads, 2) tile_fused_spmm_spmm_wf0_kernel(
    const int* __restrict__ op1_cols, const T* __restrict__ op1_vals,
    const T* __restrict__ d1_spill, const int* __restrict__ cols0,
    const T* __restrict__ vals0, const T* __restrict__ c, T* __restrict__ d1,
    T* __restrict__ rows0, int t, int w1, int c_col, int j0, int w0,
    int cb_max) {
  extern __shared__ __align__(16) float d1_s[];  // (t, cb_max)
  int2* ent1 = reinterpret_cast<int2*>(reinterpret_cast<char*>(d1_s) +
                                       d1_tile_bytes(t, cb_max));
  int2* ent0 = ent1 + t * w1;
  const int64_t v = blockIdx.x;
  const int cb0 = blockIdx.y * cb_max;
  const int cb = min(cb_max, c_col - cb0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  stage_entries(ent1, op1_cols + v * t * w1, op1_vals + v * t * w1, t * w1, 1,
                (int)threadIdx.x, kThreads);
  stage_entries(ent0, cols0 + v * j0 * w0, vals0 + v * j0 * w0, j0 * w0,
                cb_max * (int)sizeof(float), (int)threadIdx.x, kThreads);
  __syncthreads();

  // ---- op-1: D1_t rows, a row's columns across the lanes of a warp ----
  const int n_vec = (cb + kVec - 1) / kVec;
  const int lpr = n_vec < 32 ? n_vec : 32;  // lanes a row
  const int rpp = 32 / lpr;                 // rows a warp at once
  const int rr = lane / lpr;
  const int q = lane - rr * lpr;
  if (rr < rpp) {
    for (int k = warp * rpp + rr; k < t; k += (kThreads / 32) * rpp) {
      const int64_t row = v * t + k;
      const int2* e = ent1 + k * w1;
      for (int vc = q; vc < n_vec; vc += lpr) {
        const int col = cb0 + vc * kVec;
        float acc[kVec];
        load_f32<T, kVec>(d1_spill + row * c_col + col, acc);
        for (int wb = 0; wb < w1; wb += kGather) {
          float x[kGather][kVec];
          float val[kGather];
#pragma unroll
          for (int u = 0; u < kGather; ++u) {
            val[u] = 0.f;
            if (wb + u < w1) {
              const int2 ew = e[wb + u];
              val[u] = __int_as_float(ew.y);
              load_f32<T, kVec>(c + (int64_t)ew.x * c_col + col, x[u]);
            }
          }
#pragma unroll
          for (int u = 0; u < kGather; ++u) {
            if (wb + u < w1) {
#pragma unroll
              for (int i = 0; i < kVec; ++i)
                acc[i] = fmaf(val[u], x[u][i], acc[i]);
            }
          }
        }
        float* dst = d1_s + k * cb_max + vc * kVec;
#pragma unroll
        for (int i = 0; i < kVec; ++i) dst[i] = acc[i];
        store_f32<T, kVec>(d1 + row * c_col + col, acc);
      }
    }
  }
  __syncthreads();

  fused_rows_from_tile<T, kVec>(ent0, d1_s, cb_max, rows0 + v * j0 * c_col,
                                j0, w0, cb, c_col, cb0, warp, kThreads / 32);
}

template <typename T, int kVec>
cudaError_t launch_vec(const void* op1_cols, const void* op1_vals,
                       const void* d1_spill, const void* cols0,
                       const void* vals0, const void* c, void* d1,
                       void* rows0, int n_tiles, int t, int w1, int c_col,
                       int j0, int w0, int cb, cudaStream_t stream) {
  const size_t smem =
      d1_tile_bytes(t, cb) + ((size_t)t * w1 + (size_t)j0 * w0) * 8;
  auto kern = tile_fused_spmm_spmm_wf0_kernel<T, kVec>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_tiles, (c_col + cb - 1) / cb);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const int*>(op1_cols), static_cast<const T*>(op1_vals),
      static_cast<const T*>(d1_spill), static_cast<const int*>(cols0),
      static_cast<const T*>(vals0), static_cast<const T*>(c),
      static_cast<T*>(d1), static_cast<T*>(rows0), t, w1, c_col, j0, w0, cb);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* op1_cols, const void* op1_vals,
                   const void* d1_spill, const void* cols0, const void* vals0,
                   const void* c, void* d1, void* rows0, int n_tiles, int t,
                   int w1, int c_col, int j0, int w0, int cb,
                   cudaStream_t stream) {
  // 4 columns a lane where every row of C, d1_spill, d1, rows0 and D1_t
  // starts on a 4-element boundary
  const uintptr_t align = 4 * sizeof(T);
  const bool vec = cb % 4 == 0 && c_col % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(c) % align == 0 &&
                   reinterpret_cast<uintptr_t>(d1_spill) % align == 0 &&
                   reinterpret_cast<uintptr_t>(d1) % align == 0 &&
                   reinterpret_cast<uintptr_t>(rows0) % align == 0;
  if (vec)
    return launch_vec<T, 4>(op1_cols, op1_vals, d1_spill, cols0, vals0, c, d1,
                            rows0, n_tiles, t, w1, c_col, j0, w0, cb, stream);
  return launch_vec<T, 1>(op1_cols, op1_vals, d1_spill, cols0, vals0, c, d1,
                          rows0, n_tiles, t, w1, c_col, j0, w0, cb, stream);
}

}  // namespace
}  // namespace repro_torch

// op1_cols (n_tiles, t, w1) int32 global rows of C; op1_vals (n_tiles, t,
// w1), d1_spill (n_tiles * t, c_col), vals0 (n_tiles, j0, w0), c (n, c_col)
// of one dtype; cols0 (n_tiles, j0, w0) int32 tile-local; outputs
// d1 (n_tiles * t, c_col) and rows0 (n_tiles, j0, c_col) of that dtype; all
// contiguous.  cb: column block width chosen by the caller, so that the f32
// D1 block and the tile's entries fit in shared memory.  Returns the
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
