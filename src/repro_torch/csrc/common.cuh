// Helpers shared by the port's CUDA kernels: f32/bf16 conversion, 16-byte
// vector loads, and the tile-local fused-row gather that both wavefront-0
// kernels end with.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

// dtype codes passed by the Python wrappers
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch casts
}

// VEC consecutive elements moved as one aligned load/store (16 bytes when
// VEC * sizeof(T) == 16).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[VEC]) {
  const Pack<T, VEC> pk = *reinterpret_cast<const Pack<T, VEC>*>(p);
#pragma unroll
  for (int i = 0; i < VEC; ++i) out[i] = to_f32(pk.v[i]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&in)[VEC]) {
  Pack<T, VEC> pk;
#pragma unroll
  for (int i = 0; i < VEC; ++i) pk.v[i] = from_f32<T>(in[i]);
  *reinterpret_cast<Pack<T, VEC>*>(p) = pk;
}

// Second stage of both wavefront-0 kernels, for one tile and one column
// block [cb0, cb0 + cb):
//   rows0[j, cb0 + jj] = sum_w vals0[j, w] * d1_s[cols0[j, w] * cb + jj]
// d1_s is the tile's f32 D1 block in shared memory (row stride cb), so the
// fused rows read D1 at f32, never the rounded copy written to d1.  cols0,
// vals0 and rows0 point at the tile's own (j0, w0) / (j0, c_col) blocks.
// Consecutive threads take consecutive columns of one fused row: the
// shared-memory reads are conflict-free and the row store is coalesced.
template <typename T>
__device__ __forceinline__ void fused_rows_from_tile(
    const int* __restrict__ cols0, const T* __restrict__ vals0,
    const float* __restrict__ d1_s, T* __restrict__ rows0, int j0, int w0,
    int cb, int c_col, int cb0) {
  for (int e = threadIdx.x; e < j0 * cb; e += blockDim.x) {
    const int j = e / cb;
    const int jj = e - j * cb;
    const int* cj = cols0 + (int64_t)j * w0;
    const T* vj = vals0 + (int64_t)j * w0;
    float acc = 0.f;
    for (int w = 0; w < w0; ++w) {
      acc = fmaf(to_f32(vj[w]), d1_s[cj[w] * cb + jj], acc);
    }
    rows0[(int64_t)j * c_col + cb0 + jj] = from_f32<T>(acc);
  }
}

}  // namespace repro_torch
