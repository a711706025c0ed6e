// Helpers shared by the port's CUDA kernels: f32/bf16 conversion, 16-byte
// vector loads, and the tile-local fused-row gather that both wavefront-0
// kernels end with (with the staging of its ELL entries in shared memory).
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

// Load kVec consecutive elements at p as f32 / store them from f32: one
// 16-byte (f32) or 8-byte (bf16) access when kVec is 4.
template <typename T, int kVec>
__device__ __forceinline__ void load_f32(const T* p, float (&out)[kVec]) {
  if constexpr (kVec == 1) {
    out[0] = to_f32(*p);
  } else {
    load_vec<T, kVec>(p, out);
  }
}
template <typename T, int kVec>
__device__ __forceinline__ void store_f32(T* p, const float (&in)[kVec]) {
  if constexpr (kVec == 1) {
    *p = from_f32<T>(in[0]);
  } else {
    store_vec<T, kVec>(p, in);
  }
}

// One ELL entry as the wavefront-0 kernels keep it in shared memory: x =
// the column times `scale` (for the fused rows, the byte offset of the
// named D1 row in the tile), y = the value's f32 bits.
template <typename T>
__device__ __forceinline__ int2 ell_entry(int col, T val, int scale) {
  return make_int2(col * scale, __float_as_int(to_f32(val)));
}

// Copy the n entries (cols, vals) of one tile into shared memory as
// ell_entry(col, val, scale), threads [tid, tid + nthreads) taking part;
// each thread issues 8 loads before it stores, so the latency of device
// memory is paid once per 8 entries.
template <typename T>
__device__ __forceinline__ void stage_entries(int2* ent, const int* cols,
                                              const T* vals, int n,
                                              int scale, int tid,
                                              int nthreads) {
  for (int base = tid; base < n; base += 8 * nthreads) {
    int c[8];
    T v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = base + i * nthreads;
      if (e < n) {
        c[i] = __ldg(cols + e);
        v[i] = vals[e];
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = base + i * nthreads;
      if (e < n) ent[e] = ell_entry(c[i], v[i], scale);
    }
  }
}

// Second stage of both wavefront-0 kernels, for one tile and one column
// block [cb0, cb0 + cb):
//   rows0[j, cb0 + jj] = sum_w vals0[j, w] * D1_t[cols0[j, w], jj]
// D1_t is the tile's f32 D1 block in shared memory at d1_s (row stride
// `ld` floats, a multiple of kVec), so the fused rows read D1 at f32, never
// the rounded copy written to d1.  ent0 holds the tile's (j0, w0) entries
// as ell_entry(col, val, ld * 4).  The warps [warp0, warp0 + n_warps) of
// the block share the rows: a row's columns go to consecutive lanes, kVec
// columns a lane (16-byte shared loads and a 16-byte or 8-byte store when
// kVec is 4), so the lanes of a 128-column row read one 512-byte D1 row per
// entry without bank conflicts; narrower blocks put 32 / lanes rows in a
// warp.  Each lane walks two rows at once, so twice the shared loads of a
// warp are in flight behind each entry's dependent D1 load.  rows0 points
// at the tile's (j0, c_col) block.
template <typename T, int kVec>
__device__ __forceinline__ void fused_rows_from_tile(
    const int2* __restrict__ ent0, const float* __restrict__ d1_s, int ld,
    T* __restrict__ rows0, int j0, int w0, int cb, int c_col, int cb0,
    int warp, int n_warps) {
  const int lane = threadIdx.x & 31;
  const int n_vec = (cb + kVec - 1) / kVec;  // kVec-wide column vectors
  const int lpr = n_vec < 32 ? n_vec : 32;   // lanes a row
  const int rpp = 32 / lpr;                  // rows a warp at once
  const int rr = lane / lpr;
  const int q = lane - rr * lpr;
  if (rr >= rpp) return;
  const int step = n_warps * rpp;
  const char* d1_b = reinterpret_cast<const char*>(d1_s);
  for (int ja = warp * rpp + rr; ja < j0; ja += 2 * step) {
    const int jb = ja + step < j0 ? ja + step : ja;  // ja again: not stored
    const int2* ea = ent0 + (int64_t)ja * w0;
    const int2* eb = ent0 + (int64_t)jb * w0;
    for (int vc = q; vc < n_vec; vc += lpr) {
      float acc[2][kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[0][i] = acc[1][i] = 0.f;
#pragma unroll 4
      for (int w = 0; w < w0; ++w) {
        const int2 e2[2] = {ea[w], eb[w]};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float v = __int_as_float(e2[r].y);
          const float* src =
              reinterpret_cast<const float*>(d1_b + e2[r].x) + vc * kVec;
          float x[kVec];
          if constexpr (kVec == 4) {
            const float4 f = *reinterpret_cast<const float4*>(src);
            x[0] = f.x;
            x[1] = f.y;
            x[2] = f.z;
            x[3] = f.w;
          } else {
#pragma unroll
            for (int i = 0; i < kVec; ++i) x[i] = src[i];
          }
#pragma unroll
          for (int i = 0; i < kVec; ++i) acc[r][i] = fmaf(v, x[i], acc[r][i]);
        }
      }
      store_f32<T, kVec>(rows0 + (int64_t)ja * c_col + cb0 + vc * kVec,
                         acc[0]);
      if (jb != ja)
        store_f32<T, kVec>(rows0 + (int64_t)jb * c_col + cb0 + vc * kVec,
                           acc[1]);
    }
  }
}

}  // namespace repro_torch
