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
// Here a block keeps its f32 D1_t in shared memory and gathers the fused
// rows straight from it: the intermediate never round-trips device memory
// before its consumers run, which is the point of the fusion.
//
// Bound on the H100: bytes.  At the GCN widths (b_col = c_col = 128, t =
// 64) a tile moves 64 KB of B and d1 and 28 KB of fused rows for 2 MFLOP;
// f32 as three TF32 products (below) needs 6.3 MFLOP of tensor-core work a
// tile, under a third of the time the bytes take at 3.35 TB/s.  Inside an
// SM the fused-row gather, which reads w0 rows of D1_t from shared memory
// per output row, is the busiest unit.
//
// Two device functions; the wrapper picks one by shape (never by failure)
// and the launcher records which one ran:
//
// tile_fused_gemm_spmm_wf0_wgmma_kernel (t a multiple of 64, b_col and
// c_col multiples of 8, C and two D1 tiles within shared memory).  A
// persistent grid of one block an SM, two warpgroups a block; each
// warpgroup walks its own tiles, so one warpgroup's gather runs under the
// other's products.
//   - C's column block is staged once per block, transposed to K-major and
//     128-byte swizzled, as the B operand of wgmma (TF32 takes K-major
//     operands only).  f32 stages it twice, as tf32 hi = rna(c) and lo =
//     rna(c - hi); bf16 once.
//   - B rows go from device memory straight into registers as the A operand
//     (16-byte loads, the next 64 rows issued before the current rows'
//     epilogue and gather, and the next tile's rows asked into L2 by one
//     bulk prefetch a tile earlier).  The k order inside each 128 bytes is
//     permuted so that a thread's fragment words are two 16-byte vectors;
//     C's staging applies the same permutation, so the sum is unchanged.
//   - f32: 3xTF32.  A is split in registers like C, and each 8-deep k step
//     issues m64nNk8 tf32 wgmmas for lo*hi, hi*lo, then hi*hi (lo*lo is
//     dropped), about f32 accuracy at the tensor cores' rate.  The steps go
//     in commit groups of 4, so that the split fragments of one group and
//     the accumulators fit the 255 registers without spilling (one group
//     of all 16 spilled and ran about 40 % slower on an H100;
//     benchmarks_torch/wf0_variants.py).
//     bf16: one m64nNk16 wgmma a step, one group.  N is 32 (c_col <= 32)
//     or 128 (zero-padded).
//   - The accumulators go to the warpgroup's f32 D1 tile in shared memory;
//     d1 is written from there with 16-byte vector stores and the fused
//     rows are gathered from it (common.cuh), their ELL entries prefetched
//     into registers during the previous tile's gather.
//
// tile_fused_gemm_spmm_wf0_kernel (any other shape, e.g. t = 2048): the
// first version, on the CUDA cores.  C[:, cb] is staged once per block as
// f32; each thread owns an RM x RN register tile of D1_t and reads B from
// device memory / L1; the host picks cb so that (t + b_col) * cb * 4 bytes
// and the tile's fused-row entries fit in shared memory.
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace repro_torch {
namespace {

// ------------------------------------------------------- wgmma path ----

constexpr int kWgThreads = 256;  // two warpgroups
constexpr int kPreEntries = 16;  // fused-row entries a thread prefetches

struct GemmArgs {
  const int* cols0;
  const void* vals0;
  const void* b;
  const void* c;
  void* d1;
  void* rows0;
  int n_tiles, t, b_col, c_col, j0, w0, cb_max;
};

template <int kN, int kKB, bool kSplit>
struct WgLayout {
  static constexpr int kPanel = kN * 128;  // 128 bytes of k for kN columns
  static constexpr int kCBytes = (kSplit ? 2 : 1) * kKB * kPanel;
  static constexpr int kLd = kN + 8;  // D1 row stride (floats): the float2
                                      // stores of the accumulators meet no
                                      // bank conflict beyond their two
                                      // wavefronts
};

// dynamic shared memory of the wgmma path: C (hi and lo for f32), then a
// D1 tile and an entry buffer for each warpgroup, plus alignment slack
inline size_t wgmma_smem_bytes(int n, int kb, bool f32, int t, int j0,
                               int w0) {
  return (size_t)(f32 ? 2 : 1) * kb * n * 128 + 2ull * t * (n + 8) * 4 +
         2ull * j0 * w0 * 8 + 1024;
}

__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(wg + 1) : "memory");
}

// word position p (0..31) inside a 128-byte k block of the K-major C tile
// that holds actual word m of the block: thread t4 of a quad loads words
// 4 t4 .. 4 t4 + 3 and 16 + 4 t4 .. 16 + 4 t4 + 3 of each B row, its
// register i serves k step i / 2, fragment word t4 + 4 (i % 2)
__device__ __forceinline__ int permuted_word(int m) {
  const int t4 = (m & 15) >> 2;
  const int i = (m & 3) + (m >= 16 ? 4 : 0);
  return 8 * (i >> 1) + t4 + 4 * (i & 1);
}

template <typename T, int kN, int kKB>
__global__ void __launch_bounds__(kWgThreads, 1)
    tile_fused_gemm_spmm_wf0_wgmma_kernel(const GemmArgs a) {
  constexpr bool kIsF32 = std::is_same<T, float>::value;
  using L = WgLayout<kN, kKB, kIsF32>;
  using W = WgmmaKMajorB<kN>;
  constexpr int kSteps = kKB * 4;  // 32-byte k steps
  // k steps a commit group takes: f32 splits each A fragment in two
  constexpr int kGroup = kIsF32 ? (kSteps < 4 ? kSteps : 4) : kSteps;
  constexpr int kAcc = kN / 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* c_hi = base;
  uint8_t* c_lo = base + kKB * L::kPanel;  // f32 only

  const int wg = threadIdx.x >> 7;
  const int wtid = threadIdx.x & 127;
  const int warp = wtid >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int n_ent = a.j0 * a.w0;
  float* d1_s = reinterpret_cast<float*>(base + L::kCBytes) +
                (size_t)wg * a.t * L::kLd;
  int2* ent_s = reinterpret_cast<int2*>(base + L::kCBytes +
                                        2ull * a.t * L::kLd * 4) +
                (size_t)wg * n_ent;
  const int cb0 = blockIdx.y * a.cb_max;
  const int cb = min(a.cb_max, a.c_col - cb0);
  const int row_bytes = a.b_col * (int)sizeof(T);
  const int ld_bytes = L::kLd * 4;
  const int m_blocks = a.t / 64;
  const int stride = 2 * gridDim.x;
  const T* vals0 = static_cast<const T*>(a.vals0);

  // A operand: rows r and r + 8 of this thread's 16-row warp slice
  uint32_t raw[kKB][8], raw8[kKB][8];
  auto load_a = [&](int tile, int mb) {
    const char* p0 = static_cast<const char*>(a.b) +
                     ((int64_t)tile * a.t + mb * 64 + warp * 16 + g) *
                         row_bytes;
    const char* p1 = p0 + 8 * (int64_t)row_bytes;
#pragma unroll
    for (int kb = 0; kb < kKB; ++kb) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int off = kb * 128 + h * 64 + t4 * 16;
        uint4 x0 = make_uint4(0, 0, 0, 0), x1 = x0;
        if (off < row_bytes) {
          x0 = __ldg(reinterpret_cast<const uint4*>(p0 + off));
          x1 = __ldg(reinterpret_cast<const uint4*>(p1 + off));
        }
        raw[kb][4 * h] = x0.x;
        raw[kb][4 * h + 1] = x0.y;
        raw[kb][4 * h + 2] = x0.z;
        raw[kb][4 * h + 3] = x0.w;
        raw8[kb][4 * h] = x1.x;
        raw8[kb][4 * h + 1] = x1.y;
        raw8[kb][4 * h + 2] = x1.z;
        raw8[kb][4 * h + 3] = x1.w;
      }
    }
  };

  // fused-row entries of a tile, prefetched into registers
  int pc[kPreEntries];
  T pv[kPreEntries];
  auto load_entries = [&](int tile) {
    const int* cols = a.cols0 + (int64_t)tile * n_ent;
    const T* vals = vals0 + (int64_t)tile * n_ent;
#pragma unroll
    for (int i = 0; i < kPreEntries; ++i) {
      const int e = wtid + 128 * i;
      if (e < n_ent) {
        pc[i] = __ldg(cols + e);
        pv[i] = vals[e];
      }
    }
  };
  auto store_entries = [&](int tile) {
#pragma unroll
    for (int i = 0; i < kPreEntries; ++i) {
      const int e = wtid + 128 * i;
      if (e < n_ent) ent_s[e] = ell_entry(pc[i], pv[i], ld_bytes);
    }
    constexpr int kPre = 128 * kPreEntries;
    if (n_ent > kPre)
      stage_entries(ent_s + kPre, a.cols0 + (int64_t)tile * n_ent + kPre,
                    vals0 + (int64_t)tile * n_ent + kPre, n_ent - kPre,
                    ld_bytes, wtid, 128);
  };

  // warpgroup w takes tiles 2 blockIdx.x + w + i stride
  int v = 2 * blockIdx.x + wg;
  if (v < a.n_tiles) {
    load_entries(v);
    load_a(v, 0);
  }

  // ---- C's column block, K-major and swizzled, once per block ----
  {
    const T* c = static_cast<const T*>(a.c);
    constexpr int kWords = kKB * 32;  // 32-bit words of k per column
    constexpr int kItems = kWords * (kN / 4);
    for (int it0 = threadIdx.x; it0 < kItems; it0 += 8 * kWgThreads) {
      float x[8][4], y[8][4];  // f32: rows k; bf16: rows 2 m and 2 m + 1
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int it = it0 + u * kWgThreads;
        const int m = it % kWords;
        const int n = 4 * (it / kWords);
        const int k = kIsF32 ? m : 2 * m;
#pragma unroll
        for (int i = 0; i < 4; ++i) x[u][i] = y[u][i] = 0.f;
        if (it < kItems && k < a.b_col && n < cb) {
          load_vec<T, 4>(c + (int64_t)k * a.c_col + cb0 + n, x[u]);
          if constexpr (!kIsF32)
            load_vec<T, 4>(c + (int64_t)(k + 1) * a.c_col + cb0 + n, y[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int it = it0 + u * kWgThreads;
        if (it >= kItems) continue;
        const int m = it % kWords;
        const int n = 4 * (it / kWords);
        const int p = permuted_word(m & 31);
        const int panel = (m >> 5) * L::kPanel;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int nn = n + i;
          const int off =
              panel + nn * 128 + (((p >> 2) ^ (nn & 7)) << 4) + (p & 3) * 4;
          if constexpr (kIsF32) {
            const uint32_t hi = to_tf32(x[u][i]);
            const uint32_t lo = to_tf32(x[u][i] - __uint_as_float(hi));
            *reinterpret_cast<uint32_t*>(c_hi + off) = hi;
            *reinterpret_cast<uint32_t*>(c_lo + off) = lo;
          } else {
            const __nv_bfloat162 w2 =
                __floats2bfloat162_rn(x[u][i], y[u][i]);  // exact: bf16 in
            *reinterpret_cast<__nv_bfloat162*>(c_hi + off) = w2;
          }
        }
      }
    }
  }
  fence_proxy_async();  // generic-proxy stores, read by wgmma
  __syncthreads();
  // descriptors of C's panels: the base's plus the byte offset / 16
  const uint64_t desc_hi = desc(c_hi, 16, 1024);
  const uint64_t desc_lo = desc(c_lo, 16, 1024);

  for (; v < a.n_tiles; v += stride) {
    if (wtid == 0 && v + stride < a.n_tiles)  // the next tile's B, into L2
      prefetch_l2(static_cast<const char*>(a.b) +
                      (int64_t)(v + stride) * a.t * row_bytes,
                  (uint32_t)(a.t * row_bytes));
    store_entries(v);
    for (int mb = 0; mb < m_blocks; ++mb) {
      float acc[kAcc];
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
      // k steps in groups of kGroup: a group's A fragments (hi and lo for
      // f32) are made before its wgmmas and held until they retire, so at
      // most 8 kGroup registers of A are live beside the accumulators
#pragma unroll
      for (int g0 = 0; g0 < kSteps; g0 += kGroup) {
        // k step ks uses words 2 s, 2 s + 1 of block kb = ks / 4, s = ks %
        // 4, for rows r and r + 8
        uint32_t ah[kGroup][4], al[kGroup][4];
#pragma unroll
        for (int gs = 0; gs < kGroup; ++gs) {
          const int kb = (g0 + gs) >> 2, s = (g0 + gs) & 3;
          const uint32_t w[4] = {raw[kb][2 * s], raw8[kb][2 * s],
                                 raw[kb][2 * s + 1], raw8[kb][2 * s + 1]};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if constexpr (kIsF32) {
              const float x = __uint_as_float(w[i]);
              ah[gs][i] = to_tf32(x);
              al[gs][i] = to_tf32(x - __uint_as_float(ah[gs][i]));
            } else {
              ah[gs][i] = w[i];
            }
          }
        }
        wgmma_fence();
#pragma unroll
        for (int gs = 0; gs < kGroup; ++gs) {
          const int ks = g0 + gs;
          const int off = ((ks >> 2) * L::kPanel + (ks & 3) * 32) >> 4;
          const uint64_t dh = desc_hi + off;
          if constexpr (kIsF32) {
            const uint64_t dl = desc_lo + off;
            W::tf32(acc, al[gs], dh, ks > 0);
            W::tf32(acc, ah[gs], dl, true);
            W::tf32(acc, ah[gs], dh, true);
          } else {
            W::bf16(acc, ah[gs], dh, ks > 0);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        pin(acc);
#pragma unroll
        for (int gs = 0; gs < kGroup; ++gs) {
          pin(ah[gs]);
          if constexpr (kIsF32) pin(al[gs]);
        }
      }
      // the next 64 rows of B load under this epilogue and the gather
      if (mb + 1 < m_blocks)
        load_a(v, mb + 1);
      else if (v + stride < a.n_tiles)
        load_a(v + stride, 0);
      // accumulators: element 4 n + 2 r + e is (row g + 8 r, column
      // 8 n + 2 t4 + e) of the warp's 16 rows
#pragma unroll
      for (int nn = 0; nn < kN / 8; ++nn) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = mb * 64 + warp * 16 + g + 8 * r;
          *reinterpret_cast<float2*>(d1_s + row * L::kLd + 8 * nn + 2 * t4) =
              make_float2(acc[4 * nn + 2 * r], acc[4 * nn + 2 * r + 1]);
        }
      }
    }
    warpgroup_sync(wg);
    if (v + stride < a.n_tiles) load_entries(v + stride);

    // d1 in the operand dtype, 16-byte rows of the f32 tile
    {
      const int n_vec = cb / 4;
      const int lpr = n_vec < 32 ? n_vec : 32;
      const int rpp = 32 / lpr;
      const int rr = lane / lpr;
      const int q = lane - rr * lpr;
      T* d1 = static_cast<T*>(a.d1) + (int64_t)v * a.t * a.c_col + cb0;
      if (rr < rpp) {
        for (int r = warp * rpp + rr; r < a.t; r += 4 * rpp) {
          for (int vc = q; vc < n_vec; vc += lpr) {
            const float4 f =
                *reinterpret_cast<const float4*>(d1_s + r * L::kLd + 4 * vc);
            const float x[4] = {f.x, f.y, f.z, f.w};
            store_f32<T, 4>(d1 + (int64_t)r * a.c_col + 4 * vc, x);
          }
        }
      }
    }
    fused_rows_from_tile<T, 4>(
        ent_s, d1_s, L::kLd,
        static_cast<T*>(a.rows0) + (int64_t)v * a.j0 * a.c_col, a.j0, a.w0,
        cb, a.c_col, cb0, warp, 4);
    warpgroup_sync(wg);  // d1_s and ent_s are free for the next tile
  }
}

int g_last_path = -1;  // 0: wgmma kernel, 1: CUDA-core kernel

template <typename T, int kN, int kKB>
cudaError_t launch_wgmma(const GemmArgs& a, cudaStream_t stream) {
  const size_t smem = wgmma_smem_bytes(kN, kKB, std::is_same<T, float>::value,
                                       a.t, a.j0, a.w0);
  auto kern = tile_fused_gemm_spmm_wf0_wgmma_kernel<T, kN, kKB>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, kWgThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int n_cb = (a.c_col + a.cb_max - 1) / a.cb_max;
  const int want = (a.n_tiles + 1) / 2;  // two warpgroups a block
  const int fit = n_sm * per_sm / n_cb > 0 ? n_sm * per_sm / n_cb : 1;
  const dim3 grid(want < fit ? want : fit, n_cb);
  kern<<<grid, kWgThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int kN>
cudaError_t launch_wgmma_kb(const GemmArgs& a, cudaStream_t stream) {
  const int kb = (a.b_col * (int)sizeof(T) + 127) / 128;
  if (kb <= 1) return launch_wgmma<T, kN, 1>(a, stream);
  if (kb <= 2) return launch_wgmma<T, kN, 2>(a, stream);
  if (kb <= 4) return launch_wgmma<T, kN, 4>(a, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_wgmma_n(const GemmArgs& a, cudaStream_t stream) {
  // the wrapper's rule (kernels/tile_fused_gemm_spmm.py::choose_path)
  const int kb = (a.b_col * (int)sizeof(T) + 127) / 128;
  const int n = a.c_col <= 32 ? 32 : 128;
  const int kb_t = kb <= 2 ? kb : 4;
  if (a.t % 64 || a.b_col % 8 || a.c_col % 8 || kb > 4 ||
      a.cb_max != (a.c_col < 128 ? a.c_col : 128) ||
      wgmma_smem_bytes(n, kb_t, std::is_same<T, float>::value, a.t, a.j0,
                       a.w0) > 232448 ||
      !aligned16(a.b) || !aligned16(a.c) || !aligned16(a.d1) ||
      !aligned16(a.rows0))
    return cudaErrorInvalidValue;
  if (n == 32) return launch_wgmma_kb<T, 32>(a, stream);
  return launch_wgmma_kb<T, 128>(a, stream);
}

// --------------------------------------------------- CUDA-core path ----

constexpr int kThreads = 256;
constexpr int kRM = 8;  // D1 rows per thread and pass
constexpr int kRN = 4;  // D1 columns per thread

// bytes of the C and D1 blocks, rounded so the entries that follow them
// are 16-byte aligned
__host__ __device__ inline size_t core_tile_bytes(int t, int b_col, int cb) {
  return ((size_t)(b_col + t) * cb * sizeof(float) + 15) & ~size_t(15);
}

template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads) tile_fused_gemm_spmm_wf0_kernel(
    const int* __restrict__ cols0, const T* __restrict__ vals0,
    const T* __restrict__ b, const T* __restrict__ c, T* __restrict__ d1,
    T* __restrict__ rows0, int t, int b_col, int c_col, int j0, int w0,
    int cb_max) {
  extern __shared__ __align__(16) float smem[];
  const int64_t v = blockIdx.x;
  const int cb0 = blockIdx.y * cb_max;
  const int cb = min(cb_max, c_col - cb0);
  float* c_s = smem;                             // (b_col, cb)
  float* d1_s = smem + (int64_t)b_col * cb_max;  // (t, cb)
  int2* ent_s = reinterpret_cast<int2*>(
      reinterpret_cast<char*>(smem) + core_tile_bytes(t, b_col, cb_max));

  stage_entries(ent_s, cols0 + v * j0 * w0, vals0 + v * j0 * w0, j0 * w0,
                cb_max * (int)sizeof(float), (int)threadIdx.x, kThreads);
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
            d1_s[r * cb_max + jj] = acc[m][n];
            d1[(v * t + r) * c_col + cb0 + jj] = from_f32<T>(acc[m][n]);
          }
        }
      }
    }
  }
  __syncthreads();

  fused_rows_from_tile<T, kVec>(ent_s, d1_s, cb_max, rows0 + v * j0 * c_col,
                                j0, w0, cb, c_col, cb0, threadIdx.x >> 5,
                                kThreads / 32);
}

template <typename T, int kVec>
cudaError_t launch_core_vec(const GemmArgs& a, cudaStream_t stream) {
  const size_t smem =
      core_tile_bytes(a.t, a.b_col, a.cb_max) + (size_t)a.j0 * a.w0 * 8;
  auto kern = tile_fused_gemm_spmm_wf0_kernel<T, kVec>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.n_tiles, (a.c_col + a.cb_max - 1) / a.cb_max);
  kern<<<grid, kThreads, smem, stream>>>(
      a.cols0, static_cast<const T*>(a.vals0), static_cast<const T*>(a.b),
      static_cast<const T*>(a.c), static_cast<T*>(a.d1),
      static_cast<T*>(a.rows0), a.t, a.b_col, a.c_col, a.j0, a.w0, a.cb_max);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_core(const GemmArgs& a, cudaStream_t stream) {
  // 4-wide fused-row vectors where every row of D1_t and rows0 starts on
  // a vector boundary
  const uintptr_t align = 4 * sizeof(T);
  if (a.cb_max % 4 == 0 && a.c_col % 4 == 0 &&
      reinterpret_cast<uintptr_t>(a.rows0) % align == 0)
    return launch_core_vec<T, 4>(a, stream);
  return launch_core_vec<T, 1>(a, stream);
}

}  // namespace
}  // namespace repro_torch

// cols0 (n_tiles, j0, w0) int32 tile-local; vals0 (n_tiles, j0, w0),
// b (n_tiles * t, b_col), c (b_col, c_col) of one dtype; outputs
// d1 (n_tiles * t, c_col) and rows0 (n_tiles, j0, c_col) of that dtype; all
// contiguous.  cb: column block width; path: 0 for the wgmma kernel (cb =
// min(c_col, 128); the shape must satisfy the wrapper's rule), 1 for the
// CUDA-core kernel (cb chosen by the caller to fit shared memory).  Returns
// the cudaError_t of the launch (0 on success; cudaErrorInvalidValue for a
// shape the chosen path does not take).
extern "C" int tile_fused_gemm_spmm_wf0_launch(
    const void* cols0, const void* vals0, const void* b, const void* c,
    void* d1, void* rows0, int n_tiles, int t, int b_col, int c_col, int j0,
    int w0, int cb, int path, int dtype, void* stream) {
  using namespace repro_torch;
  if (n_tiles == 0 || c_col == 0) {
    g_last_path = -1;
    return (int)cudaSuccess;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const GemmArgs a{static_cast<const int*>(cols0), vals0, b, c, d1, rows0,
                   n_tiles, t, b_col, c_col, j0, w0, cb};
  if ((dtype != kF32 && dtype != kBF16) || (path != 0 && path != 1))
    return (int)cudaErrorInvalidValue;
  g_last_path = path;
  if (path == 0)
    return (int)(dtype == kF32 ? launch_wgmma_n<float>(a, s)
                               : launch_wgmma_n<__nv_bfloat16>(a, s));
  return (int)(dtype == kF32 ? launch_core<float>(a, s)
                             : launch_core<__nv_bfloat16>(a, s));
}

// the path of the last launch: 0 wgmma kernel, 1 CUDA-core kernel, -1 none
// (before any launch, or an empty one)
extern "C" int tile_fused_gemm_spmm_wf0_last_path() {
  return repro_torch::g_last_path;
}
