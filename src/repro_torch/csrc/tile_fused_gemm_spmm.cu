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
// Three device functions; the wrapper picks one by shape (never by
// failure) and the launcher records which one ran:
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
// tile_fused_gemm_spmm_wf0_wgmma_wide_kernel (the same rule, for B rows
// over 512 bytes: the sparse-band LM mixer at b_col 2048, the hetero stack
// at b_col 1024).  Bound by operations there: at the band (t 64, 32
// tiles, b_col = c_col = 2048) 17.2 GFLOP, as 3xTF32 0.104 ms at 495
// TFLOP/s, against 67 MB of bytes (0.02 ms).  C's whole column block no
// longer fits beside the D1 tiles, so k is streamed:
//   - a pre-pass (tile_fused_gemm_spmm_wf0_c_panels_kernel) writes each
//     128-column block of C and 128 bytes of k (32 f32 / 64 bf16 rows) as
//     one ring stage in a scratch buffer the wrapper allocates: the
//     K-major, swizzled, permuted panel the narrow kernel stages, as tf32
//     hi then lo for f32 (2 b_col c_col 4 bytes: 32 MiB at the band);
//   - a persistent grid of one block an SM walks items (a pair of tiles,
//     a column block): the two warpgroups take the two tiles, so each C
//     chunk feeds both.  Warp 0 refills a ring of kWideStages stages with
//     one bulk copy a chunk (full / empty mbarriers, every wait bounded);
//     B rows go from device memory into registers a chunk ahead, and are
//     split into tf32 hi and lo there (B is never copied: 3.83 GB at the
//     hetero stack);
//   - per 128-byte chunk, four k steps of m64n128k8 tf32 wgmmas (lo*hi,
//     hi*lo, hi*hi, as above) or of m64n128k16 bf16, one commit group,
//     into fresh accumulators that are then added to f32 sums held in
//     registers across chunks (kChunkSums); N = 128, zero-padded past
//     c_col;
//   - the epilogue is the narrow kernel's: D1 tile in shared memory, d1
//     by 16-byte stores, fused rows gathered from the f32 tile; the next
//     item's first chunks and B rows load under it.
//   Shared memory: a stage is 16 KiB (bf16) or 32 KiB (f32, hi and lo);
//   B takes none.  At the band, f32: 2 stages 64 KiB + two D1 tiles 2 *
//   64 * 136 * 4 = 68 KiB + two tiles' entries 2 * 64 * 32 * 8 = 32 KiB +
//   barriers and slack 1,088 bytes = 169,024 of the 232,448 bytes.  A
//   third stage fits there (201,792) but ran no faster on an H100
//   (benchmarks_torch/wf0_variants.py --wide): the ring is paced by L2's
//   bandwidth, not by its depth.  A shape whose D1 tiles and entries do
//   not fit goes to the CUDA-core kernel.
//
// tile_fused_gemm_spmm_wf0_kernel (any other shape, e.g. t = 2048 or t %
// 64 != 0): the first version, on the CUDA cores.  C[:, cb] is staged once
// per block as f32; each thread owns an RM x RN register tile of D1_t and
// reads B from device memory / L1; the host picks cb so that (t + b_col) *
// cb * 4 bytes and the tile's fused-row entries fit in shared memory.
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

int g_last_path = -1;  // 0: wgmma kernel, 1: CUDA-core kernel, 2: wide

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

// -------------------------------------------------- wide wgmma path ----

constexpr int kWideN = 128;               // columns of C an item takes (N)
constexpr int kWideStages = 2;            // C chunks in the ring
constexpr int kWidePanel = kWideN * 128;  // 128 bytes of k over N columns
// Each chunk's products go into fresh accumulators, which are then added
// to f32 sums in registers: the tensor cores' own accumulation rounds
// toward zero, which over the 768 wgmmas of K = 2048 (f32) drifted to
// 1.5e-5 of the largest value against the plain version on an H100;
// a chunk holds 12.
constexpr bool kChunkSums = true;

// bytes of a ring stage: one 128-byte k chunk of a column block of C,
// twice for f32 (tf32 hi, then lo)
__host__ __device__ constexpr int wide_stage_bytes(bool f32) {
  return (f32 ? 2 : 1) * kWidePanel;
}

// dynamic shared memory of the wide path: the ring, then a D1 tile and an
// entry buffer for each warpgroup, the ring's mbarriers (64 bytes) and
// alignment slack
inline size_t wide_smem_bytes(bool f32, int t, int j0, int w0) {
  return (size_t)kWideStages * wide_stage_bytes(f32) +
         2ull * t * (kWideN + 8) * 4 + 2ull * j0 * w0 * 8 + 64 + 1024;
}

// The pre-pass: block (chunk, column block) writes that stage's image,
// the K-major, 128-byte swizzled panel the wgmma reads, with the words of
// each 128 bytes permuted as load_a / load_b fetch B's (permuted_word);
// zero past b_col and c_col.  f32 writes tf32 hi = rna(c), then lo =
// rna(c - hi); bf16 writes the values.
template <typename T>
__global__ void __launch_bounds__(256)
    tile_fused_gemm_spmm_wf0_c_panels_kernel(const T* __restrict__ c,
                                             uint4* __restrict__ panels,
                                             int b_col, int c_col,
                                             int n_chunks) {
  constexpr bool kIsF32 = std::is_same<T, float>::value;
  constexpr int kRows = kIsF32 ? 32 : 64;  // rows of C in 128 bytes of k
  __shared__ float c_s[kRows][kWideN + 1];
  const int k0 = blockIdx.x * kRows;
  const int n0 = blockIdx.y * kWideN;
  for (int e = threadIdx.x; e < kRows * kWideN; e += blockDim.x) {
    const int k = e / kWideN;
    const int n = e - k * kWideN;
    c_s[k][n] = k0 + k < b_col && n0 + n < c_col
                    ? to_f32(c[(int64_t)(k0 + k) * c_col + n0 + n])
                    : 0.f;
  }
  __syncthreads();
  uint4* hi = panels + ((int64_t)blockIdx.y * n_chunks + blockIdx.x) *
                           (wide_stage_bytes(kIsF32) / 16);
  uint4* lo = hi + kWidePanel / 16;  // f32 only
  // vector e: the 16 bytes at n * 128 + (e % 8) * 16 of the panel, which
  // hold permuted words 4 v .. 4 v + 3, v = (e % 8) ^ (n % 8)
  for (int e = threadIdx.x; e < kWideN * 8; e += blockDim.x) {
    const int n = e >> 3;
    const int v = (e & 7) ^ (n & 7);
    uint32_t h[4], l[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = 4 * v + j;
      // the word m with permuted_word(m) == p
      const int i = 2 * (p >> 3) + ((p >> 2) & 1);
      const int m = (i & 3) + 16 * (i >> 2) + 4 * (p & 3);
      if constexpr (kIsF32) {
        h[j] = to_tf32(c_s[m][n]);
        l[j] = to_tf32(c_s[m][n] - __uint_as_float(h[j]));
      } else {
        const __nv_bfloat162 w2 =
            __floats2bfloat162_rn(c_s[2 * m][n], c_s[2 * m + 1][n]);
        h[j] = *reinterpret_cast<const uint32_t*>(&w2);  // exact: bf16 in
      }
    }
    hi[e] = make_uint4(h[0], h[1], h[2], h[3]);
    if constexpr (kIsF32) lo[e] = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kWgThreads, 1)
    tile_fused_gemm_spmm_wf0_wgmma_wide_kernel(
        const GemmArgs a, const uint8_t* __restrict__ panels, int n_chunks) {
  constexpr bool kIsF32 = std::is_same<T, float>::value;
  constexpr int S = kWideStages;
  constexpr int kStage = wide_stage_bytes(kIsF32);
  constexpr int kLd = kWideN + 8;  // D1 row stride (floats), as WgLayout
  using W = WgmmaKMajorB<kWideN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  // warp-uniform as far as ptxas can tell (see mbar_arrive)
  const int warp_id = __shfl_sync(0xffffffffu, (int)threadIdx.x / 32, 0);
  const int wg = warp_id / 4;
  const int warp = warp_id % 4;
  const int wtid = threadIdx.x & 127;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int n_ent = a.j0 * a.w0;
  uint8_t* d1_base = ring + S * kStage;
  float* d1_s = reinterpret_cast<float*>(d1_base) + (size_t)wg * a.t * kLd;
  uint8_t* ent_base = d1_base + 2ull * a.t * kLd * 4;
  int2* ent_s = reinterpret_cast<int2*>(ent_base) + (size_t)wg * n_ent;
  uint64_t* full = reinterpret_cast<uint64_t*>(ent_base + 2ull * n_ent * 8);
  uint64_t* empty = full + S;
  const int row_bytes = a.b_col * (int)sizeof(T);
  const int ld_bytes = kLd * 4;
  const T* vals0 = static_cast<const T*>(a.vals0);

  // The block's stream of chunks: item blockIdx.x + i gridDim.x (a pair of
  // tiles, a column block) takes chunks q = i steps .. (i + 1) steps - 1,
  // its m blocks of 64 rows one after another, each over every k chunk.
  const int m_blocks = a.t / 64;
  const int steps = m_blocks * n_chunks;
  const int n_pairs = (a.n_tiles + 1) / 2;
  const int n_items = n_pairs * ((a.c_col + kWideN - 1) / kWideN);
  const int my_items = ((int)blockIdx.x < n_items)
                           ? (n_items - 1 - (int)blockIdx.x) /
                                     (int)gridDim.x + 1
                           : 0;
  const int total = my_items * steps;
  auto item_of = [&](int chunk) {
    return (int)blockIdx.x + (chunk / steps) * (int)gridDim.x;
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kWgThreads / 32);  // every warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Chunk q goes into stage q % S once all eight warps have released chunk
  // q - S.  Warp 0 waits for that only when chunk need - 1 has not been
  // issued; otherwise it issues what is free (flash_attention.cu's pump).
  const bool issuer_warp = warp_id == 0;
  int issued = 0;
  auto pump = [&](int need) {
    if (!issuer_warp) return;
    while (issued < total) {
      const int st = issued % S;
      if (issued >= S) {
        const uint32_t par = ((issued / S) & 1) ^ 1;
        if (issued < need)
          mbar_wait_or_trap(&empty[st], par);
        else if (!mbar_test(&empty[st], par))
          break;
      }
      const int item = item_of(issued);
      const int ch = (issued % steps) % n_chunks;
      const uint8_t* src =
          panels + ((int64_t)(item / n_pairs) * n_chunks + ch) * kStage;
      mbar_expect_tx(&full[st], kStage, lane == 0);
      bulk_load(ring + st * kStage, src, kStage, &full[st], lane == 0);
      ++issued;
    }
  };
  pump(0);

  // A operand of chunk q: rows r and r + 8 of this thread's 16-row warp
  // slice of its tile's m block, 128 bytes of k (zero past B's row, and
  // for the missing second tile of an odd last pair), loaded a chunk
  // ahead
  uint32_t raw[8], raw8[8];
  auto load_b = [&](int chunk) {
#pragma unroll
    for (int i = 0; i < 8; ++i) raw[i] = raw8[i] = 0u;
    const int v = 2 * (item_of(chunk) % n_pairs) + wg;
    if (chunk >= total || v >= a.n_tiles) return;
    const int s = chunk % steps;
    const int mb = s / n_chunks;
    const int ch = s - mb * n_chunks;
    const char* p0 = static_cast<const char*>(a.b) +
                     ((int64_t)v * a.t + mb * 64 + warp * 16 + g) * row_bytes;
    const char* p1 = p0 + 8 * (int64_t)row_bytes;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int off = ch * 128 + h * 64 + t4 * 16;
      if (off < row_bytes) {
        const uint4 x0 = __ldg(reinterpret_cast<const uint4*>(p0 + off));
        const uint4 x1 = __ldg(reinterpret_cast<const uint4*>(p1 + off));
        raw[4 * h] = x0.x;
        raw[4 * h + 1] = x0.y;
        raw[4 * h + 2] = x0.z;
        raw[4 * h + 3] = x0.w;
        raw8[4 * h] = x1.x;
        raw8[4 * h + 1] = x1.y;
        raw8[4 * h + 2] = x1.z;
        raw8[4 * h + 3] = x1.w;
      }
    }
  };
  load_b(0);

  float acc[kWideN / 2], sum[kWideN / 2];
#pragma unroll
  for (int i = 0; i < kWideN / 2; ++i) acc[i] = sum[i] = 0.f;
  for (int q = 0; q < total; ++q) {
    const int item = item_of(q);
    const int v = 2 * (item % n_pairs) + wg;
    const bool valid = v < a.n_tiles;
    const int s_item = q % steps;
    const int mb = s_item / n_chunks;
    const int ch = s_item - mb * n_chunks;
    const int st = q % S;
    if (s_item == 0 && valid)  // d1_s and ent_s were freed at the last item
      stage_entries(ent_s, a.cols0 + (int64_t)v * n_ent,
                    vals0 + (int64_t)v * n_ent, n_ent, ld_bytes, wtid, 128);
    if (ch == 0) {
#pragma unroll
      for (int i = 0; i < kWideN / 2; ++i) sum[i] = 0.f;
    }
    const bool carry = !kChunkSums && ch > 0;  // acc holds the sums
    // k step s uses words 2 s, 2 s + 1 of the chunk, rows r and r + 8
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint32_t w[4] = {raw[2 * s], raw8[2 * s], raw[2 * s + 1],
                             raw8[2 * s + 1]};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (kIsF32) {
          const float x = __uint_as_float(w[i]);
          ah[s][i] = to_tf32(x);
          al[s][i] = to_tf32(x - __uint_as_float(ah[s][i]));
        } else {
          ah[s][i] = w[i];
        }
      }
    }
    load_b(q + 1);  // under this chunk's products
    pump(q + 1);
    mbar_wait_or_trap(&full[st], (q / S) & 1);
    const uint64_t dh = desc(ring + st * kStage, 16, 1024);
    const uint64_t dl = desc(ring + st * kStage + kWidePanel, 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int off = 2 * s;  // 32 bytes of k a step, in 16-byte units
      if constexpr (kIsF32) {
        W::tf32(acc, al[s], dh + off, carry || s > 0);
        W::tf32(acc, ah[s], dl + off, true);
        W::tf32(acc, ah[s], dh + off, true);
      } else {
        W::bf16(acc, ah[s], dh + off, carry || s > 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      pin(ah[s]);
      if constexpr (kIsF32) pin(al[s]);
    }
    mbar_arrive(&empty[st], lane == 0);
    pump(0);
    if constexpr (kChunkSums) {
#pragma unroll
      for (int i = 0; i < kWideN / 2; ++i) sum[i] += acc[i];
    }
    if (ch + 1 < n_chunks) continue;
    // the m block's sums: element 4 n + 2 r + e is (row g + 8 r, column
    // 8 n + 2 t4 + e) of the warp's 16 rows
#pragma unroll
    for (int nn = 0; nn < kWideN / 8; ++nn) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = mb * 64 + warp * 16 + g + 8 * r;
        const int i = 4 * nn + 2 * r;
        *reinterpret_cast<float2*>(d1_s + row * kLd + 8 * nn + 2 * t4) =
            kChunkSums ? make_float2(sum[i], sum[i + 1])
                       : make_float2(acc[i], acc[i + 1]);
      }
    }
    if (mb + 1 < m_blocks) continue;
    // the item's epilogue, under the next item's first loads
    const int cb0 = (item / n_pairs) * kWideN;
    const int cb = min(kWideN, a.c_col - cb0);
    warpgroup_sync(wg);
    if (valid) {
      // d1 in the operand dtype, 16-byte rows of the f32 tile
      const int n_vec = cb / 4;
      const int lpr = n_vec < 32 ? n_vec : 32;
      const int rpp = 32 / lpr;
      const int rr = lane / lpr;
      const int qv = lane - rr * lpr;
      T* d1 = static_cast<T*>(a.d1) + (int64_t)v * a.t * a.c_col + cb0;
      if (rr < rpp) {
        for (int r = warp * rpp + rr; r < a.t; r += 4 * rpp) {
          for (int vc = qv; vc < n_vec; vc += lpr) {
            const float4 f =
                *reinterpret_cast<const float4*>(d1_s + r * kLd + 4 * vc);
            const float x[4] = {f.x, f.y, f.z, f.w};
            store_f32<T, 4>(d1 + (int64_t)r * a.c_col + 4 * vc, x);
          }
        }
      }
      fused_rows_from_tile<T, 4>(
          ent_s, d1_s, kLd,
          static_cast<T*>(a.rows0) + (int64_t)v * a.j0 * a.c_col, a.j0,
          a.w0, cb, a.c_col, cb0, warp, 4);
    }
    warpgroup_sync(wg);  // d1_s and ent_s are free for the next item
  }
}

template <typename T>
cudaError_t launch_wide(const GemmArgs& a, void* panels,
                        cudaStream_t stream) {
  constexpr bool kIsF32 = std::is_same<T, float>::value;
  const int row_bytes = a.b_col * (int)sizeof(T);
  // the wrapper's rule (kernels/tile_fused_gemm_spmm.py::choose_path)
  if (a.t % 64 || a.b_col % 8 || a.c_col % 8 || row_bytes <= 512 ||
      a.cb_max != kWideN ||
      wide_smem_bytes(kIsF32, a.t, a.j0, a.w0) > 232448 ||
      !aligned16(a.b) || !aligned16(a.c) || !aligned16(a.d1) ||
      !aligned16(a.rows0) || !aligned16(panels))
    return cudaErrorInvalidValue;
  const int n_chunks = (row_bytes + 127) / 128;
  const int n_cb = (a.c_col + kWideN - 1) / kWideN;
  tile_fused_gemm_spmm_wf0_c_panels_kernel<T>
      <<<dim3(n_chunks, n_cb), 256, 0, stream>>>(
          static_cast<const T*>(a.c), static_cast<uint4*>(panels), a.b_col,
          a.c_col, n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = wide_smem_bytes(kIsF32, a.t, a.j0, a.w0);
  auto kern = tile_fused_gemm_spmm_wf0_wgmma_wide_kernel<T>;
  if ((err = cudaFuncSetAttribute(
           kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)) !=
      cudaSuccess)
    return err;
  int dev = 0, n_sm = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kern, kWgThreads, smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int n_items = (a.n_tiles + 1) / 2 * n_cb;
  const int grid = n_items < n_sm * per_sm ? n_items : n_sm * per_sm;
  kern<<<grid, kWgThreads, smem, stream>>>(
      a, static_cast<const uint8_t*>(panels), n_chunks);
  return cudaGetLastError();
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

// Rows r0 + rg + m nrg (m < M) of D1_t at this thread's columns cg + n
// ncg (n < kRN): the k loop over C's block in shared memory, then the
// sums into d1_s and d1 (d1_v: the tile's rows of d1 at column cb0).
template <typename T, int M>
__device__ __forceinline__ void core_rows(const T* __restrict__ b_t,
                                          const float* c_s, float* d1_s,
                                          T* __restrict__ d1_v, int r0,
                                          int rg, int nrg, int cg, int ncg,
                                          int cb, int cb_max, int b_col,
                                          int c_col) {
  float acc[M][kRN];
  const T* brow[M];
#pragma unroll
  for (int m = 0; m < M; ++m) {
    brow[m] = b_t + (int64_t)(r0 + rg + m * nrg) * b_col;
#pragma unroll
    for (int n = 0; n < kRN; ++n) acc[m][n] = 0.f;
  }
  for (int k = 0; k < b_col; ++k) {
    float bv[M];
    float cv[kRN];
#pragma unroll
    for (int m = 0; m < M; ++m) bv[m] = to_f32(brow[m][k]);
#pragma unroll
    for (int n = 0; n < kRN; ++n) {
      const int jj = cg + n * ncg;
      cv[n] = jj < cb ? c_s[k * cb + jj] : 0.f;
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
#pragma unroll
      for (int n = 0; n < kRN; ++n) acc[m][n] = fmaf(bv[m], cv[n], acc[m][n]);
    }
  }
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int r = r0 + rg + m * nrg;
#pragma unroll
    for (int n = 0; n < kRN; ++n) {
      const int jj = cg + n * ncg;
      if (jj < cb) {
        d1_s[r * cb_max + jj] = acc[m][n];
        d1_v[(int64_t)r * c_col + jj] = from_f32<T>(acc[m][n]);
      }
    }
  }
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
  T* d1_v = d1 + v * t * c_col + cb0;
  if (rg < nrg) {
    for (int r0 = 0; r0 < t; r0 += nrg * kRM) {
      // this thread's rows of the pass that lie in the tile: a row past
      // it is never computed
      const int n_m = min(kRM, (t - r0 - rg + nrg - 1) / nrg);
#define REPRO_CORE_ROWS(M)                                                 \
  case M:                                                                  \
    core_rows<T, M>(b_t, c_s, d1_s, d1_v, r0, rg, nrg, cg, ncg, cb,        \
                    cb_max, b_col, c_col);                                 \
    break;
      switch (n_m) {
        REPRO_CORE_ROWS(8)
        REPRO_CORE_ROWS(7)
        REPRO_CORE_ROWS(6)
        REPRO_CORE_ROWS(5)
        REPRO_CORE_ROWS(4)
        REPRO_CORE_ROWS(3)
        REPRO_CORE_ROWS(2)
        REPRO_CORE_ROWS(1)
        default:
          break;
      }
#undef REPRO_CORE_ROWS
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
// contiguous.  panels: the wide path's scratch for C's stages (the
// wrapper's wide_panel_bytes; unused by the other paths).  cb: column
// block width; path: 0 for the wgmma kernel (cb = min(c_col, 128)), 2 for
// the wide wgmma kernel (cb = 128), each only for a shape that satisfies
// the wrapper's rule; 1 for the CUDA-core kernel (cb chosen by the caller
// to fit shared memory).  Returns the cudaError_t of the launch (0 on
// success; cudaErrorInvalidValue for a shape the chosen path does not
// take).
extern "C" int tile_fused_gemm_spmm_wf0_launch(
    const void* cols0, const void* vals0, const void* b, const void* c,
    void* d1, void* rows0, void* panels, int n_tiles, int t, int b_col,
    int c_col, int j0, int w0, int cb, int path, int dtype, void* stream) {
  using namespace repro_torch;
  if (n_tiles == 0 || c_col == 0) {
    g_last_path = -1;
    return (int)cudaSuccess;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const GemmArgs a{static_cast<const int*>(cols0), vals0, b, c, d1, rows0,
                   n_tiles, t, b_col, c_col, j0, w0, cb};
  if ((dtype != kF32 && dtype != kBF16) || path < 0 || path > 2)
    return (int)cudaErrorInvalidValue;
  g_last_path = path;
  const bool f32 = dtype == kF32;
  if (path == 0)
    return (int)(f32 ? launch_wgmma_n<float>(a, s)
                     : launch_wgmma_n<__nv_bfloat16>(a, s));
  if (path == 2)
    return (int)(f32 ? launch_wide<float>(a, panels, s)
                     : launch_wide<__nv_bfloat16>(a, panels, s));
  return (int)(f32 ? launch_core<float>(a, s)
                   : launch_core<__nv_bfloat16>(a, s));
}

// the path of the last launch: 0 wgmma kernel, 1 CUDA-core kernel, 2 wide
// wgmma kernel, -1 none (before any launch, or an empty one)
extern "C" int tile_fused_gemm_spmm_wf0_last_path() {
  return repro_torch::g_last_path;
}
