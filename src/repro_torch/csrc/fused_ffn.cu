// Fused ungated FFN for Hopper: out[e] = act(x[e] @ w1[e]) @ w2[e], with
// the intermediate H = act(X W1) kept on chip.  One file serves both TPU
// kernels it replaces:
//   src/repro/kernels/fused_ffn.py::_fused_ffn    (one expert, e = 1)
//   src/repro/kernels/moe.py::_fused_moe_ffn      (E experts over
//                                                  capacity-dispatched tokens)
// whose Pallas bodies (_kernel in each file) are the same.
//
// Bound on the H100: operations.  4 m d f flops against 2 (m d + 2 d f)
// operand bytes is far above the card's ~295 flops per byte in bf16; f32
// runs as three TF32 products (below), 3 x 4 m d f operations at 495
// TFLOP/s (at stablelm-1.6b's widths, m 8192, d 2048, f 5632: 2.29 ms,
// against 0.05 ms for its 192 MB of operands).
//
// Three device functions; the launcher picks one by dtype and shape
// (never by failure) and records which one ran (fused_ffn_last_path):
//
// fused_ffn_wgmma_kernel (bf16): both products on the tensor cores with
// wgmma, H shared across a thread-block cluster.  The Pallas kernels walk
// f as a sequential grid axis and revisit one (block_m x d) output block in
// VMEM.  On the H100 a 128 x 2048 f32 output block is 1 MB, four times an
// SM's register file, so a cluster of C = ceil(min(d, 2048) / 256) CTAs
// owns one block of 128 tokens (of one expert).  CTA c keeps the 128 x 256
// f32 accumulator of output columns [256 c, 256 c + 256) in the registers
// of its two warpgroups (128 per thread), and for each chunk of f of
// BF = 64 C columns it
//   1. computes its 64 columns of H = act(X W1[:, chunk]) in f32 with
//      wgmma.m64n64k16, X and W1 tiles arriving by TMA through a ring of
//      kStages stages that warp 0 keeps ahead of the wgmmas;
//   2. rounds them to bf16 (as the Pallas kernel does, h.astype(x.dtype))
//      into slot c of its H tile in shared memory, and copies the slot with
//      cp.async.bulk into slot c of every other CTA (distributed shared
//      memory; an mbarrier in each CTA counts the bytes in);
//   3. adds H[:, chunk] W2[chunk, its 256 columns] into the accumulator
//      with wgmma.m64n256k16, W2 tiles arriving through the same ring;
//   4. tells every CTA of the cluster that it is done with its H tile.
// X W1 is computed once for d <= 2048 (every width the repo serves:
// stablelm d 2048 is C = 8, granite d 1536 is C = 6); a wider d takes
// ceil(d / 2048) cluster groups on the grid's column axis, and each group
// computes X W1 once: ceil(d / 2048) times in all.  H never touches device
// memory.  The output is summed in f32 over all of f and rounded once (the
// Pallas kernels round their running sum at every f block).  No float
// atomics: the same inputs give the same bits.  What the card showed
// (PERF.md section 6): a CTA with a ninth, producer warp gets 168 registers
// (ptxas sizes one count from the launch bound; setmaxnreg does not raise
// it), too few for both accumulators, so warp 0 issues the TMA itself;
// multicasting X to the cluster made every stage wait on all CTAs and ran
// slower.  Shared memory (kSmemBytes, 225 KB): the ring, kStages = 3 stages
// of 32 KB (an X tile 128 x 64 and a W1 tile 64 x 64, or a W2 tile
// 64 x 256); the cluster's H tile, kMaxCluster slots of 128 x 64 bf16
// (16 KB each); the barriers.  Every tile has rows of 128 bytes under the
// 128-byte swizzle, as TMA writes it and wgmma reads it: X and H K-major;
// W1 and W2 MN-major, since they are row-major in f and d.  Where d or f
// is not a multiple of 8 the rows are not 16-byte aligned, so all threads
// stage the same tiles element by element with predicated loads.
//
// fused_ffn_tf32_kernel (f32, d a multiple of 4, X, W2 and the output
// 16-byte aligned): the same clusters of C CTAs, 256 output columns each,
// and the same exchange of H, with both products as 3xTF32 on wgmma: each
// operand v is split into tf32 hi = rna(v) and lo = rna(v - hi), and each
// 8-deep k step issues lo*hi, hi*lo, then hi*hi (lo*lo is dropped), as
// tile_fused_gemm_spmm.cu's f32 path does.  What changes against bf16:
//   - TF32 wgmma takes K-major operands only, and W1 (d, f) and W2 (f, d)
//     are MN-major, so every 32-deep block of W1 and W2 is transposed on
//     its way in.  TMA cannot transpose, and the wrapper may not (a launch
//     allocates its output and nothing else).  cp.async copies each raw
//     block into shared memory ahead of use (X rows and W1 columns two
//     blocks deep, W2 one block); the warpgroup then splits it into tf32
//     hi and lo and stores both K-major under the 128-byte swizzle.
//   - X and H are the A operands, in registers: each thread reads its
//     fragment rows as 16-byte vectors (from the raw X block, or the H
//     tile) and splits them there.  The k order inside each 128 bytes is
//     permuted so a thread's fragment words are two 16-byte vectors, and
//     the B blocks are staged in the same order (the sum is unchanged).
//   - Shared memory: f32 H is twice bf16's, so a cluster owns 64 token
//     rows, not 128.  The H tile is kMaxCluster slots of 64 x 64 f32 (16
//     KB each, 128 KB), exchanged once in f32 and split by each reader.
//     Each warpgroup has 48 KB to stage into: its W1 block (hi + lo) and
//     two raw X / W1 blocks while H is computed, its W2 block (hi + lo, its
//     128 columns) and the next raw W2 block while H is consumed.  230,416
//     bytes in all.
//   - Work: warpgroup w computes all 64 columns of the CTA's slice of H
//     over the 32-deep blocks kb % 2 == w of d (m64n64k8; the two partial
//     sums meet in the slot before the activation), and output columns
//     [128 w, 128 w + 128) for all 64 rows (m64n128k8).  Each warpgroup
//     stages its own blocks behind its own named barrier; the warpgroups
//     meet at the exchange.  A chunk of f gives each CTA 64 columns of H,
//     or 32 (m64n32k8) when what is left fits in 32 a CTA: at granite's
//     experts (f 512, C 6) the tail's 128 columns then keep 4 CTAs busy,
//     not 2 (4.06 against 4.47 ms on an H100; benchmarks_torch/
//     ffn_variants.py).
//   - Accuracy: the tensor cores' own accumulation rounds toward zero
//     (tile_fused_gemm_spmm.cu).  H's products go into fresh accumulators
//     each 32-deep block, added to f32 sums in registers; the output's
//     accumulate over one chunk of f (at most 16 blocks, 192 wgmmas), and
//     each chunk's sum is added to the output in f32 (the first chunk
//     writes it; each CTA owns its tile, no atomics).  Rows stay within
//     1e-5 of the plain version at published widths.
//   - Registers: the thread's indices are hidden from the optimizer at
//     the start of each phase (opaque), so the offsets derived from them
//     are not held across both phases: 220 registers, no spills (with
//     them held, ptxas spilled 452 bytes and the kernel ran 1.8 ms slower
//     at stablelm's widths).
//   What sets the pace (ffn_variants.py's knock-outs): within a warpgroup
//   the copies, the split-and-transpose of each weight block and its
//   products run one after another, and the two warpgroups keep step
//   (making them take turns at the tensor cores ran 7-9 % slower).  At
//   stablelm's widths, 9.05 ms against 2.29 ms of 3xTF32 work (67.4 ms for
//   the first port's CUDA-core kernel).
//
// fused_ffn_kernel (f32 with d not a multiple of 4 or unaligned X, W2 or
// output; unchanged from the first port): a block owns 16 token rows x up
// to 2048 columns in registers and walks f in chunks of 32 on the CUDA
// cores, H in shared memory; a wider d recomputes H once per 2048 columns.
//
// Ragged m, d, f and cap are masked in every kernel.
#include "common.cuh"
#include "hopper.cuh"

#include <math.h>

namespace repro_torch {
namespace {

constexpr int kNone = 0;
constexpr int kGelu = 1;
constexpr int kSilu = 2;

__device__ __forceinline__ float activate(float h, int act) {
  if (act == kGelu) {  // tanh approximation, as jax.nn.gelu by default
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * h * (1.f + tanhf(c * (h + 0.044715f * h * h * h)));
  }
  if (act == kSilu) return h / (1.f + expf(-h));
  return h;
}

// ------------------------------------------------ f32, CUDA cores ----

constexpr int kThreads = 256;
constexpr int kBM = 16;                // token rows per block
constexpr int kNJ = 8;                 // output columns per thread
constexpr int kBD = kThreads * kNJ;    // output columns per block (2048)
constexpr int kBF = 32;                // f columns of H per chunk
constexpr int kKC = 128;               // d rows of X / W1 per staged slice

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    fused_ffn_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                     const T* __restrict__ w2, T* __restrict__ out, int m,
                     int d, int f, int act) {
  __shared__ float x_s[kBM][kKC + 1];
  __shared__ float w1_s[kKC][kBF + 1];
  __shared__ float h_s[kBM][kBF + 1];

  const int64_t e = blockIdx.z;
  const int r0 = blockIdx.x * kBM;
  const int c0 = blockIdx.y * kBD;
  const int rows = min(kBM, m - r0);
  const T* xe = x + (e * m + r0) * d;
  const T* w1e = w1 + e * d * f;
  const T* w2e = w2 + e * f * d;
  // H slice mapping: thread owns H[hr][hc] and H[hr][hc + 16]
  const int hr = threadIdx.x / 16;
  const int hc = threadIdx.x % 16;

  float acc[kBM][kNJ];
#pragma unroll
  for (int r = 0; r < kBM; ++r)
#pragma unroll
    for (int j = 0; j < kNJ; ++j) acc[r][j] = 0.f;

  for (int f0 = 0; f0 < f; f0 += kBF) {
    const int fc = min(kBF, f - f0);
    float h0 = 0.f, h1 = 0.f;
    for (int k0 = 0; k0 < d; k0 += kKC) {
      const int kc = min(kKC, d - k0);
      __syncthreads();  // earlier readers of x_s, w1_s and h_s are done
      for (int i = threadIdx.x; i < kBM * kKC; i += kThreads) {
        const int r = i / kKC;
        const int c = i - r * kKC;
        x_s[r][c] = (r < rows && c < kc)
                        ? to_f32(xe[(int64_t)r * d + k0 + c]) : 0.f;
      }
      for (int i = threadIdx.x; i < kKC * kBF; i += kThreads) {
        const int r = i / kBF;
        const int c = i - r * kBF;
        w1_s[r][c] = (r < kc && c < fc)
                         ? to_f32(w1e[(int64_t)(k0 + r) * f + f0 + c]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kc; ++kk) {
        const float xv = x_s[hr][kk];
        h0 = fmaf(xv, w1_s[kk][hc], h0);
        h1 = fmaf(xv, w1_s[kk][hc + 16], h1);
      }
    }
    h_s[hr][hc] = activate(h0, act);
    h_s[hr][hc + 16] = activate(h1, act);
    __syncthreads();

    for (int kk = 0; kk < fc; ++kk) {
      const T* w2r = w2e + (int64_t)(f0 + kk) * d;
      float wv[kNJ];
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        const int c = c0 + threadIdx.x + kThreads * j;
        wv[j] = c < d ? to_f32(w2r[c]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kBM; ++r) {
        const float hv = h_s[r][kk];
#pragma unroll
        for (int j = 0; j < kNJ; ++j) acc[r][j] = fmaf(hv, wv[j], acc[r][j]);
      }
    }
  }

  T* oe = out + (e * m + r0) * d;
#pragma unroll
  for (int r = 0; r < kBM; ++r) {
    if (r >= rows) break;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int c = c0 + threadIdx.x + kThreads * j;
      if (c < d) oe[(int64_t)r * d + c] = from_f32<T>(acc[r][j]);
    }
  }
}

cudaError_t launch_f32(const void* x, const void* w1, const void* w2,
                       void* out, int e, int m, int d, int f, int act,
                       cudaStream_t stream) {
  const dim3 grid((unsigned)((m + kBM - 1) / kBM),
                  (unsigned)((d + kBD - 1) / kBD), (unsigned)e);
  fused_ffn_kernel<float><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1),
      static_cast<const float*>(w2), static_cast<float*>(out), m, d, f, act);
  return cudaGetLastError();
}

// ------------------------------------- bf16, wgmma across a cluster ----

using bf16 = __nv_bfloat16;

constexpr int kRows = 128;            // token rows per cluster (2 x 64)
constexpr int kCols = 256;            // output columns per CTA
constexpr int kMaxCluster = 8;        // portable cluster size: 2048 columns
constexpr int kSlice = 64;            // H columns per CTA per chunk of f
constexpr int kBK = 64;               // d per X / W1 item
constexpr int kCtaThreads = 256;      // two warpgroups
constexpr int kXBytes = kRows * kBK * 2;             // 16 KB, 128B swizzle
constexpr int kW1Bytes = kBK * kSlice * 2;           // 8 KB, 128B swizzle
constexpr int kW2Bytes = kSlice * kCols * 2;         // 32 KB: 4 panels
constexpr int kW2Panel = kSlice * 64 * 2;            // 8 KB, 128B swizzle
constexpr int kStageBytes = kXBytes + kW1Bytes > kW2Bytes
                                ? kXBytes + kW1Bytes : kW2Bytes;
constexpr int kSlotBytes = kRows * kSlice * 2;       // 16 KB, 128B swizzle
constexpr int kStages =
    (232448 - 1024 - 256 - kMaxCluster * kSlotBytes) / kStageBytes;
constexpr int kRingOff = 0;
constexpr int kHOff = kRingOff + kStages * kStageBytes;
constexpr int kBarOff = kHOff + kMaxCluster * kSlotBytes;
constexpr int kSmemBytes = kBarOff + (2 * kStages + 2) * 8 + 1024;  // align
static_assert(kSlice == 64 && kBK == 64, "every tile has rows of 128 bytes");
static_assert(kSmemBytes <= 232448, "more shared memory than a block has");

struct Smem {
  uint8_t* ring;      // kStages x kStageBytes
  uint8_t* h;         // kMaxCluster slots of kSlotBytes: the chunk of H
  uint64_t* full;     // kStages: a stage's tiles have landed
  uint64_t* empty;    // kStages: the consumers are done with a stage
  uint64_t* hfull;    // all C slices of this chunk's H are in h
  uint64_t* hempty;   // every CTA of the cluster is done reading its h
};

__device__ __forceinline__ Smem carve(uint8_t* raw) {
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + kBarOff);
  return Smem{base + kRingOff, base + kHOff, bars, bars + kStages,
              bars + 2 * kStages, bars + 2 * kStages + 1};
}

struct FfnArgs {
  const bf16* x;    // (E, m, d)
  const bf16* w1;   // (E, d, f)
  const bf16* w2;   // (E, f, d)
  bf16* out;        // (E, m, d)
  int m, d, f, act;
  int tma;          // 1: tiles by TMA; 0: staged element by element
};

__device__ __forceinline__ void st_bf16(uint8_t* base, int offset,
                                        bf16 v) {
  *reinterpret_cast<bf16*>(base + offset) = v;
}

// Without TMA, all 256 threads stage one X / W1 item into the layouts TMA
// would write: X 128 x 64 K-major and W1 64 x 64 MN-major, both with the
// 128-byte swizzle.
__device__ __forceinline__ void stage_xw1(uint8_t* st, const FfnArgs& a,
                                          const bf16* xe, const bf16* w1e,
                                          int r0, int k0, int n0) {
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < kRows * kBK; i += kCtaThreads) {
    const int r = i / kBK, k = i % kBK;
    const bool in = r0 + r < a.m && k0 + k < a.d;
    st_bf16(st, sw128(r, k),
            in ? xe[(int64_t)(r0 + r) * a.d + k0 + k] : zero);
  }
  for (int i = threadIdx.x; i < kBK * kSlice; i += kCtaThreads) {
    const int k = i / kSlice, n = i % kSlice;
    const bool in = k0 + k < a.d && n0 + n < a.f;
    st_bf16(st + kXBytes, sw128(k, n),
            in ? w1e[(int64_t)(k0 + k) * a.f + n0 + n] : zero);
  }
}

// the same for a W2 item: 64 x 256 MN-major as four 64-column panels with
// the 128-byte swizzle
__device__ __forceinline__ void stage_w2(uint8_t* st, const FfnArgs& a,
                                         const bf16* w2e, int k0, int n0) {
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < kSlice * kCols; i += kCtaThreads) {
    const int k = i / kCols, n = i % kCols, c = n & 63;
    const bool in = k0 + k < a.f && n0 + n < a.d;
    st_bf16(st, (n >> 6) * kW2Panel + sw128(k, c),
            in ? w2e[(int64_t)(k0 + k) * a.d + n0 + n] : zero);
  }
}

// two neighbouring output values, of which n_in >= 1 lie inside the row
__device__ __forceinline__ void store_pair(bf16* dst, float v0, float v1,
                                           bool row_in, int n_in,
                                           bool pairs) {
  if (!row_in) return;
  if (pairs && n_in >= 2) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
  } else {
    dst[0] = __float2bfloat16(v0);
    if (n_in >= 2) dst[1] = __float2bfloat16(v1);
  }
}

// The ring items of one CTA, in order: for each chunk j of f, n_xw1(j) X /
// W1 items (its slice of H, unless the slice lies past f: H is act(0) = 0
// there) and then n_w2(j) W2 items, one for each slice of the chunk that
// lies inside f.  A CTA with no output columns (a ragged d over 2048) reads
// zeros for W2 and runs its wgmmas on them.
struct Plan {
  int C, bf, n_chunks, n_k, my_col, r0, n0, e, f;
  bool has_out;
  __device__ int n_xw1(int j) const {
    return j * bf + my_col < f ? n_k : 0;
  }
  __device__ int n_w2(int j) const {
    const int live = (f - j * bf + kSlice - 1) / kSlice;
    return live < C ? live : C;
  }
};

// The TMA issue of warp 0 (lane 0 issues): the next item of the plan into
// ring stage `stage`.
struct Issuer {
  int j = 0, t = 0;   // the next item: chunk, index within the chunk
  int item = 0;       // its index in the sequence
  __device__ void next(const Plan& p, const Smem& s, int stage,
                       const CUtensorMap* tx, const CUtensorMap* tw1,
                       const CUtensorMap* tw2, bool on) {
    while (j < p.n_chunks && t == p.n_xw1(j) + p.n_w2(j)) {
      ++j;
      t = 0;
    }
    if (j == p.n_chunks) return;
    uint8_t* st = s.ring + stage * kStageBytes;
    uint64_t* full = &s.full[stage];
    const int f0 = j * p.bf;
    const int nx = p.n_xw1(j);
    if (t < nx) {
      mbar_expect_tx(full, kXBytes + kW1Bytes, on);
      tma_load(st, tx, full, t * kBK, p.r0, p.e, on);
      tma_load(st + kXBytes, tw1, full, f0 + p.my_col, t * kBK, p.e, on);
    } else {
      mbar_expect_tx(full, kW2Bytes, on);
      for (int q = 0; q < kCols / 64; ++q)
        tma_load(st + q * kW2Panel, tw2, full, p.n0 + 64 * q,
                 f0 + (t - nx) * kSlice, p.e, on);
    }
    ++t;
    ++item;
  }
};

// grid (C * groups, ceil(m / 128), E), clusters of (C, 1, 1), 256 threads:
// warpgroup w owns token rows [64 w, 64 w + 64) of the block.  Warp 0
// also keeps the ring kStages items ahead of the consumers with TMA.  No
// warp is set aside as a producer: ptxas gives the whole kernel the one
// register count its launch bound allows, and with a ninth warp that is
// 168, too few for the 128 + 32 accumulators side by side (setmaxnreg
// does not raise it); 256 threads leave 255.
__global__ void __launch_bounds__(kCtaThreads, 1)
    fused_ffn_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                           const __grid_constant__ CUtensorMap tw1,
                           const __grid_constant__ CUtensorMap tw2,
                           const FfnArgs a) {
  extern __shared__ uint8_t smem_raw[];
  const Smem s = carve(smem_raw);
  uint32_t c_size;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(c_size));
  const uint32_t rank = cluster_rank();
  Plan p;
  p.C = (int)c_size;
  p.bf = p.C * kSlice;                        // H columns per chunk of f
  p.n_chunks = (a.f + p.bf - 1) / p.bf;
  p.n_k = (a.d + kBK - 1) / kBK;
  p.my_col = (int)rank * kSlice;              // this CTA's slice of a chunk
  p.r0 = blockIdx.y * kRows;
  p.n0 = blockIdx.x * kCols;                  // this CTA's output columns
  p.e = blockIdx.z;
  p.f = a.f;
  p.has_out = p.n0 < a.d;
  const bf16* xe = a.x + (int64_t)p.e * a.m * a.d;
  const bf16* w1e = a.w1 + (int64_t)p.e * a.d * a.f;
  const bf16* w2e = a.w2 + (int64_t)p.e * a.f * a.d;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&s.full[i], a.tma ? 1 : kCtaThreads);
      mbar_init(&s.empty[i], kCtaThreads / 32);   // every warp
    }
    mbar_init(s.hfull, 1);
    mbar_init(s.hempty, p.C);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();   // every barrier of the cluster is ready for remote use

  // warp-uniform as far as ptxas can tell (see mbar_arrive)
  const int warp_id = __shfl_sync(0xffffffffu, (int)threadIdx.x / 32, 0);
  const int wg = warp_id / 4;
  const int warp = warp_id % 4;
  const int lane = threadIdx.x % 32;
  const bool issuer_warp = a.tma && warp_id == 0;
  int n_items = 0;
  for (int j = 0; j < p.n_chunks; ++j) n_items += p.n_xw1(j) + p.n_w2(j);
  // Warp 0 issues item i into stage i % kStages once all eight warps have
  // released item i - kStages.  It waits for that only when item need - 1,
  // the one the warps take next, has not been issued; otherwise it issues
  // what is free and goes back to its wgmmas.
  Issuer issuer;
  auto pump = [&](int need) {
    if (!issuer_warp) return;
    while (issuer.item < n_items) {
      const int i = issuer.item;
      const int st = i % kStages;
      if (i >= kStages) {
        const uint32_t par = ((i / kStages) & 1) ^ 1;
        if (i < need)
          mbar_wait(&s.empty[st], par);
        else if (!mbar_test(&s.empty[st], par))
          break;
      }
      issuer.next(p, s, st, &tx, &tw1, &tw2, lane == 0);
    }
  };
  pump(0);

  const int row = 64 * wg + 16 * warp + lane / 4;   // and row + 8
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  int stage = 0;
  uint32_t phase = 0, hfull_parity = 0, hempty_parity = 1;
  // Each warp frees a stage once its wgmmas on it are done.
  int taken = 0;   // items taken so far
  auto release = [&](int st) {
    mbar_arrive(&s.empty[st], lane == 0);
    pump(0);
  };
  // the next item: staged by all threads without TMA; waited for either way
  auto take = [&](bool xw1, int k0, int n0) {
    uint8_t* st = s.ring + stage * kStageBytes;
    pump(++taken);
    if (!a.tma) {
      if (xw1)
        stage_xw1(st, a, xe, w1e, p.r0, k0, n0);
      else
        stage_w2(st, a, w2e, k0, n0);
      fence_proxy_async();   // generic writes, read by wgmma
      mbar_arrive(&s.full[stage]);
    }
    mbar_wait(&s.full[stage], phase);
    return st;
  };
  auto advance = [&]() {
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  };

  for (int j = 0; j < p.n_chunks; ++j) {
    const int f0 = j * p.bf;
    // 1. this CTA's 128 x 64 slice of H, f32 on the tensor cores; the
    //    wgmmas of one item overlap the wait for the next
    float h[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) h[i] = 0.f;
    int prev = -1;
    pin(h);
    for (int kt = 0; kt < p.n_xw1(j); ++kt) {
      const uint8_t* st = take(true, kt * kBK, f0 + p.my_col);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wgmma_ss_m64n64k16<1>(h, desc(st + wg * 8192 + kk * 32, 16, 1024),
                              desc(st + kXBytes + kk * 2048, 16, 1024),
                              true);
      wgmma_commit();
      wgmma_wait<1>();
      if (prev >= 0) release(prev);
      prev = stage;
      advance();
    }
    wgmma_wait<0>();
    pin(h);
    if (prev >= 0) release(prev);
    // 2. act, round to bf16 into slot `rank` of this CTA's H tile (K-major,
    //    128-byte swizzle), and copy the slot into every other CTA's tile
    uint32_t packed[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const __nv_bfloat162 v = __floats2bfloat162_rn(
          activate(h[2 * i], a.act), activate(h[2 * i + 1], a.act));
      packed[i] = *reinterpret_cast<const uint32_t*>(&v);
    }
    pump(0);
    mbar_wait<true>(s.hempty, hempty_parity);   // every CTA read its H
    hempty_parity ^= 1;
    uint8_t* mine = s.h + rank * kSlotBytes;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      // h[4q + 2 half + {0, 1}]: row + 8 half, columns 8q + 2 (lane % 4)
      *reinterpret_cast<uint32_t*>(
          mine + sw128(row + 8 * (i & 1), 8 * (i >> 1) + 2 * (lane % 4))) =
          packed[i];
    }
    fence_proxy_async();   // generic writes, read by the bulk copies
    cta_sync();
    if (threadIdx.x == 0) {
      for (int q = 0; q < p.C; ++q)
        if (q != (int)rank)
          copy_to_peer(mine, mine, kSlotBytes, s.hfull, (uint32_t)q);
      mbar_expect_tx(s.hfull, (uint32_t)((p.C - 1) * kSlotBytes));
    }
    mbar_wait(s.hfull, hfull_parity);
    hfull_parity ^= 1;
    // 3. out[:, n0 : n0 + 256] += H[:, chunk] W2[chunk, n0 : n0 + 256]
    prev = -1;
    for (int q = 0; q < p.n_w2(j); ++q) {
      const uint8_t* st = take(false, f0 + q * kSlice, p.n0);
      const uint8_t* hq = s.h + q * kSlotBytes + wg * 8192;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSlice / 16; ++kk)
        wgmma_ss_m64n256k16<1>(acc, desc(hq + kk * 32, 16, 1024),
                               desc(st + kk * 2048, kW2Panel, 1024),
                               true);
      wgmma_commit();
      wgmma_wait<1>();
      if (prev >= 0) release(prev);
      prev = stage;
      advance();
    }
    wgmma_wait<0>();
    pin(acc);
    if (prev >= 0) release(prev);
    // 4. this CTA is done with its H tile: tell every CTA of the cluster
    cta_sync();
    if (j + 1 < p.n_chunks && threadIdx.x == 0)
      for (int q = 0; q < p.C; ++q)
        mbar_arrive_peer(s.hempty, (uint32_t)q);
  }

  if (p.has_out) {
    // acc[4q + 2 half + {0, 1}]: row + 8 half, columns 8q + 2 (lane % 4)
    const int c0 = p.n0 + 2 * (lane % 4);
    bf16* top = a.out + ((int64_t)p.e * a.m + p.r0 + row) * a.d + c0;
    bf16* bottom = top + 8 * (int64_t)a.d;
    const bool top_in = p.r0 + row < a.m;
    const bool bottom_in = p.r0 + row + 8 < a.m;
    const bool pairs = a.d % 2 == 0;
#pragma unroll
    for (int q = 0; q < kCols / 8; ++q) {
      const int n_in = a.d - (c0 + 8 * q);   // columns left in the row
      if (n_in <= 0) break;
      store_pair(top + 8 * q, acc[4 * q], acc[4 * q + 1], top_in, n_in,
                 pairs);
      store_pair(bottom + 8 * q, acc[4 * q + 2], acc[4 * q + 3], bottom_in,
                 n_in, pairs);
    }
  }
  cluster_sync();   // no CTA leaves while a peer may still write to it
}

cudaError_t launch_bf16(const void* x, const void* w1, const void* w2,
                        void* out, int e, int m, int d, int f, int act,
                        cudaStream_t stream) {
  const int c = (d + kCols - 1) / kCols < kMaxCluster
                    ? (d + kCols - 1) / kCols : kMaxCluster;
  const int groups = (d + kCols * kMaxCluster - 1) / (kCols * kMaxCluster);
  const int row_blocks = (m + kRows - 1) / kRows;
  if (row_blocks > 65535 || e > 65535) return cudaErrorInvalidConfiguration;
  CUtensorMap tx{}, tw1{}, tw2{};
  const bool tma = d % 8 == 0 && f % 8 == 0 && aligned16(x) &&
                   aligned16(w1) && aligned16(w2);
  if (tma) {
    if (encode_tiled() == nullptr ||
        !tensor_map(&tx, x, e, m, d, kRows, kBK,
                    CU_TENSOR_MAP_SWIZZLE_128B) ||
        !tensor_map(&tw1, w1, e, d, f, kBK, kSlice,
                    CU_TENSOR_MAP_SWIZZLE_128B) ||
        !tensor_map(&tw2, w2, e, f, d, kSlice, 64,
                    CU_TENSOR_MAP_SWIZZLE_128B))
      return cudaErrorNotSupported;
  }
  const FfnArgs args{static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
                     static_cast<const bf16*>(w2), static_cast<bf16*>(out),
                     m, d, f, act, tma ? 1 : 0};
  cudaError_t err = cudaFuncSetAttribute(
      fused_ffn_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(c * groups), (unsigned)row_blocks,
                     (unsigned)e);
  cfg.blockDim = dim3(kCtaThreads);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fused_ffn_wgmma_kernel, tx, tw1, tw2, args);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// -------------------------------- f32, 3xTF32 wgmma across a cluster ----

constexpr int kTfRows = 64;                   // token rows per cluster
constexpr int kTfSlice = 64;                  // H columns per CTA a chunk,
                                              // at most (32 in a tail)
constexpr int kTfPanel = kTfRows * 128;       // 64 rows x 32 f32: 8 KB
constexpr int kTfSlotBytes = 2 * kTfPanel;    // a CTA's 64 columns of H
constexpr int kTfW1Half = kTfSlice * 128;     // hi or lo: 64 columns x 32 k
constexpr int kTfW2Half = 128 * 128;          // hi or lo: 128 columns x 32 k
constexpr int kTfXRaw = kTfRows * 128;        // 64 rows x 32 k of X
constexpr int kTfW1Raw = 32 * kTfSlice * 4;   // 32 k x 64 columns of W1
constexpr int kTfW2Raw = 32 * 128 * 4;        // 32 k x 128 columns of W2
// A warpgroup's part of the staging region.  While H is computed: its W1
// block (hi, lo) and a ring of two raw blocks (X rows, W1 columns) that
// cp.async fills; while H is consumed: its W2 block (hi, lo) of its 128
// output columns and the next raw W2 block.
constexpr int kTfRawOff = 2 * kTfW1Half;                         // 16 KB
constexpr int kTfRawBytes = kTfXRaw + kTfW1Raw;                  // 16 KB
constexpr int kTfW2RawOff = 2 * kTfW2Half;                       // 32 KB
constexpr int kTfWgStage =
    kTfRawOff + 2 * kTfRawBytes > kTfW2RawOff + kTfW2Raw
        ? kTfRawOff + 2 * kTfRawBytes : kTfW2RawOff + kTfW2Raw;  // 48 KB
constexpr int kTfStageOff = kMaxCluster * kTfSlotBytes;          // 128 KB
constexpr int kTfBarOff = kTfStageOff + 2 * kTfWgStage;
constexpr int kTfSmemBytes = kTfBarOff + 2 * 8 + 1024;           // align
static_assert(kTfSmemBytes <= 232448, "more shared memory than a block has");

struct TfArgs {
  const float* x;    // (E, m, d)
  const float* w1;   // (E, d, f)
  const float* w2;   // (E, f, d)
  float* out;        // (E, m, d)
  int m, d, f, act;
};

// The k word (of a 32-deep block) that position 4 v + j of a staged B row
// holds.  A thread's A fragment rows arrive as 16-byte vectors, words
// 16 h + 4 t .. 16 h + 4 t + 3 (h = 0, 1; t = lane % 4) in vector slots
// 4 h .. 4 h + 3; k step s uses slots 2 s and 2 s + 1 as fragment words t
// and t + 4, which a K-major B row holds at positions 8 s + t and
// 8 s + t + 4 (tile_fused_gemm_spmm.cu's permuted_word, inverted).
__host__ __device__ constexpr int tf_word(int v, int j) {
  return (v & 3) + 16 * (v >> 2) + 4 * j;
}

// byte offset of 16-byte position v of row n of a K-major tile with rows of
// 128 bytes under the 128-byte swizzle
__device__ __forceinline__ int kmajor_off(int n, int v) {
  return n * 128 + ((v ^ (n & 7)) << 4);
}

// byte offset of column c (< 32) of row r in a panel of the f32 H tile:
// rows of 128 bytes, 16-byte chunk c / 4 at c / 4 ^ 4 (r % 2), so the two
// rows of each phase of a warp's 16-byte fragment loads (rows g, g + 1)
// fall on different banks
__device__ __forceinline__ int h_off(int r, int c) {
  return r * 128 + ((((c >> 2) ^ ((r & 1) << 2))) << 4) + (c & 3) * 4;
}

// tf32 hi = rna(v) (returned) and lo = rna(v - hi) of four values
__device__ __forceinline__ uint4 tf32_hi4(const float (&v)[4], uint4& lo) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    h[i] = to_tf32(v[i]);
    l[i] = to_tf32(v[i] - __uint_as_float(h[i]));
  }
  lo = make_uint4(l[0], l[1], l[2], l[3]);
  return make_uint4(h[0], h[1], h[2], h[3]);
}

// cp.async of 16 (or 4) bytes from device memory into shared memory,
// zero-filled when `in` is false (src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(smem_u32(dst)), "l"(src), "r"(in ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(smem_u32(dst)), "l"(src), "r"(in ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// this thread's copies of all but the newest `N` groups have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// byte offset of 16-byte chunk c (< 32) of row k (< 32) of a raw W2 block
// (rows of 512 bytes): the chunk's place within its 128 bytes moves with
// the row, so the 8 rows tf_word(0..7, j) a converting warp reads at one
// chunk fall on different banks
__device__ __forceinline__ int w2raw_off(int k, int c) {
  return k * 512 + ((c ^ ((k & 3) | (((k >> 4) & 1) << 2))) << 4);
}

// hides v's value from the optimizer (it may have changed here)
__device__ __forceinline__ void opaque(int& v) { asm volatile("" : "+r"(v)); }

// a slice width of H as a type (h_phase's template argument)
template <int N>
struct Cols {
  static constexpr int value = N;
};

// the four warps of warpgroup `wg` (named barrier 1 + wg; 0 is the CTA's)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(wg + 1) : "memory");
}

// grid (C * groups, ceil(m / 64), E), clusters of (C, 1, 1), 256 threads.
// Warpgroup w computes this CTA's 64 columns of H over the 32-deep blocks
// of d with kb % 2 == w (the two partial sums meet in shared memory), and
// output columns [128 w, 128 w + 128) of the CTA's 256, for all 64 rows;
// warp q of a warpgroup holds rows 16 q .. 16 q + 15.  The warpgroups stage
// their own blocks into their own part of the staging region and meet only
// at the exchange of H.
__global__ void __launch_bounds__(kCtaThreads, 1)
    fused_ffn_tf32_kernel(const TfArgs a) {
  using W128 = WgmmaKMajorB<128>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* htile = base;                    // kMaxCluster slots of 2 panels
  uint64_t* hfull = reinterpret_cast<uint64_t*>(base + kTfBarOff);
  uint64_t* hempty = hfull + 1;
  uint32_t c_size;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(c_size));
  const int C = (int)c_size;
  const int rank = (int)cluster_rank();
  const int n_k = (a.d + 31) / 32;              // 32-deep blocks of d
  const int r0 = blockIdx.y * kTfRows;
  const int64_t e = blockIdx.z;
  const float* xe = a.x + e * a.m * a.d;
  const float* w1e = a.w1 + e * a.d * a.f;
  const float* w2e = a.w2 + e * a.f * a.d;
  // W1 rows as 16-byte vectors where they are
  const bool w1_vec = a.f % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(a.w1) % 16 == 0;

  const int tid = threadIdx.x;
  // warp-uniform as far as ptxas can tell (see mbar_arrive)
  const int warp_id = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int wg = warp_id / 4;
  // the thread's place, hidden from the optimizer at the start of each
  // phase (opaque): what depends on it is computed again there, not held
  // in registers across both phases
  int wtid = tid % 128;
  int t4 = tid % 4;
  int row = 16 * (warp_id % 4) + (tid % 32) / 4;   // and row + 8
  // this warpgroup's output columns and its part of the staging region
  const int n0 = blockIdx.x * kCols + 128 * wg;
  const bool has_out = n0 < a.d;
  uint8_t* stage = base + kTfStageOff + wg * kTfWgStage;

  if (tid == 0) {
    mbar_init(hfull, 1);
    mbar_init(hempty, C);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();   // every barrier of the cluster is ready for remote use
  uint32_t hfull_parity = 0, hempty_parity = 1;

  // A fragments: rows `row` (xa) and `row + 8` (xb) of a 32-deep panel
  // laid out as h_off (the H tile's panels, a raw X block); slot 4 h + i
  // holds word 16 h + 4 t4 + i
  float xa[8], xb[8];
  uint32_t ah[4][4], al[4][4];   // per k step: tf32 hi and lo fragments
  auto load_frag = [&](const uint8_t* pan) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 16 * h + 4 * t4;
      const float4 va = *reinterpret_cast<const float4*>(pan + h_off(row, c));
      const float4 vb =
          *reinterpret_cast<const float4*>(pan + h_off(row + 8, c));
      xa[4 * h] = va.x, xa[4 * h + 1] = va.y;
      xa[4 * h + 2] = va.z, xa[4 * h + 3] = va.w;
      xb[4 * h] = vb.x, xb[4 * h + 1] = vb.y;
      xb[4 * h + 2] = vb.z, xb[4 * h + 3] = vb.w;
    }
  };
  auto split = [&]() {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const float w[4] = {xa[2 * s], xb[2 * s], xa[2 * s + 1],
                          xb[2 * s + 1]};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ah[s][i] = to_tf32(w[i]);
        al[s][i] = to_tf32(w[i] - __uint_as_float(ah[s][i]));
      }
    }
  };

  // cp.async of block kb into a raw slot: X rows r0 .. r0 + 63 (h_off
  // layout), W1 rows 32 kb .. + 31 at columns n1 .. n1 + kS - 1
  // (row-major); zeros past m, d and f
  auto issue_xw1 = [&](auto slice, int kb, int n1, uint8_t* raw) {
    constexpr int kS = decltype(slice)::value;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = wtid + 128 * i;
      const int r = q / 8, c = q % 8, k = 32 * kb + 4 * c;
      const bool in = r0 + r < a.m && k < a.d;   // d % 4 == 0
      cp_async16(raw + h_off(r, 4 * c),
                 in ? xe + (int64_t)(r0 + r) * a.d + k : xe, in);
    }
    uint8_t* w1raw = raw + kTfXRaw;
    if (w1_vec) {
#pragma unroll
      for (int i = 0; i < kS / 16; ++i) {
        const int q = wtid + 128 * i;
        const int k = 32 * kb + q / (kS / 4), n = n1 + 4 * (q % (kS / 4));
        const bool in = k < a.d && n < a.f;       // f % 4 == 0
        cp_async16(w1raw + 16 * q, in ? w1e + (int64_t)k * a.f + n : w1e,
                   in);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kS / 4; ++i) {
        const int q = wtid + 128 * i;
        const int k = 32 * kb + q / kS, n = n1 + q % kS;
        const bool in = k < a.d && n < a.f;
        cp_async4(w1raw + 4 * q, in ? w1e + (int64_t)k * a.f + n : w1e, in);
      }
    }
  };
  // the raw W1 block, split and transposed into the warpgroup's K-major W1
  // block (kS rows): thread `wtid` stages column wtid % kS at positions
  // 4 v .. 4 v + 3, v = wtid / kS + (128 / kS) q
  auto convert_w1 = [&](auto slice, const uint8_t* raw) {
    constexpr int kS = decltype(slice)::value;
    const float* w1raw = reinterpret_cast<const float*>(raw + kTfXRaw);
    const int sn = wtid % kS;
#pragma unroll
    for (int q = 0; q < kS / 16; ++q) {
      const int v = wtid / kS + (128 / kS) * q;
      const float w[4] = {w1raw[tf_word(v, 0) * kS + sn],
                          w1raw[tf_word(v, 1) * kS + sn],
                          w1raw[tf_word(v, 2) * kS + sn],
                          w1raw[tf_word(v, 3) * kS + sn]};
      uint4 lo;
      const uint4 hi = tf32_hi4(w, lo);
      const int off = kmajor_off(sn, v);
      *reinterpret_cast<uint4*>(stage + off) = hi;
      *reinterpret_cast<uint4*>(stage + kTfW1Half + off) = lo;
    }
  };
  // Phase 1 of a chunk, for a slice of kS columns of H (n1 .. n1 + kS - 1):
  // this warpgroup's part of X W1[:, slice] in f32 over the blocks kb = wg
  // + 2 it (fresh accumulators a block, added to hs; element 4 n + 2 r + i
  // is (row + 8 r, column 8 n + 2 t4 + i)); then, once every CTA has read
  // its H tile, the two partial sums with the activation (f32) into panels
  // rank kS / 32 .. of the H tile
  auto h_phase = [&](auto slice, int n1) {
    constexpr int kS = decltype(slice)::value;
    using W = WgmmaKMajorB<kS>;
    opaque(wtid);
    opaque(t4);
    opaque(row);
    float hs[kS / 2];
#pragma unroll
    for (int i = 0; i < kS / 2; ++i) hs[i] = 0.f;
    const int n_own = n1 < a.f ? (n_k - wg + 1) / 2 : 0;   // else H = 0
    if (n_own > 0) {
      issue_xw1(slice, wg, n1, stage + kTfRawOff);
      cp_async_commit();
      if (n_own > 1)
        issue_xw1(slice, wg + 2, n1, stage + kTfRawOff + kTfRawBytes);
      cp_async_commit();
    }
    for (int it = 0; it < n_own; ++it) {
      uint8_t* raw = stage + kTfRawOff + (it & 1) * kTfRawBytes;
      cp_async_wait<1>();   // block it is in (block it + 1 may not be)
      // every thread's copies of block it are in; the warpgroup's wgmmas
      // of block it - 1 are done, so its W1 buffer is free
      wg_sync(wg);
      convert_w1(slice, raw);
      fence_proxy_async();   // generic writes, read by wgmma
      load_frag(raw);        // X
      split();
      wg_sync(wg);           // the W1 block is stored; the raw slot is read
      if (it + 2 < n_own) issue_xw1(slice, wg + 2 * (it + 2), n1, raw);
      cp_async_commit();
      const uint64_t dh = desc(stage, 16, 1024);
      const uint64_t dl = desc(stage + kTfW1Half, 16, 1024);
      float h[kS / 2];
#pragma unroll
      for (int i = 0; i < kS / 2; ++i) h[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s) {   // 32 bytes of k a step
        W::tf32(h, al[s], dh + 2 * s, s > 0);
        W::tf32(h, ah[s], dl + 2 * s, true);
        W::tf32(h, ah[s], dh + 2 * s, true);
      }
      wgmma_commit();
      wgmma_wait<0>();
      pin(h);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        pin(ah[s]);
        pin(al[s]);
      }
#pragma unroll
      for (int i = 0; i < kS / 2; ++i) hs[i] += h[i];
    }
    mbar_wait_or_trap<true>(hempty, hempty_parity);   // every CTA read its H
    hempty_parity ^= 1;
    // hs[4 n + 2 r + i] lies in panel rank kS / 32 + n / 4 at (row + 8 r,
    // column 8 (n % 4) + 2 t4 + i)
    auto h_pair = [&](int n, int r) {
      return reinterpret_cast<float2*>(
          htile + (rank * (kS / 32) + n / 4) * kTfPanel +
          h_off(row + 8 * r, 8 * (n % 4) + 2 * t4));
    };
    if (wg == 1) {
#pragma unroll
      for (int n = 0; n < kS / 8; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *h_pair(n, r) = make_float2(hs[4 * n + 2 * r], hs[4 * n + 2 * r + 1]);
    }
    cta_sync();
    if (wg == 0) {
#pragma unroll
      for (int n = 0; n < kS / 8; ++n) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 other = *h_pair(n, r);
          *h_pair(n, r) =
              make_float2(activate(hs[4 * n + 2 * r] + other.x, a.act),
                          activate(hs[4 * n + 2 * r + 1] + other.y, a.act));
        }
      }
    }
  };
  // cp.async of W2 rows k0 .. k0 + 31 at this warpgroup's 128 columns into
  // the raw W2 block (w2raw_off layout); zeros past f and d
  uint8_t* w2raw = stage + kTfW2RawOff;
  auto issue_w2 = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = wtid + 128 * i;
      const int k = q / 32, c = q % 32, n = n0 + 4 * c;
      const bool in = k0 + k < a.f && n < a.d;   // d % 4 == 0
      cp_async16(w2raw + w2raw_off(k, c),
                 in ? w2e + (int64_t)(k0 + k) * a.d + n : w2e, in);
    }
  };
  // the raw W2 block, split and transposed into the warpgroup's K-major W2
  // block: thread `wtid` stages positions 4 v .. 4 v + 3 (v = wtid % 8) of
  // columns 4 g .. 4 g + 3, g = wtid / 8 and wtid / 8 + 16
  auto convert_w2 = [&]() {
    const int s2v = wtid % 8;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int g = wtid / 8 + 16 * q;
      float4 r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        r[j] = *reinterpret_cast<const float4*>(
            w2raw + w2raw_off(tf_word(s2v, j), g));
      const float w[4][4] = {{r[0].x, r[1].x, r[2].x, r[3].x},
                             {r[0].y, r[1].y, r[2].y, r[3].y},
                             {r[0].z, r[1].z, r[2].z, r[3].z},
                             {r[0].w, r[1].w, r[2].w, r[3].w}};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint4 lo;
        const uint4 hi = tf32_hi4(w[i], lo);
        const int off = kmajor_off(4 * g + i, s2v);
        *reinterpret_cast<uint4*>(stage + off) = hi;
        *reinterpret_cast<uint4*>(stage + kTfW2Half + off) = lo;
      }
    }
  };


  for (int j = 0, f0 = 0; f0 < a.f; ++j) {
    // a chunk of f: 64 columns of H a CTA, or 32 when what is left fits in
    // 32 a CTA (so the tail spreads over more of the cluster)
    const int slice = a.f - f0 > 32 * C ? 64 : 32;
    const int n1 = f0 + rank * slice;   // this CTA's slice of the chunk
    const int panels = slice / 32;      // of the H tile, a CTA's slot
    const int live = min(panels * C, (a.f - f0 + 31) / 32);   // H panels
    // 1. H[:, n1 .. n1 + slice - 1] (the raw W2 block of phase 3 loads
    //    under the exchange)
    if (slice == 64)
      h_phase(Cols<64>{}, n1);
    else
      h_phase(Cols<32>{}, n1);
    if (has_out) issue_w2(f0);
    cp_async_commit();
    // 2. this CTA's slot into every other CTA's tile
    fence_proxy_async();   // generic writes, read by the bulk copies
    cta_sync();
    if (tid == 0) {
      uint8_t* mine = htile + rank * panels * kTfPanel;
      const uint32_t bytes = (uint32_t)(panels * kTfPanel);
      for (int q = 0; q < C; ++q)
        if (q != rank) copy_to_peer(mine, mine, bytes, hfull, (uint32_t)q);
      mbar_expect_tx(hfull, (C - 1) * bytes);
    }
    mbar_wait_or_trap(hfull, hfull_parity);
    hfull_parity ^= 1;
    // 3. out[:, n0 .. n0 + 127] += H[:, chunk] W2[chunk, ...], one 32-deep
    //    panel of H at a time into the accumulators (element 4 n + 2 r + i
    //    is (row + 8 r, column c0 + 8 n + i)); the chunk's sum (at most
    //    16 panels, 192 wgmmas) is then added to the output in f32: the
    //    first chunk writes it, the others add to it (each CTA owns its
    //    tile: no atomics), so no registers hold sums while H is computed
    if (has_out) {
      opaque(wtid);
      opaque(t4);
      opaque(row);
      float acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      for (int p = 0; p < live; ++p) {
        cp_async_wait<0>();   // raw W2 block p is in
        // every thread's copies are in; the warpgroup's wgmmas of the
        // previous block (or of H) are done, so its W2 buffer is free
        wg_sync(wg);
        convert_w2();
        fence_proxy_async();
        load_frag(htile + p * kTfPanel);   // H
        split();
        wg_sync(wg);   // the W2 block is stored; the raw block is read
        if (p + 1 < live) issue_w2(f0 + 32 * (p + 1));
        cp_async_commit();
        const uint64_t dh = desc(stage, 16, 1024);
        const uint64_t dl = desc(stage + kTfW2Half, 16, 1024);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          W128::tf32(acc, al[s], dh + 2 * s, p > 0 || s > 0);
          W128::tf32(acc, ah[s], dl + 2 * s, true);
          W128::tf32(acc, ah[s], dh + 2 * s, true);
        }
        wgmma_commit();
        wgmma_wait<0>();
        pin(acc);
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          pin(ah[s]);
          pin(al[s]);
        }
      }
      // this thread's output pairs: (row + 8 r, columns c0 + 8 n, + 1), in
      // or out of the tile together (d % 4 == 0)
      const int c0 = n0 + 2 * t4;
      float* out_top = a.out + (e * a.m + r0 + row) * a.d + c0;
      float* out_bottom = out_top + 8 * (int64_t)a.d;
      const bool top_in = r0 + row < a.m;
      const bool bottom_in = r0 + row + 8 < a.m;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        if (c0 + 8 * n >= a.d) break;
        float2* pair[2] = {reinterpret_cast<float2*>(out_top + 8 * n),
                           reinterpret_cast<float2*>(out_bottom + 8 * n)};
        const bool in[2] = {top_in, bottom_in};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (!in[r]) continue;
          float2 v = make_float2(acc[4 * n + 2 * r], acc[4 * n + 2 * r + 1]);
          if (j > 0) {
            const float2 prev = *pair[r];
            v.x += prev.x;
            v.y += prev.y;
          }
          *pair[r] = v;
        }
      }
    }
    // 4. this CTA is done with its H tile and the staging region: tell
    //    every CTA of the cluster
    f0 += slice * C;
    cta_sync();
    if (f0 < a.f && tid == 0)
      for (int q = 0; q < C; ++q) mbar_arrive_peer(hempty, (uint32_t)q);
  }
  cluster_sync();   // no CTA leaves while a peer may still write to it
}

cudaError_t launch_tf32(const void* x, const void* w1, const void* w2,
                        void* out, int e, int m, int d, int f, int act,
                        cudaStream_t stream) {
  const int c = (d + kCols - 1) / kCols < kMaxCluster
                    ? (d + kCols - 1) / kCols : kMaxCluster;
  const int groups = (d + kCols * kMaxCluster - 1) / (kCols * kMaxCluster);
  const int row_blocks = (m + kTfRows - 1) / kTfRows;
  if (row_blocks > 65535 || e > 65535) return cudaErrorInvalidConfiguration;
  const TfArgs args{static_cast<const float*>(x),
                    static_cast<const float*>(w1),
                    static_cast<const float*>(w2), static_cast<float*>(out),
                    m, d, f, act};
  cudaError_t err = cudaFuncSetAttribute(
      fused_ffn_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kTfSmemBytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(c * groups), (unsigned)row_blocks,
                     (unsigned)e);
  cfg.blockDim = dim3(kCtaThreads);
  cfg.dynamicSmemBytes = kTfSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)c;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, fused_ffn_tf32_kernel, args);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// the device function of the last launch (fused_ffn_last_path)
constexpr int kPathTf32 = 0, kPathCudaCore = 1, kPathBf16 = 2;
constexpr int kPathNone = -1;
int g_last_path = kPathNone;

int run(const void* x, const void* w1, const void* w2, void* out, int e,
        int m, int d, int f, int act, int dtype, void* stream) {
  g_last_path = kPathNone;
  if ((int64_t)e * m * d == 0) return (int)cudaSuccess;
  if (act != kNone && act != kGelu && act != kSilu)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f == 0)   // an empty sum
    return (int)cudaMemsetAsync(out, 0, (size_t)e * m * d *
                                (dtype == kF32 ? 4 : 2), s);
  if (dtype == kF32) {
    // X and W2 rows as 16-byte vectors, float2 output stores; W1 is read
    // a word at a time
    if (d % 4 == 0 && aligned16(x) && aligned16(w2) && aligned16(out)) {
      g_last_path = kPathTf32;
      return (int)launch_tf32(x, w1, w2, out, e, m, d, f, act, s);
    }
    g_last_path = kPathCudaCore;
    return (int)launch_f32(x, w1, w2, out, e, m, d, f, act, s);
  }
  if (dtype == kBF16) {
    g_last_path = kPathBf16;
    return (int)launch_bf16(x, w1, w2, out, e, m, d, f, act, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro_torch

// act: 0 none, 1 gelu (tanh approximation), 2 silu.  All tensors
// contiguous and of one dtype.  Each launches on `stream` and returns the
// cudaError_t of its launch.

// x (m, d), w1 (d, f), w2 (f, d), out (m, d)
extern "C" int fused_ffn_launch(const void* x, const void* w1, const void* w2,
                                void* out, int m, int d, int f, int act,
                                int dtype, void* stream) {
  return repro_torch::run(x, w1, w2, out, 1, m, d, f, act, dtype, stream);
}

// x (e, cap, d), w1 (e, d, f), w2 (e, f, d), out (e, cap, d)
extern "C" int fused_moe_ffn_launch(const void* x, const void* w1,
                                    const void* w2, void* out, int e,
                                    int cap, int d, int f, int act, int dtype,
                                    void* stream) {
  return repro_torch::run(x, w1, w2, out, e, cap, d, f, act, dtype, stream);
}

// the device function of the last launch: 0 fused_ffn_tf32_kernel, 1
// fused_ffn_kernel (CUDA cores), 2 fused_ffn_wgmma_kernel, -1 none (before
// any launch, or an empty one)
extern "C" int fused_ffn_last_path() { return repro_torch::g_last_path; }
