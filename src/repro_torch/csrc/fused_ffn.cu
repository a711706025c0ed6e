// Fused ungated FFN for Hopper: out[e] = act(x[e] @ w1[e]) @ w2[e], with
// the intermediate H = act(X W1) kept on chip.  One file serves both TPU
// kernels it replaces:
//   src/repro/kernels/fused_ffn.py::_fused_ffn    (one expert, e = 1)
//   src/repro/kernels/moe.py::_fused_moe_ffn      (E experts over
//                                                  capacity-dispatched tokens)
// whose Pallas bodies (_kernel in each file) are the same.
//
// Bound on the H100: operations.  4 m d f flops against 2 (m d + 2 d f)
// operand bytes is far above the card's ~295 flops per byte in bf16.
//
// bf16 (fused_ffn_wgmma_kernel): both products on the tensor cores with
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
// atomics: the same inputs give the same bits.
//
// Against the first port's CUDA-core kernel: both products run on the
// tensor cores (it ran f32 FMAs); every operand tile arrives by TMA ahead
// of its wgmma (it read W2 from L2 with the latency exposed and met a
// barrier every 128 values of d); blocks are 128 tokens tall (they were
// 16, and each re-read all of W1 and W2).  What the card showed (PERF.md
// §6): a CTA with a ninth, producer warp gets 168 registers (ptxas sizes
// one count from the launch bound; setmaxnreg does not raise it), too few
// for both accumulators, so warp 0 issues the TMA itself; multicasting X
// to the cluster made every stage wait on all CTAs and ran slower; 64
// columns of H per CTA halve the X re-reads of 32 and the number of
// exchanges.  Each CTA still reads its row block of X from L2 once per
// chunk of f; the waits at each ring stage and at the exchange of step 2,
// more than any one stream of bytes or products, set the pace.
//
// Shared memory per CTA (kSmemBytes, 225 KB): the ring, kStages = 3 stages
// of 32 KB (an X tile 128 x 64 and a W1 tile 64 x 64, or a W2 tile
// 64 x 256); the cluster's H tile, kMaxCluster slots of 128 x 64 bf16
// (16 KB each); the barriers.  Every tile has rows of 128 bytes under the
// 128-byte swizzle, as TMA writes it and wgmma reads it: X and H K-major;
// W1 and W2 MN-major, since they are row-major in f and d.
//
// TMA needs 16-byte strides.  Where d or f is not a multiple of 8 the rows
// are not 16-byte aligned, so neither TMA nor a 16-byte cp.async can read
// them; all threads then stage the same tiles element by element with
// predicated loads.  Ragged m, d, f and cap are masked in the kernel either
// way (TMA fills out-of-range elements with zeros).
//
// f32 stays on the CUDA cores (fused_ffn_kernel, unchanged from the first
// port; the 1e-4 bar rules out TF32): a block owns 16 token rows x up to
// 2048 columns in registers and walks f in chunks of 32, H in shared
// memory; a wider d recomputes H once per 2048 columns.
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

int run(const void* x, const void* w1, const void* w2, void* out, int e,
        int m, int d, int f, int act, int dtype, void* stream) {
  if ((int64_t)e * m * d == 0) return (int)cudaSuccess;
  if (act != kNone && act != kGelu && act != kSilu)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f == 0)   // an empty sum
    return (int)cudaMemsetAsync(out, 0, (size_t)e * m * d *
                                (dtype == kF32 ? 4 : 2), s);
  if (dtype == kF32)
    return (int)launch_f32(x, w1, w2, out, e, m, d, f, act, s);
  if (dtype == kBF16)
    return (int)launch_bf16(x, w1, w2, out, e, m, d, f, act, s);
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
