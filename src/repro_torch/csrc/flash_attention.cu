// Flash attention for Hopper: out = softmax(mask(q k^T * scale)) v per
// (batch, head), with causal and sliding-window masks and grouped K/V heads
// (query head h reads K/V head h / (H / Hkv), in place).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// _flash_attention (its Pallas body _kernel).  There the grid is (batch,
// heads, q blocks, kv blocks) with the kv axis sequential, and the running
// max, denominator and accumulator sit in VMEM scratch from one grid step
// to the next.  Blocks of a CUDA grid run in no order, so here one block
// owns one (batch, head, q block) tile and walks the kv blocks in a loop,
// the running max m, the denominator l and the f32 accumulator in
// registers for the whole walk.  The score tile never leaves the SM.
//
// Semantics are the reference's (src/repro/kernels/ref.py::attention):
// masked scores are the finite -1e30, so a row whose every key is masked
// gets the mean of V; keys past the ragged Sk edge do not exist (score
// -inf, weight exactly 0); rows past the ragged Sq edge are not stored;
// l == 0 divides by 1.  kv blocks that lie wholly outside the causal or
// window mask are skipped, which is exact for any row with one valid key
// (its first valid score makes exp(-1e30 - m) vanish).  Rows with no valid
// key exist only under a window, at q >= Sk + window - 1; a q block that
// holds such a row walks every kv block, so those rows see all Sk masked
// keys and get the mean of V as the reference gives them.
//
// Bound on the H100: operations.  Each (query, key) pair costs 4*D flops
// for 2 bytes of K and V per head dimension shared by a block of queries,
// far above the card's balance.  Three paths, chosen by dtype, head dim and
// alignment (dispatch below):
//  - bf16 with D = 64 or 128 and 16-byte aligned q, k, v (every model the
//    repo configures): flash_attention_wgmma_kernel, both products on
//    wgmma with K/V tiles arriving by TMA through a ring in shared memory;
//    described at the kernel.
//  - other bf16 head dims up to 128 (or unaligned rows): both products on
//    mma.sync.m16n8k16, described at flash_attention_mma_kernel.
//  - f32, and bf16 with D up to 256, run on the CUDA cores in f32 (bf16 is
//    converted as it is staged), so the f32 FMA pipe bounds them: 256
//    threads each hold a 4 x 4 register tile of scores (rows rg + 16i, keys
//    cg + 16j) and a 4 x (DMAX/16) tile of the accumulator, so every
//    shared-memory load feeds 2-4 FMAs; Q and K rows are padded to an odd
//    stride so the 16 keys (or 2 rows) a warp reads at once fall in
//    distinct banks; the row max and sum are reduced with shuffles inside
//    the 16 lanes that share a row.  P stays f32.
// On the tensor cores P is rounded to bf16 for the PV product, as the
// Pallas kernel rounds it to V's dtype, while l sums the f32 values.
#include "common.cuh"
#include "hopper.cuh"

#include <math.h>

#include <type_traits>

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;           // queries per block
constexpr int kBK = 64;           // keys per kv step
constexpr int kRows = kBQ / 16;   // score / accumulator rows per thread
constexpr int kKeys = kBK / 16;   // score columns per thread
constexpr float kMasked = -1e30f; // the reference's NEG_INF

// Shared-memory layout, in floats: Q (kBQ x DMAX+1), K (kBK x DMAX+1),
// V (kBK x DMAX), P (kBQ x kBK+1).
template <int DMAX>
struct Layout {
  static constexpr int kQK = DMAX + 1;
  static constexpr int kP = kBK + 1;
  static constexpr int q = kBQ * kQK;
  static constexpr int k = kBK * kQK;
  static constexpr int v = kBK * DMAX;
  static constexpr int p = kBQ * kP;
  static constexpr int floats = q + k + v + p;
};

// dst[r * stride + c] = src[r, c] for r < valid, c < d; 0 elsewhere in the
// (n_rows, DMAX) tile.  Consecutive threads read consecutive columns.
template <typename T, int DMAX>
__device__ __forceinline__ void stage(const T* __restrict__ src, int valid,
                                      int d, float* __restrict__ dst,
                                      int n_rows, int stride) {
  for (int e = threadIdx.x; e < n_rows * DMAX; e += kThreads) {
    const int r = e / DMAX;
    const int c = e - r * DMAX;
    dst[r * stride + c] =
        (r < valid && c < d) ? to_f32(src[(int64_t)r * d + c]) : 0.f;
  }
}

// max / sum over the 16 lanes that share a row (lanes differ in bits 0-3)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The kv blocks [lo, hi) of width bk that hold a valid key for some row of
// the q block [q0, q0 + bq).  Rows with no valid key exist only under a
// window, at q >= sk + window - 1; a block holding one walks every kv block.
__device__ __forceinline__ void kv_range(int q0, int bq, int bk, int sq,
                                         int sk, int causal, int window,
                                         int& lo, int& hi) {
  const int n_kb = (sk + bk - 1) / bk;
  const int q_last = min(q0 + bq, sq) - 1;
  lo = 0;
  hi = n_kb;
  if (window > 0 && q_last >= sk + window - 1) return;
  if (causal) hi = min(n_kb, q_last / bk + 1);
  if (window > 0) lo = max(0, q0 - window + 1) / bk;
}

// the K/V head that query head `head` of batch `b` reads: heads are grouped
// in runs of h / hkv that share one K/V head
__device__ __forceinline__ int64_t kv_head(int b, int head, int h, int hkv) {
  return (int64_t)b * hkv + head / (h / hkv);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int hkv, int sq, int sk,
    int d, float scale, int causal, int window) {
  using L = Layout<DMAX>;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + L::q;
  float* v_s = k_s + L::k;
  float* p_s = v_s + L::v;

  const int64_t bh = blockIdx.y + (int64_t)gridDim.y * blockIdx.z;
  const int64_t bhk = kv_head(blockIdx.z, blockIdx.y, gridDim.y, hkv);
  const int q0 = blockIdx.x * kBQ;
  const T* kg = k + bhk * sk * d;
  const T* vg = v + bhk * sk * d;
  const int rg = threadIdx.x / 16;
  const int cg = threadIdx.x % 16;

  stage<T, DMAX>(q + (bh * sq + q0) * d, min(kBQ, sq - q0), d, q_s, kBQ,
                 L::kQK);

  int kb_lo, kb_hi;
  kv_range(q0, kBQ, kBK, sq, sk, causal, window, kb_lo, kb_hi);

  float m[kRows], l[kRows], acc[kRows][DMAX / 16];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DMAX / 16; ++j) acc[i][j] = 0.f;
  }

  for (int kb = kb_lo; kb < kb_hi; ++kb) {
    const int k0 = kb * kBK;
    const int kv_valid = min(kBK, sk - k0);
    __syncthreads();  // the previous step is done with k_s, v_s and p_s
    stage<T, DMAX>(kg + (int64_t)k0 * d, kv_valid, d, k_s, kBK, L::kQK);
    stage<T, DMAX>(vg + (int64_t)k0 * d, kv_valid, d, v_s, kBK, DMAX);
    __syncthreads();

    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      float qv[kRows], kv[kKeys];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = q_s[(rg + 16 * i) * L::kQK + c];
#pragma unroll
      for (int j = 0; j < kKeys; ++j) kv[j] = k_s[(cg + 16 * j) * L::kQK + c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int qp = q0 + rg + 16 * i;
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int kp = k0 + cg + 16 * j;
        bool ok = true;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && (qp - kp) < window;
        float x = ok ? s[i][j] * scale : kMasked;
        if (kp >= sk) x = -INFINITY;  // past the ragged edge: no key
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        p_s[(rg + 16 * i) * L::kP + cg + 16 * j] = p;
      }
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DMAX / 16; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    for (int kk = 0; kk < kv_valid; ++kk) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = p_s[(rg + 16 * i) * L::kP + kk];
#pragma unroll
      for (int j = 0; j < DMAX / 16; ++j) {
        const float vv = v_s[kk * DMAX + cg + 16 * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

  T* og = out + (bh * sq + q0) * d;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = rg + 16 * i;
    if (q0 + r >= sq) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int j = 0; j < DMAX / 16; ++j) {
      const int c = cg + 16 * j;
      if (c < d) og[(int64_t)r * d + c] = from_f32<T>(acc[i][j] / denom);
    }
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int b, int h, int hkv, int sq, int sk, int d, float scale,
                   int causal, int window, cudaStream_t stream) {
  const int smem = Layout<DMAX>::floats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((sq + kBQ - 1) / kBQ), (unsigned)h, (unsigned)b);
  flash_attention_kernel<T, DMAX><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), hkv, sq, sk, d, scale,
      causal, window);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 with head dim <= 128: both products on the tensor cores through
// mma.sync.m16n8k16 (bf16 in, f32 accumulate).  Four warps own 16 query rows
// each of a 64-query block; Q fragments stay in registers for the whole kv
// walk, K and V tiles (64 keys) are staged in shared memory with rows padded
// by 8 elements so the fragment loads of a warp fall in distinct banks.  The
// score accumulator of two adjacent 8-key tiles is already laid out as the A
// fragment of the PV product (the FlashAttention-2 register reuse), so P
// never touches shared memory; like the Pallas kernel it is rounded to
// bf16 for the PV product while the denominator sums the f32 values.
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMmaBQ = kMmaWarps * 16;   // queries per block
constexpr int kMmaBK = 64;               // keys per kv step

template <int DMAX>
struct MmaLayout {
  static constexpr int kStride = DMAX + 8;  // bf16 elements per smem row
  static constexpr int q = kMmaBQ * kStride;
  static constexpr int k = kMmaBK * kStride;
  static constexpr int elems = q + 2 * k;
};

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two consecutive bf16 (the lower index in the low half)
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t pack_pair(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// dst[r * kStride + c] = src[r, c] for r < valid, c < d; 0 elsewhere in the
// (n_rows, DMAX) tile.  vec: d % 8 == 0 and src 16-byte aligned, so rows
// move as 16-byte vectors.
template <int DMAX>
__device__ __forceinline__ void stage_bf16(const __nv_bfloat16* __restrict__ src,
                                           int valid, int d, int vec,
                                           __nv_bfloat16* __restrict__ dst,
                                           int n_rows) {
  constexpr int S = MmaLayout<DMAX>::kStride;
  if (vec) {
    constexpr int kV = DMAX / 8;
    for (int e = threadIdx.x; e < n_rows * kV; e += kMmaThreads) {
      const int r = e / kV;
      const int c = (e - r * kV) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < valid && c < d)
        val = *reinterpret_cast<const uint4*>(src + (int64_t)r * d + c);
      *reinterpret_cast<uint4*>(dst + r * S + c) = val;
    }
  } else {
    for (int e = threadIdx.x; e < n_rows * DMAX; e += kMmaThreads) {
      const int r = e / DMAX;
      const int c = e - r * DMAX;
      dst[r * S + c] = (r < valid && c < d) ? src[(int64_t)r * d + c]
                                            : __float2bfloat16(0.f);
    }
  }
}

template <int DMAX>
__global__ void __launch_bounds__(kMmaThreads) flash_attention_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    int hkv, int sq, int sk, int d, float scale, int causal, int window,
    int vec) {
  using L = MmaLayout<DMAX>;
  constexpr int S = L::kStride;
  constexpr int kDT = DMAX / 8;    // 8-column tiles of the output
  constexpr int kKS = DMAX / 16;   // 16-deep k steps of the score product
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + L::q;
  __nv_bfloat16* v_s = k_s + L::k;

  const int64_t bh = blockIdx.y + (int64_t)gridDim.y * blockIdx.z;
  const int q0 = blockIdx.x * kMmaBQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // fragment row (and row + 8)
  const int t = lane & 3;   // fragment column pair
  const int64_t bhk = kv_head(blockIdx.z, blockIdx.y, gridDim.y, hkv);
  const __nv_bfloat16* kg = k + bhk * sk * d;
  const __nv_bfloat16* vg = v + bhk * sk * d;

  stage_bf16<DMAX>(q + (bh * sq + q0) * d, min(kMmaBQ, sq - q0), d, vec, q_s,
                   kMmaBQ);
  __syncthreads();
  uint32_t qf[kKS][4];
  const __nv_bfloat16* qw = q_s + warp * 16 * S;
#pragma unroll
  for (int kk = 0; kk < kKS; ++kk) {
    qf[kk][0] = ld_pair(qw + g * S + kk * 16 + 2 * t);
    qf[kk][1] = ld_pair(qw + (g + 8) * S + kk * 16 + 2 * t);
    qf[kk][2] = ld_pair(qw + g * S + kk * 16 + 8 + 2 * t);
    qf[kk][3] = ld_pair(qw + (g + 8) * S + kk * 16 + 8 + 2 * t);
  }

  int kb_lo, kb_hi;
  kv_range(q0, kMmaBQ, kMmaBK, sq, sk, causal, window, kb_lo, kb_hi);
  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  float m[2] = {kMasked, kMasked};
  float l[2] = {0.f, 0.f};
  float o[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;

  for (int kb = kb_lo; kb < kb_hi; ++kb) {
    const int k0 = kb * kMmaBK;
    const int kv_valid = min(kMmaBK, sk - k0);
    __syncthreads();  // the previous step is done with k_s and v_s
    stage_bf16<DMAX>(kg + (int64_t)k0 * d, kv_valid, d, vec, k_s, kMmaBK);
    stage_bf16<DMAX>(vg + (int64_t)k0 * d, kv_valid, d, vec, v_s, kMmaBK);
    __syncthreads();

    // s = q k^T over 8 tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kr = k_s + (nt * 8 + g) * S + 2 * t;
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk)
        mma_bf16(s[nt], qf[kk], ld_pair(kr + kk * 16),
                 ld_pair(kr + kk * 16 + 8));
    }

    float mx[2] = {kMasked, kMasked};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1;
        const int qp = row0 + 8 * r;
        const int kp = k0 + nt * 8 + 2 * t + (i & 1);
        bool ok = true;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && (qp - kp) < window;
        float x = ok ? s[nt][i] * scale : kMasked;
        if (kp >= sk) x = -INFINITY;  // past the ragged edge: no key
        s[nt][i] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = expf(s[nt][i] - m[i >> 1]);
        s[nt][i] = p;
        rs[i >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * alpha[r] + rs[r];
    }
#pragma unroll
    for (int j = 0; j < kDT; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // o += p v, 16 keys per k step
#pragma unroll
    for (int ks = 0; ks < kMmaBK / 16; ++ks) {
      const uint32_t a[4] = {pack_f32(s[2 * ks][0], s[2 * ks][1]),
                             pack_f32(s[2 * ks][2], s[2 * ks][3]),
                             pack_f32(s[2 * ks + 1][0], s[2 * ks + 1][1]),
                             pack_f32(s[2 * ks + 1][2], s[2 * ks + 1][3])};
      const __nv_bfloat16* vr = v_s + (ks * 16 + 2 * t) * S + g;
#pragma unroll
      for (int j = 0; j < kDT; ++j) {
        const __nv_bfloat16* vc = vr + j * 8;
        mma_bf16(o[j], a, pack_pair(vc[0], vc[S]),
                 pack_pair(vc[8 * S], vc[9 * S]));
      }
    }
  }

  __nv_bfloat16* og = out + bh * sq * d;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= sq) continue;
    const float denom = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
    for (int j = 0; j < kDT; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = j * 8 + 2 * t + i;
        if (c < d)
          og[(int64_t)row * d + c] = __float2bfloat16(o[j][2 * r + i] / denom);
      }
  }
}

template <int DMAX>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out,
                       int b, int h, int hkv, int sq, int sk, int d,
                       float scale, int causal, int window,
                       cudaStream_t stream) {
  const int smem = MmaLayout<DMAX>::elems * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_mma_kernel<DMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int vec = aligned16(q) && aligned16(k) && aligned16(v) && d % 8 == 0;
  const dim3 grid((unsigned)((sq + kMmaBQ - 1) / kMmaBQ), (unsigned)h,
                  (unsigned)b);
  flash_attention_mma_kernel<DMAX><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      hkv, sq, sk, d, scale, causal, window, vec);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 with D = 64 or 128: flash_attention_wgmma_kernel.
//
// A CTA owns 128 queries of one (batch, head); two warpgroups own 64 rows
// each.  Q arrives once by TMA; K and V tiles of BK keys arrive by TMA into
// a ring of kStages stages, each guarded by a full / empty mbarrier pair.
// Warp 0 also issues the TMA, without blocking: it refills every stage that
// all eight warps have freed and waits only when the item it needs next is
// not issued (no warp is set aside as a producer: a ninth warp would cap
// the whole kernel at 168 registers).  All tiles have rows of 128 bytes
// under the 128-byte swizzle: a D = 128 row is two 64-column panels.  The
// tensor maps are three-dimensional over (B*H, S, D), so TMA zero-fills
// past each head's own Sq / Sk edge instead of reading the next head.
//
// Per kv block j, in each warpgroup:
//   S_j = Q K_j^T       wgmma.m64n{BK}k16, A = Q and B = K both K-major
//                        (D is contiguous in both) from shared memory;
//   O += P_{j-1} V_{j-1} wgmma.m64n{D}k16 with A = P in registers (the
//                        accumulator layout of S, rounded to bf16, is the
//                        A-fragment layout) and B = V, MN-major;
//   wait for S_j only; the softmax of S_j (exp2 with scale * log2 e folded
//   into one FFMA; masks only in blocks that cross the causal diagonal,
//   the window edge or the Sk edge) overlaps the PV product; wait for it,
//   free the stage of block j - 1, rescale O by alpha, and only then pack
//   P_j over the registers the PV product read.
// Under a causal mask the heaviest q blocks (the highest) start first; the
// heads that share one K/V head are adjacent on the grid, so their K/V
// stays in L2.
//
// Configurations (dispatch below), from a sweep on the H100 (PERF.md):
//   D = 128: BK = 128, 3 stages (224 KB with Q), one CTA an SM at 207
//            registers; the warpgroups take turns to issue (kPingPong);
//   D = 64:  BK = 64, 4 stages (80 KB), two CTAs an SM at 111 registers
//            (the other CTA's warpgroups fill the gaps; no turns).
// What sets the pace is the chain of waits inside each warpgroup (QK^T,
// softmax, PV, ring), not any one unit: trial builds without the QK^T
// product, the PV product, the exponentials or the K/V reloads each ran
// only 2-13 % faster at the qwen2.5-3b prefill shape.
constexpr int kWgThreads = 256;  // two consumer warpgroups
constexpr int kWgBQ = 128;       // queries per CTA
constexpr float kLog2e = 1.4426950408889634f;

template <int D, int BK, int kMaxStages>
struct WgLayout {
  static constexpr int kPanels = D / 64;           // 64-column panels a row
  static constexpr int kQPanel = kWgBQ * 128;      // bytes of a Q panel
  static constexpr int kKVPanel = BK * 128;        // bytes of a K / V panel
  static constexpr int kTile = kPanels * kKVPanel;  // a K or a V tile
  static constexpr int kStage = 2 * kTile;          // K, then V
  static constexpr int kRingOff = kPanels * kQPanel;
  static constexpr int kFree = 232448 - 1024 - 256 - kRingOff;
  static constexpr int kStages =
      kFree / kStage < kMaxStages ? kFree / kStage : kMaxStages;
  static constexpr int kBarOff = kRingOff + kStages * kStage;
  static constexpr int kBytes = kBarOff + (2 * kStages + 3) * 8 + 1024;
  static_assert(D == 64 || D == 128, "head dim 64 or 128");
  static_assert(BK == 64 || BK == 128, "kv block 64 or 128");
  static_assert(kStages >= 2, "a ring of at least two stages");
};

// 2^x on the special-function unit (inputs far below -126 give +0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

struct WgArgs {
  __nv_bfloat16* out;  // (B, H, Sq, D)
  int h, hkv, sq, sk, causal, window;
  float scale_log2;    // sm_scale * log2(e)
};

// S(64 x BK) = Q(64 x 16) K(BK x 16)^T, K-major B
template <int BK>
__device__ __forceinline__ void wgmma_qk(float (&s)[BK / 2], uint64_t dq,
                                         uint64_t dk, bool accumulate) {
  if constexpr (BK == 64)
    wgmma_ss_m64n64k16<0>(s, dq, dk, accumulate);
  else
    wgmma_ss_m64n128k16<0>(s, dq, dk, accumulate);
}

// O(64 x D) += P(64 x 16, registers) V(16 x D), MN-major B
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&p)[4],
                                         uint64_t dv) {
  if constexpr (D == 64)
    wgmma_rs_m64n64k16(o, p, dv, true);
  else
    wgmma_rs_m64n128k16(o, p, dv, true);
}

template <int D, int BK, int kMinBlocks, int kMaxStages, bool kPingPong>
__global__ void __launch_bounds__(kWgThreads, kMinBlocks)
    flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                                 const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 const WgArgs a) {
  using L = WgLayout<D, BK, kMaxStages>;
  constexpr int S = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* q_s = base;
  uint8_t* ring = base + L::kRingOff;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBarOff);
  uint64_t* empty = full + S;
  uint64_t* qbar = empty + S;
  uint64_t* turn = qbar + 1;  // [w]: warpgroup w may issue its wgmmas

  const int bh = blockIdx.x;  // b * h + head
  const int qb = a.causal ? (int)gridDim.y - 1 - (int)blockIdx.y
                          : (int)blockIdx.y;
  const int q0 = qb * kWgBQ;
  const int bhk = (int)kv_head(bh / a.h, bh % a.h, a.h, a.hkv);
  int kb_lo, kb_hi;
  kv_range(q0, kWgBQ, BK, a.sq, a.sk, a.causal, a.window, kb_lo, kb_hi);
  const int n_items = kb_hi - kb_lo;

  // warp-uniform as far as ptxas can tell (see mbar_arrive)
  const int warp_id = __shfl_sync(0xffffffffu, (int)threadIdx.x / 32, 0);
  const int wg = warp_id / 4;
  const int warp = warp_id % 4;
  const int lane = threadIdx.x % 32;
  const bool issuer_warp = warp_id == 0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kWgThreads / 32);  // every warp
    }
    mbar_init(qbar, 1);
    mbar_init(&turn[0], 4);  // every warp of the other warpgroup
    mbar_init(&turn[1], 4);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (issuer_warp) {
    mbar_expect_tx(qbar, L::kPanels * L::kQPanel, lane == 0);
#pragma unroll
    for (int pn = 0; pn < L::kPanels; ++pn)
      tma_load(q_s + pn * L::kQPanel, &tq, qbar, 64 * pn, q0, bh,
               lane == 0);
  }
  // Item i (kv block kb_lo + i) goes into stage i % S once all eight warps
  // have released item i - S.  Warp 0 waits for that only when item
  // need - 1 has not been issued; otherwise it issues what is free.
  int issued = 0;
  auto pump = [&](int need) {
    if (!issuer_warp) return;
    while (issued < n_items) {
      const int st = issued % S;
      if (issued >= S) {
        const uint32_t par = ((issued / S) & 1) ^ 1;
        if (issued < need)
          mbar_wait_or_trap(&empty[st], par);
        else if (!mbar_test(&empty[st], par))
          break;
      }
      uint8_t* kd = ring + st * L::kStage;
      const int k0 = (kb_lo + issued) * BK;
      mbar_expect_tx(&full[st], L::kStage, lane == 0);
#pragma unroll
      for (int pn = 0; pn < L::kPanels; ++pn) {
        tma_load(kd + pn * L::kKVPanel, &tk, &full[st], 64 * pn, k0, bhk,
                 lane == 0);
        tma_load(kd + L::kTile + pn * L::kKVPanel, &tv, &full[st], 64 * pn,
                 k0, bhk, lane == 0);
      }
      ++issued;
    }
  };
  pump(0);

  // this thread's rows of the accumulators: row0 and row0 + 8; columns
  // 8 n + 2 t + {0, 1} of every 8-column tile n
  const int g = lane / 4;
  const int t = lane % 4;
  const int warp_row = q0 + 64 * wg + 16 * warp;
  const int row0 = warp_row + g;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float s[BK / 2];
  uint32_t p[BK / 16][4];
  float m[2] = {kMasked, kMasked};
  float l[2] = {0.f, 0.f};   // this lane's part of the row sums
  const uint8_t* q_wg = q_s + wg * 64 * 128;

  // S_j = Q K^T for the kv block in stage st
  auto issue_qk = [&](int st) {
    const uint8_t* k_s = ring + st * L::kStage;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_qk<BK>(s,
                   desc(q_wg + (kk / 4) * L::kQPanel + (kk % 4) * 32, 16,
                        1024),
                   desc(k_s + (kk / 4) * L::kKVPanel + (kk % 4) * 32, 16,
                        1024),
                   kk > 0);
  };
  // O += P V for the kv block in stage st
  auto issue_pv = [&](int st) {
    const uint8_t* v_s = ring + st * L::kStage + L::kTile;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
      wgmma_pv<D>(o, p[ks], desc(v_s + ks * 2048, L::kKVPanel, 1024));
  };
  // scores of the kv block at k0 -> f32 weights in s; returns alpha
  auto softmax = [&](int k0, float (&alpha)[2]) {
    const bool edge =
        k0 + BK > a.sk || (a.causal && k0 + BK - 1 > warp_row) ||
        (a.window > 0 && warp_row + 15 - k0 >= a.window);
    float mx[2] = {kMasked, kMasked};
    if (!edge && a.scale_log2 > 0.f) {
      // no mask: the row max of the raw scores, scaled once, and
      // p = 2^(s c - m) in one FFMA per score
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * a.scale_log2);
        alpha[r] = fast_exp2(m[r] - m_new);
        m[r] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int r = (i >> 1) & 1;
        s[i] = fast_exp2(fmaf(s[i], a.scale_log2, -m[r]));
        rs[r] += s[i];
      }
      l[0] = l[0] * alpha[0] + rs[0];
      l[1] = l[1] * alpha[1] + rs[1];
      return;
    }
    // a block that crosses a mask edge (or sm_scale <= 0): scale, mask,
    // then the row max
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int kp = k0 + 8 * (i / 4) + 2 * t + (i & 1);
      const int qp = row0 + 8 * ((i >> 1) & 1);
      bool ok = true;
      if (a.causal) ok = ok && kp <= qp;
      if (a.window > 0) ok = ok && (qp - kp) < a.window;
      float x = ok ? s[i] * a.scale_log2 : kMasked;
      if (kp >= a.sk) x = -INFINITY;  // past the ragged edge: no key
      s[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = fast_exp2(m[r] - m_new);
      m[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = fast_exp2(s[i] - m[r]);
      rs[r] += s[i];
    }
    l[0] = l[0] * alpha[0] + rs[0];
    l[1] = l[1] * alpha[1] + rs[1];
  };
  auto rescale_and_pack = [&](const float (&alpha)[2]) {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        p[ks][r] = pack_f32(s[8 * ks + 2 * r], s[8 * ks + 2 * r + 1]);
  };

  // With kPingPong the two warpgroups take turns to issue their wgmmas
  // (warpgroup 0 first), so one's softmax runs while the other's products
  // do; turn[w] completes a phase when the other warpgroup has issued.
  uint32_t turns = 0;
  auto my_turn = [&]() {
    if (kPingPong) mbar_wait_or_trap(&turn[wg], turns & 1);
  };
  auto pass_turn = [&](bool last) {
    // warpgroup 1's last turn has no successor
    if (kPingPong && !(last && wg == 1))
      mbar_arrive(&turn[1 - wg], lane == 0);
    ++turns;
  };
  if (kPingPong && wg == 1) mbar_arrive(&turn[0], lane == 0);

  mbar_wait_or_trap(qbar, 0);  // no TMA may be in flight when a CTA exits
  if (n_items > 0) {
    float alpha[2];
    // block 0: S_0 alone
    pump(1);
    mbar_wait_or_trap(&full[0], 0);
    my_turn();
    wgmma_fence();
    issue_qk(0);
    wgmma_commit();
    pass_turn(false);
    wgmma_wait<0>();
    pin(s);
    softmax(kb_lo * BK, alpha);
    rescale_and_pack(alpha);
    for (int j = 1; j < n_items; ++j) {
      const int st = j % S;
      const int prev = (j - 1) % S;
      pump(j + 1);
      mbar_wait_or_trap(&full[st], (j / S) & 1);
      my_turn();
      wgmma_fence();
      issue_qk(st);
      wgmma_commit();
      issue_pv(prev);
      wgmma_commit();
      pass_turn(false);
      wgmma_wait<1>();  // S_j is done; P_{j-1} V_{j-1} may still run
      pin(s);
      softmax((kb_lo + j) * BK, alpha);
      pin(s);  // the softmax stays before the wait, overlapping PV
      pin(l);
      wgmma_wait<0>();  // P_{j-1} V_{j-1} is done: p and o are free
      pin(o);
      pin(s);  // the packing of P_j below stays after the wait
      mbar_arrive(&empty[prev], lane == 0);
      pump(0);
      rescale_and_pack(alpha);
    }
    my_turn();
    wgmma_fence();
    issue_pv((n_items - 1) % S);
    wgmma_commit();
    pass_turn(true);
    wgmma_wait<0>();
    pin(o);
  }

  // out = O / l in bf16; rows past Sq are not stored
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  __nv_bfloat16* og = a.out + (int64_t)bh * a.sq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= a.sq) continue;
    const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
    __nv_bfloat16* orow = og + (int64_t)row * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
          __floats2bfloat162_rn(o[4 * n + 2 * r] * inv,
                                o[4 * n + 2 * r + 1] * inv);
  }
}

template <int D, int BK, int kMinBlocks, int kMaxStages, bool kPingPong>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         void* out, int b, int h, int hkv, int sq, int sk,
                         float scale, int causal, int window,
                         cudaStream_t stream) {
  using L = WgLayout<D, BK, kMaxStages>;
  const int n_qb = (sq + kWgBQ - 1) / kWgBQ;
  if (n_qb > 65535) return cudaErrorInvalidConfiguration;
  CUtensorMap tq{}, tk{}, tv{};
  if (encode_tiled() == nullptr ||
      !tensor_map(&tq, q, b * h, sq, D, kWgBQ, 64,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&tk, k, b * hkv, sk, D, BK, 64,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&tv, v, b * hkv, sk, D, BK, 64,
                  CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorNotSupported;
  auto kernel =
      flash_attention_wgmma_kernel<D, BK, kMinBlocks, kMaxStages, kPingPong>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  const WgArgs args{static_cast<__nv_bfloat16*>(out), h, hkv, sq, sk,
                    causal, window, scale * kLog2e};
  kernel<<<dim3((unsigned)(b * h), (unsigned)n_qb), kWgThreads, L::kBytes,
           stream>>>(tq, tk, tv, args);
  return cudaGetLastError();
}

// The wgmma kernel takes bf16 with D = 64 or 128 and 16-byte aligned q, k
// and v (TMA reads rows of D * 2 bytes, a multiple of 16).
bool takes_wgmma(const void* q, const void* k, const void* v, int d) {
  return (d == 64 || d == 128) && aligned16(q) && aligned16(k) &&
         aligned16(v);
}

// the path the last launch took (flash_attention_last_path)
constexpr int kPathNone = -1;      // nothing launched (no query or no key)
constexpr int kPathWgmma = 0;      // flash_attention_wgmma_kernel
constexpr int kPathMma = 1;        // flash_attention_mma_kernel
constexpr int kPathCudaCores = 2;  // flash_attention_kernel
int last_path = kPathNone;

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     int b, int h, int hkv, int sq, int sk, int d,
                     float scale, int causal, int window, cudaStream_t s) {
  last_path = kPathCudaCores;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    last_path = kPathWgmma;
    if (takes_wgmma(q, k, v, d)) {
      if (d == 64)
        return launch_wgmma<64, 64, 2, 4, false>(q, k, v, out, b, h, hkv, sq,
                                                 sk, scale, causal, window,
                                                 s);
      return launch_wgmma<128, 128, 1, 3, true>(q, k, v, out, b, h, hkv, sq,
                                                sk, scale, causal, window, s);
    }
    last_path = kPathMma;
    if (d <= 64)
      return launch_mma<64>(q, k, v, out, b, h, hkv, sq, sk, d, scale,
                            causal, window, s);
    if (d <= 128)
      return launch_mma<128>(q, k, v, out, b, h, hkv, sq, sk, d, scale,
                             causal, window, s);
  }
  last_path = kPathCudaCores;
  if (d <= 32)
    return launch<T, 32>(q, k, v, out, b, h, hkv, sq, sk, d, scale, causal,
                         window, s);
  if (d <= 64)
    return launch<T, 64>(q, k, v, out, b, h, hkv, sq, sk, d, scale, causal,
                         window, s);
  if (d <= 128)
    return launch<T, 128>(q, k, v, out, b, h, hkv, sq, sk, d, scale, causal,
                          window, s);
  if (d <= 256)
    return launch<T, 256>(q, k, v, out, b, h, hkv, sq, sk, d, scale, causal,
                          window, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro_torch

// q (b, h, sq, d), k and v (b, hkv, sk, d) with h % hkv == 0, out (b, h,
// sq, d), all contiguous and of one dtype; d <= 256.  Query head i reads
// K/V head i / (h / hkv).  Returns the cudaError_t of the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int b, int h,
                                      int hkv, int sq, int sk, int d,
                                      float scale, int causal, int window,
                                      int dtype, void* stream) {
  using namespace repro_torch;
  last_path = kPathNone;
  if ((int64_t)b * h * sq == 0 || d == 0) return (int)cudaSuccess;
  if (hkv <= 0 || h % hkv != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sk == 0)   // no key: every row is 0 (as the kernels' empty walk gives)
    return (int)cudaMemsetAsync(out, 0, (size_t)b * h * sq * d *
                                (dtype == kF32 ? 4 : 2), s);
  if (dtype == kF32) {
    return (int)dispatch<float>(q, k, v, out, b, h, hkv, sq, sk, d, scale,
                                causal, window, s);
  }
  if (dtype == kBF16) {
    return (int)dispatch<__nv_bfloat16>(q, k, v, out, b, h, hkv, sq, sk, d,
                                        scale, causal, window, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Which kernel the last flash_attention_launch on this host ran: 0 the
// wgmma kernel, 1 the mma.sync kernel, 2 the CUDA-core kernel, -1 none.
extern "C" int flash_attention_last_path() { return repro_torch::last_path; }
