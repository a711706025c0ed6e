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
// for 2 (bf16) or 4 (f32) bytes of K and V per head dimension shared by a
// block of queries, far above the card's balance; f32 counts as three TF32
// products (its f32-accurate rate on the tensor cores, 165 TFLOP/s).  Four
// paths, chosen by dtype, head dim and alignment (dispatch below):
//  - bf16 with D = 64 or 128 and 16-byte aligned q, k, v (every model the
//    repo configures): flash_attention_wgmma_kernel, both products on
//    wgmma with K/V tiles arriving by TMA through a ring in shared memory;
//    described at the kernel.  P is rounded to bf16 for the PV product, as
//    the Pallas kernel rounds it to V's dtype, while l sums the f32 values.
//  - f32 with D = 64 or 128 and 16-byte aligned q, k, v (every f32 model):
//    flash_attention_tf32_kernel, both products as 3xTF32 on wgmma (each
//    operand split into tf32 hi and lo, lo*lo dropped), K and V split
//    (and V transposed) in shared memory under the products; described at
//    the kernel.  P stays f32 to 2^-22.
//  - other bf16 head dims up to 128 (or unaligned rows): both products on
//    mma.sync.m16n8k16, described at flash_attention_mma_kernel.
//  - every other shape (f32 at other head dims or unaligned, bf16 with D
//    up to 256) on the CUDA cores in f32 (bf16 is converted as it is
//    staged), so the f32 FMA pipe bounds it: 256 threads each hold a 4 x 4
//    register tile of scores (rows rg + 16i, keys cg + 16j) and a 4 x
//    (DMAX/16) tile of the accumulator, so every shared-memory load feeds
//    2-4 FMAs; Q and K rows are padded to an odd stride so the 16 keys (or
//    2 rows) a warp reads at once fall in distinct banks; the row max and
//    sum are reduced with shuffles inside the 16 lanes that share a row.
//    P stays f32.
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

// The online softmax of one kv block's scores, held in a warpgroup's
// accumulator layout: element i of `s` is (row row0 + 8 ((i >> 1) & 1), key
// k0 + 8 (i / 4) + 2 t + (i & 1)), and warp_row is the warp's first row.
// The scores become the f32 weights 2^(s c - m) in place (c = sm_scale *
// log2 e), the running max m and this lane's part of the row sums l are
// updated, and alpha is the factor the accumulator is to be rescaled by.
// Masks are applied only in blocks that cross the causal diagonal, the
// window edge or the Sk edge (or when c <= 0).
template <int N>
__device__ __forceinline__ void online_softmax(
    float (&s)[N], float (&m)[2], float (&l)[2], float (&alpha)[2], int k0,
    int warp_row, int row0, int t, int sk, int causal, int window,
    float scale_log2) {
  constexpr int BK = 2 * N;   // keys of the block
  const bool edge = k0 + BK > sk || (causal && k0 + BK - 1 > warp_row) ||
                    (window > 0 && warp_row + 15 - k0 >= window);
  float mx[2] = {kMasked, kMasked};
  if (!edge && scale_log2 > 0.f) {
    // no mask: the row max of the raw scores, scaled once, and
    // p = 2^(s c - m) in one FFMA per score
#pragma unroll
    for (int i = 0; i < N; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * scale_log2);
      alpha[r] = fast_exp2(m[r] - m_new);
      m[r] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int r = (i >> 1) & 1;
      s[i] = fast_exp2(fmaf(s[i], scale_log2, -m[r]));
      rs[r] += s[i];
    }
    l[0] = l[0] * alpha[0] + rs[0];
    l[1] = l[1] * alpha[1] + rs[1];
    return;
  }
  // a block that crosses a mask edge (or sm_scale <= 0): scale, mask,
  // then the row max
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int kp = k0 + 8 * (i / 4) + 2 * t + (i & 1);
    const int qp = row0 + 8 * ((i >> 1) & 1);
    bool ok = true;
    if (causal) ok = ok && kp <= qp;
    if (window > 0) ok = ok && (qp - kp) < window;
    float x = ok ? s[i] * scale_log2 : kMasked;
    if (kp >= sk) x = -INFINITY;  // past the ragged edge: no key
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
  for (int i = 0; i < N; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = fast_exp2(s[i] - m[r]);
    rs[r] += s[i];
  }
  l[0] = l[0] * alpha[0] + rs[0];
  l[1] = l[1] * alpha[1] + rs[1];
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
    online_softmax(s, m, l, alpha, k0, warp_row, row0, t, a.sk, a.causal,
                   a.window, a.scale_log2);
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

// ---------------------------------------------------------------------------
// f32 with D = 64 or 128: flash_attention_tf32_kernel.
//
// Both products as 3xTF32 on wgmma, as fused_ffn.cu's f32 path: each
// operand v is split into tf32 hi = rna(v) and lo = rna(v - hi), and each
// 8-deep k step issues lo*hi, hi*lo, then hi*hi (lo*lo is dropped), so the
// result keeps f32's accuracy at a third of the TF32 rate.  A CTA owns 128
// queries of one (batch, head), two warpgroups 64 rows each, as the bf16
// kernel; warp 0 also issues the TMA.  What changes against bf16:
//   - TF32 wgmma reads K-major operands only, and TMA cannot split or
//     transpose, so K and V arrive raw by TMA (f32 rows of 32 floats a
//     128-byte swizzled panel) through a ring of kStages stages, and the
//     CTA's 256 threads split each block into the tiles the wgmmas read:
//     K hi / lo in K's own layout (S = Q K^T has D contiguous in both
//     operands), V^T hi / lo with a row per head dim and the block's keys
//     along it (O += P V needs V K-major in the keys).
//   - Q is split once: hi into registers (the A fragments of Q hi K lo and
//     Q hi K hi), lo written over the raw tile in place (the shared-memory
//     A of Q lo K hi, tf32_ss), so no register holds Q lo.
//   - P is split in registers.  The S accumulator gives thread t the keys
//     2t and 2t + 1 of each 8, and the tf32 A fragment wants words t and
//     t + 4, so V^T holds each 8 keys in the order 0, 2, 4, 6, 1, 3, 5, 7
//     (tf32_key) and P's words go in as they lie (the sum is unchanged).
//   - Accuracy: the tensor cores' own accumulation rounds toward zero
//     (tile_fused_gemm_spmm.cu), and O lives across the whole kv walk, so
//     each block's P V goes into fresh accumulators (64 columns at a
//     time) that are added to the f32 O in registers; S is fresh each
//     block.
//   - Overlap: the splits run under the products.  Per kv block j, each
//     warpgroup issues S = Q K_j^T, the CTA splits V_j while it runs,
//     then the softmax; after a CTA barrier (V_j^T stored, K_j read, stage
//     free: warp 0 refills it) each warpgroup issues P V_j while the CTA
//     splits K_{j+1}; a second barrier (K_{j+1} stored, V_j^T read) ends
//     the block.
// Shared memory (TfLayout): Q (128 rows, lo after the split), the K hi /
// lo and V^T hi / lo tiles of one block, and the raw ring: at D = 128 with
// 32-key blocks and 2 stages 192 KB, at D = 64 with 64-key blocks 160 KB.
// Registers, D = 128: O 64, Q hi 64, the P V accumulators 32, S and P's
// split 48; ptxas spills none at either head dim.
// What sets the pace (benchmarks_torch/flash_attention_variants.py on an
// H100, qwen2.5-3b's prefill: 0.85 ms against a 0.42 ms bound): the
// products themselves (without Q K^T 0.60 ms, without P V 0.69-0.74),
// then the softmax and the two CTA barriers a block, at which both
// warpgroups wait together.  The splits run mostly under the products
// (without the V^T split 0.76-0.82 ms, without the K split 0.79) and the
// copies are hidden (never reloading K / V 0.82-0.83).  A third stage
// changes nothing; 32-key blocks at D = 64 run ~10 % slower.
constexpr int kTfPanel = 32;   // f32 values in a 128-byte swizzled row

template <int D, int BK, int kStages>
struct TfLayout {
  static constexpr int kPanels = D / kTfPanel;      // panels a Q / K / V row
  static constexpr int kQPanel = kWgBQ * 128;       // bytes of a Q panel
  static constexpr int kKPanel = BK * 128;          // of a K / V panel
  static constexpr int kVtPanel = D * 128;          // of a V^T panel (32 keys)
  static constexpr int kTile = BK * D * 4;          // a K, V or V^T tile
  static constexpr int kKhOff = kPanels * kQPanel;  // after Q
  static constexpr int kKlOff = kKhOff + kTile;
  static constexpr int kVhOff = kKlOff + kTile;
  static constexpr int kVlOff = kVhOff + kTile;
  static constexpr int kRingOff = kVlOff + kTile;
  static constexpr int kStage = 2 * kTile;          // raw K, then raw V
  static constexpr int kBarOff = kRingOff + kStages * kStage;
  static constexpr int kBytes = kBarOff + (kStages + 1) * 8 + 1024;
  static_assert(D == 64 || D == 128, "head dim 64 or 128");
  static_assert(BK == 32 || BK == 64, "kv block 32 or 64");
  static_assert(kStages >= 1, "a ring of at least one stage");
  static_assert(kBytes <= 232448, "more shared memory than a block has");
};

struct TfArgs {
  float* out;          // (B, H, Sq, D)
  int h, hkv, sq, sk, causal, window;
  float scale_log2;    // sm_scale * log2(e)
};

// byte offset of f32 column c (< 32) of `row` in a tile with rows of 128
// bytes under the 128-byte swizzle
__device__ __forceinline__ int sw128_f32(int row, int c) {
  return row * 128 + (((c >> 2) ^ (row & 7)) << 4) + (c & 3) * 4;
}

// tf32 hi = rna(v) (returned) and lo = rna(v - hi)
__device__ __forceinline__ uint32_t split_tf32(float v, uint32_t& lo) {
  const uint32_t hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
  return hi;
}

// The key (of its 8) that word position w of a k step of V^T holds: the
// keys a thread's S accumulator holds (2t, 2t + 1) are the A fragment's
// words t and t + 4.
__host__ __device__ constexpr int tf32_key(int w) {
  return w < 4 ? 2 * w : 2 * (w - 4) + 1;
}

template <int D, int BK, int kStages>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_attention_tf32_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const TfArgs a) {
  using L = TfLayout<D, BK, kStages>;
  using WK = WgmmaKMajorB<BK>;   // S = Q K^T, N = BK
  using WV = WgmmaKMajorB<64>;   // O += P V, 64 columns of O at a time
  constexpr int S = kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* q_s = base;
  uint8_t* kh_s = base + L::kKhOff;
  uint8_t* kl_s = base + L::kKlOff;
  uint8_t* vh_s = base + L::kVhOff;
  uint8_t* vl_s = base + L::kVlOff;
  uint8_t* ring = base + L::kRingOff;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBarOff);
  uint64_t* qbar = full + S;

  const int bh = blockIdx.x;  // b * h + head
  const int qb = a.causal ? (int)gridDim.y - 1 - (int)blockIdx.y
                          : (int)blockIdx.y;
  const int q0 = qb * kWgBQ;
  const int bhk = (int)kv_head(bh / a.h, bh % a.h, a.h, a.hkv);
  int kb_lo, kb_hi;
  kv_range(q0, kWgBQ, BK, a.sq, a.sk, a.causal, a.window, kb_lo, kb_hi);
  const int n_items = kb_hi - kb_lo;

  const int tid = threadIdx.x;
  // warp-uniform as far as ptxas can tell (see mbar_arrive)
  const int warp_id = __shfl_sync(0xffffffffu, tid / 32, 0);
  const int wg = warp_id / 4;
  const int warp = warp_id % 4;
  const int lane = tid % 32;
  const bool issuer_warp = warp_id == 0;

  if (tid == 0) {
    for (int i = 0; i < S; ++i) mbar_init(&full[i], 1);
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // item i (kv block kb_lo + i) into stage i % S: raw K, then raw V
  auto issue_kv = [&](int item) {
    if (!issuer_warp) return;
    const int st = item % S;
    uint8_t* kd = ring + st * L::kStage;
    const int k0 = (kb_lo + item) * BK;
    mbar_expect_tx(&full[st], L::kStage, lane == 0);
#pragma unroll
    for (int pn = 0; pn < L::kPanels; ++pn) {
      tma_load(kd + pn * L::kKPanel, &tk, &full[st], kTfPanel * pn, k0, bhk,
               lane == 0);
      tma_load(kd + L::kTile + pn * L::kKPanel, &tv, &full[st],
               kTfPanel * pn, k0, bhk, lane == 0);
    }
  };
  if (issuer_warp) {
    mbar_expect_tx(qbar, L::kPanels * L::kQPanel, lane == 0);
#pragma unroll
    for (int pn = 0; pn < L::kPanels; ++pn)
      tma_load(q_s + pn * L::kQPanel, &tq, qbar, kTfPanel * pn, q0, bh,
               lane == 0);
  }
  for (int i = 0; i < S && i < n_items; ++i) issue_kv(i);

  // this thread's rows of the accumulators: row0 and row0 + 8 (of the Q
  // tile: row_l, row_l + 8); columns 8 n + 2 t + {0, 1} of every 8
  const int g = lane / 4;
  const int t = lane % 4;
  const int row_l = 64 * wg + 16 * warp + g;
  const int warp_row = q0 + 64 * wg + 16 * warp;
  const int row0 = warp_row + g;

  // Q: the A fragments of Q hi into registers (k step kk: rows row_l,
  // row_l + 8 at words t and t + 4), Q lo over the raw tile in place
  uint32_t qh[D / 8][4];
  mbar_wait_or_trap(qbar, 0);
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* p = reinterpret_cast<float*>(
          q_s + (kk / 4) * L::kQPanel +
          sw128_f32(row_l + 8 * (i & 1), 8 * (kk % 4) + t + 4 * (i >> 1)));
      uint32_t lo;
      qh[kk][i] = split_tf32(*p, lo);
      *p = __uint_as_float(lo);
    }

  // raw K of stage st -> K hi / lo (the same layout), part `part` of D /
  // 64 (one under each 64 columns of P V), 16 bytes a thread at a time
  auto split_k = [&](int st, int part) {
    const uint8_t* src = ring + st * L::kStage;
    constexpr int kUnits = L::kTile / 16 / (D / 64);
    static_assert(kUnits % kWgThreads == 0, "whole units a thread");
#pragma unroll
    for (int i = 0; i < kUnits / kWgThreads; ++i) {
      const int u = part * kUnits + tid + kWgThreads * i;
      const float4 v = *reinterpret_cast<const float4*>(src + 16 * u);
      uint4 hi, lo;
      hi.x = split_tf32(v.x, lo.x);
      hi.y = split_tf32(v.y, lo.y);
      hi.z = split_tf32(v.z, lo.z);
      hi.w = split_tf32(v.w, lo.w);
      *reinterpret_cast<uint4*>(kh_s + 16 * u) = hi;
      *reinterpret_cast<uint4*>(kl_s + 16 * u) = lo;
    }
  };
  // raw V of stage st -> V^T hi / lo: 16 bytes of row n (positions 4 v ..
  // 4 v + 3 of panel kp) a thread at a time; a warp takes 32 consecutive n,
  // so it reads 32 consecutive floats of one raw row per load
  auto split_v = [&](int st) {
    const uint8_t* src = ring + st * L::kStage + L::kTile;
    constexpr int kUnits = D * BK / 4;
    static_assert(kUnits % kWgThreads == 0, "whole units a thread");
#pragma unroll
    for (int i = 0; i < kUnits / kWgThreads; ++i) {
      const int q = tid + kWgThreads * i;
      const int n = q % D;
      const int kp = q / D / 8;
      const int v = q / D % 8;
      const uint8_t* col = src + (n / kTfPanel) * L::kKPanel;
      float w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        w[j] = *reinterpret_cast<const float*>(
            col + sw128_f32(kTfPanel * kp + 8 * (v / 2) +
                                tf32_key(4 * (v & 1) + j),
                            n % kTfPanel));
      uint4 hi, lo;
      hi.x = split_tf32(w[0], lo.x);
      hi.y = split_tf32(w[1], lo.y);
      hi.z = split_tf32(w[2], lo.z);
      hi.w = split_tf32(w[3], lo.w);
      const int off = kp * L::kVtPanel + n * 128 + ((v ^ (n & 7)) << 4);
      *reinterpret_cast<uint4*>(vh_s + off) = hi;
      *reinterpret_cast<uint4*>(vl_s + off) = lo;
    }
  };

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float s[BK / 2];
  float acc[32];
  uint32_t ph[BK / 8][4], pl[BK / 8][4];   // P's A fragments, hi and lo
  float m[2] = {kMasked, kMasked};
  float l[2] = {0.f, 0.f};   // this lane's part of the row sums
  // descriptors of the tiles' first k step (a step adds 32 bytes: 2)
  const uint64_t dql = desc(q_s + wg * 64 * 128, 16, 1024);
  const uint64_t dkh = desc(kh_s, 16, 1024);
  const uint64_t dkl = desc(kl_s, 16, 1024);
  const uint64_t dvh = desc(vh_s, 16, 1024);
  const uint64_t dvl = desc(vl_s, 16, 1024);

  // S = Q K^T over D: Q lo K hi, Q hi K lo, Q hi K hi a k step
  auto issue_qk = [&]() {
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      const uint32_t qo = ((kk / 4) * L::kQPanel + (kk % 4) * 32) >> 4;
      const uint32_t ko = ((kk / 4) * L::kKPanel + (kk % 4) * 32) >> 4;
      WK::tf32_ss(s, dql + qo, dkh + ko, kk > 0);
      WK::tf32(s, qh[kk], dkl + ko, true);
      WK::tf32(s, qh[kk], dkh + ko, true);
    }
  };
  // acc = P V[:, 64 c .. 64 c + 63] over the block's keys, fresh
  auto issue_pv = [&](int c) {
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      const uint32_t vo =
          ((ks / 4) * L::kVtPanel + c * 64 * 128 + (ks % 4) * 32) >> 4;
      WV::tf32(acc, pl[ks], dvh + vo, ks > 0);
      WV::tf32(acc, ph[ks], dvl + vo, true);
      WV::tf32(acc, ph[ks], dvh + vo, true);
    }
  };

  if (n_items > 0) {
    mbar_wait_or_trap(&full[0], 0);
#pragma unroll
    for (int c = 0; c < D / 64; ++c) split_k(0, c);
    fence_proxy_async();   // generic writes (Q lo, K 0), read by wgmma
    __syncthreads();
    for (int j = 0; j < n_items; ++j) {
      const int st = j % S;
      // 1. S_j = Q K_j^T, and V_j split under it
      wgmma_fence();
      issue_qk();
      wgmma_commit();
      split_v(st);
      wgmma_wait<0>();
      pin(s);
      // 2. the softmax of S_j; O rescaled; P_j split
      float alpha[2];
      online_softmax(s, m, l, alpha, (kb_lo + j) * BK, warp_row, row0, t,
                     a.sk, a.causal, a.window, a.scale_log2);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int ks = 0; ks < BK / 8; ++ks) {
        const float x[4] = {s[4 * ks], s[4 * ks + 2], s[4 * ks + 1],
                            s[4 * ks + 3]};
#pragma unroll
        for (int i = 0; i < 4; ++i) ph[ks][i] = split_tf32(x[i], pl[ks][i]);
      }
      // V_j^T is stored, every warp is done with K_j, stage st is free
      fence_proxy_async();
      __syncthreads();
      if (j + S < n_items) issue_kv(j + S);
      // 3. O += P_j V_j, 64 columns at a time into fresh accumulators,
      //    and K_{j+1} split under it
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        wgmma_fence();
        issue_pv(c);
        wgmma_commit();
        if (j + 1 < n_items) {
          if (c == 0)
            mbar_wait_or_trap(&full[(j + 1) % S], ((j + 1) / S) & 1);
          split_k((j + 1) % S, c);
        }
        wgmma_wait<0>();
        pin(acc);
#pragma unroll
        for (int i = 0; i < 32; ++i) o[32 * c + i] += acc[i];
      }
#pragma unroll
      for (int ks = 0; ks < BK / 8; ++ks) {
        pin(ph[ks]);
        pin(pl[ks]);
      }
      // K_{j+1} is stored; every warp is done with V_j^T
      fence_proxy_async();
      __syncthreads();
    }
  }
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) pin(qh[kk]);

  // out = O / l; rows past Sq are not stored
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  float* og = a.out + (int64_t)bh * a.sq * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= a.sq) continue;
    const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
    float* orow = og + (int64_t)row * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n) =
          make_float2(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
  }
}

template <int D, int BK, int kStages>
cudaError_t launch_tf32(const void* q, const void* k, const void* v,
                        void* out, int b, int h, int hkv, int sq, int sk,
                        float scale, int causal, int window,
                        cudaStream_t stream) {
  using L = TfLayout<D, BK, kStages>;
  const int n_qb = (sq + kWgBQ - 1) / kWgBQ;
  if (n_qb > 65535) return cudaErrorInvalidConfiguration;
  constexpr CUtensorMapDataType kF32Map = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap tq{}, tk{}, tv{};
  if (encode_tiled() == nullptr ||
      !tensor_map(&tq, q, b * h, sq, D, kWgBQ, kTfPanel,
                  CU_TENSOR_MAP_SWIZZLE_128B, kF32Map) ||
      !tensor_map(&tk, k, b * hkv, sk, D, BK, kTfPanel,
                  CU_TENSOR_MAP_SWIZZLE_128B, kF32Map) ||
      !tensor_map(&tv, v, b * hkv, sk, D, BK, kTfPanel,
                  CU_TENSOR_MAP_SWIZZLE_128B, kF32Map))
    return cudaErrorNotSupported;
  auto kernel = flash_attention_tf32_kernel<D, BK, kStages>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  const TfArgs args{static_cast<float*>(out), h, hkv, sq, sk, causal,
                    window, scale * kLog2e};
  kernel<<<dim3((unsigned)(b * h), (unsigned)n_qb), kWgThreads, L::kBytes,
           stream>>>(tq, tk, tv, args);
  return cudaGetLastError();
}

// The wgmma kernels take D = 64 or 128 and 16-byte aligned q, k and v
// (TMA reads rows of D * 2 or D * 4 bytes, a multiple of 16).
bool takes_wgmma(const void* q, const void* k, const void* v, int d) {
  return (d == 64 || d == 128) && aligned16(q) && aligned16(k) &&
         aligned16(v);
}

// the path the last launch took (flash_attention_last_path)
constexpr int kPathNone = -1;      // nothing launched (no query or no key)
constexpr int kPathWgmma = 0;      // flash_attention_wgmma_kernel
constexpr int kPathMma = 1;        // flash_attention_mma_kernel
constexpr int kPathCudaCores = 2;  // flash_attention_kernel
constexpr int kPathTf32 = 3;       // flash_attention_tf32_kernel
int last_path = kPathNone;

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     int b, int h, int hkv, int sq, int sk, int d,
                     float scale, int causal, int window, cudaStream_t s) {
  last_path = kPathCudaCores;
  if constexpr (std::is_same<T, float>::value) {
    if (takes_wgmma(q, k, v, d)) {
      last_path = kPathTf32;
      if (d == 64)
        return launch_tf32<64, 64, 2>(q, k, v, out, b, h, hkv, sq, sk,
                                      scale, causal, window, s);
      return launch_tf32<128, 32, 2>(q, k, v, out, b, h, hkv, sq, sk, scale,
                                     causal, window, s);
    }
  }
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
// bf16 wgmma kernel, 1 the mma.sync kernel, 2 the CUDA-core kernel, 3 the
// f32 (3xTF32) wgmma kernel, -1 none.
extern "C" int flash_attention_last_path() { return repro_torch::last_path; }
