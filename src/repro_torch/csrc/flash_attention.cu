// Flash attention for Hopper: out = softmax(mask(q k^T * scale)) v per
// (batch, head), with causal and sliding-window masks.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// _flash_attention (its Pallas body _kernel).  There the grid is (batch,
// heads, q blocks, kv blocks) with the kv axis sequential, and the running
// max, denominator and accumulator sit in VMEM scratch from one grid step
// to the next.  Blocks of a CUDA grid run in no order, so here one block
// owns one (batch, head, 64-query) tile and walks the kv blocks in a loop:
// K and V tiles are staged in shared memory, and the running max m, the
// denominator l and the f32 accumulator stay in registers for the whole
// walk.  The (64 x 64) score tile never leaves the SM.
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
// for 2 bytes of K and V per head dimension shared by 64 queries, far above
// the card's balance.  Two paths, chosen by dtype and head dim:
//  - bf16 with D <= 128 (every model the repo serves) runs both products on
//    the tensor cores with mma.sync.m16n8k16 (f32 accumulate), described
//    at flash_attention_mma_kernel below.  P is rounded to bf16 for the PV
//    product, as the Pallas kernel rounds it to V's dtype.
//  - f32, and bf16 with D up to 256, run on the CUDA cores in f32 (bf16 is
//    converted as it is staged), so the f32 FMA pipe bounds them: 256
//    threads each hold a 4 x 4 register tile of scores (rows rg + 16i, keys
//    cg + 16j) and a 4 x (DMAX/16) tile of the accumulator, so every
//    shared-memory load feeds 2-4 FMAs; Q and K rows are padded to an odd
//    stride so the 16 keys (or 2 rows) a warp reads at once fall in
//    distinct banks; the row max and sum are reduced with shuffles inside
//    the 16 lanes that share a row.  P stays f32.
// Neither path uses wgmma, TMA or a pipelined copy yet.
#include "common.cuh"

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

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int sq, int sk, int d,
    float scale, int causal, int window) {
  using L = Layout<DMAX>;
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + L::q;
  float* v_s = k_s + L::k;
  float* p_s = v_s + L::v;

  const int64_t bh = blockIdx.y + (int64_t)gridDim.y * blockIdx.z;
  const int q0 = blockIdx.x * kBQ;
  const T* kg = k + bh * sk * d;
  const T* vg = v + bh * sk * d;
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
                   int b, int h, int sq, int sk, int d, float scale,
                   int causal, int window, cudaStream_t stream) {
  const int smem = Layout<DMAX>::floats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((sq + kBQ - 1) / kBQ), (unsigned)h, (unsigned)b);
  flash_attention_kernel<T, DMAX><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), sq, sk, d, scale,
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
    int sq, int sk, int d, float scale, int causal, int window, int vec) {
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
  const __nv_bfloat16* kg = k + bh * sk * d;
  const __nv_bfloat16* vg = v + bh * sk * d;

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
                       int b, int h, int sq, int sk, int d, float scale,
                       int causal, int window, cudaStream_t stream) {
  const int smem = MmaLayout<DMAX>::elems * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_mma_kernel<DMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const bool aligned = reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const int vec = (aligned && d % 8 == 0) ? 1 : 0;
  const dim3 grid((unsigned)((sq + kMmaBQ - 1) / kMmaBQ), (unsigned)h,
                  (unsigned)b);
  flash_attention_mma_kernel<DMAX><<<grid, kMmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      sq, sk, d, scale, causal, window, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     int b, int h, int sq, int sk, int d, float scale,
                     int causal, int window, cudaStream_t s) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (d <= 64)
      return launch_mma<64>(q, k, v, out, b, h, sq, sk, d, scale, causal,
                            window, s);
    if (d <= 128)
      return launch_mma<128>(q, k, v, out, b, h, sq, sk, d, scale, causal,
                             window, s);
  }
  if (d <= 32)
    return launch<T, 32>(q, k, v, out, b, h, sq, sk, d, scale, causal,
                         window, s);
  if (d <= 64)
    return launch<T, 64>(q, k, v, out, b, h, sq, sk, d, scale, causal,
                         window, s);
  if (d <= 128)
    return launch<T, 128>(q, k, v, out, b, h, sq, sk, d, scale, causal,
                          window, s);
  if (d <= 256)
    return launch<T, 256>(q, k, v, out, b, h, sq, sk, d, scale, causal,
                          window, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro_torch

// q (b, h, sq, d), k and v (b, h, sk, d), out (b, h, sq, d), all contiguous
// and of one dtype; d <= 256.  Returns the cudaError_t of the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int b, int h,
                                      int sq, int sk, int d, float scale,
                                      int causal, int window, int dtype,
                                      void* stream) {
  using namespace repro_torch;
  if ((int64_t)b * h * sq == 0 || d == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    return (int)dispatch<float>(q, k, v, out, b, h, sq, sk, d, scale, causal,
                                window, s);
  }
  if (dtype == kBF16) {
    return (int)dispatch<__nv_bfloat16>(q, k, v, out, b, h, sq, sk, d, scale,
                                        causal, window, s);
  }
  return (int)cudaErrorInvalidValue;
}
