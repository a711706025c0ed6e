// Fused ungated FFN for Hopper: out[e] = act(x[e] @ w1[e]) @ w2[e], with
// the intermediate H = act(X W1) kept on chip.  One template serves both
// TPU kernels it replaces:
//   src/repro/kernels/fused_ffn.py::_fused_ffn    (one expert, e = 1)
//   src/repro/kernels/moe.py::_fused_moe_ffn      (E experts over
//                                                  capacity-dispatched tokens)
// whose Pallas bodies (_kernel in each file) are the same.
//
// The Pallas kernels walk f as a sequential grid axis and revisit one
// (block_m x d) output block in VMEM across it.  On the H100 that block
// does not fit (64 rows x d 2048 x 4 bytes is 512 KB against 227 KB of
// shared memory) and blocks run in no order, so nothing can be carried
// from one block to the next.  Design chosen here (deterministic, no
// atomics): a block owns an output tile of 16 token rows x up to 2048
// columns of d and keeps it in registers (16 x 8 f32 per thread); it walks
// f in chunks of 32 itself: per chunk it computes the 16 x 32 slice of H
// in f32 (staging 128-deep slices of X and W1 in shared memory), applies
// the activation, keeps the slice in shared memory and adds its product
// with W2[chunk, tile] into the registers.  H never touches device memory.
// For d <= 2048 (every model width the repo serves) a row block is one
// tile and H is computed once; a wider d takes ceil(d / 2048) column tiles
// and recomputes H once per tile.  Sums run in f32 and the output is
// rounded once (the Pallas kernels round H and the running output to the
// operand dtype; the plain version, like the JAX oracle, does not).
//
// Bound on the H100: operations (4 * m * d * f flops against 2(m d + 2 d f)
// operand bytes).  This first version runs on the CUDA cores in f32 (no
// mma / wgmma yet), so the FMA pipe bounds it; the W2 product is register
// tiled (each W2 value loaded once feeds 16 FMAs, each H value 8), while
// the X W1 product reads two shared-memory values per FMA pair and is the
// slower half.  Every block reads all of W1[e] and W2[e] through L2.
#include "common.cuh"

#include <math.h>

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kBM = 16;                // token rows per block
constexpr int kNJ = 8;                 // output columns per thread
constexpr int kBD = kThreads * kNJ;    // output columns per block (2048)
constexpr int kBF = 32;                // f columns of H per chunk
constexpr int kKC = 128;               // d rows of X / W1 per staged slice

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

template <typename T>
cudaError_t launch(const void* x, const void* w1, const void* w2, void* out,
                   int e, int m, int d, int f, int act, cudaStream_t stream) {
  const dim3 grid((unsigned)((m + kBM - 1) / kBM),
                  (unsigned)((d + kBD - 1) / kBD), (unsigned)e);
  fused_ffn_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const T*>(w2), static_cast<T*>(out), m, d, f, act);
  return cudaGetLastError();
}

int run(const void* x, const void* w1, const void* w2, void* out, int e,
        int m, int d, int f, int act, int dtype, void* stream) {
  if ((int64_t)e * m * d == 0) return (int)cudaSuccess;
  if (act != kNone && act != kGelu && act != kSilu)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return (int)launch<float>(x, w1, w2, out, e, m, d, f, act, s);
  if (dtype == kBF16)
    return (int)launch<__nv_bfloat16>(x, w1, w2, out, e, m, d, f, act, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro_torch

// act: 0 none, 1 gelu (tanh approximation), 2 silu.  All tensors
// contiguous and of one dtype.  Each returns the cudaError_t of its launch.

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
