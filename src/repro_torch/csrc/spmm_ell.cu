// Hybrid-ELL SpMM for Hopper, the ELL body and each row's spill tail in one
// pass:
//   out[r(i), :] = sum_w vals[i, w] * x[cols[i, w], :]
//                + sum_{k in tail(i)} tail_vals[k] * x[tail_cols[k], :]
// with f32 sums and one rounding; r(i) = out_rows[i] (rows whose target is
// n_out, the pad index, are skipped) or i.
//
// Replaces the TPU kernel src/repro/kernels/spmm.py::_spmm_ell (its Pallas
// body _kernel).  That kernel stages all of X in VMEM and gathers rows with
// a one-hot (block_rows, n) matrix fed to the MXU: it computes the ELL body
// only, since a one-hot matmul cannot walk tails of varying length, and the
// callers add the spill lanes with a scatter-add.  Here a row gather is a
// plain read from device memory through L2, so the kernel walks each row's
// tail too and the hybrid product is one call; nothing of X is staged and n
// is unbounded.
//
// Bound on the H100: bytes.  Each entry moves one row of X (c values) for
// 2c flops, far below the card's ~20 flops per byte of f32 balance, and
// the rows come from L2 at best.  Each row is a chain of dependent loads
// (its tail range, its entries, the rows they name), so what paces the
// kernel is how many rows are in flight on an SM, and how evenly the work
// is spread.  So:
// - a group of kLanes lanes owns one output row, kVec columns a lane (a
//   16-byte load for f32, 8 bytes for bf16), so a group reads a row of X as
//   contiguous segments; c = 32 puts 4 rows in a warp (8 lanes a row);
// - the group loads its row's (col, val) entries, body slots then tail,
//   coalesced, 32 at a time, and broadcasts them with __shfl_sync; a lane
//   issues the row reads of kGather entries before its first FMA, few
//   enough that a thread needs at most 64 registers and 4 blocks (32
//   warps) share an SM: more rows in flight beat deeper gathers a row;
// - a row sums its body and its tail in the same f32 registers and writes
//   once; a tail longer than max_chunk (a hub row of a power-law graph) was
//   cut into chunks by the host plan: each chunk is a work item of its own
//   that writes an f32 partial row, the chunks run first in the grid, and a
//   second launch sums the split row's body and its partials in chunk
//   order.  No float atomics: every run gives the same bits.
// Rows or widths that are not multiples of 4 columns (or unaligned x / out)
// take the same code one column a lane.
//
// Row reads through Hopper's bulk copies (cp.async.bulk of each named row
// into a shared-memory ring, counted on mbarriers, so loads in flight cost
// no registers) were 1.7-2.6x slower than the register gather at every
// main-path shape; benchmarks_torch/spmm_variants.py carries that variant
// as a patch of this file (PERF.md §6).
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;  // blocks an SM: at most 64 registers a thread
constexpr int kGather = 4;     // row reads a lane issues before its FMAs
constexpr int kBatch = 32;     // entries a group loads (coalesced) at once
constexpr int kPartials = 32;  // partial rows a lane of pass 2 loads at once
constexpr unsigned kFull = 0xffffffffu;

int g_last_path = -1;  // 0: one pass, 1: with the split-row pass

struct Args {
  const int* cols;        // (n_rows, w) body
  const void* vals;
  const void* x;          // (n, c)
  void* out;              // (n_out, c)
  const int* out_rows;    // (n_rows,) or null
  const int* ranges;      // (n_rows, 2) tail [start, end), (-1, -1) split
  const int* tail_cols;
  const void* tail_vals;
  const int* chunks;      // (n_chunks, 3) (row, start, end)
  const int* split_rows;  // (n_split,)
  const int* split_ptr;   // (n_split + 1,)
  float* partial;         // (n_chunks, c) f32 scratch
  int64_t n_rows;
  int w, c, n_out, n_chunks, n_split;
};

// One group's entries: nb body slots at (cb, vb), then nt tail lanes at
// (tc, tv).
template <typename T>
struct Entries {
  const int* cb;
  const T* vb;
  int nb;
  const int* tc;
  const T* tv;
  int nt;
};

// acc[i] += sum over the group's entries of val * x[col, col0 + i]
// (columns col0 .. col0 + kVec - 1 of this lane; col_ok false past c).
// Every lane of the warp calls it (the shuffles and the warp-wide maximum
// need all 32); a group with no entries passes nb = nt = 0.
template <typename T, int kVec, int kLanes>
__device__ __forceinline__ void gather_entries(
    float (&acc)[kVec], const Entries<T>& e, const T* __restrict__ x, int c,
    int col0, bool col_ok, int q) {
  constexpr int kPer = kBatch / kLanes;  // entries a lane holds
  const int n_ent = e.nb + e.nt;
  const int n_max = __reduce_max_sync(kFull, n_ent);
  for (int b = 0; b < n_max; b += kBatch) {
    int ec[kPer];
    float ev[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int k = b + j * kLanes + q;
      ec[j] = 0;
      ev[j] = 0.f;
      if (k < e.nb) {
        ec[j] = __ldg(e.cb + k);
        ev[j] = to_f32(e.vb[k]);
      } else if (k < n_ent) {
        ec[j] = __ldg(e.tc + (k - e.nb));
        ev[j] = to_f32(e.tv[k - e.nb]);
      }
    }
#pragma unroll
    for (int u0 = 0; u0 < kBatch; u0 += kGather) {
      if (b + u0 >= n_max) break;  // the same for the whole warp
      float xv[kGather][kVec];
      float val[kGather];
#pragma unroll
      for (int g = 0; g < kGather; ++g) {
        const int u = u0 + g;
        const int col = __shfl_sync(kFull, ec[u / kLanes], u % kLanes, kLanes);
        val[g] = __shfl_sync(kFull, ev[u / kLanes], u % kLanes, kLanes);
        if (b + u < n_ent && col_ok)
          load_f32<T, kVec>(x + (int64_t)col * c + col0, xv[g]);
      }
#pragma unroll
      for (int g = 0; g < kGather; ++g) {
        if (b + u0 + g < n_ent && col_ok) {
#pragma unroll
          for (int i = 0; i < kVec; ++i)
            acc[i] = fmaf(val[g], xv[g][i], acc[i]);
        }
      }
    }
  }
}

// Pass 1.  Work items: the chunks of split rows first (each to its f32
// partial row), then the rows (body + tail range to out[r(i)]; split rows
// and pad targets are left to pass 2 / not written).  One group an item.
template <typename T, int kVec, int kLanes>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    spmm_hybrid_kernel(const Args a) {
  const int q = threadIdx.x % kLanes;
  const int64_t item =
      ((int64_t)blockIdx.x * kThreads + threadIdx.x) / kLanes;
  const T* vals = static_cast<const T*>(a.vals);
  const T* tail_vals = static_cast<const T*>(a.tail_vals);
  Entries<T> e{nullptr, nullptr, 0, a.tail_cols, tail_vals, 0};
  float* pdst = nullptr;
  T* odst = nullptr;
  if (item < a.n_chunks) {
    const int start = a.chunks[item * 3 + 1];
    e.tc += start;
    e.tv += start;
    e.nt = a.chunks[item * 3 + 2] - start;
    pdst = a.partial + item * a.c;
  } else if (item - a.n_chunks < a.n_rows) {
    const int64_t row = item - a.n_chunks;
    int start = 0, end = 0;
    if (a.ranges != nullptr) {
      const int2 rg = reinterpret_cast<const int2*>(a.ranges)[row];
      start = rg.x;
      end = rg.y;
    }
    const int r = a.out_rows != nullptr ? a.out_rows[row] : (int)row;
    if (start >= 0 && (unsigned)r < (unsigned)a.n_out) {
      e.cb = a.cols + row * a.w;
      e.vb = vals + row * a.w;
      e.nb = a.w;
      e.tc += start;
      e.tv += start;
      e.nt = end - start;
      odst = static_cast<T*>(a.out) + (int64_t)r * a.c;
    }
  }
  for (int seg0 = 0; seg0 < a.c; seg0 += kLanes * kVec) {
    const int col0 = seg0 + q * kVec;
    const bool col_ok = col0 < a.c;
    float acc[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] = 0.f;
    gather_entries<T, kVec, kLanes>(acc, e, static_cast<const T*>(a.x), a.c,
                                    col0, col_ok, q);
    if (col_ok) {
      if (pdst != nullptr) store_f32<float, kVec>(pdst + col0, acc);
      if (odst != nullptr) store_f32<T, kVec>(odst + col0, acc);
    }
  }
}

// Pass 2: each split row's body, then its chunks' partials in chunk order,
// written once.
template <typename T, int kVec, int kLanes>
__global__ void __launch_bounds__(kThreads)
    spmm_hybrid_split_kernel(const Args a) {
  const int q = threadIdx.x % kLanes;
  const int64_t s = ((int64_t)blockIdx.x * kThreads + threadIdx.x) / kLanes;
  Entries<T> e{nullptr, nullptr, 0, nullptr, nullptr, 0};
  T* odst = nullptr;
  int k0 = 0, k1 = 0;
  if (s < a.n_split) {
    const int row = a.split_rows[s];
    const int r = a.out_rows != nullptr ? a.out_rows[row] : row;
    if ((unsigned)r < (unsigned)a.n_out) {
      e.cb = a.cols + (int64_t)row * a.w;
      e.vb = static_cast<const T*>(a.vals) + (int64_t)row * a.w;
      e.nb = a.w;
      odst = static_cast<T*>(a.out) + (int64_t)r * a.c;
      k0 = a.split_ptr[s];
      k1 = a.split_ptr[s + 1];
    }
  }
  for (int seg0 = 0; seg0 < a.c; seg0 += kLanes * kVec) {
    const int col0 = seg0 + q * kVec;
    const bool col_ok = col0 < a.c;
    float acc[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] = 0.f;
    gather_entries<T, kVec, kLanes>(acc, e, static_cast<const T*>(a.x), a.c,
                                    col0, col_ok, q);
    if (col_ok && odst != nullptr) {
      // kPartials partials loaded at once (a hub row has a hundred and
      // more), added in chunk order
      for (int k = k0; k < k1; k += kPartials) {
        float p[kPartials][kVec];
#pragma unroll
        for (int g = 0; g < kPartials; ++g)
          if (k + g < k1)
            load_f32<float, kVec>(a.partial + (int64_t)(k + g) * a.c + col0,
                                  p[g]);
#pragma unroll
        for (int g = 0; g < kPartials; ++g)
          if (k + g < k1) {
#pragma unroll
            for (int i = 0; i < kVec; ++i) acc[i] += p[g][i];
          }
      }
      store_f32<T, kVec>(odst + col0, acc);
    }
  }
}

template <typename T, int kVec, int kLanes>
cudaError_t launch_lanes(const Args& a, cudaStream_t stream) {
  const int64_t items = a.n_chunks + a.n_rows;
  const int64_t blocks = (items * kLanes + kThreads - 1) / kThreads;
  spmm_hybrid_kernel<T, kVec, kLanes>
      <<<(unsigned)blocks, kThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.n_split == 0) return err;
  const int64_t blocks2 = ((int64_t)a.n_split * kLanes + kThreads - 1) /
                          kThreads;
  spmm_hybrid_split_kernel<T, kVec, kLanes>
      <<<(unsigned)blocks2, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int kVec>
cudaError_t launch_vec(const Args& a, cudaStream_t stream) {
  // lanes a row: enough to cover c in kVec-wide loads, a power of two from
  // 4 to one warp, so groups never straddle a warp
  const int per_row = (a.c + kVec - 1) / kVec;
  if (per_row <= 4) return launch_lanes<T, kVec, 4>(a, stream);
  if (per_row <= 8) return launch_lanes<T, kVec, 8>(a, stream);
  if (per_row <= 16) return launch_lanes<T, kVec, 16>(a, stream);
  return launch_lanes<T, kVec, 32>(a, stream);
}

template <typename T>
cudaError_t dispatch(const Args& a, cudaStream_t stream) {
  // 4 columns a lane where every row of x, out and the partials starts on
  // a 4-element boundary
  const uintptr_t align = 4 * sizeof(T);
  const bool vec = a.c % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(a.x) % align == 0 &&
                   reinterpret_cast<uintptr_t>(a.out) % align == 0 &&
                   reinterpret_cast<uintptr_t>(a.partial) % 16 == 0;
  if (vec) return launch_vec<T, 4>(a, stream);
  return launch_vec<T, 1>(a, stream);
}

}  // namespace
}  // namespace repro_torch

// cols (n_rows, w) int32, vals (n_rows, w) and x (n, c) of one dtype; out
// (n_out, c) of that dtype, written at out_rows[i] (int32, null: row i,
// then n_out == n_rows); the tails (ranges (n_rows, 2), tail_cols, chunks
// (n_chunks, 3), split_rows, split_ptr int32; tail_vals in the dtype; all
// null for the body only, with n_chunks = n_split = 0); partial (n_chunks,
// c) f32 scratch; all contiguous.  Returns the cudaError_t of the launches
// (0 on success).
extern "C" int spmm_ell_launch(
    const void* cols, const void* vals, const void* x, void* out,
    const void* out_rows, const void* ranges, const void* tail_cols,
    const void* tail_vals, const void* chunks, const void* split_rows,
    const void* split_ptr, void* partial, int64_t n_rows, int w, int c,
    int n_out, int n_chunks, int n_split, int dtype, void* stream) {
  using namespace repro_torch;
  g_last_path = -1;
  if (n_rows < 0 || w < 0 || c < 0 || n_out < 0 || n_chunks < 0 ||
      n_split < 0 || n_chunks < n_split ||
      ((n_chunks > 0 || n_split > 0) &&
       (ranges == nullptr || chunks == nullptr || split_rows == nullptr ||
        split_ptr == nullptr || partial == nullptr)) ||
      (out_rows == nullptr && n_out != n_rows))
    return (int)cudaErrorInvalidValue;
  if (n_rows == 0 || c == 0) return (int)cudaSuccess;
  const Args a{static_cast<const int*>(cols), vals, x, out,
               static_cast<const int*>(out_rows),
               static_cast<const int*>(ranges),
               static_cast<const int*>(tail_cols), tail_vals,
               static_cast<const int*>(chunks),
               static_cast<const int*>(split_rows),
               static_cast<const int*>(split_ptr),
               static_cast<float*>(partial), n_rows, w, c, n_out, n_chunks,
               n_split};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == kF32) {
    err = dispatch<float>(a, s);
  } else if (dtype == kBF16) {
    err = dispatch<__nv_bfloat16>(a, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err == cudaSuccess) g_last_path = n_split > 0 ? 1 : 0;
  return (int)err;
}

// the path the last launch took: 0 one pass, 1 with the split-row pass, -1
// none (spmm_ell_last_path)
extern "C" int spmm_ell_last_path() { return repro_torch::g_last_path; }
