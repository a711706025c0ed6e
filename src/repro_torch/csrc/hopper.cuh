// Hopper building blocks shared by the port's wgmma kernels
// (fused_ffn.cu, flash_attention.cu, tile_fused_gemm_spmm.cu): shared-memory
// addresses, thread-block cluster and mbarrier operations, TMA loads, wgmma
// descriptors and the wgmma shapes the kernels issue, and on the host the
// tensor maps TMA reads through.
//
// Every tile a wgmma reads here has rows of 128 bytes under the 128-byte
// swizzle, as TMA writes it (or a kernel's own stores do): a K-major operand
// (A, or B with kTransB 0) advances 32 bytes per k step (16 bf16, or 8 tf32)
// inside its 128-byte panel; an MN-major B (kTransB 1) advances 16 rows
// (2048 bytes) per k step, with LBO the stride between its 64-column
// panels.  SBO is 1024 bytes (8 rows) for both.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace repro_torch {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the shared::cluster address of `local_addr` in CTA `rank` of the cluster
__device__ __forceinline__ uint32_t peer_addr(uint32_t local_addr,
                                              uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(local_addr), "r"(rank));
  return out;
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// The single-thread operations below take a predicate instead of sitting
// in a branch: a branch that splits a warp between two wgmmas makes ptxas
// serialize them.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar, bool on = true) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n"
      :: "r"(smem_u32(bar)), "r"((int)on) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes,
                                               bool on = true) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n}\n"
      :: "r"(smem_u32(bar)), "r"(bytes), "r"((int)on) : "memory");
}

// arrive on the barrier at `bar`'s offset in CTA `rank` of the cluster,
// ordered after this thread's earlier memory accesses (cluster scope)
__device__ __forceinline__ void mbar_arrive_peer(uint64_t* bar,
                                                 uint32_t rank) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];"
      :: "r"(peer_addr(smem_u32(bar), rank)) : "memory");
}

// one try: true once the phase of parity `parity` has completed; the
// `.acquire.cluster` form also orders this thread after the release of
// arrivals from other CTAs of the cluster
template <bool kCluster>
__device__ __forceinline__ bool mbar_try_wait(uint32_t addr,
                                              uint32_t parity) {
  uint32_t done;
  if (kCluster)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  else
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  return done != 0;
}

// without waiting: has the phase of parity `parity` completed?
__device__ __forceinline__ bool mbar_test(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  return done != 0;
}

template <bool kCluster = false>
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  while (!mbar_try_wait<kCluster>(addr, parity)) {
  }
}

// mbar_wait that traps after about 2^26 tries (each suspends the thread for
// a while), so a protocol fault ends the launch with an error instead of
// hanging the card (kCluster: mbar_try_wait's cluster-scope acquire)
template <bool kCluster = false>
__device__ __forceinline__ void mbar_wait_or_trap(uint64_t* bar,
                                                  uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t tries = 0; !mbar_try_wait<kCluster>(addr, parity); ++tries)
    if (tries == (1u << 26)) __trap();
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, bool on) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "@p cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n}\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"((int)on)
      : "memory");
}

// copy `bytes` (a multiple of 16) of device memory at `src` into this CTA's
// shared memory at `dst` (both 16-byte aligned), counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar,
                                          bool on) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %4, 0;\n"
      "@p cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n}\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)),
         "r"(bytes), "r"(smem_u32(bar)), "r"((int)on)
      : "memory");
}

// ask for `bytes` (a multiple of 16) of device memory at `p` (16-byte
// aligned) to be brought into L2, without waiting and without registers
__device__ __forceinline__ void prefetch_l2(const void* p, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;"
               :: "l"(reinterpret_cast<uint64_t>(p)), "r"(bytes) : "memory");
}

// copy `bytes` of this CTA's shared memory to CTA `rank`'s copy of `dst`,
// counted on that CTA's copy of `bar`
__device__ __forceinline__ void copy_to_peer(void* dst, const void* src,
                                             uint32_t bytes, uint64_t* bar,
                                             uint32_t rank) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::"
      "bytes [%0], [%1], %2, [%3];"
      :: "r"(peer_addr(smem_u32(dst), rank)), "r"(smem_u32(src)),
         "r"(bytes), "r"(peer_addr(smem_u32(bar), rank))
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void cta_sync() {
  asm volatile("bar.sync 0;" ::: "memory");
}

// wgmma shared-memory descriptor of a tile with the 128-byte swizzle: `lbo`
// steps between 64-column panels of an MN-major tile, `sbo` between groups
// of 8 rows (1024 bytes for every tile here)
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// keeps the compiler from moving accesses of accumulator registers across
// the asynchronous wgmma instructions
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// byte offset of element (row, col < 64) of a tile with rows of 128 bytes
// under the 128-byte swizzle, as TMA writes it and wgmma reads it
__device__ __forceinline__ int sw128(int row, int col) {
  return row * 128 + (((col >> 3) ^ (row & 7)) << 4) + (col & 7) * 2;
}

// D(64 x 64, f32) (+)= A(64 x 16, smem, K-major) * B(16 x 64, smem);
// B is MN-major when kTransB is 1, K-major when 0; D is overwritten when
// `accumulate` is false
template <int kTransB>
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32],
                                                  uint64_t desc_a,
                                                  uint64_t desc_b,
                                                  bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"((int)accumulate), "n"(kTransB));
}

// D(64 x 128, f32) (+)= A(64 x 16, smem, K-major) * B(16 x 128, smem);
// B is MN-major when kTransB is 1, K-major when 0; D is overwritten when
// `accumulate` is false
template <int kTransB>
__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64],
                                                  uint64_t desc_a,
                                                  uint64_t desc_b,
                                                  bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"((int)accumulate), "n"(kTransB));
}

// D(64 x 256, f32) (+)= A(64 x 16, smem, K-major) * B(16 x 256, smem);
// B is MN-major when kTransB is 1, K-major when 0; D is overwritten when
// `accumulate` is false
template <int kTransB>
__device__ __forceinline__ void wgmma_ss_m64n256k16(float (&d)[128],
                                                  uint64_t desc_a,
                                                  uint64_t desc_b,
                                                  bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"((int)accumulate), "n"(kTransB));
}

// D(64 x 64, f32) (+)= A(64 x 16, registers) * B(16 x 64, smem, MN-major).
// Each warp holds rows 16 w .. 16 w + 15 of A in the m16n8k16 A-fragment
// layout: a[0] (row g, cols 2t, 2t + 1), a[1] (row g + 8, same), a[2] (row
// g, cols 8 + 2t, ...), a[3] (row g + 8, ...), g = lane / 4, t = lane % 4.
// The registers of `a` must not change until the wgmma has retired.
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t desc_b,
                                                  bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"((int)accumulate));
}

// D(64 x 128, f32) (+)= A(64 x 16, registers) * B(16 x 128, smem, MN-major).
// Each warp holds rows 16 w .. 16 w + 15 of A in the m16n8k16 A-fragment
// layout: a[0] (row g, cols 2t, 2t + 1), a[1] (row g + 8, same), a[2] (row
// g, cols 8 + 2t, ...), a[3] (row g + 8, ...), g = lane / 4, t = lane % 4.
// The registers of `a` must not change until the wgmma has retired.
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64],
                                                  const uint32_t (&a)[4],
                                                  uint64_t desc_b,
                                                  bool accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"((int)accumulate));
}

// tf32 value nearest to x (ties away from zero), as the b32 a tf32 wgmma
// reads: the low 13 bits of the f32 pattern are zero
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// keeps the registers of a wgmma's A operand live until after the
// wgmma.wait_group it follows (the asynchronous wgmma reads them late)
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Register-A wgmmas with a K-major B (each row of B's tile, one output
// column, holds 128 bytes of k under the 128-byte swizzle), N = 32, 64 (tf32
// only) or 128:
//   tf32: D(64 x N, f32) (+)= A(64 x 8) * B(8 x N), 32 bytes of k per step;
//   bf16: D(64 x N, f32) (+)= A(64 x 16) * B(16 x N), the same 32 bytes.
// Each warp holds rows 16 w .. 16 w + 15 of A in the m16n8 A-fragment
// layout, in 32-bit words (one tf32 value, or two bf16 values): a[0] (row
// g, word t), a[1] (row g + 8, word t), a[2] (row g, word t + 4), a[3]
// (row g + 8, word t + 4) of the step's 8 words, g = lane / 4, t = lane %
// 4.  The registers of `a` must not change until the wgmma has retired.
// tf32_ss (N = 32, 64) reads A from shared memory instead, K-major like B
// (64 rows of 128 bytes under the 128-byte swizzle, 32 bytes a step).
#define REPRO_WG_D16(o)                                                    \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),          \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7]),      \
      "+f"(d[o + 8]), "+f"(d[o + 9]), "+f"(d[o + 10]), "+f"(d[o + 11]),    \
      "+f"(d[o + 12]), "+f"(d[o + 13]), "+f"(d[o + 14]), "+f"(d[o + 15])
#define REPRO_WG_N32_REGS                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, " \
  "{%16, %17, %18, %19}, %20, p"
#define REPRO_WG_N64_REGS                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "                              \
  "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "                     \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "                     \
  "%30, %31}, {%32, %33, %34, %35}, %36, p"
#define REPRO_WG_N128_REGS                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "                              \
  "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "                     \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "                     \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "                     \
  "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "                     \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "                     \
  "%60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p"
#define REPRO_WG_N32_SS                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, " \
  "%16, %17, p"
#define REPRO_WG_N64_SS                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "                              \
  "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "                     \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "                     \
  "%30, %31}, %32, %33, p"
// the instruction, register-A or shared-memory-A
#define REPRO_WG_RS(shape_types, regs, tail, pred)                         \
  "{\n.reg .pred p;\nsetp.ne.b32 p, " pred ", 0;\n"                        \
  "wgmma.mma_async.sync.aligned." shape_types " " regs tail ";\n}\n"

template <int N>
struct WgmmaKMajorB;

template <>
struct WgmmaKMajorB<32> {
  static __device__ __forceinline__ void tf32(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b,
                                              bool accumulate) {
    asm volatile(REPRO_WG_RS("m64n32k8.f32.tf32.tf32", REPRO_WG_N32_REGS,
                             ", 1, 1", "%21")
                 : REPRO_WG_D16(0)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
                   "r"((int)accumulate));
  }
  static __device__ __forceinline__ void tf32_ss(float (&d)[16],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b,
                                                 bool accumulate) {
    asm volatile(REPRO_WG_RS("m64n32k8.f32.tf32.tf32", REPRO_WG_N32_SS,
                             ", 1, 1", "%18")
                 : REPRO_WG_D16(0)
                 : "l"(desc_a), "l"(desc_b), "r"((int)accumulate));
  }
  static __device__ __forceinline__ void bf16(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b,
                                              bool accumulate) {
    asm volatile(REPRO_WG_RS("m64n32k16.f32.bf16.bf16", REPRO_WG_N32_REGS,
                             ", 1, 1, 0", "%21")
                 : REPRO_WG_D16(0)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
                   "r"((int)accumulate));
  }
};

template <>
struct WgmmaKMajorB<64> {
  static __device__ __forceinline__ void tf32(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b,
                                              bool accumulate) {
    asm volatile(REPRO_WG_RS("m64n64k8.f32.tf32.tf32", REPRO_WG_N64_REGS,
                             ", 1, 1", "%37")
                 : REPRO_WG_D16(0), REPRO_WG_D16(16)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
                   "r"((int)accumulate));
  }
  static __device__ __forceinline__ void tf32_ss(float (&d)[32],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b,
                                                 bool accumulate) {
    asm volatile(REPRO_WG_RS("m64n64k8.f32.tf32.tf32", REPRO_WG_N64_SS,
                             ", 1, 1", "%34")
                 : REPRO_WG_D16(0), REPRO_WG_D16(16)
                 : "l"(desc_a), "l"(desc_b), "r"((int)accumulate));
  }
};

template <>
struct WgmmaKMajorB<128> {
  static __device__ __forceinline__ void tf32(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b,
                                              bool accumulate) {
    asm volatile(REPRO_WG_RS("m64n128k8.f32.tf32.tf32", REPRO_WG_N128_REGS,
                             ", 1, 1", "%69")
                 : REPRO_WG_D16(0), REPRO_WG_D16(16), REPRO_WG_D16(32),
                   REPRO_WG_D16(48)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
                   "r"((int)accumulate));
  }
  static __device__ __forceinline__ void bf16(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b,
                                              bool accumulate) {
    asm volatile(REPRO_WG_RS("m64n128k16.f32.bf16.bf16", REPRO_WG_N128_REGS,
                             ", 1, 1, 0", "%69")
                 : REPRO_WG_D16(0), REPRO_WG_D16(16), REPRO_WG_D16(32),
                   REPRO_WG_D16(48)
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
                   "r"((int)accumulate));
  }
};

#undef REPRO_WG_D16
#undef REPRO_WG_N32_REGS
#undef REPRO_WG_N64_REGS
#undef REPRO_WG_N128_REGS
#undef REPRO_WG_N32_SS
#undef REPRO_WG_N64_SS
#undef REPRO_WG_RS

// ------------------------------------------------------------ host ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver PyTorch has already loaded, so
// the library links against the runtime only
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// a map of a row-major (depth, rows, cols) tensor of bf16 (or f32, with
// `type` CU_TENSOR_MAP_DATA_TYPE_FLOAT32), boxes of (1, box_rows,
// box_cols); out-of-range elements read as zero
inline bool tensor_map(
    CUtensorMap* map, const void* base, int depth, int rows, int cols,
    int box_rows, int box_cols, CUtensorMapSwizzle swizzle,
    CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16) {
  const cuuint64_t elem = type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)depth};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * elem,
                                 (cuuint64_t)rows * cols * elem};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode_tiled()(map, type, 3,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace repro_torch
