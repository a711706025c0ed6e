#!/usr/bin/env python3
"""Build variants of the hybrid-ELL SpMM kernel and time them on the card,
at the shapes the GCN's main path gives it (``chip_smoke.py`` phase 3).

Run from the root of a checkout, on a machine with an H100:

    python3 benchmarks_torch/spmm_variants.py [--only NAME,NAME,...]

Each variant is ``src/repro_torch/csrc/spmm_ell.cu`` (with its headers)
with one constant changed or, for the ``cp.async.bulk`` ring, the patch
``BULK_RING`` applied, or the shipped build fed another tail plan
(``max_chunk``), or one part knocked out (the tails dropped: a wrong
result, timed only to see what the tails cost).  Every distinct source is
compiled by its own ``nvcc`` into ``build/spmm_variants/``, all in
parallel, and called through its ``spmm_ell_launch`` with ``ctypes``.
The cases are the power-law GCN's whole hybrid product (``powerlaw_graph
(131072, 8)``, width cap auto) at 128 and 32 columns in f32 and at 128 in
bf16, and the banded GCN's layer-1 wavefront 1 written in place at
``j_rows1`` (``banded_spd(131072, 8)``).  Variants are timed in two
rounds, the second in reverse order (CUDA events, 30 calls after 3
warm-ups); those that compute the function are held to the plain version
(f32 within 1e-4, bf16 within 2e-2 of the largest value).  ``--only``
runs the named variants alone.  The last line is the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "spmm_variants"
N_NODES = 131_072
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
KERNEL = "spmm_ell.cu"
GATHER = "constexpr int kGather = 4; "
BLOCKS = "constexpr int kMinBlocks = 4; "


def _gather(n: int, blocks: int) -> list:
    """Substitutions for kGather row reads in flight at kMinBlocks blocks
    an SM (65,536 / (256 * blocks) registers a thread at most)."""
    return [(KERNEL, GATHER, f"constexpr int kGather = {n}; "),
            (KERNEL, BLOCKS, f"constexpr int kMinBlocks = {blocks}; ")]


# The row reads through Hopper's bulk copies, a patch of the shipped source:
# the first lane of a group copies each named row (its column segment) into
# a ring of kGather slots in shared memory with cp.async.bulk, completion
# counted on one mbarrier a slot, and the lanes read their columns from
# shared memory, so loads in flight cost no registers.  1.7-2.6x slower than
# the register gather (PERF.md §6), so it is not shipped.
_RING_PROLOGUE = """
  extern __shared__ __align__(16) char ring_smem[];
  using R = Ring<T, kVec, kLanes>;
  uint32_t ring_phase;
  ring_init<kVec, kLanes>(ring_smem,
                          (size_t)R::kGroups * kGather * R::kSeg * sizeof(T),
                          ring_phase);
"""
BULK_RING = [
    (KERNEL, '#include "common.cuh"\n',
     '#include "common.cuh"\n#include "hopper.cuh"\n'),
    (KERNEL, "// acc[i] += sum over the group's entries", """\
// Shared memory of the bulk-copy ring: kGather slots of one segment of
// kLanes * kVec values per group, and one mbarrier a slot.
template <typename T, int kVec, int kLanes>
struct Ring {
  static constexpr int kSeg = kLanes * kVec;
  static constexpr int kGroups = kThreads / kLanes;
  static constexpr size_t kBytes =
      (size_t)kGroups * kGather * kSeg * sizeof(T) +
      (size_t)kGroups * kGather * sizeof(uint64_t);
};

template <int kVec, int kLanes>
__device__ __forceinline__ void ring_init(char* ring_smem, size_t slot_bytes,
                                          uint32_t& ring_phase) {
  ring_phase = 0;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring_smem + slot_bytes);
  for (int i = threadIdx.x; i < (kThreads / kLanes) * kGather; i += kThreads)
    mbar_init(bars + i, 1);
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  __syncthreads();
}

// acc[i] += sum over the group's entries"""),
    (KERNEL, "    int col0, bool col_ok, int q) {",
     "    int col0, int seg0, bool col_ok, int q, char* ring_smem,\n"
     "    uint32_t& ring_phase) {"),
    (KERNEL, """\
#pragma unroll
      for (int g = 0; g < kGather; ++g) {
        const int u = u0 + g;
        const int col = __shfl_sync(kFull, ec[u / kLanes], u % kLanes, kLanes);
        val[g] = __shfl_sync(kFull, ev[u / kLanes], u % kLanes, kLanes);
        if (b + u < n_ent && col_ok)
          load_f32<T, kVec>(x + (int64_t)col * c + col0, xv[g]);
      }
""", """\
      // the group's first lane copies each named row segment into its
      // slot; every lane then waits for the slot and reads its columns
      using R = Ring<T, kVec, kLanes>;
      const int grp = (threadIdx.x / kLanes);
      T* slots = reinterpret_cast<T*>(ring_smem) +
                 (size_t)grp * kGather * R::kSeg;
      uint64_t* bars = reinterpret_cast<uint64_t*>(
                           ring_smem + (size_t)R::kGroups * kGather *
                                           R::kSeg * sizeof(T)) +
                       grp * kGather;
      const int seg_n = min(R::kSeg, c - seg0);
      const uint32_t bytes = (uint32_t)(seg_n * sizeof(T));
#pragma unroll
      for (int g = 0; g < kGather; ++g) {
        const int u = u0 + g;
        const int col = __shfl_sync(kFull, ec[u / kLanes], u % kLanes, kLanes);
        val[g] = __shfl_sync(kFull, ev[u / kLanes], u % kLanes, kLanes);
        if (q == 0 && b + u < n_ent) {
          mbar_expect_tx(bars + g, bytes);
          asm volatile(
              "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
              "::bytes [%0], [%1], %2, [%3];"
              :: "r"(smem_u32(slots + g * R::kSeg)),
                 "l"(reinterpret_cast<uint64_t>(x + (int64_t)col * c +
                                                seg0)),
                 "r"(bytes), "r"(smem_u32(bars + g))
              : "memory");
        }
      }
#pragma unroll
      for (int g = 0; g < kGather; ++g) {
        if (b + u0 + g < n_ent) {
          mbar_wait_or_trap(bars + g, (ring_phase >> g) & 1u);
          ring_phase ^= 1u << g;
          if (col_ok) {
            float tmp[kVec];
            load_f32<T, kVec>(slots + g * R::kSeg + (col0 - seg0), tmp);
#pragma unroll
            for (int i = 0; i < kVec; ++i) xv[g][i] = tmp[i];
          }
        }
      }
      // every lane has read its slots before the bulk copies refill them
      __syncwarp();
      fence_proxy_async();
"""),
    (KERNEL, "    spmm_hybrid_kernel(const Args a) {\n",
     "    spmm_hybrid_kernel(const Args a) {" + _RING_PROLOGUE),
    (KERNEL, "    spmm_hybrid_split_kernel(const Args a) {\n",
     "    spmm_hybrid_split_kernel(const Args a) {" + _RING_PROLOGUE),
    (KERNEL, "col0, col_ok, q);",   # both calls of gather_entries
     "col0, seg0, col_ok, q, ring_smem,\n"
     "                                    ring_phase);"),
    (KERNEL, "  const int64_t items = a.n_chunks + a.n_rows;\n", """\
  const size_t smem = Ring<T, kVec, kLanes>::kBytes;
  cudaError_t err0 = cudaFuncSetAttribute(
      spmm_hybrid_kernel<T, kVec, kLanes>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err0 == cudaSuccess)
    err0 = cudaFuncSetAttribute(spmm_hybrid_split_kernel<T, kVec, kLanes>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
  if (err0 != cudaSuccess) return err0;
  const int64_t items = a.n_chunks + a.n_rows;
"""),
    (KERNEL, "kThreads, 0, stream>>>", "kThreads, smem, stream>>>"),
    # the bulk copies need 16-byte rows: f32 only
    (KERNEL, "  if (vec) return launch_vec<T, 4>(a, stream);\n", """\
  if (!(vec && (a.c * sizeof(T)) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(a.x) % 16 == 0))
    return cudaErrorInvalidValue;
  if (vec) return launch_vec<T, 4>(a, stream);
"""),
]

# (name, [(source file, old, new), ...], max_chunk of the plan, tails on)
VARIANTS = [
    ("shipped", [], 256, True),
    ("2 gathers in flight", _gather(2, 4), 256, True),
    ("8 gathers, 4 blocks an SM", _gather(8, 4), 256, True),
    ("8 gathers, 3 blocks an SM", _gather(8, 3), 256, True),
    ("16 gathers, 2 blocks an SM", _gather(16, 2), 256, True),
    ("16 gathers, 1 block an SM", _gather(16, 1), 256, True),
    ("max_chunk 64", [], 64, True),
    ("max_chunk 128", [], 128, True),
    ("max_chunk 512", [], 512, True),
    ("pass 2 loads 4 partials at once", [
        (KERNEL, "constexpr int kPartials = 32;",
         "constexpr int kPartials = 4;")], 256, True),
    ("cp.async.bulk ring", BULK_RING, 256, True),
    ("no tails (knock-out)", [], 256, False),
]


def build(vs: list) -> dict:
    """{variant name: its library}; variants with the same source share
    one build."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc, cmds, libs, by_source = _build.nvcc(), [], {}, {}
    for name, subs, _, _ in vs:
        key = tuple(subs)
        if key in by_source:
            libs[name] = by_source[key]
            continue
        vdir = OUT / f"variant{len(by_source)}"
        vdir.mkdir(exist_ok=True)
        texts = {f: (CSRC / f).read_text()
                 for f in (KERNEL, "common.cuh", "hopper.cuh")}
        for f, old, new in subs:
            assert old in texts[f], (name, old)
            texts[f] = texts[f].replace(old, new)
        for f, text in texts.items():
            (vdir / f).write_text(text)
        libs[name] = by_source[key] = vdir / "variant.so"
        cmds.append((name, [nvcc, *_build.FLAGS, f"-I{vdir}", "-shared",
                            str(vdir / KERNEL), "-o", str(libs[name])]))
    procs = [(name, subprocess.Popen(c, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True))
             for name, c in cmds]
    for name, p in procs:
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"{name}: build failed\n{log}")
        fn = None
        for line in log.splitlines():   # ptxas on the f32 row kernels
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                fn = m.group(1)
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and fn and re.search(r"spmm_hybrid_kernelIfLi4ELi(32|8)E",
                                      fn):
                spill = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if m and fn and re.search(r"spmm_hybrid_kernelIfLi4ELi(32|8)E",
                                      fn):
                lanes = re.search(r"Li4ELi(\d+)E", fn).group(1)
                print(f"[build] {name} (f32, {lanes} lanes a row): "
                      f"{m.group(1)} registers, {spill} bytes spilled")
    fns = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        lib.spmm_ell_launch.argtypes = _build.SIGNATURES["spmm_ell_launch"]
        lib.spmm_ell_launch.restype = ctypes.c_int
        fns[name] = lib
    return fns


def main() -> None:
    import numpy as np
    import torch
    parser = argparse.ArgumentParser()
    parser.add_argument("--only", default="",
                        help="comma-separated variant names to run")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("spmm_variants: no CUDA device")
    only = [n for n in args.only.split(",") if n]
    vs = [v for v in VARIANTS if not only or v[0] in only]
    if not vs:
        sys.exit(f"spmm_variants: no variant named {only}")
    libs = build(vs)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.gcn import CONFIG
    from repro_torch.core.sparse.formats import hybrid_width_cap
    from repro_torch.core.sparse.random import banded_spd, powerlaw_graph
    from repro_torch.core.tilefusion import fused_ops
    from repro_torch.kernels import ref, spmm
    from repro_torch.models.gcn import GCN, normalize_adjacency
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            dev)

    # (label, body cols, body vals, tails per max_chunk, x, out, out_rows)
    cases = []
    pl = normalize_adjacency(powerlaw_graph(N_NODES, 8, seed=0))
    hell = fused_ops.csr_to_ell(pl, hybrid_width_cap(np.diff(pl.indptr)))
    for c, dtype in ((128, torch.float32), (32, torch.float32),
                     (128, torch.bfloat16)):
        tails = {m: spmm.Tails.upload(
            spmm.plan_tails(hell.spill_rows, pl.n_rows, m), hell.spill_cols,
            hell.spill_vals, dev, dtype) for m in {v[2] for v in vs}}
        t = fused_ops.HybridTensors.upload(hell, dev, dtype)
        cases.append((f"power-law c{c} {str(dtype)[6:]}", t.cols, t.vals,
                      tails, randn(N_NODES, c).to(dtype), None, None))
    cfg = dataclasses.replace(CONFIG, n_nodes=N_NODES)
    ds = GCN(cfg, banded_spd(N_NODES, 8, seed=0), device=dev).entries[
        0].dsched
    st = fused_ops.schedule_tensors(ds, dev, torch.float32)
    tails = {m: spmm.Tails.upload(fused_ops.wf1_tail_plan(ds, m),
                                  ds.spill_cols1, ds.spill_vals1, dev,
                                  torch.float32) for m in {v[2] for v in vs}}
    cases.append(("banded wf1 L1 f32", st.cols1, st.vals1, tails,
                  randn(ds.n_i, 128), randn(ds.n_j, 128), st.j_rows1_32))

    def time_ms(fn, iters=30):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def rel_err(got, want):
        got, want = got.float(), want.float()
        return float((got - want).abs().max()) / float(want.abs().max())

    wants = {}
    results = {}
    for rnd in range(2):
        for name, _, max_chunk, tails_on in (vs if rnd == 0 else vs[::-1]):
            for label, cols, vals, tails, x, out0, out_rows in cases:
                kw = dict(tails=tails[max_chunk] if tails_on else None,
                          out_rows=out_rows)
                out = None if out0 is None else out0.clone()

                def run(lib=libs[name], kw=kw, out=out):
                    return spmm.launch(lib, cols, vals, x, out=out, **kw)
                got = run()
                torch.cuda.synchronize()
                err = float("nan")
                if tails_on:
                    if label not in wants:
                        wants[label] = ref.spmm_ell(
                            cols, vals, x, out=None if out0 is None
                            else out0.clone(), **kw)
                    err = rel_err(got, wants[label])
                    if not err <= TOL[str(x.dtype)[6:]]:
                        raise RuntimeError(f"{name} at {label}: rel error "
                                           f"{err}")
                results.setdefault((name, label), []).append(
                    (time_ms(run), err))
                del got, out
    for (name, label), r in results.items():
        err = r[0][1]
        print(f"[variant] {name:32s} {label:22s} {r[0][0]:.4f} / "
              f"{r[1][0]:.4f} ms" + (f"  rel err {err:.3e}" if err == err
                                     else ""))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
