#!/usr/bin/env python3
"""Build variants of the GeMM-SpMM wavefront-0 ``wgmma`` kernels and time
them on the card: the narrow kernel at the GCN shapes ``chip_smoke.py``
phase 3 uses, or with ``--wide`` the wide kernel (B rows over 512 bytes)
at the sparse-band mixer's and the ogbn-mag-shaped stack's shapes
(phases 14a and 11c).

Run from the root of a checkout, on a machine with an H100:

    python3 benchmarks_torch/wf0_variants.py [--wide]

Each variant is ``src/repro_torch/csrc/tile_fused_gemm_spmm.cu`` (with
its headers) with one constant changed, or with one part knocked out (a
trial build that computes a wrong result, timed only to see what the part
costs).  Every variant is compiled by its own ``nvcc`` into
``build/wf0_variants/``, all in parallel, and called through its
``tile_fused_gemm_spmm_wf0_launch`` with ``ctypes`` on the wgmma path
(the wide path with ``--wide``).  The inputs are the banded GCN's layers
(``banded_spd(131072, 8)``, ``configs/gcn.py`` widths, the schedules the
GCN inspects); with ``--wide``, the band ``decay_band_csr(2048, 32)``'s
forward schedule at b_col = c_col = 2048 (f32 and bf16) and random
tile-local fused rows at the stack's shape (14,618 tiles of 64 rows, j0
64, w0 1, b_col 1024, c_col 128, f32).  Variants are timed in two rounds,
the second in reverse order (CUDA events, 30 launches after 3 warm-ups);
those that compute the function are held to the plain version (f32
within 1e-4, bf16 within 2e-2 of the largest value).  The last line is
the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import dataclasses
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "wf0_variants"
N_NODES = 131_072
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
KERNEL = "tile_fused_gemm_spmm.cu"
# (name, [(source file, old, new), ...], computes the function)
VARIANTS = [
    ("shipped", [], True),
    ("one commit group (f32)", [
        (KERNEL, "constexpr int kGroup = kIsF32 ? (kSteps < 4 ? kSteps : 4) "
                 ": kSteps;", "constexpr int kGroup = kSteps;")], True),
    ("commit groups of 8 steps (f32)", [
        (KERNEL, "constexpr int kGroup = kIsF32 ? (kSteps < 4 ? kSteps : 4) "
                 ": kSteps;",
         "constexpr int kGroup = kIsF32 ? (kSteps < 8 ? kSteps : 8) "
         ": kSteps;")], True),
    ("8 prefetched entries a thread", [
        (KERNEL, "constexpr int kPreEntries = 16;",
         "constexpr int kPreEntries = 8;")], True),
    ("no L2 prefetch of B", [
        (KERNEL, "    if (wtid == 0 && v + stride < a.n_tiles)",
         "    if (false)")], True),
    ("no fused-row gather", [
        (KERNEL, "    fused_rows_from_tile<T, 4>(\n        ent_s,",
         "    if (false) fused_rows_from_tile<T, 4>(\n        ent_s,")], False),
    ("no products", [
        (KERNEL, "            W::tf32(acc, al[gs], dh, ks > 0);\n"
                 "            W::tf32(acc, ah[gs], dl, true);\n"
                 "            W::tf32(acc, ah[gs], dh, true);", ""),
        (KERNEL, "            W::bf16(acc, ah[gs], dh, ks > 0);", "")],
     False),
    ("no d1 store", [
        (KERNEL, "            store_f32<T, 4>(d1 + (int64_t)r * a.c_col + "
                 "4 * vc, x);",
         "            if (false) store_f32<T, 4>(d1 + (int64_t)r * a.c_col "
         "+ 4 * vc, x);")], False),
    ("B read for 2 tiles only", [
        (KERNEL, "        if (off < row_bytes) {",
         "        if (off < row_bytes && tile < 2) {")], False),
]
# the wide kernel's variants and knock-outs
WIDE_VARIANTS = [
    ("shipped", [], True),
    ("one accumulator across chunks", [
        (KERNEL, "constexpr bool kChunkSums = true;",
         "constexpr bool kChunkSums = false;")], True),
    ("3 ring stages", [
        (KERNEL, "constexpr int kWideStages = 2;",
         "constexpr int kWideStages = 3;")], True),
    ("refill each stage as soon as both warpgroups free it", [
        (KERNEL, "    mbar_arrive(&empty[st], lane == 0);\n    pump(0);",
         "    mbar_arrive(&empty[st], lane == 0);\n    pump(q + S + 1);")],
     True),
    ("the same, 3 ring stages", [
        (KERNEL, "    mbar_arrive(&empty[st], lane == 0);\n    pump(0);",
         "    mbar_arrive(&empty[st], lane == 0);\n    pump(q + S + 1);"),
        (KERNEL, "constexpr int kWideStages = 2;",
         "constexpr int kWideStages = 3;")], True),
    ("no products", [
        (KERNEL, "        W::tf32(acc, al[s], dh + off, carry || s > 0);\n"
                 "        W::tf32(acc, ah[s], dl + off, true);\n"
                 "        W::tf32(acc, ah[s], dh + off, true);", ""),
        (KERNEL, "        W::bf16(acc, ah[s], dh + off, carry || s > 0);",
         "")], False),
    ("no B loads", [
        (KERNEL, "    if (chunk >= total || v >= a.n_tiles) return;",
         "    return;")], False),
    ("no fused-row gather", [
        (KERNEL, "      fused_rows_from_tile<T, 4>(\n"
                 "          ent_s, d1_s, kLd,",
         "      if (false) fused_rows_from_tile<T, 4>(\n"
         "          ent_s, d1_s, kLd,")], False),
    ("no C pre-pass", [
        (KERNEL, "  tile_fused_gemm_spmm_wf0_c_panels_kernel<T>\n",
         "  if (false) tile_fused_gemm_spmm_wf0_c_panels_kernel<T>\n")],
     False),
]


def build(vs: list) -> dict:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc, cmds, libs = _build.nvcc(), [], {}
    for i, (name, subs, _) in enumerate(vs):
        vdir = OUT / f"variant{i}"
        vdir.mkdir(exist_ok=True)
        texts = {f: (CSRC / f).read_text()
                 for f in (KERNEL, "common.cuh", "hopper.cuh")}
        for f, old, new in subs:
            assert old in texts[f], (name, old)
            texts[f] = texts[f].replace(old, new)
        for f, text in texts.items():
            (vdir / f).write_text(text)
        libs[name] = vdir / "variant.so"
        cmds.append([nvcc, *_build.FLAGS, f"-I{vdir}", "-shared",
                     str(vdir / KERNEL), "-o", str(libs[name])])
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    for (name, _, _), p in zip(vs, procs):
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"{name}: build failed\n{log}")
        lines = log.splitlines()
        for j, line in enumerate(lines):   # ptxas on the timed kernels
            if "Compiling" in line and ("wgmma_wide_kernelI" in line or (
                    "wgmma_kernelI" in line and (
                        "Li128ELi4E" in line or "Li128ELi2E" in line))):
                kind = "f32" if "_kernelIf" in line else "bf16"
                print(f"[build] {name} ({kind}): " + "; ".join(
                    x.split(":")[-1].strip() for x in lines[j + 2:j + 4]))
            if "C75" in line:
                print(f"[build] {name}: {line.strip()}")
    fns = {}
    for name, path in libs.items():
        fn = ctypes.CDLL(str(path)).tile_fused_gemm_spmm_wf0_launch
        fn.argtypes = _build.SIGNATURES["tile_fused_gemm_spmm_wf0_launch"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def narrow_cases(dev, rng) -> list:
    """(label, t, cols0, vals0, b, c) at the banded GCN's two layers."""
    import numpy as np
    import torch
    from repro_torch.configs.gcn import CONFIG
    from repro_torch.core.sparse.random import banded_spd
    from repro_torch.core.tilefusion import fused_ops
    from repro_torch.models.gcn import GCN
    cfg = dataclasses.replace(CONFIG, n_nodes=N_NODES)
    model = GCN(cfg, banded_spd(N_NODES, 8, seed=0), seed=0, device=dev)
    cases = []
    for label, entry, dtypes in (("GCN layer 1", model.entries[0],
                                  (torch.float32, torch.bfloat16)),
                                 ("GCN layer 2", model.entries[1],
                                  (torch.float32,))):
        ds = entry.dsched
        for dtype in dtypes:
            st = fused_ops.schedule_tensors(ds, dev, dtype)
            b = torch.from_numpy(rng.standard_normal(
                (ds.n_tiles0 * ds.t_pad, entry.b_col), np.float32)).to(
                    dev, dtype)
            c = torch.from_numpy(rng.standard_normal(
                (entry.b_col, entry.c_col), np.float32)
                / np.float32(entry.b_col ** 0.5)).to(dev, dtype)
            cases.append((f"{label} {str(dtype)[6:]}", ds.t_pad, st.cols0,
                          st.vals0, b, c))
    return cases


def wide_cases(dev, rng) -> list:
    """(label, t, cols0, vals0, b, c) at the sparse-band mixer's forward
    entry (f32, bf16) and the ogbn-mag-shaped stack's shape (f32)."""
    import numpy as np
    import torch
    from repro_torch.core.tilefusion import api, fused_ops
    from repro_torch.models import ssm
    band = ssm.decay_band_csr(2048, 32, 0.9)
    entry = api.get_schedule(band, b_col=2048, c_col=2048, spec=(
        dataclasses.replace(ssm._BAND_SPEC, dtype_bytes=4)))
    ds = entry.dsched

    def dense(rows, cols, dtype, scale=1.0):
        return torch.from_numpy(rng.standard_normal((rows, cols), np.float32)
                                * np.float32(scale)).to(dev, dtype)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        st = fused_ops.schedule_tensors(ds, dev, dtype)
        cases.append((f"band {str(dtype)[6:]}", ds.t_pad, st.cols0,
                      st.vals0, dense(ds.n_tiles0 * ds.t_pad, 2048, dtype),
                      dense(2048, 2048, dtype, 2048 ** -0.5)))
    n_tiles = 14_618
    cols0 = torch.from_numpy(rng.integers(0, 64, (n_tiles, 64, 1))
                             .astype(np.int32)).to(dev)
    vals0 = torch.from_numpy(rng.standard_normal((n_tiles, 64, 1))
                             .astype(np.float32)).to(dev)
    cases.append(("mag-shaped stack f32", 64, cols0, vals0,
                  dense(n_tiles * 64, 1024, torch.float32),
                  dense(1024, 128, torch.float32, 1024 ** -0.5)))
    return cases


def main() -> None:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("wf0_variants: no CUDA device")
    wide = "--wide" in sys.argv[1:]
    variants = WIDE_VARIANTS if wide else VARIANTS
    fns = build(variants)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import config, ref
    from repro_torch.kernels import tile_fused_gemm_spmm as gemm_wf0
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    cases = [(label, t, cols0, vals0, b, c,
              ref.tile_fused_gemm_spmm_wf0(cols0, vals0, b, c, t=t))
             for label, t, cols0, vals0, b, c in
             (wide_cases if wide else narrow_cases)(dev, rng)]

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

    stream = torch.cuda.current_stream().cuda_stream
    results = {}
    for rnd in range(2):
        order = variants if rnd == 0 else variants[::-1]
        for name, _, computes in order:
            for label, t, cols0, vals0, b, c, want in cases:
                n_tiles, j0, w0 = cols0.shape
                b_col, c_col = c.shape
                d1 = torch.empty((n_tiles * t, c_col), dtype=c.dtype,
                                 device=dev)
                rows0 = torch.empty((n_tiles, j0, c_col), dtype=c.dtype,
                                    device=dev)
                panels = (torch.empty(gemm_wf0.wide_panel_bytes(
                    b_col, c_col, c.dtype), dtype=torch.uint8, device=dev)
                    if wide else None)
                args = (cols0.data_ptr(), vals0.data_ptr(), b.data_ptr(),
                        c.data_ptr(), d1.data_ptr(), rows0.data_ptr(),
                        panels.data_ptr() if wide else None, n_tiles, t,
                        b_col, c_col, j0, w0, 128 if wide else min(c_col, 128),
                        2 if wide else 0, config.DTYPE_CODES[c.dtype], stream)

                def run(fn=fns[name], args=args, keep=panels):
                    err = fn(*args)
                    if err:
                        raise RuntimeError(f"{name}: cudaError {err}")
                run()
                torch.cuda.synchronize()
                err = float("nan")
                if computes:
                    err = max(rel_err(d1, want[0]), rel_err(rows0, want[1]))
                    tol = TOL[str(c.dtype)[6:]]
                    if not err <= tol:
                        raise RuntimeError(f"{name} at {label}: rel error "
                                           f"{err}")
                results.setdefault((name, label), []).append(
                    (time_ms(run), err))
    for (name, label), r in results.items():
        err = r[0][1]
        print(f"[variant] {name:28s} {label:22s} {r[0][0]:.4f} / "
              f"{r[1][0]:.4f} ms" + (f"  rel err {err:.3e}" if err == err
                                     else ""))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
