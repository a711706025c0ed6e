#!/usr/bin/env python3
"""Build variants of the f32 fused FFN kernel (``fused_ffn_tf32_kernel``,
3xTF32 on ``wgmma``) and time them on the card at ``chip_smoke.py`` phase
7's f32 cells: stablelm-1.6b's FFN widths and granite-moe-3b's experts.

Run from the root of a checkout, on a machine with an H100:

    python3 benchmarks_torch/ffn_variants.py

Each variant is ``src/repro_torch/csrc/fused_ffn.cu`` (with its headers)
with one part changed, or knocked out (a trial build that computes a
wrong result, timed only to see what the part costs).  Every variant is
compiled by its own ``nvcc`` into ``build/ffn_variants/``, all in
parallel, and called through its ``fused_ffn_launch`` /
``fused_moe_ffn_launch`` with ``ctypes``.  Inputs come from a seed (x
unit normal, w1 and w2 scaled by ``d^-1/2`` and ``f^-1/2``).  Variants are
timed in two rounds, the second in reverse order (CUDA events, 10 launches
after 2 warm-ups); those that compute the function are held to the plain
version row by row within 1e-4.  The last line is the card's name and
power limit.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "ffn_variants"
KERNEL = "fused_ffn.cu"
TOL = 1e-4
# (label, kernel, e (0: one expert), m, d, f, act)
CELLS = [("stablelm-1.6b FFN", "fused_ffn", 0, 8192, 2048, 5632, "gelu"),
         ("granite-moe-3b experts", "fused_moe_ffn", 40, 1024, 1536, 512,
          "silu")]
GEMM1_PRODUCTS = ("        W::tf32(h, al[s], dh + 2 * s, s > 0);\n"
                  "        W::tf32(h, ah[s], dl + 2 * s, true);\n"
                  "        W::tf32(h, ah[s], dh + 2 * s, true);\n")
GEMM2_PRODUCTS = ("          W128::tf32(acc, al[s], dh + 2 * s, "
                  "p > 0 || s > 0);\n"
                  "          W128::tf32(acc, ah[s], dl + 2 * s, true);\n"
                  "          W128::tf32(acc, ah[s], dh + 2 * s, true);\n")
NO_GEMM2 = (KERNEL, "    if (has_out) {\n      opaque(wtid);",
            "    if (false) {\n      opaque(wtid);")
NO_GEMM1 = (KERNEL, "    const int n_own = n1 < a.f ? (n_k - wg + 1) / 2 : 0;",
            "    const int n_own = 0;")
# (name, [(source file, old, new), ...], computes the function)
VARIANTS = [
    ("shipped", [], True),
    ("64 columns of H a CTA in the tail chunk too", [
        (KERNEL, "    const int slice = a.f - f0 > 32 * C ? 64 : 32;",
         "    const int slice = 64;")], True),
    ("no exchange copies", [
        (KERNEL, "        if (q != rank) copy_to_peer(mine, mine, bytes, hfull, "
                 "(uint32_t)q);\n", "        ;\n"),
        (KERNEL, "mbar_expect_tx(hfull, (C - 1) * bytes);",
         "mbar_expect_tx(hfull, 0u);")], False),
    ("X W1 only", [NO_GEMM2], False),
    ("X W1 only, no products", [NO_GEMM2, (KERNEL, GEMM1_PRODUCTS, "")],
     False),
    ("X W1 only, no W1 conversion", [NO_GEMM2, (
        KERNEL, "      convert_w1(slice, raw);",
        "      if (a.act == 7) convert_w1(slice, raw);")], False),
    ("X W1 only, no copies", [NO_GEMM2, (
        KERNEL, "      if (it + 2 < n_own) issue_xw1(",
        "      if (a.act == 7) issue_xw1(")], False),
    ("H W2 only", [NO_GEMM1], False),
    ("H W2 only, no products", [NO_GEMM1, (KERNEL, GEMM2_PRODUCTS, "")],
     False),
    ("H W2 only, no W2 conversion", [NO_GEMM1, (
        KERNEL, "        convert_w2();\n",
        "        if (a.act == 7) convert_w2();\n")], False),
    ("H W2 only, no copies", [NO_GEMM1, (
        KERNEL, "        if (p + 1 < live) issue_w2(",
        "        if (a.act == 7) issue_w2(")], False),
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
        for j, line in enumerate(lines):   # ptxas on the f32 kernel
            if "Compiling" in line and "fused_ffn_tf32_kernel" in line:
                print(f"[build] {name}: " + "; ".join(
                    x.split(":")[-1].strip() for x in lines[j + 2:j + 4]))
    fns = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        pair = []
        for sym in ("fused_ffn_launch", "fused_moe_ffn_launch"):
            fn = getattr(lib, sym)
            fn.argtypes = _build.SIGNATURES[sym]
            fn.restype = ctypes.c_int
            pair.append(fn)
        fns[name] = pair
    return fns


def main() -> None:
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import config, ref
    from repro_torch.kernels.fused_ffn import ACT_CODES
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    fns = build(VARIANTS)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    stream = config.stream_of(dev)
    for label, kernel, e, m, d, f, act in CELLS:
        lead = (e,) if e else ()
        x = torch.randn(*lead, m, d, generator=gen).to(dev)
        w1 = (torch.randn(*lead, d, f, generator=gen) * d ** -0.5).to(dev)
        w2 = (torch.randn(*lead, f, d, generator=gen) * f ** -0.5).to(dev)
        want = (ref.ffn if kernel == "fused_ffn" else ref.moe_ffn)(
            x, w1, w2, act=act)
        out = torch.empty_like(x)
        dims = (m, d, f) if kernel == "fused_ffn" else (e, m, d, f)
        which = 0 if kernel == "fused_ffn" else 1

        def call(name):
            rc = fns[name][which](x.data_ptr(), w1.data_ptr(),
                                  w2.data_ptr(), out.data_ptr(), *dims,
                                  ACT_CODES[act], 0, stream)
            config.raise_on_error(rc, name)

        errs = {}
        for name, _, exact in VARIANTS:
            call(name)
            torch.cuda.synchronize()
            if exact:
                got, ref_ = out.float(), want.float()
                err = (got - ref_).abs().amax(-1) / ref_.abs().amax(
                    -1).clamp_min(1e-30)
                errs[name] = float(err.max())
                if errs[name] > TOL:
                    raise SystemExit(f"{label} {name}: row rel err "
                                     f"{errs[name]:.3e} > {TOL}")
        times = {name: [] for name, _, _ in VARIANTS}
        order = [name for name, _, _ in VARIANTS]
        for rnd in (order, order[::-1]):
            for name in rnd:
                for _ in range(2):
                    call(name)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(10):
                    call(name)
                end.record()
                torch.cuda.synchronize()
                times[name].append(start.elapsed_time(end) / 10)
        for name, _, exact in VARIANTS:
            t = ", ".join(f"{v:.4f}" for v in times[name])
            tail = (f"row rel err {errs[name]:.3e}" if exact
                    else "knock-out (wrong result)")
            print(f"{label} f32 | {name}: {t} ms ({tail})", flush=True)
        del x, w1, w2, want, out
        torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip())


if __name__ == "__main__":
    main()
