#!/usr/bin/env python3
"""Time the fused FFN and MoE-FFN kernels on the card at ``chip_smoke.py``
phase 7's published cells, f32 and bf16, beside their plain versions, the
library chains (``matmul`` / ``bmm``, full f32) and the bound.

Run from the root of a checkout, on a machine with an H100:

    python3 benchmarks_torch/ffn_cells.py [--parent DIR] [--iters N]

Each cell: inputs from a seed (x unit normal, w1 / w2 scaled by
``d^-1/2`` / ``f^-1/2``, as phase 7 makes them), the kernel through
``kernels.ops`` checked row by row against its plain version (f32 within
1e-4, bf16 within 2^-6), the device function it ran (``last_path``), then
CUDA-event times (mean of ``--iters`` launches after 3 warm-ups).  With
``--parent DIR`` (an unpacked checkout of another commit, e.g. the parent
by ``git archive``) that checkout's ``csrc`` is compiled with the same
flags into ``build/ffn_parent/`` and its ``fused_ffn_launch`` /
``fused_moe_ffn_launch`` are timed on the same inputs, in turns: parent,
this tree, this tree, parent.  The build log's ptxas lines for the FFN
functions (registers, spills) are printed first; the last line is the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import _build, config, fused_ffn, ops, ref  # noqa

# (label, kernel, e (0: one expert, no leading axis), m, d, f, act): the
# phase-7 cells of chip_smoke.py
CELLS = [
    ("fused_ffn (stablelm-1.6b widths)", "fused_ffn", 0, 8192, 2048, 5632,
     "gelu"),
    ("fused_moe_ffn (granite-moe-3b experts)", "fused_moe_ffn", 40, 1024,
     1536, 512, "silu"),
]
TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.float32: 495e12 / 3, torch.bfloat16: 989e12}  # 3xTF32


def build_parent(parent: Path) -> ctypes.CDLL:
    """The parent checkout's kernels, compiled with this tree's flags."""
    out = ROOT / "build" / "ffn_parent"
    out.mkdir(parents=True, exist_ok=True)
    csrc = parent / "src" / "repro_torch" / "csrc"
    objs = []
    procs = []
    for src in _build.SOURCES:
        obj = out / (Path(src).stem + ".o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [_build.nvcc(), *_build.FLAGS, "-c", str(csrc / src), "-o",
             str(obj)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    for p in procs:
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"parent build failed:\n{log}")
    lib = out / "libparent.so"
    subprocess.run([_build.nvcc(), "-shared", "-o", str(lib),
                    *map(str, objs)], check=True)
    cdll = ctypes.CDLL(str(lib))
    for name in ("fused_ffn_launch", "fused_moe_ffn_launch"):
        fn = getattr(cdll, name)
        fn.argtypes = _build.SIGNATURES[name]
        fn.restype = ctypes.c_int
    return cdll


def time_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def row_rel(got, want) -> float:
    got, want = got.float(), want.float()
    err = (got - want).abs().amax(-1)
    return float((err / want.abs().amax(-1).clamp_min(1e-30)).max())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    build = _build.build()
    _build.library()
    sys.path.insert(0, str(ROOT))
    from chip_smoke import ptxas_report
    for fn, (regs, st, ld) in ptxas_report(build.log).items():
        if "fused_ffn" in fn:
            print(f"[ptxas] {fn}: {regs} registers, spill stores {st} "
                  f"bytes, spill loads {ld} bytes")
    parent = build_parent(args.parent) if args.parent else None
    gen = torch.Generator().manual_seed(0)
    for label, kernel, e, m, d, f, act in CELLS:
        for dtype in (torch.float32, torch.bfloat16):
            lead = (e,) if e else ()
            x = torch.randn(*lead, m, d, generator=gen).to(dev, dtype)
            w1 = (torch.randn(*lead, d, f, generator=gen) * d ** -0.5).to(
                dev, dtype)
            w2 = (torch.randn(*lead, f, d, generator=gen) * f ** -0.5).to(
                dev, dtype)
            op = getattr(ops, kernel)
            plain = ref.ffn if kernel == "fused_ffn" else ref.moe_ffn
            got = op(x, w1, w2, act=act)
            torch.cuda.synchronize()
            path = fused_ffn.last_path()
            want = plain(x, w1, w2, act=act)
            err = row_rel(got, want)
            act_fn = {"gelu": lambda t: F.gelu(t, approximate="tanh"),
                      "silu": F.silu, "none": lambda t: t}[act]
            mm = torch.matmul if kernel == "fused_ffn" else torch.bmm
            calls = {"kernel": lambda: op(x, w1, w2, act=act),
                     "plain": lambda: plain(x, w1, w2, act=act),
                     "library": lambda: mm(act_fn(mm(x, w1)), w2)}
            if parent is not None:
                out = torch.empty_like(x)
                fn = getattr(parent, f"{kernel}_launch")
                dims = (m, d, f) if kernel == "fused_ffn" else (e, m, d, f)
                code = fused_ffn.ACT_CODES[act]
                stream = config.stream_of(dev)

                def parent_call(x=x, w1=w1, w2=w2, out=out, fn=fn,
                                dims=dims, code=code, stream=stream):
                    rc = fn(x.data_ptr(), w1.data_ptr(), w2.data_ptr(),
                            out.data_ptr(), *dims, code,
                            config.DTYPE_CODES[x.dtype], stream)
                    config.raise_on_error(rc, "parent " + kernel)

                parent_call()
                torch.cuda.synchronize()
                perr = row_rel(out, want)
                order = ["parent", "kernel", "kernel", "parent"]
                calls["parent"] = parent_call
            else:
                perr = None
                order = ["kernel"]
            times = {}
            for name in order:
                times.setdefault(name, []).append(
                    time_ms(calls[name], args.iters))
            plain_ms = time_ms(calls["plain"], 3)
            lib_ms = time_ms(calls["library"], args.iters)
            moved = sum(t.numel() * t.element_size() for t in (x, w1, w2))
            moved += x.numel() * x.element_size()
            n_ops = 4.0 * x.numel() * f
            bound = max(moved / HBM_BYTES_PER_S, n_ops / PEAK_OPS[dtype]) * 1e3
            dname = str(dtype).split(".")[1]
            kern = ", ".join(f"{t:.4f}" for t in times["kernel"])
            line = (f"{label} {dname}: ran {path}, row rel err {err:.3e} "
                    f"(tolerance {TOL[dtype]}); kernel {kern} ms, "
                    f"share {bound / min(times['kernel']):.3f}; ")
            if perr is not None:
                par = ", ".join(f"{t:.4f}" for t in times["parent"])
                line += f"parent {par} ms (row rel err {perr:.3e}); "
            line += (f"plain {plain_ms:.4f} ms; library chain {lib_ms:.4f} "
                     f"ms; bound {bound:.4f} ms")
            print(line, flush=True)
            if err > TOL[dtype]:
                raise SystemExit(f"{label} {dname}: row rel err {err:.3e} > "
                                 f"{TOL[dtype]}")
            del x, w1, w2, got, want
            torch.cuda.empty_cache()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip())


if __name__ == "__main__":
    main()
