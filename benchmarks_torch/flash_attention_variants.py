#!/usr/bin/env python3
"""Build variants of the bf16 ``wgmma`` flash-attention kernel and time
them on the card, at the three shapes ``chip_smoke.py`` phase 7 uses.

Run from the root of a checkout, on a machine with an H100:

    python3 benchmarks_torch/flash_attention_variants.py

Each variant is ``src/repro_torch/csrc/flash_attention.cu`` with the
template arguments of one head dim's ``launch_wgmma`` call replaced
(kv block BK, CTAs an SM, ring stages, warpgroup ping-pong), or with one
part knocked out (a trial build that computes a wrong result, timed only
to see what the part costs).  Every variant is compiled by its own
``nvcc`` into ``build/flash_variants/``, all in parallel, and called
through its ``flash_attention_launch`` with ``ctypes``.  Variants are timed
in two rounds, the second in reverse order (CUDA events, 30 launches after
3 warm-ups); those that compute attention are held to the plain version
row by row within 2^-6.  ``scaled_dot_product_attention`` is timed beside
them as the library yardstick.  The last line is the card's name and
power limit.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "flash_variants"
# the launches the shipped dispatch makes, per head dim
SHIPPED = {64: "launch_wgmma<64, 64, 2, 4, false>",
           128: "launch_wgmma<128, 128, 1, 3, true>"}
# (name, head dim, template arguments <D, BK, CTAs an SM, stages,
# ping-pong>, knock-outs)
CONFIGS = [
    ("bk64 1cta 4st", 128, "128, 64, 1, 4, false"),
    ("bk64 1cta 4st pp", 128, "128, 64, 1, 4, true"),
    ("bk128 1cta 3st", 128, "128, 128, 1, 3, false"),
    ("bk128 1cta 3st pp (shipped)", 128, "128, 128, 1, 3, true"),
    ("bk128 1cta 2st pp", 128, "128, 128, 1, 2, true"),
    ("bk64 2cta 2st", 128, "128, 64, 2, 2, false"),
    ("bk64 2cta 4st (shipped)", 64, "64, 64, 2, 4, false"),
    ("bk64 2cta 4st pp", 64, "64, 64, 2, 4, true"),
    ("bk64 1cta 4st pp", 64, "64, 64, 1, 4, true"),
    ("bk128 1cta 4st", 64, "64, 128, 1, 4, false"),
    ("bk128 2cta 2st", 64, "64, 128, 2, 2, false"),
]
# trial builds of the shipped D = 128 kernel, each without one part
KNOCKOUTS = {
    "no QK^T product": [("      wgmma_qk<BK>(s,",
                         "      if (false) wgmma_qk<BK>(s,")],
    "no PV product": [("wgmma_pv<D>(o, p[ks], desc(v_s + ks * 2048, "
                       "L::kKVPanel, 1024));", ";")],
    "no exp2 (unmasked blocks)": [
        ("s[i] = fast_exp2(fmaf(s[i], a.scale_log2, -m[r]));",
         "s[i] = fmaf(s[i], a.scale_log2, -m[r]);")],
    "no K/V reloads (ring filled once)": [
        ("mbar_expect_tx(&full[st], L::kStage, lane == 0);",
         "mbar_expect_tx(&full[st], issued < S ? L::kStage : 0, "
         "lane == 0);"),
        ("&full[st], 64 * pn, k0, bhk,\n                 lane == 0);",
         "&full[st], 64 * pn, k0, bhk,\n                 lane == 0 && "
         "issued < S);"),
        ("64 * pn,\n                 k0, bhk, lane == 0);",
         "64 * pn,\n                 k0, bhk, lane == 0 && issued < S);")],
}
# (name, b, h, hkv, sq, sk, d, causal, window): chip_smoke.py phase 7
SHAPES = [("qwen2.5-3b prefill", 4, 16, 2, 2048, 2048, 128, True, 0),
          ("hymba-1.5b, window 1024", 1, 25, 5, 4096, 4096, 64, True, 1024),
          ("whisper-medium encoder", 4, 16, 16, 1500, 1500, 64, False, 0)]
ROW_TOL = 2.0 ** -6


def variants(src: str) -> list:
    """(name, head dim, source text, computes attention)."""
    out = []
    for name, d, args in CONFIGS:
        assert SHIPPED[d] in src, SHIPPED[d]
        out.append((f"D{d} {name}", d,
                    src.replace(SHIPPED[d], f"launch_wgmma<{args}>"), True))
    for name, subs in KNOCKOUTS.items():
        text = src
        for old, new in subs:
            assert old in text, old
            text = text.replace(old, new)
        out.append((f"D128 shipped, {name}", 128, text, False))
    return out


def build(vs: list) -> dict:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc, cmds, libs = _build.nvcc(), [], {}
    for i, (name, _, text, _) in enumerate(vs):
        cu = OUT / f"variant{i}.cu"
        cu.write_text(text)
        libs[name] = OUT / f"variant{i}.so"
        cmds.append([nvcc, *_build.FLAGS, f"-I{CSRC}", "-shared", str(cu),
                     "-o", str(libs[name])])
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    for (name, d, _, _), p in zip(vs, procs):
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"{name}: build failed\n{log}")
        lines = log.splitlines()
        for j, line in enumerate(lines):   # ptxas on this head dim's kernel
            if "Compiling" in line and f"wgmma_kernelILi{d}E" in line:
                print(f"[build] {name}: " + "; ".join(
                    x.split(":")[-1].strip() for x in lines[j + 1:j + 3]))
            if "C75" in line:
                print(f"[build] {name}: {line.strip()}")
    fns = {}
    for name, path in libs.items():
        fn = ctypes.CDLL(str(path)).flash_attention_launch
        fn.argtypes = _build.SIGNATURES["flash_attention_launch"]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> None:
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        sys.exit("flash_attention_variants: no CUDA device")
    src = (CSRC / "flash_attention.cu").read_text()
    vs = variants(src)
    fns = build(vs)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    data = {}
    for name, b, h, hkv, sq, sk, d, causal, window in SHAPES:
        q = torch.randn(b, h, sq, d, generator=g).to(dev, torch.bfloat16)
        k, v = (torch.randn(b, hkv, sk, d, generator=g).to(dev,
                                                          torch.bfloat16)
                for _ in range(2))
        data[name] = (q, k, v, causal, window,
                      ref.attention(q, k, v, causal=causal, window=window))

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

    def row_err(got, want):
        got, want = got.float(), want.float()
        err = (got - want).abs().amax(-1)
        return float((err / want.abs().amax(-1).clamp_min(1e-30)).max())

    stream = torch.cuda.current_stream().cuda_stream
    results = {}
    order = [v for v in vs]
    for rnd in range(2):
        for name, d, _, computes in (order if rnd == 0 else order[::-1]):
            for shape, (q, k, v, causal, window, want) in data.items():
                if q.shape[3] != d:
                    continue
                out = torch.empty_like(q)
                args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), q.shape[0], q.shape[1], k.shape[1],
                        q.shape[2], k.shape[2], d, d ** -0.5, int(causal),
                        window, 1, stream)

                def run(fn=fns[name], args=args):
                    err = fn(*args)
                    if err:
                        raise RuntimeError(f"{name}: cudaError {err}")
                run()
                torch.cuda.synchronize()
                err = row_err(out, want) if computes else float("nan")
                if computes and not err <= ROW_TOL:
                    raise RuntimeError(f"{name} at {shape}: row error {err}")
                results.setdefault((name, shape), []).append(
                    (time_ms(run), err))
    for (name, shape), r in results.items():
        err = r[0][1]
        print(f"[variant] {name:44s} {shape:26s} {r[0][0]:.4f} / "
              f"{r[1][0]:.4f} ms"
              + (f"  row err {err:.3e}" if err == err else ""))
    for shape, (q, k, v, causal, window, _) in data.items():
        kw = dict(enable_gqa=k.shape[1] != q.shape[1])
        if window:
            kw["attn_mask"] = ref.attention_mask(
                q.shape[2], k.shape[2], causal=causal, window=window,
                device=dev)
        else:
            kw["is_causal"] = causal
        ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, **kw))
        print(f"[sdpa] {shape:26s} {ms:.4f} ms")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
