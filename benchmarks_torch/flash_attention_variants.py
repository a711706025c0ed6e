#!/usr/bin/env python3
"""Build variants of the flash-attention kernels on ``wgmma`` and time them
on the card: the bf16 kernel at three of ``chip_smoke.py`` phase 7's
shapes, the f32 (3xTF32) kernel at all six of phase 7's flash shapes.

Run from the root of a checkout, on a machine with an H100:

    python3 benchmarks_torch/flash_attention_variants.py

Each variant is ``src/repro_torch/csrc/flash_attention.cu`` with the
template arguments of one head dim's launch replaced (bf16: kv block BK,
CTAs an SM, ring stages, warpgroup ping-pong; f32: kv block BK and ring
stages), or with one part knocked out (a trial build that computes a
wrong result, timed only to see what the part costs).  The f32 cells also
build the "before": the same source with f32's dispatch sent to the
CUDA-core ``flash_attention_kernel``, as every f32 shape ran before the
3xTF32 kernel.  Every variant is compiled by its own ``nvcc`` into
``build/flash_variants/``, all in parallel, and called through its
``flash_attention_launch`` with ``ctypes``.  Variants are timed in two
rounds, the second in reverse order (CUDA events, 30 launches after 3
warm-ups); those that compute attention are held to the plain version
row by row (bf16 within 2^-6, f32 within 1e-4).
``scaled_dot_product_attention`` is timed beside them in each dtype as
the library yardstick (f32 with TF32 off), and each f32 shape prints its
bound: 4 D FLOPs a kept (query, key) pair as three TF32 products at 495
TFLOP/s.  The last line is the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "flash_variants"
# the launches the shipped dispatch makes, per dtype and head dim
SHIPPED = {("bf16", 64): "launch_wgmma<64, 64, 2, 4, false>",
           ("bf16", 128): "launch_wgmma<128, 128, 1, 3, true>",
           ("f32", 64): "launch_tf32<64, 64, 2>",
           ("f32", 128): "launch_tf32<128, 32, 2>"}
# (dtype, name, head dim, template arguments): bf16 <D, BK, CTAs an SM,
# stages, ping-pong>, f32 <D, BK, stages>
CONFIGS = [
    ("bf16", "bk64 1cta 4st", 128, "128, 64, 1, 4, false"),
    ("bf16", "bk64 1cta 4st pp", 128, "128, 64, 1, 4, true"),
    ("bf16", "bk128 1cta 3st", 128, "128, 128, 1, 3, false"),
    ("bf16", "bk128 1cta 3st pp (shipped)", 128, "128, 128, 1, 3, true"),
    ("bf16", "bk128 1cta 2st pp", 128, "128, 128, 1, 2, true"),
    ("bf16", "bk64 2cta 2st", 128, "128, 64, 2, 2, false"),
    ("bf16", "bk64 2cta 4st (shipped)", 64, "64, 64, 2, 4, false"),
    ("bf16", "bk64 2cta 4st pp", 64, "64, 64, 2, 4, true"),
    ("bf16", "bk64 1cta 4st pp", 64, "64, 64, 1, 4, true"),
    ("bf16", "bk128 1cta 4st", 64, "64, 128, 1, 4, false"),
    ("bf16", "bk128 2cta 2st", 64, "64, 128, 2, 2, false"),
    ("f32", "bk32 2st (shipped)", 128, "128, 32, 2"),
    ("f32", "bk32 3st", 128, "128, 32, 3"),
    ("f32", "bk32 1st", 128, "128, 32, 1"),
    ("f32", "bk64 2st (shipped)", 64, "64, 64, 2"),
    ("f32", "bk64 3st", 64, "64, 64, 3"),
    ("f32", "bk32 2st", 64, "64, 32, 2"),
    ("f32", "bk32 4st", 64, "64, 32, 4"),
]
# trial builds of the shipped bf16 D = 128 kernel, each without one part
KNOCKOUTS = {
    "no QK^T product": [("      wgmma_qk<BK>(s,",
                         "      if (false) wgmma_qk<BK>(s,")],
    "no PV product": [("wgmma_pv<D>(o, p[ks], desc(v_s + ks * 2048, "
                       "L::kKVPanel, 1024));", ";")],
    "no exp2 (unmasked blocks)": [
        ("s[i] = fast_exp2(fmaf(s[i], scale_log2, -m[r]));",
         "s[i] = fmaf(s[i], scale_log2, -m[r]);")],
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
# trial builds of the shipped f32 kernel (both head dims), each without
# one part; the substitutions apply to the f32 kernel's section only
F32_SECTION = "// f32 with D = 64 or 128: flash_attention_tf32_kernel."
F32_KNOCKOUTS = {
    "no QK^T product": [("      issue_qk();",
                         "      if (false) issue_qk();")],
    "no PV product": [("        issue_pv(c);",
                       "        if (false) issue_pv(c);")],
    "no V^T split-and-transpose": [("      split_v(st);",
                                    "      if (false) split_v(st);")],
    "no K split": [("          split_k((j + 1) % S, c);",
                    "          if (false) split_k((j + 1) % S, c);")],
    "no K/V reloads (ring filled once)": [
        ("mbar_expect_tx(&full[st], L::kStage, lane == 0);",
         "mbar_expect_tx(&full[st], item < S ? L::kStage : 0, lane == 0);"),
        ("k0, bhk,\n               lane == 0);",
         "k0, bhk,\n               lane == 0 && item < S);"),
        ("kTfPanel * pn, k0, bhk, lane == 0);",
         "kTfPanel * pn, k0, bhk, lane == 0 && item < S);")],
}
# f32's dispatch sent to the CUDA cores: the kernel before the 3xTF32 one
CUDA_CORES = ("    if (takes_wgmma(q, k, v, d)) {\n"
              "      last_path = kPathTf32;",
              "    if (false) {\n      last_path = kPathTf32;")
# (dtype, name, b, h, hkv, sq, sk, d, causal, window): phase 7's flash
# cases (chip_smoke.LM_CASES), bf16 at three of them
SHAPES = [
    ("bf16", "qwen2.5-3b prefill", 4, 16, 2, 2048, 2048, 128, True, 0),
    ("bf16", "hymba-1.5b, window 1024", 1, 25, 5, 4096, 4096, 64, True,
     1024),
    ("bf16", "whisper-medium encoder", 4, 16, 16, 1500, 1500, 64, False, 0),
    ("f32", "qwen2.5-3b prefill", 4, 16, 2, 2048, 2048, 128, True, 0),
    ("f32", "hymba-1.5b, window 1024", 1, 25, 5, 4096, 4096, 64, True,
     1024),
    ("f32", "whisper-medium encoder", 4, 16, 16, 1500, 1500, 64, False, 0),
    ("f32", "granite-moe-3b prefill", 4, 24, 8, 2048, 2048, 64, True, 0),
    ("f32", "llama4-scout prefill, window 8192", 4, 40, 8, 2048, 2048, 128,
     True, 8192),
    ("f32", "minicpm3-4b prefill", 4, 40, 40, 2048, 2048, 64, True, 0),
]
ROW_TOL = {"bf16": 2.0 ** -6, "f32": 1e-4}
DTYPE_CODE = {"f32": 0, "bf16": 1}
PEAK_3XTF32 = 495e12 / 3


def _sub(text: str, subs: list, start: int = 0, end: int | None = None
         ) -> str:
    """``text`` with each (old, new) substitution made in text[start:end]
    only (old must occur there)."""
    end = len(text) if end is None else end
    part = text[start:end]
    for old, new in subs:
        assert old in part, old
        part = part.replace(old, new)
    return text[:start] + part + text[end:]


def variants(src: str) -> list:
    """(dtype, name, head dims, source text, computes attention)."""
    out = []
    for dtype, name, d, args in CONFIGS:
        shipped = SHIPPED[(dtype, d)]
        assert shipped in src, shipped
        fn = shipped.split("<")[0]
        out.append((dtype, f"D{d} {name}", (d,),
                    src.replace(shipped, f"{fn}<{args}>"), True))
    f32 = src.index(F32_SECTION)
    for name, subs in KNOCKOUTS.items():
        out.append(("bf16", f"D128 shipped, {name}", (128,),
                    _sub(src, subs, end=f32), False))
    for name, subs in F32_KNOCKOUTS.items():
        out.append(("f32", f"shipped, {name}", (64, 128),
                    _sub(src, subs, start=f32), False))
    out.append(("f32", "before: flash_attention_kernel (CUDA cores)",
                (64, 128), _sub(src, [CUDA_CORES]), True))
    return out


def build(vs: list) -> dict:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc, cmds, libs = _build.nvcc(), [], {}
    for i, (dtype, name, _, text, _) in enumerate(vs):
        cu = OUT / f"variant{i}.cu"
        cu.write_text(text)
        libs[(dtype, name)] = OUT / f"variant{i}.so"
        cmds.append([nvcc, *_build.FLAGS, f"-I{CSRC}", "-shared", str(cu),
                     "-o", str(libs[(dtype, name)])])
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    kernel = {"bf16": "wgmma_kernelILi", "f32": "tf32_kernelILi"}
    for (dtype, name, dims, _, _), p in zip(vs, procs):
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"{name}: build failed\n{log}")
        lines = log.splitlines()
        for j, line in enumerate(lines):   # ptxas on this variant's kernel
            if "Compiling" in line and any(f"{kernel[dtype]}{d}E" in line
                                           for d in dims):
                print(f"[build] {dtype} {name}: " + "; ".join(
                    x.split(":")[-1].strip() for x in lines[j + 1:j + 3]))
            if "C75" in line:
                print(f"[build] {dtype} {name}: {line.strip()}")
    fns = {}
    for key, path in libs.items():
        fn = ctypes.CDLL(str(path)).flash_attention_launch
        fn.argtypes = _build.SIGNATURES["flash_attention_launch"]
        fn.restype = ctypes.c_int
        fns[key] = fn
    return fns


def main() -> None:
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        sys.exit("flash_attention_variants: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    src = (CSRC / "flash_attention.cu").read_text()
    vs = variants(src)
    fns = build(vs)
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    tdtype = {"bf16": torch.bfloat16, "f32": torch.float32}
    data = {}
    for dtype, name, b, h, hkv, sq, sk, d, causal, window in SHAPES:
        q = torch.randn(b, h, sq, d, generator=g).to(dev, tdtype[dtype])
        k, v = (torch.randn(b, hkv, sk, d, generator=g).to(dev, tdtype[dtype])
                for _ in range(2))
        pairs = int(ref.attention_mask(sq, sk, causal=causal, window=window,
                                       device=dev).sum()) * b * h
        data[(dtype, name)] = (q, k, v, causal, window,
                               ref.attention(q, k, v, causal=causal,
                                             window=window),
                               4.0 * d * pairs / PEAK_3XTF32 * 1e3)

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
    for rnd in range(2):
        for dtype, name, dims, _, computes in (vs if rnd == 0 else vs[::-1]):
            for (sdtype, shape), (q, k, v, causal, window, want,
                                  _) in data.items():
                if sdtype != dtype or q.shape[3] not in dims:
                    continue
                d = q.shape[3]
                out = torch.empty_like(q)
                args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), q.shape[0], q.shape[1], k.shape[1],
                        q.shape[2], k.shape[2], d, d ** -0.5, int(causal),
                        window, DTYPE_CODE[dtype], stream)

                def run(fn=fns[(dtype, name)], args=args):
                    err = fn(*args)
                    if err:
                        raise RuntimeError(f"{name}: cudaError {err}")
                run()
                torch.cuda.synchronize()
                err = row_err(out, want) if computes else float("nan")
                if computes and not err <= ROW_TOL[dtype]:
                    raise RuntimeError(f"{dtype} {name} at {shape}: row "
                                       f"error {err}")
                results.setdefault((dtype, name, shape), []).append(
                    (time_ms(run), err))
    for (dtype, name, shape), r in results.items():
        err = r[0][1]
        print(f"[variant] {dtype} {name:46s} {shape:34s} {r[0][0]:.4f} / "
              f"{r[1][0]:.4f} ms"
              + (f"  row err {err:.3e}" if err == err else ""))
    for (dtype, shape), (q, k, v, causal, window, _, bound) in data.items():
        kw = dict(enable_gqa=k.shape[1] != q.shape[1])
        if window:
            kw["attn_mask"] = ref.attention_mask(
                q.shape[2], k.shape[2], causal=causal, window=window,
                device=dev)
        else:
            kw["is_causal"] = causal
        ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, **kw))
        print(f"[sdpa] {dtype} {shape:34s} {ms:.4f} ms"
              + (f"  (3xTF32 bound {bound:.4f} ms)" if dtype == "f32"
                 else ""))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
