#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA H100 and check it.

Run from the root of a checkout, on a machine with the card:

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero; no exception is caught):

  1. device  — the card's name, power limit and compute capability (9.0+).
  2. build   — the CUDA kernels from ``src/repro_torch/csrc`` (one
               ``nvcc`` per source, in parallel), with ptxas' register,
               shared-memory and spill report and the build time; then
               ``cuobjdump -sass`` of the library: the tensor-core
               instructions (``HGMMA``, ``HMMA``) of each kernel's
               functions, printed for every function whose name holds
               ``fused_ffn``, ``flash_attention`` or ``gemm_spmm``; fails
               when the bf16 FFN kernel, the bf16 flash ``wgmma`` kernel or
               any instance of the GeMM-SpMM ``wgmma`` kernel has no
               ``HGMMA``.  The hybrid SpMM's functions print their
               registers and spills, and the build fails if any of them
               holds a float atomic (``RED`` / ``ATOM*`` on F32, F16, BF16).
  3. kernels — each kernel against its plain PyTorch version at every
               shape the main path gives it (GCN layers 1 and 2, the
               power-law hybrid product, SpMM-SpMM; taken from the real
               schedules below, whose device copies the main path then
               reuses), f32
               and bf16: max abs / relative error, time (CUDA events), the
               bound (larger of compulsory bytes / 3.35 TB/s and operations
               / peak rate: nonzero entries, needed table rows and real
               output rows, each once; format padding is not counted; f32
               at 495 / 3 TFLOP/s, the rate of f32-accurate products as
               three TF32 products on the tensor cores, bf16 at 989), the
               plain version's time, and a library yardstick in f32:
               ``torch.sparse.mm`` for ``spmm_ell``; for the two fused
               kernels the unfused chain that computes the same ``(d1,
               rows0)`` (``kernels/ref.py``: ``torch.matmul`` or
               ``torch.sparse.mm`` for op 1, then ``torch.sparse.mm`` of
               the fused rows).  The GeMM-SpMM cases print the device
               function the launcher dispatched, and GCN layers 1 and 2
               must run ``tile_fused_gemm_spmm_wf0_wgmma_kernel`` in f32
               and bf16.  ``spmm_ell`` runs body-only at wavefront 1,
               then as the path runs it: banded wavefront 1
               at both layers with its tails, written in place at
               ``j_rows1``, and the power-law graph's whole hybrid product
               at 128 and 32 columns; each of those is timed beside the
               chain it replaced (body-only call, ``index_copy_`` where
               it applies, ``fused_ops._spill_add``) and ``torch.sparse.mm``
               of the same matrix (f32); its bound counts tail lanes like
               body entries.  The power-law cases must take the split-row
               path (``row+split``), and every whole hybrid product must
               give the same bits twice.  The backward's shapes, from the
               real transpose entries: GeMM-SpMM at the banded GCN's
               layer-2 ``dB`` (t 64, b_col 32, c_col 128, on the ``wgmma``
               kernel), and the banded ``Âᵀ`` hybrid product at 128 and
               32 columns (each layer's ``Âᵀ·Ḋ``).
  4. tile_fused_matmul on ``banded_spd(131072, 8)``, GeMM-SpMM and
               SpMM-SpMM at 128 columns: the ``auto`` pick must be
               ``cuda``; the result must match ``backend="torch"`` on the
               card and the numpy oracle on the host.  After the main path
               has been counted, both op pairs are timed on the fused arm
               (``backend="cuda"``) and on ``backend="unfused"`` (CUDA
               events over 20 calls after 3 warm-ups, and the profiler's
               device time of 5 calls), and the fused/unfused ratios are
               printed: the paper's Table 2 and Table 3 comparison on the
               card.  Gradients of both op pairs through the autograd
               Functions, on ``banded_spd(131072, 8)`` with ``(w·D).sum()``
               and on the same matrix with its even rows emptied
               (non-symmetric) with ``D.sum()``: ``auto`` against
               ``backend="torch"`` (rel. err ≤ 2e-3); each backward must
               launch its wavefront-0 kernel, and the transpose entry's
               pick is printed.
  5. GCN serving at the ``CONFIG`` widths (128 → 128 → 32) on two
               131,072-node graphs, 8 requests each: banded (fused arm) and
               power-law (unfused arm), under ``torch.inference_mode()``
               (serving records no graph).  Each answer is held to the
               ``backend="torch"`` forward.
  6. trace   — one more request per graph under ``torch.profiler``: device
               time by kernel and the device's busy share of the request;
               fails on any ``index_add_`` in either request, or on more
               ``index_copy_`` calls than fused layers (the scatter of
               wavefront 0's rows; wavefront 1 is written in place).
  7. LM kernels — flash attention, the fused FFN and the fused MoE FFN
               through their entry points (``kernels.ops``) at published
               widths (qwen2.5-3b prefill, hymba-1.5b's window, Whisper's
               ragged 1500-frame encoder; stablelm-1.6b FFN widths;
               granite-moe-3b experts; minitron-8b FFN widths, bf16
               only: d 4096, two cluster groups), f32 and bf16, each
               against its plain version (each output row against its
               own largest value; bf16 within 2^-6, f32 within 1e-4):
               errors, time, bound (compulsory bytes, and
               operations over the unmasked (query, key) pairs only),
               plain time, and a library call as yardstick
               (``scaled_dot_product_attention``; the unfused
               ``matmul → act → matmul`` / ``bmm`` chains).  Flash K/V
               carry the models' own K/V heads (read in place), and the
               launcher's record of its dispatch names the device
               function each flash case ran: bf16 at head dim 64 or 128
               must run ``flash_attention_wgmma_kernel``.
  8. LM serving — qwen2.5-3b at full width in bf16 (weights from a seeded
               generator on the card): 4 prompts of 2048 tokens, one
               batched prefill, 32 greedy decode steps through
               ``launch.serve``'s step; prefill time and tokens/s (after
               ``empty_cache``, so with ``cudaMalloc``; then three more
               prefills with the allocator warm), decode p50 and max; the
               prefill logits held to the same model with
               the plain attention (``impl="torch"``); the first decode
               steps replayed on a fresh cache of the serve run's size:
               their greedy picks must be the served tokens, and their
               logits are held to a full forward over prompt + served
               tokens with the plain attention.
  9. trace   — one prefill and one decode step under ``torch.profiler``:
               device time by kernel, device kernels per step and the
               device's busy share.
 10. GCN training — the ``CONFIG`` model on both phase-5 graphs, f32,
               10 SGD steps at lr 0.3 through ``launch.steps
               .make_gcn_train_step``: step 1's weight gradients against
               ``backend="torch"`` on the card and a float64 host oracle
               (the same loss through ``torch.sparse.mm`` autograd), ≤
               2e-3; the loss must fall; no schedule-cache miss after step
               1, and one transpose entry a graph (layer 2's ``dB``); each
               step's launches (``spmm_ell`` for each layer's ``Âᵀ·Ḋ``
               beside the forward's; on the banded graph one GeMM-SpMM
               launch more than a request, the backward's ``dB`` on the
               ``wgmma`` kernel); two backward passes give the same bits;
               one step under the profiler (device time by kernel, busy
               share; fails on any ``index_add_``); step p50 and max
               beside two yardsticks: the same step with
               ``backend="unfused"`` and a ``torch.sparse.mm`` autograd
               step.

Each path is driven with the launch counts set to 0 just before it and
read just after: phases 4-5 (the GCN path, gradients included) must
launch the three sparse kernels, ``spmm_ell`` in every request of both
graphs, phase 10's training runs ``spmm_ell`` and GeMM-SpMM, phase 7's
entry-point calls the FFN and MoE kernels, and phase 8 the flash kernel
exactly once per layer of the prefill.  Launches made to
compare a kernel with its plain version, or to time it, are not counted.
The last three lines are the card's ``nvidia-smi`` name and power limit,
the kernels' JSON record (with each kernel's tensor-core instruction count
from phase 2 and the device function its record case ran) and the result
line.  float32 matrix products run
in true f32 (TF32 off).
"""
from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_NODES = 131_072          # OGB scale (ogbn-arxiv has 169,343 nodes)
REQUESTS = 8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# f32: 495 TFLOP/s of TF32 over the three products of an f32-accurate
# 3xTF32 product (the card's fastest f32-accurate rate); bf16 tensor cores
PEAK_OPS = {"float32": 495e12 / 3, "bfloat16": 989e12}
PEAK_F32_CUDA_CORES = 67e12   # f32 outside the tensor cores (printed only)
TOL = {"float32": 1e-4, "bfloat16": 2e-2}           # kernel vs plain, rel
# the LM kernels in bf16, each output row against its own largest value:
# flash attention two bf16 units in the last place (P is rounded to bf16
# before the PV product, as in the Pallas kernel, and the output once more);
# the FFN / MoE kernels one rounding of the output plus the bf16 rounding of
# H summed over f (tests/test_torch_lm_kernels.py grounds it)
LM_BF16_TOL = 2.0 ** -6
MAIN_TOL = 2e-3                                      # path vs references
# phase 3: the sleep kernel that the queued timings wait behind (about 10
# ms at the H100's clock), longer than the host takes to queue 20 calls
SLEEP_CYCLES = 20_000_000

# phase 7: (name, kernel, shape and options) at published widths
LM_CASES = [
    ("flash_attention (qwen2.5-3b prefill)", "flash_attention",
     dict(b=4, h=16, hkv=2, sq=2048, sk=2048, d=128, causal=True,
          window=0)),
    ("flash_attention (hymba-1.5b, window 1024)", "flash_attention",
     dict(b=1, h=25, hkv=5, sq=4096, sk=4096, d=64, causal=True,
          window=1024)),
    ("flash_attention (whisper-medium encoder)", "flash_attention",
     dict(b=4, h=16, hkv=16, sq=1500, sk=1500, d=64, causal=False,
          window=0)),
    ("fused_ffn (stablelm-1.6b widths)", "fused_ffn",
     dict(e=0, m=8192, d=2048, f=5632, act="gelu")),
    # a 4096-token row, top-8 of 40 experts, capacity factor 1.25
    # (repro.models.layers.moe_apply): cap = 1.25 * 4096 * 8 / 40 = 1024
    ("fused_moe_ffn (granite-moe-3b experts)", "fused_moe_ffn",
     dict(e=40, m=1024, d=1536, f=512, act="silu")),
    # configs/minitron_8b.py FFN widths, 4096 tokens: d > 2048 takes two
    # cluster groups (X W1 computed twice); bf16 only
    ("fused_ffn (minitron-8b widths)", "fused_ffn",
     dict(e=0, m=4096, d=4096, f=16384, act="gelu", bf16_only=True)),
]
# the case whose numbers stand for each LM kernel in the JSON record
LM_RECORD = {"flash_attention": "flash_attention (qwen2.5-3b prefill)",
             "fused_ffn": "fused_ffn (stablelm-1.6b widths)",
             "fused_moe_ffn": "fused_moe_ffn (granite-moe-3b experts)"}
# phase 8: qwen2.5-3b at full width; 4 prompts of 2048 tokens, 32 decode
# steps after the prefill
LM_ARCH = "qwen2.5-3b"
LM_REDUCED = False
LM_BATCH, LM_PROMPT, LM_DECODE = 4, 2048, 32
LM_TOL = 5e-2   # bf16 logits, served path vs plain attention, rel
LM_REPLAY = 4   # decode steps replayed against a full forward
# phase 10: SGD on the GCN
TRAIN_STEPS, TRAIN_LR = 10, 0.3
GCN_KERNELS = ("spmm_ell", "tile_fused_gemm_spmm_wf0",
               "tile_fused_spmm_spmm_wf0")
# phase 2: the functions of each kernel in the library's SASS (a part of the
# mangled name); the FFN and MoE launchers share one kernel
KERNEL_FUNCTIONS = {"spmm_ell": "spmm_hybrid", "tile_fused_gemm_spmm_wf0":
                    "gemm_spmm", "tile_fused_spmm_spmm_wf0": "spmm_spmm",
                    "flash_attention": "flash_attention",
                    "fused_ffn": "fused_ffn", "fused_moe_ffn": "fused_ffn"}
TC_OPCODES = ("HGMMA", "HMMA")   # wgmma and mma.sync in SASS
FLOAT_ATOMIC_TYPES = ("F32", "F16", "BF16")
# the bf16 flash kernel on wgmma (head dim 64 or 128, aligned rows)
FLASH_WGMMA = "flash_attention_wgmma_kernel"
# the phase-3 case whose numbers stand for spmm_ell in the JSON record: the
# power-law GCN's layer-1 hybrid product, body and tails (f32)
SPMM_RECORD = "spmm_ell (power-law hybrid, 128 columns)"
# the GeMM-SpMM kernel on wgmma (GCN layers 1 and 2 must run it)
GEMM_WGMMA = "tile_fused_gemm_spmm_wf0_wgmma_kernel"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sass_scan(library: Path) -> tuple:
    """``({function: HGMMA / HMMA instructions}, {function: float atomics})``
    over every function in ``cuobjdump -sass`` of the kernel library; a
    float atomic is a ``RED`` or ``ATOM*`` instruction on F32, F16 or
    BF16."""
    from repro_torch.kernels import _build
    tool = Path(_build.nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(library)],
                         capture_output=True, text=True, check=True,
                         timeout=300).stdout
    counts, atomics, name = {}, {}, None
    for line in out.splitlines():
        line = line.strip()
        if line.startswith("Function : "):
            name = line[len("Function : "):]
            counts[name] = atomics[name] = 0
        elif name is not None:
            if any(f" {op}." in line or f" {op} " in line
                   for op in TC_OPCODES):
                counts[name] += 1
            words = line.split("*/", 1)[-1].split()
            words = [w for w in words if not w.startswith("@")]
            op = words[0] if words else ""
            if (op.startswith(("RED", "ATOM"))
                    and any(t in op for t in FLOAT_ATOMIC_TYPES)):
                atomics[name] += 1
    return counts, atomics


def ptxas_report(log: str) -> dict:
    """{function: (registers, spill store bytes, spill load bytes)} from
    ``-Xptxas -v`` in the build log."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            out[name] = [0, 0, 0]
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def every_other_row(a):
    """``a`` with its even rows emptied (the parity matrix's empty-rows
    cell at size): ``Aᵀ != A``, and row and column degrees differ."""
    import numpy as np
    lens = np.diff(a.indptr)
    keep = np.arange(a.n_rows) % 2 == 1
    flat = np.repeat(keep, lens)
    indptr = np.concatenate([[0], np.cumsum(np.where(keep, lens, 0))])
    return type(a)(a.n_rows, a.n_cols, indptr.astype(a.indptr.dtype),
                   a.indices[flat], a.data[flat])


def main(device: str = "cuda") -> None:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(f"{ROOT} is not a checkout of the repository "
             f"(src/repro_torch is missing)")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.configs.gcn import CONFIG
    from repro_torch.core.sparse.formats import csr_content_digest
    from repro_torch.core.sparse.random import banded_spd, powerlaw_graph
    from repro_torch.core.tilefusion import api, fused_ops, fused_ref
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels.flash_attention import (
        last_path as flash_last_path)
    from repro_torch.kernels.spmm import last_path as spmm_last_path
    from repro_torch.kernels.tile_fused_gemm_spmm import (
        last_path as gemm_last_path)
    from repro_torch.launch import serve, steps
    from repro_torch.models.gcn import GCN

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    t_start = time.perf_counter()

    # ---- 1. device ----
    smi = nvidia_smi()
    device_kind = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    print(f"[1 device] nvidia-smi: {smi}")
    print(f"[1 device] {device_kind}, compute capability {cap[0]}.{cap[1]}, "
          f"{torch.cuda.device_count()} device(s), torch {torch.__version__}"
          f" (CUDA {torch.version.cuda})")
    if cap < (9, 0):
        fail(f"compute capability {cap} < 9.0: the kernels are sm_90a")

    # ---- 2. build ----
    build = _build.build()
    _build.library()
    print(f"[2 build] {build.path.relative_to(ROOT)} in {build.seconds:.1f} s"
          f" (reused: {build.reused})")
    for line in build.log.splitlines():
        if any(k in line for k in ("Compiling entry", "registers", "spill",
                                   "smem", "error", "C75")):
            print(f"[2 build] {line.strip()}")
    sass, float_atomics = sass_scan(build.path)
    for fn, (regs, st, ld) in ptxas_report(build.log).items():
        if "spmm_hybrid" in fn:
            print(f"[2 build] ptxas {fn}: {regs} registers, spill stores "
                  f"{st} bytes, spill loads {ld} bytes")
    spmm_atomics = {f: n for f, n in float_atomics.items()
                    if KERNEL_FUNCTIONS["spmm_ell"] in f}
    print(f"[2 build] float atomics in the {len(spmm_atomics)} spmm "
          f"functions' SASS: {sum(spmm_atomics.values())}")
    if not spmm_atomics or any(spmm_atomics.values()):
        fail(f"spmm functions with float atomics (or none found): "
             f"{spmm_atomics}")
    tensor_core_ops = {k: sum(n for f, n in sass.items() if part in f)
                       for k, part in KERNEL_FUNCTIONS.items()}
    for fn, n in sass.items():
        if any(k in fn for k in ("fused_ffn", "flash_attention", "gemm_spmm")):
            print(f"[2 build] SASS {fn}: {n} tensor-core instructions "
                  f"({'/'.join(TC_OPCODES)})")
    print(f"[2 build] tensor-core instructions per kernel: {tensor_core_ops}")
    for label, part in (("FFN", "fused_ffn_wgmma"), ("flash", FLASH_WGMMA),
                        ("GeMM-SpMM", GEMM_WGMMA)):
        counts = [n for f, n in sass.items() if part in f]
        if not counts or min(counts) == 0:
            fail(f"the {label} wgmma kernel holds no HGMMA instruction: "
                 f"{counts}")

    # ---- set-up: graphs, models and their inspections (host) ----
    t0 = time.perf_counter()
    banded = banded_spd(N_NODES, 8, seed=0)
    power = powerlaw_graph(N_NODES, 8, seed=0)
    cfg = dataclasses.replace(CONFIG, n_nodes=N_NODES)
    models = {"banded": GCN(cfg, banded, seed=0, device=dev),
              "powerlaw": GCN(cfg, power, seed=1, device=dev)}
    e_gemm = api.get_schedule(banded, b_col=128, c_col=128)
    e_spmm = api.get_schedule(banded, b_col=128, c_col=128, b_is_sparse=True)
    # the backward's dB of GCN layer 2 (Âᵀ·(Ḋ₂·W₂ᵀ): 32 -> 128 columns) on
    # the banded graph's transpose entry; training hits it from step 1 on
    e_db = api.get_schedule(
        models["banded"].adj, b_col=CONFIG.out_dim, c_col=CONFIG.hidden_dim,
        spec=dataclasses.replace(models["banded"].spec, transpose=True,
                                 dtype_bytes=4))
    print(f"[setup] graphs nnz banded={banded.nnz} powerlaw={power.nnz}; "
          f"{api.schedule_cache_stats()['misses']} inspections in "
          f"{time.perf_counter() - t0:.1f} s host")
    for name, e in [("gcn-banded L1", models["banded"].entries[0]),
                    ("gcn-banded L2", models["banded"].entries[1]),
                    ("gcn-powerlaw L1", models["powerlaw"].entries[0]),
                    ("banded gemm", e_gemm), ("banded spmm", e_spmm),
                    ("gcn-banded L2 dB (transpose)", e_db)]:
        ds = e.dsched
        print(f"[setup] {name}: t={ds.t_pad} T0={ds.n_tiles0} "
              f"j0_max={ds.j_rows0.shape[1]} w0={ds.ell_cols0.shape[2]} "
              f"wf1={tuple(ds.ell_cols1.shape)} "
              f"spill={ds.spill_rows1.size} "
              f"fused_ratio={e.sched.fused_ratio:.3f} "
              f"saving={e.traffic_model['traffic_saving']:.3f} "
              f"inspect={e.inspector_s:.2f}s")

    rng = np.random.default_rng(0)

    def randn(*shape, scale=1.0):
        return torch.from_numpy(
            rng.standard_normal(shape, np.float32) * np.float32(scale)
        ).to(dev)

    def time_ms(fn, iters=20):
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

    def rel_err(got, want, rows=False):
        """(max abs error, relative error): relative to the largest |want|,
        or with ``rows`` the largest over rows of each row's error relative
        to that row's own largest |want| (a row is the last axis)."""
        got, want = got.float(), want.float()
        if not torch.isfinite(got).all():
            fail("non-finite values in a result")
        diff = (got - want).abs()
        err = float(diff.max())
        if rows:
            return err, float((diff.amax(-1) / want.abs().amax(-1)
                               .clamp_min(1e-30)).max())
        return err, err / max(float(want.abs().max()), 1e-30)

    def queued_ms(fn, iters=20):
        """Like ``time_ms``, with the calls queued behind a sleep kernel of
        about 10 ms, so the device never waits for the host's wrappers:
        the device's own pace for a call whose kernels are short."""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    # ---- 3. kernels against their plain versions ----
    # The bound counts compulsory bytes only: the index and value of each
    # nonzero ELL entry (pad slots hold value 0 and are not needed), the
    # rows of a gathered table that a nonzero names, the output rows that
    # are real (pad rows of a fused-row block, index n_j, are not), and of
    # the SpMM-SpMM spill delta the rows that spill lanes touch.
    def nz_bytes(cols, vals):
        """Bytes of an ELL's nonzero entries: one index and one value."""
        nz = int((vals != 0).sum())
        return float(nz * (cols.element_size() + vals.element_size()))

    def row_bytes(n_rows, table):
        return float(n_rows * table.shape[1] * table.element_size())

    def gathered_bytes(cols, vals, table):
        """The rows of ``table`` a sparse product must read: the distinct
        rows that a nonzero value names (this run's data)."""
        return row_bytes(torch.unique(cols[vals != 0]).numel(), table)

    def real_rows(j_rows, n_j):
        return int((np.asarray(j_rows) != n_j).sum())

    def gemm_case(label, entry, dtype):
        ds = entry.dsched
        st = fused_ops.schedule_tensors(ds, dev, dtype)
        b_col, c_col = entry.b_col, entry.c_col
        b = randn(ds.n_tiles0 * ds.t_pad, b_col).to(dtype)
        c = randn(b_col, c_col, scale=b_col ** -0.5).to(dtype)
        nnz0 = int((st.vals0 != 0).sum())
        n_ops = 2.0 * ds.n_i * b_col * c_col + 2.0 * nnz0 * c_col
        moved = (nz_bytes(st.cols0, st.vals0) + row_bytes(ds.n_i, b)
                 + row_bytes(b_col, c) + row_bytes(ds.n_i, c)       # d1
                 + row_bytes(real_rows(ds.j_rows0, ds.n_j), c))    # rows0
        lib = None
        if dtype == torch.float32:
            csr0 = ref.fused_rows_csr(st.cols0, st.vals0, ds.t_pad)
            lib = lambda: ref.gemm_spmm_wf0_library(csr0, b, c)  # noqa: E731
        return ("tile_fused_gemm_spmm_wf0" + label,
                lambda: ops.tile_fused_gemm_spmm_wf0(st.cols0, st.vals0, b, c,
                                                     t=ds.t_pad),
                lambda: ref.tile_fused_gemm_spmm_wf0(st.cols0, st.vals0, b, c,
                                                     t=ds.t_pad),
                moved, n_ops, lib)

    def sparse_mm(cols, vals, x):
        """``torch.sparse.mm`` over the ELL's nonzeros as a CSR: the
        library yardstick of ``spmm_ell`` (f32 only)."""
        if x.dtype != torch.float32:
            return None
        keep = vals != 0
        crow = torch.zeros(cols.shape[0] + 1, dtype=torch.int64, device=dev)
        crow[1:] = torch.cumsum(keep.sum(1), 0)
        csr = torch.sparse_csr_tensor(crow, cols.long()[keep], vals[keep],
                                      (cols.shape[0], x.shape[0]),
                                      check_invariants=True)
        return lambda: torch.sparse.mm(csr, x)

    def wf1_case(label, entry, dtype):
        """``spmm_ell`` as wavefront 1 runs it: over the finished D1."""
        ds = entry.dsched
        st = fused_ops.schedule_tensors(ds, dev, dtype)
        x = randn(ds.n_i, entry.c_col).to(dtype)
        lib = sparse_mm(st.cols1, st.vals1, x)
        moved = (nz_bytes(st.cols1, st.vals1)
                 + gathered_bytes(st.cols1, st.vals1, x)
                 + row_bytes(real_rows(ds.j_rows1, ds.n_j), x))
        return ("spmm_ell" + label,
                lambda: ops.spmm_ell(st.cols1, st.vals1, x),
                lambda: ref.spmm_ell(st.cols1, st.vals1, x),
                moved, 2.0 * int((st.vals1 != 0).sum()) * x.shape[1], lib)

    def tail_rows(tails):
        """The row of each spill lane of a tail plan (lanes are sorted by
        row)."""
        r, ch = tails.ranges.long(), tails.chunks.long()
        counts = (r[:, 1] - r[:, 0]).clamp_min(0)
        counts.index_add_(0, ch[:, 0], ch[:, 2] - ch[:, 1])
        return torch.repeat_interleave(
            torch.arange(len(counts), device=dev), counts)

    def hybrid_moved(cols, vals, tails, x, n_written, out_rows=None):
        """Compulsory bytes of a hybrid product: each nonzero body entry and
        each tail lane (index and value, alike), the tail plan, the
        target-row map, the rows of x that a nonzero names, and the rows
        written."""
        plan = sum(t.numel() * t.element_size() for t in (
            tails.ranges, tails.chunks, tails.split_rows, tails.split_ptr))
        named = torch.unique(torch.cat([cols[vals != 0],
                                        tails.cols[tails.vals != 0]]))
        return (nz_bytes(cols, vals) + nz_bytes(tails.cols, tails.vals)
                + plan + (0 if out_rows is None else out_rows.numel() * 4)
                + row_bytes(named.numel(), x) + row_bytes(n_written, x))

    def hybrid_ops(vals, tails, c):
        return 2.0 * (int((vals != 0).sum())
                      + int((tails.vals != 0).sum())) * c

    def hybrid_library(cols, vals, tails, x):
        """``torch.sparse.mm`` of the same matrix (body nonzeros and tail
        lanes as one CSR; f32 only)."""
        if x.dtype != torch.float32:
            return None
        csr = ref.ell_csr(cols, vals, x.shape[0],
                          (tail_rows(tails), tails.cols, tails.vals))
        return lambda: torch.sparse.mm(csr, x)

    def wf1_hybrid_case(label, entry, dtype):
        """``spmm_ell`` as the kernel arms run wavefront 1: body and tails
        over the finished D1, written in place into D at ``j_rows1``; the
        chain it replaces is the body-only call, ``index_copy_`` and
        ``_spill_add``."""
        ds = entry.dsched
        st = fused_ops.schedule_tensors(ds, dev, dtype)
        n_j, c = ds.n_j, entry.c_col
        x = randn(ds.n_i, c).to(dtype)
        d0 = randn(n_j + 1, c).to(dtype)    # what wavefront 0 left in D
        outs = {k: d0.clone() for k in ("kernel", "plain", "chain")}
        kw = dict(tails=st.tails1, out_rows=st.j_rows1_32)

        def chain():
            d = outs["chain"]
            d.index_copy_(0, st.j_rows1, ops.spmm_ell(st.cols1, st.vals1, x))
            return fused_ops._spill_add(d, st.spill_rows1, st.spill_cols1,
                                        st.spill_vals1, x)[:n_j]
        return ("spmm_ell" + label,
                lambda: ops.spmm_ell(st.cols1, st.vals1, x,
                                     out=outs["kernel"][:n_j], **kw),
                lambda: ref.spmm_ell(st.cols1, st.vals1, x,
                                     out=outs["plain"][:n_j], **kw),
                hybrid_moved(st.cols1, st.vals1, st.tails1, x,
                             real_rows(ds.j_rows1, n_j), st.j_rows1_32),
                hybrid_ops(st.vals1, st.tails1, c),
                hybrid_library(st.cols1, st.vals1, st.tails1, x),
                # the library product has one row a packed slot (zeros for
                # pad slots): D's rows at j_rows1
                dict(chain=chain, lib_rows=lambda w: torch.cat(
                    [w, torch.zeros_like(w[:1])])[st.j_rows1]))

    def full_hybrid_case(label, a, c, dtype, **extra):
        """A whole full-matrix hybrid product of ``a`` (width cap auto), as
        the unfused arm and the backward's ``Âᵀ·Ḋ`` run it; the chain it
        replaces is the body-only call and ``_spill_add``."""
        cap = api._resolve_width_cap(a, "auto")
        hell = api._csr_ell(a, cap, dev, dtype)
        _, _, srows, scols, svals = fused_ops.csr_to_ell(
            a, cap).to_torch(dev, dtype)
        x = randn(a.n_cols, c).to(dtype)
        return (label,
                lambda: ops.spmm_ell(hell.cols, hell.vals, x,
                                     tails=hell.tails),
                lambda: ref.spmm_ell(hell.cols, hell.vals, x,
                                     tails=hell.tails),
                hybrid_moved(hell.cols, hell.vals, hell.tails, x, a.n_rows),
                hybrid_ops(hell.vals, hell.tails, c),
                hybrid_library(hell.cols, hell.vals, hell.tails, x),
                dict(chain=lambda: fused_ops._spill_add(
                    ops.spmm_ell(hell.cols, hell.vals, x), srows, scols,
                    svals, x), bitwise=True, **extra))

    def kernel_cases(dtype):
        """(name, kernel call, plain call, compulsory bytes, operations,
        library call or None[, extra]) at every shape the main path gives
        each kernel: GCN layers 1 and 2, the power-law hybrid product,
        SpMM-SpMM.  A library call returns what the kernel returns, the
        fused rows flattened to (T0 * j0_max, c_col).  ``extra`` may name
        the chain a kernel replaces (timed beside it), the path the
        launcher must record, and whether two calls must give the same
        bits."""
        layer1, layer2 = models["banded"].entries
        yield gemm_case("", layer1, dtype)
        yield gemm_case(" (GCN layer 2)", layer2, dtype)
        yield gemm_case(" (GCN layer 2 dB, backward)", e_db, dtype)
        yield wf1_case("", layer1, dtype)
        yield wf1_case(" (GCN layer 2 wf1)", layer2, dtype)
        yield wf1_hybrid_case(" (banded wf1 + tails, layer 1)", layer1,
                              dtype)
        yield wf1_hybrid_case(" (banded wf1 + tails, layer 2)", layer2,
                              dtype)
        for c in (128, 32):
            yield full_hybrid_case(f"spmm_ell (power-law hybrid, {c} columns)",
                                   models["powerlaw"].adj, c, dtype,
                                   path="row+split")
        # the backward's Âᵀ·Ḋ of the banded GCN, layers 1 and 2
        for c in (128, 32):
            yield full_hybrid_case(
                f"spmm_ell (banded Âᵀ hybrid, backward, {c} columns)",
                models["banded"].adj.transpose(), c, dtype)

        pl = models["powerlaw"]
        hell = api._csr_ell(pl.adj, api._resolve_width_cap(pl.adj, "auto"),
                            dev, dtype)
        x = randn(N_NODES, 128).to(dtype)
        yield ("spmm_ell (power-law unfused body)",
               lambda: ops.spmm_ell(hell.cols, hell.vals, x),
               lambda: ref.spmm_ell(hell.cols, hell.vals, x),
               nz_bytes(hell.cols, hell.vals)
               + gathered_bytes(hell.cols, hell.vals, x)
               + row_bytes(hell.cols.shape[0], x),
               2.0 * int((hell.vals != 0).sum()) * 128,
               sparse_mm(hell.cols, hell.vals, x))

        ds = e_spmm.dsched
        st = fused_ops.schedule_tensors(ds, dev, dtype)
        cs = randn(N_NODES, 128, scale=0.1).to(dtype)
        ot = fused_ops.op1_tensors(banded, ds, dev, dtype)
        spill = fused_ops.op1_spill(ot, cs, ds.n_tiles0 * ds.t_pad)
        args = (ot.cols, ot.vals, spill, st.cols0, st.vals0, cs)
        spill_rows = torch.unique(ot.spill_flat).numel()
        ss_ops = (2.0 * int((ot.vals != 0).sum()) * 128 + spill_rows * 128
                  + 2.0 * int((st.vals0 != 0).sum()) * 128)
        moved = (nz_bytes(ot.cols, ot.vals) + row_bytes(spill_rows, spill)
                 + nz_bytes(st.cols0, st.vals0)
                 + gathered_bytes(ot.cols, ot.vals, cs)
                 + row_bytes(ds.n_i, cs)                               # d1
                 + row_bytes(real_rows(ds.j_rows0, ds.n_j), cs))     # rows0
        lib = None
        if dtype == torch.float32:
            csr1 = ref.ell_csr(ot.cols, ot.vals, N_NODES,
                               (ot.spill_flat, ot.spill_cols, ot.spill_vals))
            csr0 = ref.fused_rows_csr(st.cols0, st.vals0, ds.t_pad)
            lib = lambda: ref.spmm_spmm_wf0_library(  # noqa: E731
                csr1, csr0, cs)
        yield ("tile_fused_spmm_spmm_wf0",
               lambda: ops.tile_fused_spmm_spmm_wf0(*args, t=ds.t_pad),
               lambda: ref.tile_fused_spmm_spmm_wf0(*args, t=ds.t_pad),
               moved, ss_ops, lib)

    records = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[1]
        for name, kern, plain, moved, n_ops, lib, *more in kernel_cases(
                dtype):
            extra = more[0] if more else {}
            got, want = kern(), plain()
            torch.cuda.synchronize()
            path = None
            if name.startswith("tile_fused_gemm_spmm_wf0"):
                path = gemm_last_path()
                print(f"[3 kernels] {name} {dname}: ran {path}")
                if path != GEMM_WGMMA:
                    fail(f"{name} {dname}: ran {path}, not {GEMM_WGMMA}")
            if name.startswith("spmm_ell"):
                path = spmm_last_path()
                print(f"[3 kernels] {name} {dname}: ran {path}")
                if path != extra.get("path", path):
                    fail(f"{name} {dname}: ran {path}, not {extra['path']}")
            if extra.get("bitwise"):
                again = kern()
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    fail(f"{name} {dname}: two calls differ")
                print(f"[3 kernels] {name} {dname}: two calls give the same "
                      f"bits")
                del again
            if isinstance(got, torch.Tensor):
                got, want = (got,), (want,)
            errs = [rel_err(g, w) for g, w in zip(got, want)]
            abs_err = max(e[0] for e in errs)
            rel = max(e[1] for e in errs)
            bound_bytes = moved / HBM_BYTES_PER_S * 1e3
            bound_ops = n_ops / PEAK_OPS[dname] * 1e3
            ms = time_ms(kern)
            plain_ms = time_ms(plain)
            lib_ms = None
            if lib is not None:
                lib_out = lib()
                if isinstance(lib_out, torch.Tensor):
                    lib_out = (lib_out,)
                rows = extra.get("lib_rows", lambda w: w)
                lib_err = max(rel_err(g, rows(w).reshape(g.shape))[1]
                              for g, w in zip(lib_out, want))
                lib_ms = time_ms(lib)
            chain_ms = chain_note = None
            if "chain" in extra:
                chain_rel = rel_err(extra["chain"](), want[0])[1]
                chain_ms = time_ms(extra["chain"])
                # a short kernel is paced by its host wrapper: the same
                # calls queued behind a sleep give the device's pace
                chain_note = (f" replaced chain={chain_ms:.4f} ms (rel "
                              f"{chain_rel:.1e}); queued: kernel "
                              f"{queued_ms(kern):.4f} ms, chain "
                              f"{queued_ms(extra['chain']):.4f} ms")
            rec = dict(ms=ms, plain_ms=plain_ms,
                       bound_ms=max(bound_bytes, bound_ops),
                       bound_by="bytes" if bound_bytes >= bound_ops
                       else "operations", library_ms=lib_ms,
                       max_abs_err=abs_err, path=path,
                       replaced_chain_ms=chain_ms)
            cores = ""
            if dtype == torch.float32:
                at_67 = max(bound_bytes,
                            n_ops / PEAK_F32_CUDA_CORES * 1e3)
                cores = (f" (at 67 TFLOP/s: bound {at_67:.4f} ms, share "
                         f"{at_67 / ms:.3f})")
            print(f"[3 kernels] {name} {dname}: max_abs={abs_err:.3e} "
                  f"rel={rel:.3e} kernel={ms:.4f} ms plain={plain_ms:.4f} ms"
                  f" bound={rec['bound_ms']:.4f} ms ({rec['bound_by']}: "
                  f"{moved / 1e6:.1f} MB, {n_ops / 1e9:.3f} Gop) "
                  f"share={rec['bound_ms'] / ms:.3f}{cores}"
                  + (f" library={lib_ms:.4f} ms (rel {lib_err:.1e})"
                     if lib_ms is not None else "") + (chain_note or ""))
            if rel > TOL[dname]:
                fail(f"{name} {dname}: rel err {rel:.3e} > {TOL[dname]}")
            records[(name, dname)] = rec

    # ---- 4 + 5: the main path, with the launch counts from 0 ----
    ops.reset_launch_counts()

    # ---- 4. tile_fused_matmul, both op pairs ----
    b_np = rng.standard_normal((N_NODES, 128), np.float32)
    c_np = (rng.standard_normal((128, 128), np.float32)
            / np.float32(128 ** 0.5))
    cs_np = rng.standard_normal((N_NODES, 128), np.float32)
    cases = [("GeMM-SpMM", e_gemm, torch.from_numpy(b_np).to(dev),
              torch.from_numpy(c_np).to(dev),
              lambda: fused_ref.unfused_gemm_spmm(banded, b_np, c_np)),
             ("SpMM-SpMM", e_spmm, banded, torch.from_numpy(cs_np).to(dev),
              lambda: fused_ref.unfused_spmm_spmm(banded, banded, cs_np))]
    for name, entry, b_or_a1, c, oracle in cases:
        pick = api.select_backend(entry, dev)
        if pick != "cuda":
            fail(f"phase 4 {name}: auto picked {pick!r}, expected 'cuda'")
        before = ops.launch_counts()
        t0 = time.perf_counter()
        got = api.tile_fused_matmul(banded, b_or_a1, c)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launched = {k: v - before[k] for k, v in ops.launch_counts().items()}
        want = api.tile_fused_matmul(banded, b_or_a1, c, backend="torch")
        host = torch.from_numpy(oracle())
        err_t = rel_err(got, want)[1]
        err_h = rel_err(got.cpu().double(), host)[1]
        print(f"[4 tile_fused_matmul] {name}: pick={pick} shape="
              f"{tuple(got.shape)} rel_err vs torch={err_t:.2e} vs host "
              f"oracle={err_h:.2e} launches={launched} wall={wall:.2f} ms")
        if max(err_t, err_h) > MAIN_TOL or got.shape != host.shape:
            fail(f"phase 4 {name}: result disagrees")
        if sum(launched.values()) == 0:
            fail(f"phase 4 {name}: no kernel launched")

    # ---- 4, gradients: both op pairs through the autograd Functions ----
    # the backward runs Aᵀ products off transpose entries; a symmetric A
    # hides a transpose bug, so a non-symmetric matrix runs too (with
    # D.sum(), whose cotangent has stride 0)
    nonsym = every_other_row(banded_spd(N_NODES, 8, seed=2))
    grad_rng = np.random.default_rng(3)
    grad_np = {"b": grad_rng.standard_normal((N_NODES, 128), np.float32),
               "c": (grad_rng.standard_normal((128, 128), np.float32)
                     / np.float32(128 ** 0.5)),
               "cs": grad_rng.standard_normal((N_NODES, 128), np.float32),
               "w": grad_rng.standard_normal((N_NODES, 128), np.float32)}
    w_dev = torch.from_numpy(grad_np["w"]).to(dev)

    def backward_run(a, sparse, weighted, backend):
        """(gradients, launches of the backward alone) of ``loss(D)``."""
        leaves = ([grad_np["cs"]] if sparse else [grad_np["b"], grad_np["c"]])
        leaves = [torch.from_numpy(v).to(dev).requires_grad_()
                  for v in leaves]
        d = (api.tile_fused_matmul(a, a, leaves[0], backend=backend)
             if sparse else
             api.tile_fused_matmul(a, *leaves, backend=backend))
        value = (w_dev * d).sum() if weighted else d.sum()
        torch.cuda.synchronize()
        before = ops.launch_counts()
        value.backward()
        torch.cuda.synchronize()
        launched = {k: v - before[k] for k, v in ops.launch_counts().items()}
        return [x.grad for x in leaves], launched

    for aname, a, weighted in (("banded_spd", banded, True),
                               ("non-symmetric", nonsym, False)):
        for name, sparse, wf0 in (("GeMM-SpMM", False,
                                   "tile_fused_gemm_spmm_wf0"),
                                  ("SpMM-SpMM", True,
                                   "tile_fused_spmm_spmm_wf0")):
            got, launched = backward_run(a, sparse, weighted, "auto")
            want, _ = backward_run(a, sparse, weighted, "torch")
            err = max(rel_err(g, w)[1] for g, w in zip(got, want))
            e_t = api.get_schedule(a, b_col=128, c_col=128,
                                   b_is_sparse=sparse,
                                   spec=api.FusionSpec(transpose=True,
                                                       dtype_bytes=4))
            loss_name = "(w·D).sum()" if weighted else "D.sum()"
            print(f"[4 gradients] {name} on {aname} ({a.nnz} nnz), loss "
                  f"{loss_name}: transpose entry t={e_t.dsched.t_pad} "
                  f"T0={e_t.dsched.n_tiles0} saving="
                  f"{e_t.traffic_model['traffic_saving']:.3f} auto pick "
                  f"{api.select_backend(e_t, dev)!r}; grads rel_err vs "
                  f"torch={err:.2e}; backward launches {launched}")
            if err > MAIN_TOL:
                fail(f"phase 4 {name} on {aname}: gradients disagree "
                     f"({err:.2e})")
            if launched[wf0] == 0:
                fail(f"phase 4 {name} on {aname}: the backward launched no "
                     f"{wf0}")
            del got, want
    del nonsym

    # ---- 5. GCN serving ----
    expected_pick = {"banded": "cuda", "powerlaw": "unfused"}
    serve_p50_ms, serve_launches = {}, {}
    for gname, model in models.items():
        picks = model.layer_backends()
        print(f"[5 gcn] {gname}: layer picks {picks}")
        if picks[0] != expected_pick[gname]:
            fail(f"phase 5 {gname}: layer 1 picked {picks[0]!r}")
        lat, per_req = [], []
        req_rng = np.random.default_rng(100)
        for r in range(REQUESTS):
            x = torch.from_numpy(req_rng.standard_normal(
                (N_NODES, cfg.in_dim), np.float32)).to(dev)
            torch.cuda.synchronize()
            before = ops.launch_counts()
            t0 = time.perf_counter()
            with torch.inference_mode():
                logits = model(x)
                torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
            per_req.append({k: v - before[k]
                            for k, v in ops.launch_counts().items()})
            with torch.inference_mode():
                want = model(x, backend="torch")
            err = rel_err(logits, want)[1]
            if (tuple(logits.shape) != (N_NODES, cfg.out_dim)
                    or err > MAIN_TOL):
                fail(f"phase 5 {gname} request {r}: shape "
                     f"{tuple(logits.shape)}, rel err {err:.2e}")
        if any(p["spmm_ell"] == 0 for p in per_req):
            fail(f"phase 5 {gname}: a request launched no spmm_ell")
        serve_p50_ms[gname] = float(np.median(lat))
        serve_launches[gname] = per_req[-1]
        print(f"[5 gcn] {gname}: {REQUESTS} requests, p50="
              f"{float(np.median(lat)):.3f} ms max={max(lat):.3f} ms "
              f"(host clock around forward + synchronize, features already"
              f" on the card); launches per request {per_req[-1]}; "
              f"last rel err vs torch {err:.2e}")

    counts = ops.launch_counts()
    print(f"[main path] kernel launches in phases 4-5: {counts}")
    missing = [k for k in GCN_KERNELS if counts[k] == 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    path_launches = {k: counts[k] for k in GCN_KERNELS}

    # ---- 4, continued: the fused arm against the unfused arm ----
    # (after the main path's counts were read: these launches are not
    # counted).  CUDA events time the stream, which waits for the host when
    # the host is slower than the device; the profiler's device time of the
    # same calls is the device's own work.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def device_ms(fn, calls=5):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA) / 1e3 / calls

    for name, entry, b_or_a1, c, _ in cases:
        arms = {}
        for arm in ("cuda", "unfused"):
            call = (lambda arm=arm: api.tile_fused_matmul(  # noqa: E731
                banded, b_or_a1, c, backend=arm))
            arms[arm] = (time_ms(call), device_ms(call))
        (ev_f, dev_f), (ev_u, dev_u) = arms["cuda"], arms["unfused"]
        print(f"[4 arms] {name}: per tile_fused_matmul call, fused arm "
              f"(backend='cuda') {ev_f:.4f} ms, unfused arm {ev_u:.4f} ms "
              f"(CUDA events, mean of 20 calls after 3 warm-ups); device "
              f"time {dev_f:.4f} ms and {dev_u:.4f} ms (profiler, mean of "
              f"5 calls)")
        dev_ratio = (f"{dev_f / dev_u:.3f}" if dev_f > 0 and dev_u > 0
                     else "not measured (the profiler saw no device time)")
        print(f"[4 arms] {name} fused/unfused = {ev_f / ev_u:.3f} "
              f"(events), {dev_ratio} (device time)")

    # ---- 6. trace: where one request's time goes ----
    for gname, model in models.items():
        x = torch.from_numpy(np.random.default_rng(200).standard_normal(
            (N_NODES, cfg.in_dim), np.float32)).to(dev)
        with torch.inference_mode():
            model(x)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                model(x)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
        # device-side events only: an aten op's row repeats the time of
        # the kernels it launched, which would count them twice
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0]
        device_us = sum(e.self_device_time_total for e in events)
        p50_us = serve_p50_ms[gname] * 1e3
        print(f"[6 trace] {gname}: device busy {device_us / 1e3:.3f} ms per "
              f"request: {device_us / wall_us:.3f} of the profiled wall "
              f"({wall_us / 1e3:.3f} ms), {device_us / p50_us:.3f} of the "
              f"phase-5 p50 ({p50_us / 1e3:.3f} ms)")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
            print(f"[6 trace] {gname}:   {e.self_device_time_total:9.1f} us"
                  f"  x{e.count:<3d} {e.key[:90]}")
        # the spill lanes and wavefront 1 go through the hybrid kernel: no
        # scatter-add on either path, and index_copy_ only for the scatter
        # of wavefront 0's fused rows (one a fused layer)
        calls = {e.key: e.count for e in prof.key_averages()
                 if e.key in ("aten::index_add_", "aten::index_copy_")}
        fused_layers = model.layer_backends().count("cuda")
        print(f"[6 trace] {gname}: {calls or 'no index_add_ / index_copy_'}"
              f" ({fused_layers} fused layers)")
        if (calls.get("aten::index_add_", 0)
                or calls.get("aten::index_copy_", 0) > fused_layers):
            fail(f"phase 6 {gname}: {calls} in one request")

    # ---- 7. LM kernels through their entry points ----
    import torch.nn.functional as F

    def lm_inputs(kernel, dtype, b=0, h=0, hkv=0, sq=0, sk=0, d=0, e=0,
                  m=0, f=0, **_):
        if kernel == "flash_attention":
            return [randn(b, h, sq, d).to(dtype),
                    randn(b, hkv, sk, d).to(dtype),
                    randn(b, hkv, sk, d).to(dtype)]
        lead = (e,) if e else ()
        return [randn(*lead, m, d).to(dtype),
                randn(*lead, d, f, scale=d ** -0.5).to(dtype),
                randn(*lead, f, d, scale=f ** -0.5).to(dtype)]

    def lm_calls(kernel, args, opts):
        """(kernel call, plain call, library call, bytes, operations)."""
        moved = float(sum(a.numel() * a.element_size() for a in args)
                      + args[0].numel() * args[0].element_size())  # output
        if kernel == "flash_attention":
            q, k, v = args
            causal, window = opts["causal"], opts["window"]
            mask = ref.attention_mask(q.shape[2], k.shape[2], causal=causal,
                                      window=window, device=dev)
            pairs = int(mask.sum()) * q.shape[0] * q.shape[1]
            kw = dict(causal=causal, window=window)
            sdpa = dict(enable_gqa=k.shape[1] != q.shape[1])
            if window:
                sdpa["attn_mask"] = mask
            else:
                sdpa["is_causal"] = causal
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, **sdpa)
            return (lambda: ops.flash_attention(q, k, v, **kw),
                    lambda: ref.attention(q, k, v, **kw), lib, moved,
                    4.0 * q.shape[3] * pairs)
        x, w1, w2 = args
        act = opts["act"]
        act_fn = {"gelu": lambda t: F.gelu(t, approximate="tanh"),
                  "silu": F.silu, "none": lambda t: t}[act]
        n_ops = 4.0 * x.numel() * w1.shape[-1]
        if kernel == "fused_ffn":
            return (lambda: ops.fused_ffn(x, w1, w2, act=act),
                    lambda: ref.ffn(x, w1, w2, act=act),
                    lambda: torch.matmul(act_fn(torch.matmul(x, w1)), w2),
                    moved, n_ops)
        return (lambda: ops.fused_moe_ffn(x, w1, w2, act=act),
                lambda: ref.moe_ffn(x, w1, w2, act=act),
                lambda: torch.bmm(act_fn(torch.bmm(x, w1)), w2),
                moved, n_ops)

    lm_cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for label, kernel, opts in LM_CASES:
            if opts.get("bf16_only") and dtype != torch.bfloat16:
                continue
            lm_cases.append((label, kernel, opts, dtype,
                             lm_inputs(kernel, dtype, **opts)))
    # the kernel entry point is the path of the FFN and MoE kernels (no
    # model calls them): drive it once per case with the counts from 0
    ops.reset_launch_counts()
    entry_out = [lm_calls(kernel, args, opts)[0]()
                 for _, kernel, opts, _, args in lm_cases]
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    print(f"[7 lm kernels] launches through the entry points: {counts}")
    for k in ("fused_ffn", "fused_moe_ffn", "flash_attention"):
        if counts[k] == 0:
            fail(f"phase 7: {k} never launched through its entry point")
    path_launches.update(fused_ffn=counts["fused_ffn"],
                         fused_moe_ffn=counts["fused_moe_ffn"])
    flash_record_path = "none"
    for (label, kernel, opts, dtype, args), got in zip(lm_cases, entry_out):
        dname = str(dtype).split(".")[1]
        kern, plain, lib, moved, n_ops = lm_calls(kernel, args, opts)
        want = plain()
        # row by row: under a causal mask the first rows hold the largest
        # values, and a global scale would hide errors on the long rows
        abs_err, rel = rel_err(got, want, rows=True)
        tol = LM_BF16_TOL if dtype == torch.bfloat16 else TOL[dname]
        if got.shape != want.shape or rel > tol:
            fail(f"{label} {dname}: shape {tuple(got.shape)}, row rel err "
                 f"{rel:.3e} > {tol}")
        lib_err = rel_err(lib(), want, rows=True)[1]
        if kernel == "flash_attention":
            kern()
            torch.cuda.synchronize()
            ran = flash_last_path()
            print(f"[7 lm kernels] {label} {dname}: ran {ran}")
            if (label, dname) == (LM_RECORD["flash_attention"], "bfloat16"):
                flash_record_path = ran
            if (dtype == torch.bfloat16 and opts["d"] in (64, 128)
                    and ran != FLASH_WGMMA):
                fail(f"{label} {dname}: ran {ran}, not {FLASH_WGMMA}")
        bound_bytes = moved / HBM_BYTES_PER_S * 1e3
        bound_ops = n_ops / PEAK_OPS[dname] * 1e3
        ms, plain_ms, lib_ms = time_ms(kern), time_ms(plain), time_ms(lib)
        rec = dict(ms=ms, plain_ms=plain_ms,
                   bound_ms=max(bound_bytes, bound_ops),
                   bound_by="bytes" if bound_bytes >= bound_ops
                   else "operations", library_ms=lib_ms,
                   max_abs_err=abs_err)
        print(f"[7 lm kernels] {label} {dname}: max_abs={abs_err:.3e} "
              f"row_rel={rel:.3e} kernel={ms:.4f} ms plain={plain_ms:.4f} ms "
              f"bound={rec['bound_ms']:.4f} ms ({rec['bound_by']}: "
              f"{moved / 1e6:.1f} MB, {n_ops / 1e9:.3f} Gop) "
              f"share={rec['bound_ms'] / ms:.3f} library={lib_ms:.4f} ms "
              f"(rel {lib_err:.1e})")
        records[(label, dname)] = rec
    del lm_cases, entry_out
    torch.cuda.empty_cache()

    # ---- 8. LM serving: qwen2.5-3b, batched prefill + greedy decode ----
    lm_cfg = get_config(LM_ARCH, reduced=LM_REDUCED)
    t0 = time.perf_counter()
    lm, prompts = serve.build(lm_cfg, batch=LM_BATCH, prompt_len=LM_PROMPT,
                              seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in lm.parameters())
    print(f"[8 lm serve] {lm_cfg.name}: {n_params / 1e9:.3f} B parameters "
          f"({lm_cfg.dtype}), {lm_cfg.n_layers} layers, d_model "
          f"{lm_cfg.d_model}, built on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    # prefill logits: flash kernel against the plain attention (this also
    # warms up the path; its launches are not counted)
    cache = lm.init_cache(LM_BATCH, LM_PROMPT + LM_DECODE + 1)
    got, _ = lm.decode_step(prompts, cache, 0)
    want, _ = lm.decode_step(prompts, cache, 0, impl="torch")
    torch.cuda.synchronize()
    abs_err, rel = rel_err(got, want)
    agree = float((got[:, -1].argmax(-1) == want[:, -1].argmax(-1))
                  .float().mean())
    print(f"[8 lm serve] prefill logits {tuple(got.shape)} vs impl=torch: "
          f"max_abs={abs_err:.3e} rel={rel:.3e} (tolerance {LM_TOL}); "
          f"next-token agreement {agree:.2f}")
    if rel > LM_TOL:
        fail(f"phase 8: prefill logits disagree with the plain attention "
             f"(rel {rel:.3e} > {LM_TOL})")
    del got, want, cache
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    tokens, timing = serve.generate(lm, prompts, LM_DECODE + 1)
    counts = ops.launch_counts()
    dec_ms = [t * 1e3 for t in timing.decode_s]
    print(f"[8 lm serve] prefill {LM_BATCH} x {LM_PROMPT} tokens in "
          f"{timing.prefill_s * 1e3:.2f} ms "
          f"({LM_BATCH * LM_PROMPT / timing.prefill_s:.0f} tokens/s); "
          f"{len(dec_ms)} decode steps p50={float(np.median(dec_ms)):.3f} ms"
          f" max={max(dec_ms):.3f} ms "
          f"({LM_BATCH / (float(np.median(dec_ms)) / 1e3):.1f} tokens/s at "
          f"p50); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; host clock"
          f" around each step + synchronize")
    print(f"[8 lm serve] launches in the serve run: {counts}; "
          f"sample {tokens[0, :8].tolist()}")
    # the prefill above follows empty_cache(), so it also pays cudaMalloc
    # (which synchronizes); a serving process reuses its cached blocks:
    # time the prefill step again with the allocator warm
    serve_step = steps.make_serve_step(lm)
    warm_ms = []
    for _ in range(3):
        cache = lm.init_cache(LM_BATCH, LM_PROMPT + LM_DECODE + 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serve_step(prompts, cache, 0)
        torch.cuda.synchronize()
        warm_ms.append((time.perf_counter() - t0) * 1e3)
        del cache
    print(f"[8 lm serve] prefill with the allocator warm: "
          f"{', '.join(f'{t:.2f}' for t in warm_ms)} ms "
          f"({LM_BATCH * LM_PROMPT / (min(warm_ms) / 1e3):.0f} tokens/s at "
          f"the fastest)")
    if tuple(tokens.shape) != (LM_BATCH, LM_DECODE + 1) or not bool(
            ((tokens >= 0) & (tokens < lm_cfg.vocab_size)).all()):
        fail(f"phase 8: tokens {tuple(tokens.shape)} out of range")
    if counts["flash_attention"] != lm_cfg.n_layers:
        fail(f"phase 8: {counts['flash_attention']} flash launches for one "
             f"prefill of {lm_cfg.n_layers} layers")
    path_launches["flash_attention"] = counts["flash_attention"]
    # the decode path at full width: replay the first decode steps on a
    # cache of the serve run's size, fed the served tokens; each step's
    # greedy pick must be the served token, and its logits must match a
    # full forward over prompt + served tokens with the plain attention
    cache = lm.init_cache(LM_BATCH, LM_PROMPT + LM_DECODE + 1)
    logits, cache = lm.decode_step(prompts, cache, 0)
    picks, dec_logits = [logits[:, -1].argmax(-1)], []
    for i in range(LM_REPLAY):
        logits, cache = lm.decode_step(tokens[:, i:i + 1], cache,
                                       LM_PROMPT + i)
        dec_logits.append(logits[:, 0])
        picks.append(logits[:, 0].argmax(-1))
    picks = torch.stack(picks, dim=1).to(tokens.dtype)
    if not torch.equal(picks, tokens[:, :LM_REPLAY + 1]):
        fail(f"phase 8: replayed greedy picks {picks.tolist()} are not the "
             f"served tokens {tokens[:, :LM_REPLAY + 1].tolist()}")
    del cache, logits
    seq = torch.cat([prompts, tokens[:, :LM_REPLAY].to(prompts.dtype)], 1)
    want = lm(seq, impl="torch")[:, LM_PROMPT:]
    got = torch.stack(dec_logits, dim=1)
    abs_err, rel = rel_err(got, want)
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    print(f"[8 lm serve] {LM_REPLAY} decode steps at cache capacity "
          f"{LM_PROMPT + LM_DECODE + 1}: greedy picks = served tokens; "
          f"logits {tuple(got.shape)} vs full forward (impl=torch): "
          f"max_abs={abs_err:.3e} rel={rel:.3e} (tolerance {LM_TOL}); "
          f"next-token agreement {agree:.2f}")
    if rel > LM_TOL:
        fail(f"phase 8: decode logits disagree with the full forward "
             f"(rel {rel:.3e} > {LM_TOL})")
    del got, want, seq, dec_logits
    torch.cuda.empty_cache()

    # ---- 9. trace: where one prefill's and one decode step's time goes ----
    cache = lm.init_cache(LM_BATCH, LM_PROMPT + 2)
    step = steps.make_serve_step(lm)
    for what, toks, cache_len in (("prefill", prompts, 0),
                                  ("decode step", tokens[:, :1], LM_PROMPT)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(toks, cache, cache_len)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0]
        device_us = sum(e.self_device_time_total for e in events)
        launches = sum(e.count for e in events)
        print(f"[9 trace] {what}: device busy {device_us / 1e3:.3f} ms of "
              f"{wall_us / 1e3:.3f} ms profiled wall "
              f"({device_us / wall_us:.3f}), {launches} device kernels")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
            print(f"[9 trace] {what}:   {e.self_device_time_total:10.1f} us "
                  f"({e.self_device_time_total / device_us:.3f}) "
                  f"x{e.count:<4d} {e.key[:80]}")
    del lm, cache
    torch.cuda.empty_cache()

    # ---- 10. GCN training: CONFIG widths, both phase-5 graphs, SGD ----
    import torch.nn.functional as F

    def sparse_mm_loss(adj, x, y, ws, masks=None):
        """``(loss, sign changes)``: the GCN loss through ``torch.sparse.mm``
        autograd, the f64 host oracle and the card's library yardstick
        (independent of the port's executors).  With ``masks`` (one bool
        tensor a hidden layer) each ReLU is the linear branch that the
        checked run took: where a pre-activation lies within f32 rounding
        of 0, f32 and f64 take different branches and the gradient jumps
        (one such entry moves ``dW1`` by ~1e-3 of its largest value); the
        second value counts those entries."""
        h, flips = x, 0
        for i, w in enumerate(ws):
            h = torch.sparse.mm(adj, h @ w)
            if i == len(ws) - 1:
                break
            if masks is None:
                h = torch.relu(h)
            else:
                flips += int((masks[i] != (h > 0)).sum())
                h = h * masks[i]
        logp = F.log_softmax(h, dim=-1)
        return -torch.take_along_dim(logp, y[:, None], dim=1).mean(), flips

    def sparse_adj(a, device, dtype):
        rows = np.repeat(np.arange(a.n_rows), np.diff(a.indptr))
        idx = torch.from_numpy(np.stack([rows, a.indices]).astype(np.int64))
        return torch.sparse_coo_tensor(
            idx, torch.from_numpy(np.asarray(a.data, np.float64)),
            (a.n_rows, a.n_cols)).coalesce().to(device, dtype)

    def transpose_entries(adj):
        """``{(b_col, c_col): entry}`` of ``adj``'s live transpose
        entries."""
        digest = csr_content_digest(adj)
        return {(k[1], k[2]): e for k, e in api._schedule_cache.items()
                if e.transpose and k[0] == digest}

    def step_ms(step, x, y, n):
        out = []
        for _ in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(x, y)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    train_launches = dict.fromkeys(GCN_KERNELS, 0)
    for gname, model in models.items():
        n_layers = len(model.weights)
        data_rng = np.random.default_rng(300)
        x = torch.from_numpy(data_rng.standard_normal(
            (N_NODES, cfg.in_dim), np.float32)).to(dev)
        y = torch.from_numpy(data_rng.integers(0, cfg.out_dim,
                                               N_NODES)).to(dev)
        w0 = [w.detach().clone() for w in model.weights]

        def grads_at(weights, backend):
            with torch.no_grad():
                for w, v in zip(model.weights, weights):
                    w.copy_(v)
            for w in model.weights:
                w.grad = None
            loss = model.loss(x, y, backend=backend)
            loss.backward()
            return float(loss), [w.grad.clone() for w in model.weights]

        # the references at the initial weights: the plain path on the
        # card, and the f64 oracle on the host, on the ReLU branches of the
        # run's own forward
        want_loss, want = grads_at(w0, "torch")
        masks, h = [], x
        with torch.no_grad():
            for w in w0[:-1]:
                z = api.tile_fused_matmul(model.adj, h, w)
                masks.append((z > 0).cpu())
                h = torch.relu(z)
        del h, z
        oracle_ws = [v.cpu().double().requires_grad_() for v in w0]
        oracle_loss, flips = sparse_mm_loss(
            sparse_adj(model.adj, "cpu", torch.float64), x.cpu().double(),
            y.cpu(), oracle_ws, masks)
        oracle_loss.backward()
        del masks

        # the training run, counted: 10 SGD steps from w0
        step = steps.make_gcn_train_step(model, lr=TRAIN_LR)
        misses = []
        ops.reset_launch_counts()
        losses, lat, per_step, bwd_path = [], [], [], []
        for i in range(TRAIN_STEPS):
            before = ops.launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = step(x, y)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t0) * 1e3)
            per_step.append({k: v - before[k]
                             for k, v in ops.launch_counts().items()})
            losses.append(float(loss))
            misses.append(api.schedule_cache_stats()["misses"])
            if gname == "banded":
                bwd_path.append(gemm_last_path())
            if i == 0:
                got = [w.grad.clone() for w in model.weights]
                keys = sorted(transpose_entries(model.adj))
        counts = ops.launch_counts()
        for k in GCN_KERNELS:
            train_launches[k] += counts[k]

        err_t = max(rel_err(g, w)[1] for g, w in zip(got, want))
        err_o = max(rel_err(g.cpu().double(), w.grad)[1]
                    for g, w in zip(got, oracle_ws))
        print(f"[10 gcn train] {gname}: step-1 loss {losses[0]:.6f} (torch "
              f"{want_loss:.6f}, f64 oracle {float(oracle_loss):.6f}); "
              f"weight grads rel_err vs torch={err_t:.2e} vs f64 "
              f"torch.sparse.mm oracle={err_o:.2e} (on the run's ReLU "
              f"branches; {flips} of {N_NODES * cfg.hidden_dim} "
              f"pre-activations change sign in f64)")
        print(f"[10 gcn train] {gname}: losses "
              f"{', '.join(f'{v:.5f}' for v in losses)}")
        picks = [api.select_backend(e, dev)
                 for e in transpose_entries(model.adj).values()]
        print(f"[10 gcn train] {gname}: transpose entries after step 1 "
              f"{keys}, auto picks {picks}; schedule-cache misses after "
              f"each step {misses}")
        print(f"[10 gcn train] {gname}: launches per step {per_step[-1]} "
              f"(a serving request: {serve_launches[gname]}); "
              f"GeMM-SpMM path of each step's last launch (the backward's "
              f"dB) {sorted(set(bwd_path))}")
        if max(err_t, err_o) > MAIN_TOL:
            fail(f"phase 10 {gname}: step-1 gradients disagree "
                 f"({err_t:.2e} vs torch, {err_o:.2e} vs the oracle)")
        if not losses[-1] < losses[0]:
            fail(f"phase 10 {gname}: loss {losses[0]} -> {losses[-1]}")
        if len(set(misses)) != 1:
            fail(f"phase 10 {gname}: re-inspected after step 1: {misses}")
        if keys != [(cfg.out_dim, cfg.hidden_dim)]:
            fail(f"phase 10 {gname}: transpose entries {keys}, expected "
                 f"layer 2's dB only")
        for i, p in enumerate(per_step):
            # each layer's Âᵀ·Ḋ is one more spmm_ell call than serving makes
            if p["spmm_ell"] < serve_launches[gname]["spmm_ell"] + n_layers:
                fail(f"phase 10 {gname} step {i + 1}: {p['spmm_ell']} "
                     f"spmm_ell launches")
            if gname == "banded" and p["tile_fused_gemm_spmm_wf0"] != (
                    serve_launches[gname]["tile_fused_gemm_spmm_wf0"] + 1):
                fail(f"phase 10 {gname} step {i + 1}: "
                     f"{p['tile_fused_gemm_spmm_wf0']} GeMM-SpMM launches")
        if gname == "banded" and set(bwd_path) != {GEMM_WGMMA}:
            fail(f"phase 10 {gname}: the backward's dB ran {bwd_path}")

        # (not counted from here on) two backward passes from the same
        # weights give the same bits
        w_now = [w.detach().clone() for w in model.weights]
        _, g1 = grads_at(w_now, "auto")
        _, g2 = grads_at(w_now, "auto")
        if not all(torch.equal(a, b) for a, b in zip(g1, g2)):
            fail(f"phase 10 {gname}: two backward passes differ")
        print(f"[10 gcn train] {gname}: two backward passes from the same "
              f"weights give the same bits")

        # one step under the profiler: device time by kernel, busy share.
        # A step traced warm-up first (recorded, then dropped): a session's
        # first kernels launched through ctypes can go missing from its
        # trace, as the step's first GeMM-SpMM launch did without it
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=torch.profiler.schedule(
                         wait=0, warmup=1, active=1, repeat=1)) as prof:
            step(x, y)
            torch.cuda.synchronize()
            prof.step()
            t0 = time.perf_counter()
            step(x, y)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
            prof.step()
        # kernels only: the schedule's step annotation spans the step on
        # the device's timeline too
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0
                  and not e.key.startswith("ProfilerStep")]
        device_us = sum(e.self_device_time_total for e in events)
        p50 = float(np.median(lat))
        print(f"[10 gcn train] {gname}: {TRAIN_STEPS} steps, p50="
              f"{p50:.3f} ms max={max(lat):.3f} ms (host clock around the "
              f"step + synchronize; step 1 {lat[0]:.3f} ms); device busy "
              f"{device_us / 1e3:.3f} ms per step: {device_us / wall_us:.3f}"
              f" of the profiled wall ({wall_us / 1e3:.3f} ms), "
              f"{device_us / 1e3 / p50:.3f} of the p50")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:14]:
            print(f"[10 gcn train] {gname}:   {e.self_device_time_total:9.1f}"
                  f" us  x{e.count:<3d} {e.key[:120]}")
        adds = sum(e.count for e in prof.key_averages()
                   if e.key == "aten::index_add_")
        if adds:
            fail(f"phase 10 {gname}: {adds} index_add_ in a training step")

        # the host time of Eq-3's pick, which every layer of every step
        # asks (Schedule.fused_ratio sums over the wavefront-0 tiles)
        t0 = time.perf_counter()
        for _ in range(20):
            for e in model.entries:
                api.select_backend(e, dev)
        print(f"[10 gcn train] {gname}: host time of one select_backend "
              f"call {(time.perf_counter() - t0) / 20 / n_layers * 1e6:.1f} "
              f"us ({model.entries[0].dsched.n_tiles0} wavefront-0 tiles "
              f"at layer 1)")

        # yardsticks: the unfused arm, and torch.sparse.mm autograd
        unfused = step_ms(steps.make_gcn_train_step(
            model, lr=TRAIN_LR, backend="unfused"), x, y, 5)
        adj_dev = sparse_adj(model.adj, dev, torch.float32)
        lib_ws = [v.clone().requires_grad_() for v in w0]

        def library_step(x, y):
            for w in lib_ws:
                w.grad = None
            sparse_mm_loss(adj_dev, x, y, lib_ws)[0].backward()
            with torch.no_grad():
                for w in lib_ws:
                    w.sub_(TRAIN_LR * w.grad)
        library = step_ms(library_step, x, y, 5)
        print(f"[10 gcn train] {gname}: step p50 {p50:.3f} ms; yardsticks "
              f"p50 over 5 steps: backend='unfused' "
              f"{float(np.median(unfused)):.3f} ms, torch.sparse.mm autograd"
              f" {float(np.median(library)):.3f} ms")
        del adj_dev, lib_ws, x, y
    print(f"[10 gcn train] kernel launches in the training runs: "
          f"{train_launches}")
    for k in ("spmm_ell", "tile_fused_gemm_spmm_wf0"):
        if train_launches[k] == 0:
            fail(f"phase 10: {k} never launched in training")
        path_launches[k] += train_launches[k]

    sources = {
        "spmm_ell": ("src/repro_torch/csrc/spmm_ell.cu",
                     "src/repro/kernels/spmm.py:40"),
        "tile_fused_gemm_spmm_wf0": (
            "src/repro_torch/csrc/tile_fused_gemm_spmm.cu",
            "src/repro/kernels/tile_fused_gemm_spmm.py:80"),
        "tile_fused_spmm_spmm_wf0": (
            "src/repro_torch/csrc/tile_fused_spmm_spmm.cu",
            "src/repro/kernels/tile_fused_spmm_spmm.py:101"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:87"),
        "fused_ffn": ("src/repro_torch/csrc/fused_ffn.cu",
                      "src/repro/kernels/fused_ffn.py:54"),
        "fused_moe_ffn": ("src/repro_torch/csrc/fused_ffn.cu",
                          "src/repro/kernels/moe.py:53"),
    }
    # the device function each record's case ran (the launchers' records
    # for the kernels with several paths)
    paths = {"spmm_ell": records[(SPMM_RECORD, "float32")]["path"],
             "tile_fused_gemm_spmm_wf0": records[(
                 "tile_fused_gemm_spmm_wf0", "float32")]["path"],
             "tile_fused_spmm_spmm_wf0": "tile_fused_spmm_spmm_wf0_kernel",
             "flash_attention": flash_record_path,
             "fused_ffn": "fused_ffn_wgmma_kernel",
             "fused_moe_ffn": "fused_ffn_wgmma_kernel"}
    kernels = []
    for name, (source, replaces) in sources.items():
        # the GCN kernels' records are f32 (the GCN path's dtype), the LM
        # kernels' bf16 (the LM serving dtype)
        rec = (records[(LM_RECORD[name], "bfloat16")] if name in LM_RECORD
               else records[(SPMM_RECORD if name == "spmm_ell" else name,
                             "float32")])
        extra = ({} if name != "spmm_ell" else
                 dict(case=SPMM_RECORD,
                      replaced_chain_ms=rec["replaced_chain_ms"]))
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces,
                            launches=path_launches[name],
                            max_abs_err=rec["max_abs_err"], ms=rec["ms"],
                            plain_ms=rec["plain_ms"],
                            bound_ms=rec["bound_ms"],
                            bound_by=rec["bound_by"],
                            library_ms=rec["library_ms"],
                            tensor_core_ops=tensor_core_ops[name],
                            path=paths[name], **extra))
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(nvidia_smi())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
