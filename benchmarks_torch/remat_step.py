#!/usr/bin/env python3
"""The LM training step under each remat policy, on one H100.

Run from the root of a checkout, on a machine with the card:

    python3 benchmarks_torch/remat_step.py [--steps 4]

stablelm-1.6b at its published widths, bf16, weights from seed 0, one
batch of 4 × 2048 tokens from seed 0, AdamW (lr 3e-4, warmup 1), through
``launch.steps.make_train_step``:
- the ``sparse-band`` block (``chip_smoke.py`` phase 14's model) under
  remat ``"none"``, ``"full"`` and ``"dots"``;
- the dense decoder (phase 15's) under ``"full"`` and ``"dots"``
  (``"none"`` keeps every layer's attention scores and probabilities,
  ≈ 200 GB, more than the card holds).

For each: the step's wall p50 and max over ``--steps`` steps after one
warm-up (host clock around the step + synchronize), the kernel launches
a step, one profiled step's device busy time and its share of that
step's wall (the second of two profiler sessions of a step each: a
session can drop its first ctypes launch), and peak device memory.
Prints the card's name and power limit last.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BATCH, SEQ = 4, 2048


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args()
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    from repro_torch.optim import OptConfig, adamw

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    dev = torch.device("cuda")
    base = get_config("stablelm-1.6b")
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = {k: torch.randint(0, base.vocab_size, (BATCH, SEQ), device=dev,
                              generator=gen) for k in ("tokens", "labels")}
    cells = [("sparse-band", r) for r in ("none", "full", "dots")] + [
        ("attn", r) for r in ("full", "dots")]
    for pattern, remat in cells:
        cfg = dataclasses.replace(base, block_pattern=pattern, remat=remat)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = T.Transformer(cfg, device=dev, seed=0)
        step = steps.make_train_step(
            model, OptConfig(lr=3e-4, warmup_steps=1, total_steps=20))
        state = [adamw.init(model.parameters())]

        def one():
            state[0], m = step(state[0], batch)
            torch.cuda.synchronize()
            return float(m["loss"])
        one()
        walls, losses = [], []
        for _ in range(args.steps):
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            losses.append(one())
            walls.append((time.perf_counter() - t0) * 1e3)
        launches = {k: v for k, v in ops.launch_counts().items() if v}
        for _ in range(2):      # the first session is a warm-up
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                one()
                traced = (time.perf_counter() - t0) * 1e3
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA) / 1e3
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"{pattern:11s} remat {remat!r:7s}: step p50 "
              f"{np.median(walls):.1f} ms, max {max(walls):.1f} ms over "
              f"{args.steps} steps; traced step busy {busy:.1f} of "
              f"{traced:.1f} ms ({busy / traced:.3f}); peak "
              f"{peak:.2f} GiB; launches a step {launches}; losses "
              f"{', '.join(f'{v:.4f}' for v in losses)}", flush=True)
        del model, step, state, prof
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
