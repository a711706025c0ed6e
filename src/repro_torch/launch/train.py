"""Fault-tolerant LM training driver.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --reduced --device cpu --steps 200 --batch 8 --seq 128 \\
        --ckpt-dir /tmp/ckpt

The twin of ``repro.launch.train``, with the same flags, defaults and log
lines, and ``--device`` (default ``cuda``: the run needs the card unless
the CPU is asked for).  Weights come from ``--seed`` through the model's
``torch.Generator`` (the reference's distributions, not its numbers); the
data stream is the reference's own (``data.SyntheticStream``).

  * step-tagged atomic checkpoints of the parameters and the AdamW state
    in the reference's layout (``checkpoint.ckpt``), every
    ``--ckpt-every`` steps and at the end, pruned to the newest 3; a run
    restores the newest complete step, so a reference checkpoint resumes
    here and the reverse;
  * the data stream is a pure function of the step, so a restart neither
    skips nor repeats a batch;
  * straggler watchdog: an EMA of the step's wall time; a step slower
    than ``--straggler-factor`` × the EMA is logged;
  * ``--simulate-preemption N`` ends the loop after step N (exit 17);
    ``[fatal] NaN loss`` exits 2.

``main(argv)`` runs in-process and returns a ``TrainRun``.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import sys
import time

import torch

from .. import checkpoint as ckpt
from ..configs import get_config
from ..data import DataConfig, SyntheticStream
from ..models import transformer as T
from ..optim import OptConfig, adamw
from . import steps


@dataclasses.dataclass
class TrainRun:
    """What a finished run leaves: each step's loss and wall time (host
    clock around the step; reading the loss waits for the device), the
    model and its optimizer state, and the step function."""
    losses: list
    step_s: list
    model: T.Transformer
    opt_state: adamw.OptState
    train_step: object


def _tree(model, opt_state) -> tuple:
    """The checkpointed tree, the reference's ``(params, opt_state)``."""
    return model.param_tree(), adamw.state_to_tree(opt_state, model)


def main(argv=None) -> TrainRun:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--straggler-factor", type=float, default=3.0)
    ap.add_argument("--simulate-preemption", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, reduced=args.reduced)
    opt_cfg = OptConfig(lr=args.lr, warmup_steps=20, total_steps=args.steps)

    # a stubbed frontend without an encoder trains on embeddings
    dkind = "lm" if (cfg.frontend == "none" or cfg.encoder_layers) \
        else "embeds"
    data = SyntheticStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch, seed=args.seed, kind=dkind,
        d_model=cfg.d_model))

    model = T.Transformer(cfg, device=args.device, seed=args.seed)
    opt_state = adamw.init(model.parameters())
    start_step = 0

    if args.ckpt_dir:
        latest = ckpt.latest_step(args.ckpt_dir)
        if latest is not None:
            (params, opt_tree), extra = ckpt.restore(
                args.ckpt_dir, latest, _tree(model, opt_state))
            model.params_from_jax(params)
            opt_state = adamw.state_from_tree(opt_tree, model)
            start_step = extra["step"]
            print(f"[restore] resumed from step {start_step}", flush=True)

    train_step = steps.make_train_step(model, opt_cfg)

    ema = None
    loss = math.nan
    losses, step_s = [], []
    for step in range(start_step, args.steps):
        t0 = time.time()
        raw = data.batch_at(step)
        batch = {k: torch.from_numpy(v).to(model.device)
                 for k, v in raw.items()}
        if cfg.encoder_layers:
            # the stubbed frontend's frames: zeros, as the reference's
            batch["enc_embeds"] = torch.zeros(
                (args.batch, cfg.encoder_seq, cfg.d_model),
                device=model.device)
        opt_state, metrics = train_step(opt_state, batch)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        losses.append(loss)
        step_s.append(dt)
        ema = dt if ema is None else 0.9 * ema + 0.1 * dt
        if dt > args.straggler_factor * ema and step > start_step + 3:
            print(f"[straggler] step {step} took {dt:.2f}s "
                  f"(ema {ema:.2f}s)", flush=True)
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} {dt*1e3:.0f}ms", flush=True)
        if math.isnan(loss):
            print("[fatal] NaN loss", flush=True)
            sys.exit(2)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, step + 1, _tree(model, opt_state),
                      extra={"step": step + 1, "arch": args.arch})
            ckpt.prune(args.ckpt_dir, keep=3)
        if args.simulate_preemption and step + 1 == args.simulate_preemption:
            print(f"[preempted] simulated preemption at step {step+1}",
                  flush=True)
            sys.exit(17)

    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, args.steps, _tree(model, opt_state),
                  extra={"step": args.steps, "arch": args.arch})
    print(f"done: {args.steps} steps, final loss {loss:.4f}", flush=True)
    return TrainRun(losses, step_s, model, opt_state, train_step)


if __name__ == "__main__":
    main()
