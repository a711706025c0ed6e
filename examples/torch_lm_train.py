"""End-to-end LM training on the PyTorch port (twin of ``lm_train.py``): a
~25M-parameter dense transformer for a few hundred steps with checkpoint /
restart, through the port's ``launch.train``.

  PYTHONPATH=src python examples/torch_lm_train.py [--steps 300]
  PYTHONPATH=src python examples/torch_lm_train.py --device cpu \\
      --steps 8 --batch 2 --seq 32

A run resumes from the newest checkpoint in ``--ckpt-dir``;
``--simulate-preemption N`` ends it after step N (exit 17), and the next
run picks up there.  ``--device`` defaults to the card and raises
without one.
"""
import argparse
import os

from repro_torch.configs import _MODULES  # registry
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import train as train_mod

SMALL_LM = ModelConfig(
    name="small-lm-25m", family="dense",
    n_layers=8, d_model=256, n_heads=8, n_kv_heads=4,
    d_ff=1024, vocab_size=8192, remat="none",
)


class _Mod:
    CONFIG = SMALL_LM
    REDUCED = SMALL_LM


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "build", "lm_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--simulate-preemption", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _MODULES["small-lm-25m"] = _Mod  # register the example config
    return train_mod.main([
        "--arch", "small-lm-25m", "--steps", str(args.steps),
        "--batch", str(args.batch), "--seq", str(args.seq),
        "--ckpt-dir", args.ckpt_dir, "--ckpt-every", str(args.ckpt_every),
        "--log-every", str(args.log_every),
        "--simulate-preemption", str(args.simulate_preemption),
        "--device", args.device,
    ])


if __name__ == "__main__":
    main()
