"""Serving on the PyTorch port (twin of ``moe_serve.py``): batched decode
on the MoE arch (the tile-fusion flagship), then a sampled-subgraph stream
through the dynamic-pattern serving tier.

  PYTHONPATH=src python examples/torch_moe_serve.py
  PYTHONPATH=src python examples/torch_moe_serve.py --device cpu

``--device`` defaults to the card and raises without one.
"""
import argparse

from repro_torch.launch import serve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--subgraphs", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    serve.main(["--arch", "granite-moe-3b-a800m", "--reduced",
                "--batch", "4", "--prompt-len", "16", "--gen", str(args.gen),
                "--device", args.device])
    # dynamic-pattern tier: bucketed schedule reuse + incremental
    # inspection + batched dispatch over a drifting subgraph stream
    return serve.main(["--subgraphs", str(args.subgraphs),
                       "--subgraph-nodes", "192", "--feat-dim", "16",
                       "--out-dim", "8", "--max-batch", "4",
                       "--device", args.device])


if __name__ == "__main__":
    main()
