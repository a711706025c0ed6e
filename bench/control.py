"""Readings that set a cell's correctness limits, on the card.

    python3 bench/control.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 1,2,3]

For each seed: the program's first steps (the cell's own set-up, at its
own size) against the plain reference: the lower readings.  For each
control seed also the control, the reference computed a precision below
the configuration's (TF32 for f32, fp8 for bf16), and the reference with
half of the batch left out, each against the reference: the upper
readings.  A step that returns its state unchanged reads 1 by
``change_gap`` and needs no run.  One JSON line a reading; the benchmark's
own runs never run this.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
#: the control's precision: the nearest below the configuration's
LOWER = {"float32": "tf32", "bfloat16": "fp8"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import importlib

    import torch

    from bench import compare, generate, harness
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = harness.find_cell(harness.manifest(), args.workload)
    cfg = generate.load("configs", cell["config"])
    traffic = generate.load("traffic", cell["traffic"])
    family = importlib.import_module(f"bench.families.{cfg['family']}")
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.perf_counter()
        sess = family.Session(cfg, traffic, seed, dev)
        sess.setup()
        program = sess.readings
        sess.close()
        gc.collect()
        torch.cuda.empty_cache()
        ref = sess.reference()
        rows = [("program", compare.gaps(program, ref))]
        if seed in controls:
            rows.append(("control", compare.gaps(
                sess.reference(LOWER[cfg["dtype"]]), ref)))
            rows.append(("half_batch", compare.gaps(
                sess.reference(fault="half_batch"), ref)))
        for kind, gaps in rows:
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "kind": kind, **gaps}), flush=True)
        print(f"# seed {seed}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
        del sess
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
