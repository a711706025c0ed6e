"""The port's dry run of a few cells, its collective bytes split by the
code that moved them.

Usage:
  PYTHONPATH=src python tools/dryrun_callers.py \
      --cell hymba-1.5b:decode_32k [--cell ...] [--mesh 16x16] \
      [--layers N] [--out FILE]

Each cell is counted as ``repro_torch.launch.dryrun`` counts it
(``dryrun._count`` on a ``meta`` mesh, default the 16 × 16 production
mesh; ``--layers`` replaces the config's depth) and printed as one JSON
line: FLOPs, bytes and collective bytes a member, the collective bytes by
caller, the three roofline terms on the H100's peaks, the MODEL/HLO ratio,
and the fullest member's argument and peak bytes.

A collective's bytes are filed under the first of these frames found
above ``models.sharding.count``: ``MeshExecutor.full`` (a weight gathered
whole), ``MeshCache.take`` (a cache region rebuilt on a member),
``MeshCache.put`` (a result written back into other members' blocks),
``MeshExecutor._whole_mm`` (a product's columns gathered as an
activation), ``Zero1.update`` (the optimizer's chunks); anything else under
its kind (``psum``, ``all_gather``, ``gather``: the logits).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from repro_torch.launch import dryrun
from repro_torch.models import sharding
from repro_torch.models.sharding import Mesh
from repro_torch.roofline import model_flops, roofline

#: frame function name -> caller tag
CALLERS = {"full": "weights_gathered", "take": "cache_rebuilt",
           "put": "cache_written_back", "_whole_mm": "activation_gathered",
           "update": "zero1"}


def _tagged_count(by_caller: dict):
    plain = sharding.count

    def count(kind, nbytes, members=2):
        f = sys._getframe(1)
        tag = kind
        while f is not None:
            if f.f_code.co_name in CALLERS:
                tag = CALLERS[f.f_code.co_name]
                break
            f = f.f_back
        by_caller[tag] = by_caller.get(tag, 0) + nbytes
        plain(kind, nbytes, members)
    return count


def run(arch: str, shape: str, mesh, layers: int | None) -> dict:
    by_caller = {}
    plain = sharding.count
    sharding.count = _tagged_count(by_caller)
    t0 = time.time()
    try:
        full = dryrun._count(arch, shape, mesh, cfg_replace=(
            {"n_layers": layers} if layers else None))
    finally:
        sharding.count = plain
    n = mesh.devices.size
    rl = roofline(full["cost"], full["coll"],
                  model_flops_global=model_flops(full["cfg"], full["shape"]),
                  n_devices=n)
    fullest = max(full["members"],
                  key=lambda w: full["members"][w]["peak_bytes"])
    mem = full["members"][fullest]
    return {
        "arch": arch, "shape": shape, "layers": full["cfg"].n_layers,
        "mesh": "x".join(map(str, mesh.devices.shape)),
        "flops": full["cost"]["flops"],
        "bytes": full["cost"]["bytes accessed"],
        "coll_bytes": full["coll"]["total_bytes"],
        "coll_by_caller": {k: v / n for k, v in sorted(by_caller.items())},
        "compute_s": rl.compute_s, "memory_s": rl.memory_s,
        "collective_s": rl.collective_s, "bottleneck": rl.bottleneck,
        "useful_ratio": rl.useful_ratio,
        "argument_bytes": mem["argument_bytes"],
        "peak_bytes": mem["peak_bytes"], "fullest_member": list(fullest),
        "seconds": round(time.time() - t0, 1),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", action="append", required=True,
                    help="arch:shape")
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--layers", type=int)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    dims = tuple(int(n) for n in args.mesh.split("x"))
    axes = ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
    mesh = Mesh(np.full(dims, "meta", dtype=object), axes)
    for cell in args.cell:
        arch, shape = cell.split(":")
        res = run(arch, shape, mesh, args.layers)
        line = json.dumps(res)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
