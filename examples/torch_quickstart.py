"""Quickstart on the PyTorch port (twin of ``quickstart.py``).

  PYTHONPATH=src python examples/torch_quickstart.py
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Inspects a tile-fusion schedule for a graph matrix through the port's
dispatch API, holds the fused GeMM-SpMM to the unfused float64 oracle,
prints the schedule's metrics, shows the inspector cache amortizing, and
trains a 2-layer GCN (the paper's native workload) for a few steps.
``--device`` defaults to the card (the hand-written kernels) and raises
without one; ``cpu`` runs the kernels' plain versions.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import gcn as gcn_cfg
from repro_torch.core.sparse.random import banded_spd, powerlaw_graph
from repro_torch.core.tilefusion import api, fused_ref
from repro_torch.core.tilefusion.spec import FusionSpec
from repro_torch.launch.steps import make_gcn_train_step
from repro_torch.models.gcn import GCN


def main(argv=None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu")

    # ---- 1. inspect a GeMM-SpMM schedule: D = A (B C) ----
    # banded SPD = the paper's scientific-computing matrix group (group I);
    # swap in powerlaw_graph(...) for the graph group (lower fused ratio)
    n, bcol, ccol = args.nodes, 64, 64
    a = banded_spd(n, bandwidth=8, seed=0)
    spec = FusionSpec(p=8, cache_size=300_000.0, ct_size=512)
    entry = api.get_schedule(a, b_col=bcol, c_col=ccol, spec=spec)
    sched = entry.sched
    print(f"matrix: {n}x{n}, nnz={a.nnz}")
    print(f"schedule: {len(sched.wavefronts[0])} fused tiles + "
          f"{len(sched.wavefronts[1])} wavefront-1 tiles, t={sched.t}, "
          f"fused_ratio={sched.fused_ratio:.2f} (1 barrier, 0 atomics)")
    tm = entry.traffic_model
    print(f"traffic model: fused moves {tm['fused_bytes']/1e6:.1f}MB vs "
          f"unfused {tm['unfused_bytes']/1e6:.1f}MB "
          f"({100*tm['traffic_saving']:.0f}% saved, "
          f"{tm['d1_spill_rows']}/{n} D1 rows spill past the barrier)")

    # ---- 2. correctness vs oracle, dispatch + inspector amortization ----
    rng = np.random.default_rng(0)
    b = rng.standard_normal((n, bcol))
    c = rng.standard_normal((bcol, ccol))
    d_ref = fused_ref.unfused_gemm_spmm(a, b, c)
    d = api.tile_fused_matmul(
        a, torch.from_numpy(b).float().to(device),
        torch.from_numpy(c).float().to(device), spec=spec)
    err = float(np.abs(d.cpu().numpy() - d_ref).max() / np.abs(d_ref).max())
    print(f"fused (backend=auto -> {api.select_backend(entry, device)}) "
          f"vs oracle rel err: {err:.2e}")
    print(f"inspector: {entry.inspector_s*1e3:.1f}ms once, then cached — "
          f"stats {api.schedule_cache_stats()}")

    # ---- 3. GCN training on the fused path ----
    cfg = gcn_cfg.REDUCED
    model = GCN(cfg, powerlaw_graph(cfg.n_nodes, cfg.avg_degree, seed=1),
                device=device)
    x = torch.from_numpy(rng.standard_normal(
        (cfg.n_nodes, cfg.in_dim)).astype(np.float32)).to(device)
    y = torch.from_numpy(rng.integers(0, cfg.out_dim, cfg.n_nodes)).to(
        device)
    step = make_gcn_train_step(model, lr=0.5)
    t0 = time.time()
    for i in range(args.steps):
        loss = step(x, y)
        if i % 3 == 0:
            print(f"gcn step {i}: loss {float(loss):.4f}")
    print(f"{args.steps} GCN steps in {time.time()-t0:.1f}s — schedule "
          f"inspected once, served from cache every step (paper §4.2.3)")
    return err


if __name__ == "__main__":
    main()
