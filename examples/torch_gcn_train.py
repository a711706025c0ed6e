"""End-to-end GCN training on the PyTorch port (twin of ``gcn_train.py``).

  PYTHONPATH=src python examples/torch_gcn_train.py [--nodes 4096] [--steps 100]
  PYTHONPATH=src python examples/torch_gcn_train.py --device cpu --nodes 4096 --steps 5

GCN layer = D = Â(XW) = GeMM-SpMM; every layer and every step runs through
the port's ``tile_fused_matmul`` (schedule inspected once per graph, then
served from the content-keyed cache).  The backward runs on the same
dispatch: the api's autograd Functions run the transposed products off
cached transpose schedules (on the card, through the CUDA kernels).
Reports fused vs unfused wall time, per-layer traffic models, and the
train-step (fwd+bwd) traffic from the transpose entries.  ``--device``
defaults to the card and raises without one.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs.gcn import GCNConfig
from repro_torch.core.sparse.random import powerlaw_graph
from repro_torch.core.tilefusion import api
from repro_torch.core.tilefusion.spec import FusionSpec
from repro_torch.launch.steps import make_gcn_train_step
from repro_torch.models.gcn import GCN


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=4096)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=0.3)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)

    cfg = GCNConfig(n_nodes=args.nodes, in_dim=args.hidden,
                    hidden_dim=args.hidden, out_dim=32, n_layers=2)
    adj = powerlaw_graph(cfg.n_nodes, cfg.avg_degree, seed=0)
    t0 = time.time()
    model = GCN(cfg, adj, spec=FusionSpec(cache_size=300_000.0),
                device=device)
    sched = model.entries[0].sched
    print(f"schedule inspect: {time.time()-t0:.2f}s (cached for every "
          f"layer/step), fused_ratio={sched.fused_ratio:.2f}, "
          f"tiles={len(sched.wavefronts[0])}+{len(sched.wavefronts[1])}")
    for i, e in enumerate(model.entries):
        print(f"layer {i} ({model.dims[i]}->{model.dims[i+1]}): traffic "
              f"saving (kernel path) "
              f"{100*e.traffic_model['traffic_saving']:.0f}%")
    for i, tm in enumerate(model.train_step_traffic_models()):
        print(f"layer {i} train step: fwd {tm['forward_bytes']/1e6:.1f} MB "
              f"+ bwd {tm['backward_bytes']/1e6:.1f} MB "
              f"(bwd fused saving {100*tm['backward_saving']:.0f}%)")

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(
        (cfg.n_nodes, cfg.in_dim)).astype(np.float32)).to(device)
    y = torch.from_numpy(rng.integers(0, cfg.out_dim, cfg.n_nodes)).to(
        device)
    weights = [w.detach().clone() for w in model.weights]
    final_losses = {}

    for fused in (True, False):
        with torch.no_grad():
            for w, w0 in zip(model.weights, weights):
                w.copy_(w0)
        # the fused leg runs backend="auto": Eq-3 picks the executor per
        # entry, falling back to the plain hybrid SpMM when the modeled
        # saving can't cover the tile loop's fixed costs
        be = "auto" if fused else "unfused"
        picks = ",".join(sorted(set(model.layer_backends()))) if fused \
            else be
        step_fn = make_gcn_train_step(model, lr=args.lr, backend=be)
        misses0 = api.schedule_cache_stats()["misses"]
        _sync(device)
        t0 = time.time()
        for _ in range(args.steps):
            step_fn(x, y)
        _sync(device)
        dt = time.time() - t0
        # the loss at the post-loop weights (the in-loop value lags one
        # update behind)
        with torch.inference_mode():
            final_loss = final_losses[be] = float(
                model.loss(x, y, backend=be))
        stats = api.schedule_cache_stats()
        print(f"{f'fused[{picks}]' if fused else 'unfused'}: "
              f"{args.steps} steps "
              f"in {dt:.2f}s ({dt/args.steps*1e3:.1f} ms/step), "
              f"final loss {final_loss:.4f}, "
              f"re-inspections during loop: "
              f"{stats['misses'] - misses0}, "
              f"transpose entries: {stats['transpose_entries']}")
    return final_losses


if __name__ == "__main__":
    main()
