#!/usr/bin/env python3
"""Sharded tile fusion over distinct cards, beside the same meshes on one
card.

Run from the root of a checkout, on a machine with two or more H100s
(four for the meshes below as written):

    python3 benchmarks_torch/sharded_multicard.py

On the normalized ``banded_spd(131072, 8)`` (the GCN graph of
``chip_smoke.py``) with B 131072 × 128 and C 128 × 128 (GeMM-SpMM) and
C 131072 × 128 (SpMM-SpMM), ``tile_fused_matmul`` runs over the meshes
(4,) 1d, (2, 2) 1.5d and (2, 2, 2) 2.5d, with ``psum`` and
``reduce_scatter``, overlap off and on, twice: with the mesh's entries
spread over the cards (``cuda:0`` .. ``cuda:{n-1}``, repeated where the
mesh has more entries than cards) and with every entry ``cuda:0``.  Each
result is held to the one-device ``"cuda"`` arm (rel err ≤ 1e-4, relative
to the largest value) and must land on C's card; each call's kernel
launches and the collectives' counted bytes are printed.  Wall per call:
host clock around the call and a synchronize of every card, median of 10
after 2 warm-ups, the one-device ``"cuda"`` arm beside it.  Then the
``CONFIG`` GCN (128 / 128 / 32) serves a request and takes one SGD step on
the (4,) mesh over the cards, against one device.  A failed check exits
non-zero.  The last line is each card's name and power limit.
"""
from __future__ import annotations

import dataclasses
import itertools
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N_NODES = 131_072
TOL = 1e-4
MESHES = {"1d": (4,), "1.5d": (2, 2), "2.5d": (2, 2, 2)}
REPS = 10


def main() -> None:
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.gcn import CONFIG
    from repro_torch.core.sparse.random import banded_spd
    from repro_torch.core.tilefusion import api
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import sharding
    from repro_torch.models.gcn import GCN

    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_cards < 2:
        sys.exit("needs two or more CUDA devices")
    torch.backends.cuda.matmul.allow_tf32 = False
    cards = [torch.device("cuda", i) for i in range(n_cards)]
    dev = cards[0]

    def sync():
        for d in cards:
            torch.cuda.synchronize(d)

    def rel_err(got, want):
        got, want = got.float(), want.float()
        return float((got - want).abs().max()) / max(
            float(want.abs().max()), 1e-30)

    def mesh_of(shape, spread):
        n = int(np.prod(shape))
        names = [str(cards[i % n_cards]) if spread else str(dev)
                 for i in range(n)]
        return sharding.Mesh(np.array(names, dtype=object).reshape(shape),
                             ("x", "y", "z")[:len(shape)])

    def wall_ms(fn):
        for _ in range(2):
            fn()
        sync()
        out = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            fn()
            sync()
            out.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(out))

    model = GCN(dataclasses.replace(CONFIG, n_nodes=N_NODES),
                banded_spd(N_NODES, 8, seed=0), seed=0, device=dev)
    adj = model.adj
    rng = np.random.default_rng(0)
    b = torch.from_numpy(rng.standard_normal((N_NODES, 128),
                                             np.float32)).to(dev)
    c = torch.from_numpy((rng.standard_normal((128, 128), np.float32)
                          / np.float32(128 ** 0.5))).to(dev)
    cs = torch.from_numpy(rng.standard_normal((N_NODES, 128),
                                              np.float32)).to(dev)
    print(f"[setup] {n_cards} cards {[torch.cuda.get_device_name(d) for d in cards]}"
          f"; nnz {adj.nnz}")
    failed = []
    for name, b_or_a1, cc in (("GeMM-SpMM", b, c), ("SpMM-SpMM", adj, cs)):
        want = api.tile_fused_matmul(adj, b_or_a1, cc, backend="cuda")
        one_ms = wall_ms(lambda: api.tile_fused_matmul(adj, b_or_a1, cc,
                                                       backend="cuda"))
        print(f"[{name}] one device, backend='cuda': wall {one_ms:.3f} ms")
        for (layout, shape), combine, overlap in itertools.product(
                MESHES.items(), ("psum", "reduce_scatter"), (False, True)):
            walls = {}
            for spread in (True, False):
                spec = api.FusionSpec(mesh=mesh_of(shape, spread),
                                      shard_layout=layout,
                                      shard_combine=combine, overlap=overlap)
                sync()
                ops.reset_launch_counts()
                sharding.reset_comm_bytes()
                got = api.tile_fused_matmul(adj, b_or_a1, cc, spec=spec)
                sync()
                counts = {k: v for k, v in ops.launch_counts().items() if v}
                comm = dict(sharding.comm_bytes)
                err = rel_err(got, want)
                walls[spread] = wall_ms(
                    lambda: api.tile_fused_matmul(adj, b_or_a1, cc,
                                                  spec=spec))
                if err > TOL or got.device != cc.device:
                    failed.append((name, layout, combine, overlap, spread))
                if spread:
                    print(f"[{name}] {layout} {shape} {combine} overlap="
                          f"{overlap} over {n_cards} cards: rel err {err:.2e}"
                          f" on {got.device}; launches {counts}; collective "
                          f"bytes {comm}")
            print(f"[{name}] {layout} {combine} overlap={overlap}: wall "
                  f"{walls[True]:.3f} ms over {n_cards} cards, "
                  f"{walls[False]:.3f} ms with every shard on cuda:0")

    mesh = mesh_of((4,), True)
    x = torch.from_numpy(rng.standard_normal((N_NODES, CONFIG.in_dim),
                                             np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, CONFIG.out_dim, N_NODES)).to(dev)
    with torch.inference_mode():
        err = rel_err(model(x, mesh=mesh), model(x))
    model.loss(x, y).backward()
    want = [w.grad.clone() for w in model.weights]
    for w in model.weights:
        w.grad = None
    loss = steps.make_gcn_train_step(model, lr=0.3, mesh=mesh)(x, y)
    sync()
    g_err = max(rel_err(w.grad, v) for w, v in zip(model.weights, want))
    print(f"[gcn] mesh (4,) over {n_cards} cards: logits rel err {err:.2e}, "
          f"step-1 weight grads rel err {g_err:.2e}, loss {float(loss):.5f}")
    if err > TOL or g_err > TOL:
        failed.append(("gcn", err, g_err))
    if failed:
        sys.exit(f"FAILED: {failed}")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().replace("\n", "; "))


if __name__ == "__main__":
    main()
