"""Full-batch GCN training: ``repro_torch.models.gcn.GCN`` trained by
``repro_torch.launch.steps.make_gcn_train_step`` (SGD in place) over the
whole graph every step, the loss read on the host after each step, as a
training loop that logs every epoch does.

The graph, features, labels and initial weights are the benchmark's,
made from the seed; the program gets the graph as a CSR of unit edge
weights and normalizes it itself.  The reference gets the same raw
inputs.  The configuration's ``spec`` (if any) holds the program's
``FusionSpec`` settings, such as ``reorder``; without it the program's
defaults hold.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import generate, work
from ..reference import gcn as reference

#: steps run in set-up, the ones the reference follows
CHECKED = 3


class Session:
    trace_steps = 20

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.seeds = generate.sub_seeds(seed)
        self.inspect_s = 0.0

    # -------------------------------------------------------- set-up ----
    def setup(self) -> None:
        from repro_torch.configs.gcn import GCNConfig
        from repro_torch.core.sparse.formats import CSR
        from repro_torch.core.tilefusion import api
        from repro_torch.core.tilefusion.spec import FusionSpec
        from repro_torch.launch import steps
        from repro_torch.models.gcn import GCN
        self.api = api
        cfg, n = self.cfg, self.cfg["n_nodes"]
        self.indptr, self.indices = generate.graph(self.traffic, n,
                                                   self.seeds["graph"])
        self.nnz = int(self.indices.shape[0])
        self.x, self.y, self.w0 = generate.gcn_inputs(cfg, self.seeds,
                                                      self.device)
        adj = CSR(n, n, self.indptr, self.indices,
                  np.ones(self.nnz, np.float32))
        gcfg = GCNConfig(name=cfg["name"], n_nodes=n, in_dim=cfg["in_dim"],
                         hidden_dim=cfg["hidden_dim"],
                         out_dim=cfg["out_dim"], n_layers=cfg["n_layers"])
        inspect = api.get_schedule

        def timed_inspect(*args, **kwargs):
            misses = api.schedule_cache_stats()["misses"]
            t0 = time.perf_counter()
            entry = inspect(*args, **kwargs)
            if api.schedule_cache_stats()["misses"] > misses:
                self.inspect_s += time.perf_counter() - t0
            return entry
        api.get_schedule = timed_inspect
        try:
            self.model = GCN(gcfg, adj, device=self.device,
                             spec=FusionSpec(**cfg.get("spec", {})))
            with torch.no_grad():
                for w, w0 in zip(self.model.weights, self.w0):
                    w.copy_(w0)
            self.train = steps.make_gcn_train_step(self.model, lr=cfg["lr"])
            losses = []
            for i in range(CHECKED):
                losses.append(float(self.train(self.x, self.y)))
                if i == 0:
                    grads = [float(w.grad.norm()) for w in self.model.weights]
        finally:
            api.get_schedule = inspect
        names = [f"w{i}" for i in range(len(self.w0))]
        self.readings = {
            "losses": losses,
            "grad_norms": dict(zip(names, grads)),
            "change_norms": {k: float((w.detach() - w0).norm()) for k, w, w0
                             in zip(names, self.model.weights, self.w0)}}

    # -------------------------------------------------------- window ----
    def step(self) -> int:
        self.last_loss = float(self.train(self.x, self.y))
        return 1

    def info(self) -> dict:
        stats = self.api.schedule_cache_stats()
        return {"nodes": self.cfg["n_nodes"], "nnz": self.nnz,
                "eq3_pick_per_layer": self.model.layer_backends(),
                "schedule_cache": {k: stats[k] for k in
                                   ("hits", "misses", "entries",
                                    "transpose_entries")},
                "last_loss": self.last_loss}

    # ---------------------------------------------------------- work ----
    def step_flops(self) -> float:
        return work.gcn_step_flops(self.cfg, self.nnz)

    def scoped_work(self) -> list:
        return work.gcn_calls(self.cfg, self.nnz)

    # ----------------------------------------------------- reference ----
    def close(self) -> None:
        del self.model, self.train

    def reference(self, prec: str = "f32", fault: str | None = None) -> dict:
        return reference.train(self.indptr, self.indices, self.x, self.y,
                               self.w0, lr=self.cfg["lr"], steps=CHECKED,
                               prec=prec, fault=fault)
