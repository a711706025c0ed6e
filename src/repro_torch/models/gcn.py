"""GCN — the paper's native application, on the port's tile fusion.

One GCN layer is ``H' = σ(Â (H W))`` — exactly the paper's GeMM-SpMM with
``A = Â`` (normalized adjacency), ``B = H``, ``C = W``.  Every layer routes
through ``core.tilefusion.api.tile_fused_matmul``: the schedule is inspected
once per (graph, layer shape) when the model is built and served from the
content-keyed cache for every request (paper §4.2.3 amortization).

``forward`` is differentiable in the weights: under grad mode each
layer's backward runs the transposed fused products (``api``'s autograd
Functions) off cached transpose schedules, which ``launch.steps
.make_gcn_train_step`` trains with.  A serving caller runs it under
``torch.inference_mode()``, where no graph is recorded and the layers
dispatch directly.  ``mesh=`` (a ``models.sharding.Mesh``) spreads every
layer, and its backward, over the mesh's devices.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.sparse.formats import CSR
from ..core.tilefusion import api, cost_model
from ..core.tilefusion.spec import FusionSpec


def normalize_adjacency(a: CSR) -> CSR:
    """Â = D^{-1/2} (A) D^{-1/2} (self-loops assumed already present).

    A copy of ``repro.models.gcn.normalize_adjacency``: the degree
    arithmetic runs in float64, and the result keeps ``a.data``'s dtype.
    Square adjacencies use the row degree on both sides; rectangular ones
    scale rows by out-degree and columns by in-degree."""
    deg = np.maximum(np.diff(a.indptr), 1).astype(np.float64)
    dinv = 1.0 / np.sqrt(deg)
    rows = np.repeat(np.arange(a.n_rows), np.diff(a.indptr))
    if a.n_rows == a.n_cols:
        cinv = dinv
    else:
        col_deg = np.maximum(
            np.bincount(a.indices, minlength=a.n_cols), 1).astype(
                np.float64)
        cinv = 1.0 / np.sqrt(col_deg)
    data = (a.data * dinv[rows] * cinv[a.indices]).astype(
        a.data.dtype, copy=False)
    return CSR(a.n_rows, a.n_cols, a.indptr, a.indices, data)


class GCN(nn.Module):
    """Tile-fused GCN on the port's dispatch API.

    ``device=None`` means ``"cuda"``, and building the model raises when
    there is no card: it never drops to the CPU on its own (pass
    ``device="cpu"`` for that).  Weights are ``randn / sqrt(fan_in)`` from
    a ``torch.Generator`` seeded with ``seed``; ``params_from_jax`` loads
    the JAX reference's weights instead.
    """

    def __init__(self, cfg, adj: CSR, *, spec: FusionSpec | None = None,
                 device=None, seed: int = 0):
        super().__init__()
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("GCN runs on the card by default and found no "
                               "CUDA device; pass device='cpu' to run on the "
                               "CPU")
        self.cfg = cfg
        self.adj = normalize_adjacency(adj)
        self.spec = FusionSpec() if spec is None else spec
        self.dims = ([cfg.in_dim] + [cfg.hidden_dim] * (cfg.n_layers - 1)
                     + [cfg.out_dim])
        # inspect every layer shape once per graph; forward() then hits the
        # cache for every layer of every request
        self.entries = [
            api.get_schedule(self.adj, b_col=self.dims[i],
                             c_col=self.dims[i + 1], spec=self.spec)
            for i in range(cfg.n_layers)]
        gen = torch.Generator().manual_seed(seed)
        self.weights = nn.ParameterList(
            nn.Parameter(torch.randn(d_in, d_out, generator=gen)
                         / d_in ** 0.5)
            for d_in, d_out in zip(self.dims[:-1], self.dims[1:]))
        self.to(device)

    @torch.no_grad()
    def params_from_jax(self, params) -> None:
        """Copy weights from the JAX reference (``repro.models.gcn.GCN
        .init_params``), given as a list of arrays."""
        params = list(params)
        if len(params) != len(self.weights):
            raise ValueError(f"{len(params)} weight matrices for "
                             f"{len(self.weights)} layers")
        for w, p in zip(self.weights, params):
            w.copy_(torch.tensor(np.asarray(p)))

    def _spec(self, mesh) -> FusionSpec:
        return (self.spec if mesh is None
                else dataclasses.replace(self.spec, mesh=mesh))

    def layer_entries(self, mesh=None) -> list:
        """Each layer's schedule entry under ``mesh`` (the ones built with
        the model for ``mesh=None``)."""
        if mesh is None:
            return list(self.entries)
        return [api.get_schedule(self.adj, b_col=e.b_col, c_col=e.c_col,
                                 spec=self._spec(mesh)) for e in self.entries]

    def layer_backends(self, device=None, mesh=None) -> list:
        """The ``backend="auto"`` pick of each layer on ``device`` (default:
        where the weights live), under ``mesh``."""
        device = self.weights[0].device if device is None else device
        return [api.select_backend(e, device)
                for e in self.layer_entries(mesh)]

    def train_step_traffic_models(self) -> list:
        """Per-layer forward + backward traffic (``cost_model
        .train_step_traffic``): the transpose entry prices the backward's
        fused product against Âᵀ, the extra SpMM term its ``Âᵀ·Ḋ``."""
        out = []
        for e in self.entries:
            et = api.get_schedule(
                self.adj, b_col=e.c_col, c_col=e.b_col,
                spec=dataclasses.replace(self.spec, transpose=True,
                                         dtype_bytes=e.dtype_bytes))
            out.append(cost_model.train_step_traffic(
                e.traffic_model, et.traffic_model, nnz=self.adj.nnz,
                n_i=self.adj.n_cols, n_j=self.adj.n_rows, c_col=e.c_col,
                dtype_bytes=e.dtype_bytes))
        return out

    def forward(self, x: torch.Tensor, *, backend: str = "auto",
                mesh=None) -> torch.Tensor:
        """Logits for node features ``x`` of shape ``(n_nodes, in_dim)``,
        on the weights' device; ``mesh=`` runs each layer over a mesh
        (``dataclasses.replace(self.spec, mesh=mesh)``)."""
        spec = self._spec(mesh)
        last = len(self.weights) - 1
        for i, w in enumerate(self.weights):
            h = api.tile_fused_matmul(self.adj, x, w, backend=backend,
                                      spec=spec)
            x = torch.relu(h) if i < last else h
        return x

    def loss(self, x: torch.Tensor, labels: torch.Tensor, *,
             backend: str = "auto", mesh=None) -> torch.Tensor:
        """Mean negative log-likelihood of ``labels`` under the softmax of
        the logits, written as the reference's ``GCN.loss`` (log-softmax,
        the label's entry of each row, mean)."""
        logp = F.log_softmax(self(x, backend=backend, mesh=mesh), dim=-1)
        return -torch.take_along_dim(logp, labels[:, None], dim=1).mean()
