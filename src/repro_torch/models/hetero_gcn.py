"""Hetero-GCN — RGCN-style relational convolution on the fused stack.

A copy of ``repro.models.hetero_gcn`` as an ``nn.Module``.  One layer
computes, per destination node type ``dt``,

    ``out[dt] = σ( Σ_{r : dst(r) = dt}  Â_r · (X[src(r)] · W_r) )``

— one normalized-adjacency GeMM-SpMM per relation, summed over the
relations that share a destination type.  The whole bundle runs as ONE
``hetero.hetero_fused_matmul`` dispatch (block-diagonal stack, a single
Algorithm-1 inspection, warmed up when the layer is built); the
per-relation outputs come back un-stacked and are summed per type.  The
weights are ``nn.Parameter``s, so autograd flows through the fused
dispatch's backward; a serving caller runs the layer under
``torch.inference_mode()``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..core.tilefusion import api, hetero
from ..core.tilefusion.spec import FusionSpec
from .gcn import normalize_adjacency


@dataclasses.dataclass(frozen=True)
class HeteroGraph:
    """A typed multi-relation graph.

    ``relations`` maps ``(src_type, name, dst_type)`` to the relation's
    adjacency (``(n_dst, n_src)`` CSR); ``node_counts`` gives each node
    type's cardinality.  Relation order is the sorted key order — the
    deterministic stacking order of the fused dispatch."""

    node_counts: dict
    relations: dict

    def __post_init__(self):
        for (src, name, dst), a in self.relations.items():
            if a.n_rows != self.node_counts[dst]:
                raise ValueError(f"adjacency of {(src, name, dst)} has "
                                 f"{a.n_rows} rows; dst type {dst!r} has "
                                 f"{self.node_counts[dst]} nodes")
            if a.n_cols != self.node_counts[src]:
                raise ValueError(f"adjacency of {(src, name, dst)} has "
                                 f"{a.n_cols} cols; src type {src!r} has "
                                 f"{self.node_counts[src]} nodes")

    @property
    def rel_keys(self) -> list:
        return sorted(self.relations)


class HeteroGCNLayer(nn.Module):
    """One relational convolution layer on the fused hetero dispatch.

    ``device=None`` means ``"cuda"``, and building the layer raises when
    there is no card (pass ``device="cpu"`` to run on the CPU).  The
    weight ``W_r`` of relation ``r`` (``(in_dims[src(r)], out_dim)``) is
    drawn Glorot-style, ``randn · sqrt(2 / (fan_in + out_dim))``, from a
    ``torch.Generator`` seeded with ``seed``, in ``rel_keys`` order;
    ``params_from_jax`` loads the JAX reference's weights instead."""

    def __init__(self, graph: HeteroGraph, in_dims: dict, out_dim: int, *,
                 spec: FusionSpec | None = None, backend: str = "auto",
                 activation=torch.relu, device=None, seed: int = 0):
        super().__init__()
        device = torch.device("cuda" if device is None else device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("HeteroGCNLayer runs on the card by default "
                               "and found no CUDA device; pass device='cpu' "
                               "to run on the CPU")
        self.graph = graph
        self.in_dims = dict(in_dims)
        self.out_dim = int(out_dim)
        self.spec = FusionSpec() if spec is None else spec
        self.backend = backend
        self.activation = activation
        # symmetric-normalized adjacencies, fixed stacking order
        self.rel_keys = graph.rel_keys
        self.adjs = {k: normalize_adjacency(graph.relations[k])
                     for k in self.rel_keys}
        gen = torch.Generator().manual_seed(seed)
        weights = []
        for src, _, _ in self.rel_keys:
            fan_in = self.in_dims[src]
            scale = float(np.sqrt(2.0 / (fan_in + self.out_dim)))
            weights.append(nn.Parameter(
                torch.randn(fan_in, self.out_dim, generator=gen) * scale))
        self.weights = nn.ParameterList(weights)
        # warm up the one stacked schedule (and its cache entry) — the
        # hetero analogue of GCN.__init__'s per-layer inspection — priced
        # at the parameters' itemsize, which is the operands' itemsize the
        # dispatch resolves when features and weights share a dtype
        self.stack = hetero.stack_adjacencies(
            [self.adjs[k] for k in self.rel_keys])
        b_col = sum(self.in_dims[k[0]] for k in self.rel_keys)
        warm = self.spec
        if warm.dtype_bytes is None:
            warm = dataclasses.replace(
                warm, dtype_bytes=weights[0].element_size())
        self.entry = api.get_schedule(self.stack.a, b_col=b_col,
                                      c_col=self.out_dim, spec=warm)
        self.to(device)

    def params(self) -> dict:
        """``{relation_key: W_r}``, the module's parameters by relation."""
        return dict(zip(self.rel_keys, self.weights))

    @torch.no_grad()
    def params_from_jax(self, params: dict) -> None:
        """Copy weights from the JAX reference (``repro.models.hetero_gcn
        .HeteroGCNLayer.init_params``), given as ``{relation_key:
        array}``."""
        if sorted(params) != self.rel_keys:
            raise ValueError(f"weights for {sorted(params)}; the layer's "
                             f"relations are {self.rel_keys}")
        for key, w in self.params().items():
            w.copy_(torch.tensor(np.asarray(params[key])))

    def combine(self, outs) -> dict:
        """Per-relation outputs (in ``rel_keys`` order) summed per
        destination type, then the activation."""
        by_dst: dict = {}
        for (_, _, dst), d_r in zip(self.rel_keys, outs):
            by_dst[dst] = d_r if dst not in by_dst else by_dst[dst] + d_r
        if self.activation is not None:
            by_dst = {t: self.activation(v) for t, v in by_dst.items()}
        return by_dst

    def forward(self, feats: dict, *, backend: str | None = None) -> dict:
        """``feats`` maps node type -> ``(n_type, in_dims[type])`` tensor
        on the weights' device; returns per-destination-type activations.
        ``backend`` overrides the layer's own for this call."""
        relations = [(self.adjs[k], feats[k[0]], w)
                     for k, w in zip(self.rel_keys, self.weights)]
        return self.combine(hetero.hetero_fused_matmul(
            relations, backend=self.backend if backend is None else backend,
            spec=self.spec))

    def reference(self, feats: dict) -> dict:
        """The per-relation loop oracle (one ``backend="unfused"`` dispatch
        per relation) that the fused layer must reproduce."""
        return self.combine(
            api.tile_fused_matmul(self.adjs[k], feats[k[0]], w,
                                  backend="unfused", spec=self.spec)
            for k, w in zip(self.rel_keys, self.weights))
