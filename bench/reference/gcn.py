"""Plain reference of full-batch GCN training: ``H' = σ(Â·(H·W))`` with
ReLU between layers, the mean negative log-likelihood over every node,
and SGD, ``w ← w − lr·g``.

It works from the raw inputs that the benchmark hands to the program
too: the graph's CSR pattern (unit edge weights), the features, the
labels and the initial weights.  ``Â = D^{-1/2}·A·D^{-1/2}`` is worked
out here again (degrees in float64, D the row counts), and so are the
transposed products of the backward.  Imports nothing of the program.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import precision as P


def normalized(indptr: np.ndarray, indices: np.ndarray, n: int,
               device, prec: str) -> tuple:
    """``(Â, Âᵀ)`` as f32 sparse CSR tensors on ``device``, their values
    rounded to ``prec``."""
    counts = np.diff(indptr).astype(np.int64)
    dinv = 1.0 / np.sqrt(np.maximum(counts, 1).astype(np.float64))
    rows = np.repeat(np.arange(n), counts)
    cols = indices.astype(np.int64)
    vals = torch.as_tensor(dinv[rows] * dinv[cols], dtype=torch.float32)
    vals = P.round_to(vals, prec)

    def csr(r, c, v):
        order = np.lexsort((c, r))
        ptr = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(r, minlength=n), out=ptr[1:])
        return torch.sparse_csr_tensor(
            torch.as_tensor(ptr), torch.as_tensor(c[order]),
            v[torch.as_tensor(order)], (n, n),
            check_invariants=False).to(device)
    return csr(rows, cols, vals), csr(cols, rows, vals)


def loss_fn(a, at, x, y, weights, prec: str, fault: str | None = None):
    h = x
    for i, w in enumerate(weights):
        h = P.spmm(a, at, P.matmul(h, w, prec), prec)
        if i < len(weights) - 1:
            h = torch.relu(h)
    if fault == "half_batch":
        half = h.shape[0] // 2
        return F.cross_entropy(h[:half], y[:half])
    return F.cross_entropy(h, y)


def train(indptr, indices, x, y, weights, *, lr: float, steps: int = 3,
          prec: str = "f32", fault: str | None = None) -> dict:
    """``steps`` SGD steps from ``weights``; the readings the benchmark
    compares: each step's loss, each weight's first gradient and its
    change after the last step (norms, in layer order).  ``fault``
    plants one of the faults a training cell can have
    (``"half_batch"``: the loss over the first half of the nodes)."""
    P.disable_tf32()
    n = x.shape[0]
    a, at = normalized(indptr, indices, n, x.device, prec)
    w0 = [w.detach().float().clone() for w in weights]
    ws = [w.clone().requires_grad_(True) for w in w0]
    losses, grads = [], None
    for step in range(steps):
        for w in ws:
            w.grad = None
        loss = loss_fn(a, at, x, y, ws, prec, fault)
        loss.backward()
        losses.append(float(loss.detach()))
        if step == 0:
            grads = [float(w.grad.norm()) for w in ws]
        with torch.no_grad():
            for w in ws:
                w.sub_(lr * w.grad)
    names = [f"w{i}" for i in range(len(ws))]
    return {"losses": losses,
            "grad_norms": dict(zip(names, grads)),
            "change_norms": {k: float((w.detach() - w_0).norm())
                             for k, w, w_0 in zip(names, ws, w0)}}
