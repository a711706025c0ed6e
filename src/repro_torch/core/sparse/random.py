"""Synthetic sparsity generators (a copy of ``repro.core.sparse.random``).

SuiteSparse is not available offline; these generators produce the two matrix
families the paper evaluates (§4.1.2): (I) SPD/stencil-like scientific matrices
(banded, high fused ratio) and (II) graph matrices (power-law degree, lower
fused ratio).  Deterministic given a seed.
"""
from __future__ import annotations

import numpy as np

from .formats import CSR


def banded_spd(n: int, bandwidth: int = 8, seed: int = 0) -> CSR:
    """Banded symmetric positive-definite-like matrix (paper's group I)."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for off in range(1, bandwidth + 1):
        keep = rng.random(n - off) < 0.8
        idx = np.nonzero(keep)[0]
        v = rng.standard_normal(idx.shape[0]) * 0.1
        rows.append(idx); cols.append(idx + off); vals.append(v)
        rows.append(idx + off); cols.append(idx); vals.append(v)
    # strong diagonal for SPD-ness
    rows.append(np.arange(n)); cols.append(np.arange(n))
    vals.append(np.full(n, bandwidth + 1.0))
    return CSR.from_coo(
        n, n,
        np.concatenate(rows).astype(np.int64),
        np.concatenate(cols).astype(np.int64),
        np.concatenate(vals),
    )


def powerlaw_graph(n: int, avg_deg: int = 8, alpha: float = 2.1, seed: int = 0) -> CSR:
    """Power-law (scale-free-ish) adjacency matrix (paper's group II, graphs)."""
    rng = np.random.default_rng(seed)
    # degree-proportional endpoint sampling (Chung-Lu style)
    w = (np.arange(1, n + 1, dtype=np.float64)) ** (-1.0 / (alpha - 1.0))
    p = w / w.sum()
    m = n * avg_deg // 2
    src = rng.choice(n, size=m, p=p)
    dst = rng.choice(n, size=m, p=p)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    rows = np.concatenate([src, dst]).astype(np.int64)
    cols = np.concatenate([dst, src]).astype(np.int64)
    vals = np.ones(rows.shape[0], dtype=np.float64)
    # add self loops (GCN-normalized adjacency has them)
    rows = np.concatenate([rows, np.arange(n, dtype=np.int64)])
    cols = np.concatenate([cols, np.arange(n, dtype=np.int64)])
    vals = np.concatenate([vals, np.ones(n)])
    a = CSR.from_coo(n, n, rows, cols, vals)
    return a


def hub_powerlaw(n: int, avg_deg: int = 8, seed: int = 0) -> CSR:
    """Power-law graph with one row boosted to degree ~n/2 — the single
    max-degree hub that makes pad-to-max ELL width explode (the hybrid
    width-cap stress case shared by benchmarks and regression tests)."""
    base = powerlaw_graph(n, avg_deg, seed=seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(base.indptr))
    hub = int(np.random.default_rng(seed).integers(n))
    hcols = np.arange(0, n, 2, dtype=np.int64)
    return CSR.from_coo(
        n, n,
        np.concatenate([rows, np.full(hcols.shape[0], hub, np.int64)]),
        np.concatenate([base.indices.astype(np.int64), hcols]),
        np.concatenate([base.data, np.ones(hcols.shape[0])]))


def block_diag_noise(n: int, block: int = 256, density: float = 0.3,
                     off_frac: float = 0.05, seed: int = 0) -> CSR:
    """Mostly block-diagonal matrix with a sprinkle of off-block entries.

    High fused-ratio family — models locality-friendly reordered matrices.
    """
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for b0 in range(0, n, block):
        b1 = min(b0 + block, n)
        sz = b1 - b0
        k = int(density * sz * 4)
        rows.append(rng.integers(b0, b1, k))
        cols.append(rng.integers(b0, b1, k))
    k_off = int(off_frac * n * 4)
    rows.append(rng.integers(0, n, k_off))
    cols.append(rng.integers(0, n, k_off))
    rows = np.concatenate(rows).astype(np.int64)
    cols = np.concatenate(cols).astype(np.int64)
    vals = rng.standard_normal(rows.shape[0])
    rows = np.concatenate([rows, np.arange(n, dtype=np.int64)])
    cols = np.concatenate([cols, np.arange(n, dtype=np.int64)])
    vals = np.concatenate([vals, np.ones(n)])
    return CSR.from_coo(n, n, rows, cols, vals)


def induced_subgraph(base: CSR, start: int, n_sub: int) -> CSR:
    """Contiguous induced subgraph: rows/columns ``[start, start+n_sub)``
    of ``base``, relabeled to ``[0, n_sub)``.

    The neighbor-sampled minibatch stand-in for serving streams: a
    sampler relabels the sampled node set contiguously, so the served
    adjacency is exactly an induced submatrix of the (reordered) graph.
    Deterministic — perturbation comes from ``perturb_rows``."""
    stop = min(start + n_sub, base.n_rows)
    lo, hi = int(base.indptr[start]), int(base.indptr[stop])
    cols = base.indices[lo:hi].astype(np.int64)
    vals = base.data[lo:hi]
    rows = np.repeat(np.arange(start, stop, dtype=np.int64),
                     np.diff(base.indptr[start:stop + 1]))
    keep = (cols >= start) & (cols < stop)
    return CSR.from_coo(stop - start, stop - start, rows[keep] - start,
                        cols[keep] - start, vals[keep])


def perturb_rows(a: CSR, rows: np.ndarray, seed: int = 0) -> CSR:
    """Re-sample the neighbor sets of ``rows`` (degree preserved, fresh
    uniform targets and values) — the "same subgraph, a few re-sampled
    nodes" delta between consecutive requests of a serving stream."""
    rng = np.random.default_rng(seed)
    rows = np.unique(np.asarray(rows, dtype=np.int64))
    counts = np.diff(a.indptr).astype(np.int64)
    all_rows = np.repeat(np.arange(a.n_rows, dtype=np.int64), counts)
    dirty = np.zeros(a.n_rows, dtype=bool)
    dirty[rows] = True
    keep = ~dirty[all_rows]
    new_r = np.repeat(rows, counts[rows])
    new_c = rng.integers(0, a.n_cols, new_r.shape[0]).astype(np.int64)
    new_v = rng.uniform(0.5, 1.5, new_r.shape[0])
    return CSR.from_coo(
        a.n_rows, a.n_cols,
        np.concatenate([all_rows[keep], new_r]),
        np.concatenate([a.indices[keep].astype(np.int64), new_c]),
        np.concatenate([a.data[keep].astype(np.float64), new_v]))


SUITES = {
    "banded_spd": banded_spd,
    "powerlaw_graph": powerlaw_graph,
    "hub_powerlaw": hub_powerlaw,
    "block_diag_noise": block_diag_noise,
}


def benchmark_suite(n: int = 4096, seed: int = 0):
    """The benchmark matrix set: name -> CSR, spanning both paper groups."""
    return {
        "banded_spd_b4": banded_spd(n, bandwidth=4, seed=seed),
        "banded_spd_b16": banded_spd(n, bandwidth=16, seed=seed + 1),
        "powerlaw_d4": powerlaw_graph(n, avg_deg=4, seed=seed + 2),
        "powerlaw_d16": powerlaw_graph(n, avg_deg=16, seed=seed + 3),
        "blockdiag": block_diag_noise(n, block=512, seed=seed + 4),
    }
