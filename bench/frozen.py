"""Frozen copies of the program's input generators.

The benchmark draws its graphs and token batches with these copies, so a
later change to the program cannot move the inputs it is measured on.
Each function says what it copies; all were copied from commit 7970e53 of
this repository.  The copies keep the random draws of the originals, so
they give the same patterns and tokens; they return the pattern as CSR
arrays (unit edge weights are the caller's) instead of the program's
``CSR`` object.
"""
from __future__ import annotations

import numpy as np


def _pattern(n: int, rows: np.ndarray, cols: np.ndarray) -> tuple:
    """``(indptr, indices)`` int32 of the distinct ``(row, col)`` pairs,
    columns sorted within each row (duplicates merged, as
    ``CSR.from_coo`` merges them)."""
    key = np.unique(rows.astype(np.int64) * n + cols.astype(np.int64))
    indices = (key % n).astype(np.int32)
    counts = np.bincount(key // n, minlength=n)
    indptr = np.zeros(n + 1, np.int32)
    np.cumsum(counts, out=indptr[1:])
    return indptr, indices


def banded_pattern(n: int, bandwidth: int = 8, seed: int = 0) -> tuple:
    """The pattern of ``repro_torch.core.sparse.random.banded_spd`` (the
    paper's group I): each off-diagonal pair within ``bandwidth`` kept with
    probability 0.8, symmetrically, and the whole diagonal."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for off in range(1, bandwidth + 1):
        keep = rng.random(n - off) < 0.8
        idx = np.nonzero(keep)[0]
        rng.standard_normal(idx.shape[0])   # the values' draw, unused here
        rows += [idx, idx + off]
        cols += [idx + off, idx]
    rows.append(np.arange(n))
    cols.append(np.arange(n))
    return _pattern(n, np.concatenate(rows), np.concatenate(cols))


def powerlaw_pattern(n: int, avg_deg: int = 8, alpha: float = 2.1,
                     seed: int = 0) -> tuple:
    """The pattern of ``repro_torch.core.sparse.random.powerlaw_graph``
    (the paper's group II): Chung-Lu endpoints with weights ``i^(-1/(α-1))``,
    ``n·avg_deg/2`` draws, no self pairs, symmetric, then every self-loop."""
    rng = np.random.default_rng(seed)
    w = np.arange(1, n + 1, dtype=np.float64) ** (-1.0 / (alpha - 1.0))
    p = w / w.sum()
    m = n * avg_deg // 2
    src = rng.choice(n, size=m, p=p)
    dst = rng.choice(n, size=m, p=p)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    loops = np.arange(n)
    return _pattern(n, np.concatenate([src, dst, loops]),
                    np.concatenate([dst, src, loops]))


def lm_batch_at(seed: int, step: int, batch: int, seq_len: int,
                vocab_size: int) -> dict:
    """``repro_torch.data.pipeline.SyntheticStream.batch_at`` for the
    ``lm`` kind on one shard: Zipf-like tokens ``min(V·u³, V-1)``, a pure
    function of ``(seed, step)``; ``{"tokens", "labels"}`` int32 ``(batch,
    seq_len)``, the labels the tokens shifted by one."""
    base = np.random.default_rng((seed, step)).integers(0, 2**31 - 1)
    rows = []
    for r in range(batch):
        u = np.random.default_rng((base, r)).random(seq_len + 1)
        rows.append(np.minimum((vocab_size * u ** 3).astype(np.int64),
                               vocab_size - 1))
    arr = np.stack(rows)
    return {"tokens": arr[:, :-1].astype(np.int32),
            "labels": arr[:, 1:].astype(np.int32)}
