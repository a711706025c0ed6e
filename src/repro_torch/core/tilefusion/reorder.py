"""Bandwidth-reducing row reordering (a copy of
``repro.core.tilefusion.reorder``, numpy on the host).

The tile-fusion criterion (a second-op row fuses iff ALL its dependencies
fall inside one contiguous tile) makes the fused ratio a direct function of
the matrix bandwidth.  The paper takes the matrix ordering as given; a
reverse Cuthill-McKee (RCM) pass before scheduling concentrates each row's
neighbourhood into a contiguous range, raising the fused ratio on graph
matrices (the paper's weak case) at a one-off cost amortized exactly like
the scheduler itself.  ``similarity_order`` is the binary-row-merging
alternative (arXiv 2206.06611): group rows whose column support hits the
same tile-granularity blocks, cheap and rectangular-safe.

Correctness: D = A(BC) with symmetric permutation P is
P·D = (P·A·Pᵀ)((P·B)·C).  Callers normally never apply it by hand:
``FusionSpec(reorder=...)`` makes the permutation a schedule transform
inside ``api.get_schedule`` (Eq-3-priced, baked into the cached entry), and
``api`` permutes the dense operands in and the output back out.
"""
from __future__ import annotations

from collections import deque

import numpy as np

from ..sparse.formats import CSR


def _require_square(a: CSR, who: str) -> None:
    if a.n_rows != a.n_cols:
        raise ValueError(
            f"{who} requires a square matrix (symmetric permutation "
            f"P·A·Pᵀ); got ({a.n_rows}, {a.n_cols}).  For rectangular "
            f"matrices pass explicit row_perm=/col_perm= to permute_csr.")


def rcm_order(a: CSR) -> np.ndarray:
    """Reverse Cuthill-McKee permutation (perm[new] = old).

    Treats column ids as neighbour row ids, so the matrix must be square
    (raises otherwise).  Components are seeded in order of minimum degree;
    the BFS expands each node's unvisited neighbours by ascending degree
    (stable sorts, so the order equals the reference's array for array)."""
    _require_square(a, "rcm_order")
    n = a.n_rows
    deg = np.diff(a.indptr)
    visited = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    for seed in np.argsort(deg, kind="stable"):
        if visited[seed]:
            continue
        queue = deque((int(seed),))
        visited[seed] = True
        while queue:
            u = queue.popleft()
            order[pos] = u
            pos += 1
            nbrs = a.indices[a.indptr[u]:a.indptr[u + 1]]
            nbrs = nbrs[~visited[nbrs]]
            if nbrs.size:
                visited[nbrs] = True
                nbrs = nbrs[np.argsort(deg[nbrs], kind="stable")]
                queue.extend(int(x) for x in nbrs)
    assert pos == n
    return order[::-1].copy()          # the "reverse" in RCM


def similarity_order(a: CSR, block: int = 64) -> np.ndarray:
    """Row ordering by column-support similarity (perm[new] = old).

    Each row gets a bitmask of the ``block``-granularity column blocks it
    touches, and rows are sorted lexicographically by that mask, so rows
    with matching support land adjacent.  O(nnz + n·words) time and an
    ``n × words`` mask; rectangular-safe (it permutes rows only)."""
    n = a.n_rows
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    n_blocks = max(-(-a.n_cols // max(int(block), 1)), 1)
    n_words = -(-n_blocks // 64)
    masks = np.zeros((n, n_words), dtype=np.uint64)
    if a.nnz:
        rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(a.indptr))
        blk = a.indices.astype(np.int64) // max(int(block), 1)
        word, bit = blk // 64, blk % 64
        np.bitwise_or.at(masks, (rows, word),
                         np.uint64(1) << bit.astype(np.uint64))
    # lexsort by mask words (most-significant word last = primary key)
    keys = tuple(masks[:, w] for w in range(n_words))
    return np.lexsort(keys).astype(np.int64)


def permute_csr(a: CSR, perm: np.ndarray | None = None, *,
                row_perm: np.ndarray | None = None,
                col_perm: np.ndarray | None = None) -> CSR:
    """Permute a CSR matrix.

    ``perm=`` is the symmetric form ``A' = P A Pᵀ`` with ``perm[new] =
    old``, square matrices only.  For the general case pass ``row_perm=``
    and/or ``col_perm=`` (each ``perm[new] = old``, sized by its axis)."""
    if perm is not None:
        if row_perm is not None or col_perm is not None:
            raise ValueError("pass either perm= or row_perm=/col_perm=, "
                             "not both")
        _require_square(a, "permute_csr(perm=)")
        row_perm = col_perm = np.asarray(perm, dtype=np.int64)
    if row_perm is None and col_perm is None:
        return a
    rows = np.repeat(np.arange(a.n_rows), np.diff(a.indptr))
    if row_perm is not None:
        row_perm = np.asarray(row_perm, dtype=np.int64)
        if row_perm.shape[0] != a.n_rows:
            raise ValueError(f"row_perm has {row_perm.shape[0]} entries "
                             f"for {a.n_rows} rows")
        inv_r = np.empty_like(row_perm)
        inv_r[row_perm] = np.arange(row_perm.shape[0])
        rows = inv_r[rows]
    cols = a.indices
    if col_perm is not None:
        col_perm = np.asarray(col_perm, dtype=np.int64)
        if col_perm.shape[0] != a.n_cols:
            raise ValueError(f"col_perm has {col_perm.shape[0]} entries "
                             f"for {a.n_cols} columns")
        inv_c = np.empty_like(col_perm)
        inv_c[col_perm] = np.arange(col_perm.shape[0])
        cols = inv_c[cols]
    return CSR.from_coo(a.n_rows, a.n_cols, rows.astype(np.int64),
                        cols.astype(np.int64), a.data.copy())


def permute_rows_cached(a: CSR, perm: np.ndarray) -> CSR:
    """Row-permuted ``P·A``, memoized on ``a`` for its last permutation.

    The SpMM-SpMM dispatch row-permutes its first operand on every call
    with an active reorder, always with the same array (the entry's
    ``reorder_perm``), so a hit is an identity check; another array with
    equal contents hits too, after one comparison.  CSR and the entry's
    permutation are treated as immutable."""
    memo = getattr(a, "_row_perm_memo", None)
    if memo is not None:
        memo_perm, out = memo
        if memo_perm is perm or (memo_perm.shape == perm.shape
                                 and np.array_equal(memo_perm, perm)):
            return out
    out = permute_csr(a, row_perm=perm)
    object.__setattr__(a, "_row_perm_memo", (perm, out))
    return out


def bandwidth(a: CSR) -> int:
    """Largest ``|row - col|`` over the nonzeros (0 for an empty matrix)."""
    rows = np.repeat(np.arange(a.n_rows), np.diff(a.indptr))
    if rows.size == 0:
        return 0
    return int(np.abs(rows - a.indices).max())
