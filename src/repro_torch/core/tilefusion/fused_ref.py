"""Schedule-walking numpy oracle.

Executes the fused schedule tile by tile *in schedule order* and asserts the
central correctness invariant: every D1 row read by a fused second-op
iteration was produced earlier in the SAME tile (wavefront 0) or in any
wavefront-0 tile (wavefront 1, after the barrier).  This is the executable
statement of the paper's "no synchronization inside a wavefront" guarantee.

A copy of ``repro.core.tilefusion.fused_ref``, except that the unfused
oracles multiply by the CSR directly (``csr_matmul``) instead of densifying
it, so they also serve graphs of 10^5 nodes and more.
"""
from __future__ import annotations

import numpy as np

from ..sparse.formats import CSR
from .scheduler import Schedule


def run_gemm_spmm(a: CSR, b: np.ndarray, c: np.ndarray, sched: Schedule,
                  check: bool = True) -> np.ndarray:
    """D = A @ (B @ C) executed per the fused schedule."""
    n_i, n_j = sched.n_i, sched.n_j
    c_col = c.shape[1]
    d1 = np.zeros((n_i, c_col), dtype=np.float64)
    d1_ready = np.zeros(n_i, dtype=bool)
    d = np.zeros((n_j, c_col), dtype=np.float64)

    # ---- wavefront 0 ----
    for tl in sched.wavefronts[0]:
        local_ready = np.zeros(n_i, dtype=bool)
        d1[tl.i_start:tl.i_end] = b[tl.i_start:tl.i_end] @ c
        local_ready[tl.i_start:tl.i_end] = True
        for j in tl.j_rows:
            cols, vals = a.row(int(j))
            if check:
                assert local_ready[cols].all(), (
                    f"tile [{tl.i_start},{tl.i_end}) fused row {j} reads D1 "
                    f"rows outside the tile — scheduler bug")
            d[j] = vals @ d1[cols]
        d1_ready[tl.i_start:tl.i_end] = True
    if check:
        assert d1_ready.all(), "wavefront 0 did not produce all of D1"

    # ---- barrier; wavefront 1 ----
    for tl in sched.wavefronts[1]:
        for j in tl.j_rows:
            cols, vals = a.row(int(j))
            d[j] = vals @ d1[cols]
    return d


def run_spmm_spmm(a: CSR, a1: CSR, c: np.ndarray, sched: Schedule,
                  check: bool = True) -> np.ndarray:
    """D = A @ (A1 @ C) executed per the fused schedule (both ops SpMM)."""
    n_i, n_j = sched.n_i, sched.n_j
    c_col = c.shape[1]
    d1 = np.zeros((n_i, c_col), dtype=np.float64)
    d = np.zeros((n_j, c_col), dtype=np.float64)
    d1_ready = np.zeros(n_i, dtype=bool)

    for tl in sched.wavefronts[0]:
        for i in range(tl.i_start, tl.i_end):
            cols, vals = a1.row(i)
            d1[i] = vals @ c[cols]
        for j in tl.j_rows:
            cols, vals = a.row(int(j))
            if check:
                assert ((cols >= tl.i_start) & (cols < tl.i_end)).all(), (
                    f"fused row {j} escapes tile [{tl.i_start},{tl.i_end})")
            d[j] = vals @ d1[cols]
        d1_ready[tl.i_start:tl.i_end] = True
    if check:
        assert d1_ready.all()

    for tl in sched.wavefronts[1]:
        for j in tl.j_rows:
            cols, vals = a.row(int(j))
            d[j] = vals @ d1[cols]
    return d


def csr_matmul(a: CSR, x: np.ndarray, rows_per_chunk: int = 8192
               ) -> np.ndarray:
    """``a @ x`` in float64 without densifying ``a``: one ``reduceat`` over
    each chunk of rows' gathered ``x`` rows (chunks bound the temporary)."""
    x = np.asarray(x, np.float64)
    out = np.zeros((a.n_rows, x.shape[1]), np.float64)
    counts = np.diff(a.indptr)
    for r0 in range(0, a.n_rows, rows_per_chunk):
        r1 = min(r0 + rows_per_chunk, a.n_rows)
        lo, hi = int(a.indptr[r0]), int(a.indptr[r1])
        nonempty = np.nonzero(counts[r0:r1])[0]
        if not nonempty.size:
            continue
        prod = a.data[lo:hi, None] * x[a.indices[lo:hi]]
        starts = a.indptr[r0:r1][nonempty] - lo
        out[r0 + nonempty] = np.add.reduceat(prod, starts, axis=0)
    return out


def unfused_gemm_spmm(a: CSR, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    return csr_matmul(a, np.asarray(b, np.float64) @ np.asarray(c, np.float64))


def unfused_spmm_spmm(a: CSR, a1: CSR, c: np.ndarray) -> np.ndarray:
    return csr_matmul(a, csr_matmul(a1, c))
