"""Loop-based inspector reference — the pre-vectorization Algorithm 1.

The production inspector (``scheduler.py`` / ``schedule.py`` / the ELL
packers) is O(nnz) vectorized numpy.  This module keeps the original
row-at-a-time implementations, for two jobs:

  * the parity property tests (``tests/test_torch_legacy.py``) assert the
    vectorized scheduler emits *identical* schedules and device arrays on
    random CSR patterns, so the rewrite can never drift semantically;
  * an inspector benchmark can time it as the "before" of the inspector
    speedup (the §4.2.3 amortization argument needs the number).

A copy of ``repro.core.tilefusion.reference``, function for function, over
the port's ``CSR`` / ``HybridELL`` / ``TileELL``, ``Schedule`` / ``Tile``
and ``DeviceSchedule``.  Nothing outside tests/benchmarks should import
this module.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..sparse.formats import CSR, HybridELL, TileELL
from .schedule import DeviceSchedule
from .scheduler import Schedule, Tile


# --------------------------------------------------------------------------
# Eq-3 cost (loop over fused rows)
# --------------------------------------------------------------------------
def tile_cost_elements_ref(a: CSR, i_start: int, i_end: int,
                           j_rows: np.ndarray, b_col: int, c_col: int,
                           b_is_sparse: bool) -> float:
    t = max(i_end - i_start, 0)
    if j_rows.size:
        starts = a.indptr[j_rows]
        ends = a.indptr[j_rows + 1]
        nnz_a = int((ends - starts).sum())
        cols = np.concatenate([a.indices[s:e] for s, e in zip(starts, ends)]) \
            if nnz_a else np.zeros(0, np.int32)
        uc = int(np.unique(cols).shape[0])
    else:
        nnz_a, uc = 0, 0
    if b_is_sparse:
        nz_b = int(a.indptr[min(i_end, a.n_rows)]
                   - a.indptr[min(i_start, a.n_rows)])
        nz = nnz_a + nz_b
        idx = nnz_a + nz_b
    else:
        nz = nnz_a + t * b_col
        idx = nnz_a
    return float((nz + uc + t + j_rows.size) * c_col + idx)


# --------------------------------------------------------------------------
# Algorithm 1 (row-at-a-time dependency test)
# --------------------------------------------------------------------------
def _fused_mask_ref(a: CSR, i_start: int, i_end: int,
                    j_candidates: np.ndarray) -> np.ndarray:
    out = np.zeros(j_candidates.shape[0], dtype=bool)
    for k, j in enumerate(j_candidates):
        lo, hi = int(a.indptr[j]), int(a.indptr[j + 1])
        cols = a.indices[lo:hi]
        out[k] = bool(cols.size == 0 or
                      ((cols >= i_start) & (cols < i_end)).all())
    return out


def _split_tile_ref(a: CSR, tile: Tile, b_col: int, c_col: int,
                    b_is_sparse: bool, cache_size: float,
                    demoted: list) -> List[Tile]:
    cost = tile_cost_elements_ref(a, tile.i_start, tile.i_end, tile.j_rows,
                                  b_col, c_col, b_is_sparse)
    if cost <= cache_size or tile.n_i <= 1:
        if cost > cache_size and tile.n_j > 0 and tile.n_i <= 1:
            keep = tile.j_rows[: max(tile.n_j // 2, 0)]
            demoted.append(tile.j_rows[keep.shape[0]:])
            return [Tile(tile.i_start, tile.i_end, keep)]
        return [tile]
    mid = tile.i_start + tile.n_i // 2
    mask_lo = _fused_mask_ref(a, tile.i_start, mid, tile.j_rows)
    mask_hi = _fused_mask_ref(a, mid, tile.i_end, tile.j_rows)
    j_lo = tile.j_rows[mask_lo]
    j_hi = tile.j_rows[mask_hi & ~mask_lo]
    spanning = tile.j_rows[~(mask_lo | mask_hi)]
    if spanning.size:
        demoted.append(spanning)
    lo = Tile(tile.i_start, mid, j_lo)
    hi = Tile(mid, tile.i_end, j_hi)
    return (_split_tile_ref(a, lo, b_col, c_col, b_is_sparse, cache_size,
                            demoted)
            + _split_tile_ref(a, hi, b_col, c_col, b_is_sparse, cache_size,
                              demoted))


def _split_wf1_tile_ref(a: CSR, j_rows: np.ndarray, b_col: int, c_col: int,
                        b_is_sparse: bool, cache_size: float) -> List[Tile]:
    cost = tile_cost_elements_ref(a, 0, 0, j_rows, b_col, c_col, b_is_sparse)
    if cost <= cache_size or j_rows.size <= 1:
        return [Tile(0, 0, j_rows)]
    mid = j_rows.size // 2
    return (_split_wf1_tile_ref(a, j_rows[:mid], b_col, c_col, b_is_sparse,
                                cache_size)
            + _split_wf1_tile_ref(a, j_rows[mid:], b_col, c_col, b_is_sparse,
                                  cache_size))


def _balance_ref(j_all: np.ndarray, t: int, p: int) -> List[np.ndarray]:
    if j_all.size == 0:
        return []
    n_tiles = max(p, -(-j_all.size // max(t, 1)))
    n_tiles = min(n_tiles, j_all.size)
    return [chunk.astype(np.int32)
            for chunk in np.array_split(np.sort(j_all), n_tiles)]


def _step1_ref(a: CSR, t: int, n_i: int, n_j: int):
    wf0: List[Tile] = []
    unfused: List[np.ndarray] = []
    for i0 in range(0, n_i, t):
        i1 = min(i0 + t, n_i)
        j_cand = np.arange(i0, min(i1, n_j), dtype=np.int32)
        if j_cand.size:
            m = _fused_mask_ref(a, i0, i1, j_cand)
            wf0.append(Tile(i0, i1, j_cand[m]))
            unfused.append(j_cand[~m])
        else:
            wf0.append(Tile(i0, i1, np.zeros(0, np.int32)))
    if n_j > n_i:
        unfused.append(np.arange(n_i, n_j, dtype=np.int32))
    return wf0, unfused


def build_schedule_ref(
    a: CSR,
    b_col: int,
    c_col: int,
    p: int = 8,
    cache_size: float = 600_000.0,
    ct_size: int = 2048,
    b_is_sparse: bool = False,
    uniform_split: bool = False,
) -> Schedule:
    """The original loop-based ``build_schedule`` (see scheduler.py docs)."""
    n_i = a.n_cols
    n_j = a.n_rows

    if -(-n_i // ct_size) >= p:
        t = ct_size
    else:
        t = max(-(-n_i // p), 1)

    if uniform_split:
        while True:
            wf0, unfused = _step1_ref(a, t, n_i, n_j)
            worst = max((tile_cost_elements_ref(a, tl.i_start, tl.i_end,
                                                tl.j_rows, b_col, c_col,
                                                b_is_sparse) for tl in wf0),
                        default=0.0)
            if worst <= cache_size or t <= 64:
                break
            t //= 2
        split_wf0, demoted = wf0, []
    else:
        wf0, unfused = _step1_ref(a, t, n_i, n_j)
        demoted = []
        split_wf0 = []
        for tl in wf0:
            split_wf0.extend(_split_tile_ref(a, tl, b_col, c_col, b_is_sparse,
                                             cache_size, demoted))

    j_wf1 = np.concatenate(unfused + demoted) if (unfused or demoted) \
        else np.zeros(0, np.int32)
    wf1: List[Tile] = []
    for chunk in _balance_ref(j_wf1, t, p):
        wf1.extend(_split_wf1_tile_ref(a, chunk, b_col, c_col, b_is_sparse,
                                       cache_size))

    sched = Schedule(wavefronts=[split_wf0, wf1], n_i=n_i, n_j=n_j, t=t)
    sched.validate()
    return sched


def fused_compute_ratio_ref(a: CSR, ct_size: int = 2048) -> float:
    n = a.n_rows
    fused_nnz = 0
    for i0 in range(0, a.n_cols, ct_size):
        i1 = min(i0 + ct_size, a.n_cols)
        j_cand = np.arange(i0, min(i1, n), dtype=np.int32)
        m = _fused_mask_ref(a, i0, i1, j_cand)
        for j in j_cand[m]:
            fused_nnz += int(a.indptr[j + 1] - a.indptr[j])
    return fused_nnz / max(a.nnz, 1)


# --------------------------------------------------------------------------
# ELL packers (doubly nested loops)
# --------------------------------------------------------------------------
def ell_arrays_ref(a: CSR, j_rows_list, j_max, pad_row, local_start=None):
    n_tiles = len(j_rows_list)
    widths = [
        int((a.indptr[jr + 1] - a.indptr[jr]).max()) if jr.size else 0
        for jr in j_rows_list
    ]
    w = max(widths + [1])
    j_rows = np.full((n_tiles, j_max), pad_row, dtype=np.int32)
    cols = np.zeros((n_tiles, j_max, w), dtype=np.int32)
    vals = np.zeros((n_tiles, j_max, w), dtype=np.float32)
    for v, jr in enumerate(j_rows_list):
        j_rows[v, : jr.size] = jr
        for k, j in enumerate(jr):
            lo, hi = int(a.indptr[j]), int(a.indptr[j + 1])
            c = a.indices[lo:hi]
            if local_start is not None:
                c = c - local_start[v]
            cols[v, k, : c.shape[0]] = c
            vals[v, k, : c.shape[0]] = a.data[lo:hi].astype(np.float32)
    return j_rows, cols, vals


def tile_ell_from_csr_rows_ref(a: CSR, rows: np.ndarray,
                               width: int | None = None) -> TileELL:
    counts = (a.indptr[rows + 1] - a.indptr[rows]).astype(np.int64)
    w = int(counts.max()) if width is None and rows.size else (width or 1)
    w = max(w, 1)
    cols = np.zeros((rows.shape[0], w), dtype=np.int32)
    vals = np.zeros((rows.shape[0], w), dtype=np.float64)
    for k, r in enumerate(rows):
        c, v = a.row(int(r))
        c, v = c[:w], v[:w]
        cols[k, : c.shape[0]] = c
        vals[k, : v.shape[0]] = v
    return TileELL(cols=cols, vals=vals)


def hybrid_ell_from_csr_rows_ref(a: CSR, rows: np.ndarray,
                                 cap: int | None = None) -> HybridELL:
    """Row-at-a-time ``HybridELL.from_csr_rows`` (pins the vectorized
    packer; spill entries appear in row order, tail slots in column order)."""
    from ..sparse.formats import hybrid_width_cap
    rows = np.asarray(rows, dtype=np.int64)
    counts = (a.indptr[rows + 1] - a.indptr[rows]).astype(np.int64)
    if cap is None:
        cap = hybrid_width_cap(counts)
    w_max = int(counts.max()) if rows.size else 1
    w = max(min(int(cap), max(w_max, 1)), 1)
    cols = np.zeros((rows.shape[0], w), dtype=np.int32)
    vals = np.zeros((rows.shape[0], w), dtype=np.float64)
    s_rows, s_cols, s_vals = [], [], []
    for k, r in enumerate(rows):
        c, v = a.row(int(r))
        cols[k, : min(c.shape[0], w)] = c[:w]
        vals[k, : min(v.shape[0], w)] = v[:w]
        for cc, vv in zip(c[w:], v[w:]):
            s_rows.append(k); s_cols.append(int(cc)); s_vals.append(vv)
    return HybridELL(
        cols=cols, vals=vals,
        spill_rows=np.asarray(s_rows, np.int32),
        spill_cols=np.asarray(s_cols, np.int32),
        spill_vals=np.asarray(s_vals, np.float64))


def op1_ell_ref(a1: CSR, dsched: DeviceSchedule):
    t_pad = dsched.t_pad
    n_t = dsched.n_tiles0
    counts = np.diff(a1.indptr)
    w = int(counts.max()) if counts.size else 1
    cols = np.zeros((n_t, t_pad, max(w, 1)), np.int32)
    vals = np.zeros((n_t, t_pad, max(w, 1)), np.float32)
    for v in range(n_t):
        i0, ln = int(dsched.i_starts[v]), int(dsched.i_lens[v])
        for k in range(ln):
            cc, vv = a1.row(i0 + k)
            cols[v, k, : cc.shape[0]] = cc
            vals[v, k, : cc.shape[0]] = vv
    return cols, vals


def to_device_schedule_ref(a: CSR, sched: Schedule) -> DeviceSchedule:
    """``to_device_schedule`` with the loop-based ELL packer."""
    wf0, wf1 = sched.wavefronts
    n_i, n_j = sched.n_i, sched.n_j

    t_pad = max([tl.n_i for tl in wf0] + [1])
    j0_max = max([tl.n_j for tl in wf0] + [1])
    i_starts = np.asarray([tl.i_start for tl in wf0], dtype=np.int32)
    i_lens = np.asarray([tl.n_i for tl in wf0], dtype=np.int32)
    j_rows0, cols0, vals0 = ell_arrays_ref(
        a, [tl.j_rows for tl in wf0], j0_max, pad_row=n_j,
        local_start=i_starts)

    if wf1:
        j1_max = max(tl.n_j for tl in wf1)
        j_rows1, cols1, vals1 = ell_arrays_ref(
            a, [tl.j_rows for tl in wf1], max(j1_max, 1), pad_row=n_j)
    else:
        j_rows1 = np.full((0, 1), n_j, dtype=np.int32)
        cols1 = np.zeros((0, 1, 1), dtype=np.int32)
        vals1 = np.zeros((0, 1, 1), dtype=np.float32)

    return DeviceSchedule(
        n_i=n_i, n_j=n_j, t_pad=int(t_pad),
        i_starts=i_starts, i_lens=i_lens,
        j_rows0=j_rows0, ell_cols0=cols0, ell_vals0=vals0,
        j_rows1=j_rows1, ell_cols1=cols1, ell_vals1=vals1,
    )
