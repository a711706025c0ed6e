"""Sparse matrix containers of the PyTorch port (numpy on the host).

A copy of ``repro.core.sparse.formats``: CSR is the scheduler-side format,
and the kernel-side formats are static-shape padded ELL layouts that the
CUDA kernels and the plain PyTorch executors consume.  Conversion happens
once per sparsity pattern, amortized exactly like the paper's scheduler
(§4.2.3).  ``to_torch`` moves a container's arrays onto a device.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CSR:
    """Host-side CSR matrix (numpy)."""

    n_rows: int
    n_cols: int
    indptr: np.ndarray   # int32 (n_rows+1,)
    indices: np.ndarray  # int32 (nnz,)
    data: np.ndarray     # float (nnz,)

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def row_extents(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-row (min, max) column index, O(nnz) via ``ufunc.reduceat``.

        Empty rows get ``(n_cols, -1)`` so the Algorithm-1 containment test
        ``row_min >= i_start and row_max < i_end`` is vacuously true for
        them.  Memoized per instance (CSR is treated as immutable): the
        scheduler's step 1, step 2, and the autotune sweep all share one
        pass over the indices.
        """
        ext = getattr(self, "_row_extents", None)
        if ext is None:
            counts = np.diff(self.indptr)
            row_min = np.full(self.n_rows, self.n_cols, dtype=np.int64)
            row_max = np.full(self.n_rows, -1, dtype=np.int64)
            nonempty = counts > 0
            if nonempty.any():
                starts = self.indptr[:-1][nonempty]
                row_min[nonempty] = np.minimum.reduceat(self.indices, starts)
                row_max[nonempty] = np.maximum.reduceat(self.indices, starts)
            ext = (row_min, row_max)
            object.__setattr__(self, "_row_extents", ext)
        return ext

    def row(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        lo, hi = int(self.indptr[i]), int(self.indptr[i + 1])
        return self.indices[lo:hi], self.data[lo:hi]

    def to_dense(self) -> np.ndarray:
        out = np.zeros((self.n_rows, self.n_cols), dtype=self.data.dtype)
        for i in range(self.n_rows):
            cols, vals = self.row(i)
            out[i, cols] += vals
        return out

    @staticmethod
    def from_dense(a: np.ndarray) -> "CSR":
        n_rows, n_cols = a.shape
        indptr = [0]
        indices = []
        data = []
        for i in range(n_rows):
            (cols,) = np.nonzero(a[i])
            indices.append(cols.astype(np.int32))
            data.append(a[i, cols])
            indptr.append(indptr[-1] + cols.shape[0])
        return CSR(
            n_rows=n_rows,
            n_cols=n_cols,
            indptr=np.asarray(indptr, dtype=np.int32),
            indices=np.concatenate(indices) if indices else np.zeros(0, np.int32),
            # preserve the source dtype even when every row is empty — a
            # hardcoded float64 here flows into operand_dtype_bytes and
            # misprices Eq-3 for f32/bf16 zero-nnz patterns
            data=np.concatenate(data) if data else np.zeros(0, a.dtype),
        )

    def transpose(self) -> "CSR":
        """``Aᵀ`` via the COO round-trip, memoized per instance (CSR is
        treated as immutable) with the back-pointer set so ``Aᵀᵀ is A``.

        This is what the differentiable fused path runs its backward
        against (the ``mm(sparse.t(), grad)`` structure of sparse autograd
        rules): the transpose is materialized once per matrix and every
        transpose-schedule inspection and ELL pack hangs off this one
        cached instance."""
        t = getattr(self, "_transpose", None)
        if t is None:
            rows = np.repeat(np.arange(self.n_rows, dtype=np.int32),
                             np.diff(self.indptr))
            t = CSR.from_coo(self.n_cols, self.n_rows,
                             self.indices.astype(np.int32), rows, self.data)
            object.__setattr__(self, "_transpose", t)
            object.__setattr__(t, "_transpose", self)
        return t

    @staticmethod
    def from_coo(n_rows: int, n_cols: int, rows: np.ndarray, cols: np.ndarray,
                 vals: np.ndarray, *, dtype=None) -> "CSR":
        # coerce up front so list inputs and zero-nnz patterns keep a real,
        # caller-controlled value dtype (pass dtype= for an empty build)
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        vals = np.asarray(vals, dtype=dtype)
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        # merge duplicates
        key = rows.astype(np.int64) * n_cols + cols
        uniq, inv = np.unique(key, return_inverse=True)
        merged = np.zeros(uniq.shape[0], dtype=vals.dtype)
        np.add.at(merged, inv, vals)
        urows = (uniq // n_cols).astype(np.int32)
        ucols = (uniq % n_cols).astype(np.int32)
        indptr = np.zeros(n_rows + 1, dtype=np.int32)
        np.add.at(indptr, urows + 1, 1)
        indptr = np.cumsum(indptr).astype(np.int32)
        return CSR(n_rows, n_cols, indptr, ucols, merged)

    def to_torch(self, device, dtype: torch.dtype = torch.float32
                 ) -> torch.Tensor:
        """This matrix as a ``torch.sparse_csr_tensor`` on ``device``."""
        return torch.sparse_csr_tensor(
            torch.as_tensor(self.indptr, dtype=torch.int64),
            torch.as_tensor(self.indices, dtype=torch.int64),
            torch.as_tensor(self.data).to(dtype),
            (self.n_rows, self.n_cols), device=device, check_invariants=True)


def csr_content_digest(a: CSR) -> bytes:
    """Content hash of a CSR matrix (shape + pattern + values), memoized
    per instance (CSR is treated as immutable).  Keys every content-
    addressed cache in the system: the schedule/ELL caches and the per-
    schedule op-1 pack memo."""
    digest = getattr(a, "_content_digest", None)
    if digest is None:
        h = hashlib.blake2b(digest_size=16)
        h.update(np.asarray([a.n_rows, a.n_cols], np.int64).tobytes())
        h.update(np.ascontiguousarray(a.indptr, np.int32).tobytes())
        h.update(np.ascontiguousarray(a.indices, np.int32).tobytes())
        # tag the source dtype: the value bytes below are canonicalized to
        # f64, so without this, identical patterns held at f32 vs bf16
        # would collide — and dtype_bytes-priced entries would alias
        h.update(str(a.data.dtype).encode())
        h.update(np.ascontiguousarray(a.data, np.float64).tobytes())
        digest = h.digest()
        object.__setattr__(a, "_content_digest", digest)
    return digest


def csr_gather_rows(a: CSR, rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized multi-row gather: flat positions of ``rows``' entries.

    Returns ``(flat, lens)`` where ``a.indices[flat]`` / ``a.data[flat]``
    are the selected rows' entries concatenated in row order and ``lens[k]``
    is row ``rows[k]``'s nonzero count.  This is the O(nnz) backbone shared
    by every ELL packer and the Eq-3 cost model — no Python per-row loop.
    """
    rows = np.asarray(rows, dtype=np.int64)
    starts = a.indptr[rows].astype(np.int64)
    ends = a.indptr[rows + 1].astype(np.int64)
    lens = ends - starts
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, np.int64), lens
    # entry p of the concatenation lands at starts[k] + (p - cum[k-1])
    # = p + (ends[k] - cum[k]) for its row k — one arange + one repeat.
    cum = np.cumsum(lens)
    flat = np.arange(total, dtype=np.int64) + np.repeat(ends - cum, lens)
    return flat, lens


def ell_slot_coords(lens: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(row, slot) coordinates for ragged rows of sizes ``lens`` flattened.

    ``row[p]`` is the ragged-row id of flat entry ``p`` and ``slot[p]`` its
    position within that row — exactly the scatter targets of an ELL pack.
    """
    lens = np.asarray(lens, dtype=np.int64)
    total = int(lens.sum())
    row = np.repeat(np.arange(lens.shape[0], dtype=np.int64), lens)
    cum = np.cumsum(lens)
    slot = np.arange(total, dtype=np.int64) - np.repeat(cum - lens, lens)
    return row, slot


#: Degree quantile used when a HybridELL cap is requested by quantile rather
#: than by the traffic-optimal search — the autotune width-cap sweep tries
#: this alongside the optimal cap and pad-to-max.
DEFAULT_WIDTH_QUANTILE = 0.99


def hybrid_width_cap(counts: np.ndarray, quantile: float | None = None) -> int:
    """Width cap for a hybrid ELL body over rows of nonzero counts ``counts``.

    ``quantile=None`` (default) returns the *traffic-optimal* cap: the width
    ``w`` minimizing ``2 * n_rows * w + 3 * spill(w)`` where ``spill(w)`` is
    the number of entries past slot ``w`` — a body slot streams (col, val),
    a spilled entry (row, col, val), the same 2-vs-3 weighting the Eq-3
    packed-traffic pricing uses.  A quantile in (0, 1] caps at that degree
    quantile instead (1.0 degenerates to pad-to-max).  Always >= 1.
    """
    counts = np.asarray(counts, dtype=np.int64)
    if counts.size == 0:
        return 1
    if quantile is not None:
        return max(int(np.quantile(counts, quantile)), 1)
    n = counts.shape[0]
    cands = np.unique(np.concatenate([[1], np.unique(counts)]))
    cands = cands[cands >= 1]
    # spill(w) = sum(max(counts - w, 0)) for every candidate, vectorized via
    # a sort + suffix sums: rows with count > w each contribute (count - w)
    srt = np.sort(counts)
    suffix = np.concatenate([np.cumsum(srt[::-1])[::-1], [0]])
    pos = np.searchsorted(srt, cands, side="right")
    spill = suffix[pos] - (n - pos) * cands
    cost = 2 * n * cands + 3 * spill
    return int(cands[np.argmin(cost)])


@dataclasses.dataclass(frozen=True)
class HybridELL:
    """Width-capped ELL body + COO spill lanes — the hub-safe row format.

    Pad-to-max ELL packs every row to the *maximum* degree, so one hub row
    of a power-law graph inflates the whole allocation (``n_rows × max_deg``,
    GB-scale at GNN sizes).  HybridELL bounds the body width at a cap (a
    degree quantile or the traffic-optimal split, see ``hybrid_width_cap``):

      * **body** — ``cols``/``vals`` of shape ``(n_rows, width)``: each row's
        first ``width`` entries, padded with col=0/val=0 (padded slots
        contribute nothing to an SpMM).
      * **spill lanes** — the tail entries of rows wider than the cap, as
        flat COO triples ``(spill_rows, spill_cols, spill_vals)`` sorted by
        row.  ``spill_rows[k]`` indexes the *packed row set* (position in
        the ``rows`` argument of ``from_csr_rows``), so consumers apply the
        spill with one scatter-add after the dense ELL body pass.

    Total storage is ``n_rows * width + n_spill`` value slots, bounded by
    the typical-degree mass instead of the max degree — the SpArch-style
    condensed representation this repo's power-law workloads need.
    """

    cols: np.ndarray        # int32 (n_rows, width) body, pad col 0 / val 0
    vals: np.ndarray        # float (n_rows, width)
    spill_rows: np.ndarray  # int32 (n_spill,) packed-row index of the entry
    spill_cols: np.ndarray  # int32 (n_spill,)
    spill_vals: np.ndarray  # float (n_spill,)

    @property
    def width(self) -> int:
        return int(self.cols.shape[1])

    @property
    def n_spill(self) -> int:
        return int(self.spill_rows.shape[0])

    def packed_elements(self) -> int:
        """Value slots the format stores (body incl. padding + spill)."""
        return int(self.cols.size + self.spill_rows.size)

    @staticmethod
    def from_csr_rows(a: CSR, rows: np.ndarray,
                      cap: int | None = None) -> "HybridELL":
        """Pack ``rows`` of ``a`` with body width ``min(cap, max_deg)``.

        ``cap=None`` derives the traffic-optimal cap from the rows' own
        degree distribution.  O(nnz) — same flat scatter as ``TileELL`` with
        one extra mask splitting body slots from spill entries."""
        rows = np.asarray(rows, dtype=np.int64)
        flat, lens = csr_gather_rows(a, rows)
        if cap is None:
            cap = hybrid_width_cap(lens)
        w_max = int(lens.max()) if rows.size else 1
        w = max(min(int(cap), max(w_max, 1)), 1)
        cols = np.zeros((rows.shape[0], w), dtype=np.int32)
        vals = np.zeros((rows.shape[0], w), dtype=np.float64)
        if not flat.size:
            return HybridELL(cols, vals, np.zeros(0, np.int32),
                             np.zeros(0, np.int32), np.zeros(0, np.float64))
        r, k = ell_slot_coords(lens)
        body = k < w
        cols[r[body], k[body]] = a.indices[flat[body]]
        vals[r[body], k[body]] = a.data[flat[body]]
        sp = ~body
        return HybridELL(
            cols=cols, vals=vals,
            spill_rows=r[sp].astype(np.int32),
            spill_cols=a.indices[flat[sp]].astype(np.int32),
            spill_vals=a.data[flat[sp]].astype(np.float64))

    def to_torch(self, device, dtype: torch.dtype = torch.float32) -> tuple:
        """``(cols, vals, spill_rows, spill_cols, spill_vals)`` on ``device``:
        body columns int32 (the ELL kernel's index type), spill indices
        int64 (what ``index_add_`` and indexing take), values in ``dtype``.
        Values go through f32 first, as the reference casts them."""
        def vals(v):
            return torch.as_tensor(np.asarray(v, np.float32)).to(device, dtype)

        def idx(i, dt):
            return torch.as_tensor(np.asarray(i)).to(device, dt)
        return (idx(self.cols, torch.int32), vals(self.vals),
                idx(self.spill_rows, torch.int64),
                idx(self.spill_cols, torch.int64), vals(self.spill_vals))


def block_csr_pattern(a: CSR, block: int) -> CSR:
    """Collapse a CSR matrix to its block-level sparsity pattern.

    Returns a CSR over the ``(ceil(n / block) x ceil(m / block))`` block
    grid where ``data[k]`` is the number of scalar nonzeros inside block
    ``k``: the DAG a scheduler at block granularity runs on."""
    nb_rows = -(-a.n_rows // block)
    nb_cols = -(-a.n_cols // block)
    rows = np.repeat(np.arange(a.n_rows, dtype=np.int64), np.diff(a.indptr))
    brows = (rows // block).astype(np.int64)
    bcols = (a.indices.astype(np.int64) // block)
    key = brows * nb_cols + bcols
    uniq, counts = np.unique(key, return_counts=True)
    urows = (uniq // nb_cols).astype(np.int32)
    ucols = (uniq % nb_cols).astype(np.int32)
    indptr = np.zeros(nb_rows + 1, dtype=np.int32)
    np.add.at(indptr, urows + 1, 1)
    indptr = np.cumsum(indptr).astype(np.int32)
    return CSR(nb_rows, nb_cols, indptr, ucols, counts.astype(np.float64))


def block_diag_csr(mats, *, row_sizes=None, col_sizes=None) -> CSR:
    """Stack CSR matrices block-diagonally into one CSR.

    Block ``r`` occupies rows ``[sum(row_sizes[:r]), ...)`` and columns
    ``[sum(col_sizes[:r]), ...)``; size overrides larger than a block's own
    shape pad it with empty rows / never-referenced columns (the hetero
    fusion path passes a square pitch per relation so row and column
    offsets coincide and the stack stays square).  O(total nnz), one
    concatenation per array — no COO round-trip.
    """
    mats = list(mats)
    if not mats:
        raise ValueError("block_diag_csr needs at least one matrix")
    row_sizes = ([m.n_rows for m in mats] if row_sizes is None
                 else [int(s) for s in row_sizes])
    col_sizes = ([m.n_cols for m in mats] if col_sizes is None
                 else [int(s) for s in col_sizes])
    if len(row_sizes) != len(mats) or len(col_sizes) != len(mats):
        raise ValueError("row_sizes/col_sizes must match the matrix count")
    n_rows, n_cols = sum(row_sizes), sum(col_sizes)
    indptr = np.zeros(n_rows + 1, dtype=np.int64)
    idx_parts, data_parts = [], []
    row_off = col_off = nnz = 0
    for m, rs, cs in zip(mats, row_sizes, col_sizes):
        if rs < m.n_rows or cs < m.n_cols:
            raise ValueError(f"block size ({rs}, {cs}) smaller than matrix "
                             f"({m.n_rows}, {m.n_cols})")
        indptr[row_off + 1:row_off + m.n_rows + 1] = nnz + m.indptr[1:]
        indptr[row_off + m.n_rows + 1:row_off + rs + 1] = nnz + m.indptr[-1]
        idx_parts.append(m.indices.astype(np.int64) + col_off)
        data_parts.append(m.data)
        nnz += m.nnz
        row_off += rs
        col_off += cs
    return CSR(n_rows, n_cols, indptr.astype(np.int32),
               np.concatenate(idx_parts).astype(np.int32),
               np.concatenate(data_parts))


@dataclasses.dataclass(frozen=True)
class TileELL:
    """Padded ELL layout for a set of CSR rows, one static shape.

    Each of n_rows has up to `width` (col, val) slots; padding uses col=0,
    val=0 so padded slots contribute nothing.
    """

    cols: np.ndarray  # int32 (n_rows, width)
    vals: np.ndarray  # float (n_rows, width)

    @staticmethod
    def from_csr_rows(a: CSR, rows: np.ndarray, width: int | None = None) -> "TileELL":
        rows = np.asarray(rows)
        counts = (a.indptr[rows + 1] - a.indptr[rows]).astype(np.int64)
        w = int(counts.max()) if width is None and rows.size else (width or 1)
        w = max(w, 1)
        cols = np.zeros((rows.shape[0], w), dtype=np.int32)
        vals = np.zeros((rows.shape[0], w), dtype=np.float64)
        flat, lens = csr_gather_rows(a, rows)
        if flat.size:
            r, k = ell_slot_coords(lens)
            keep = k < w                       # explicit width may truncate
            r, k, flat = r[keep], k[keep], flat[keep]
            cols[r, k] = a.indices[flat]
            vals[r, k] = a.data[flat]
        return TileELL(cols=cols, vals=vals)
