"""Data-movement cost model — Equation 3 of the paper, dtype-aware.

cost(T, bCol, cCol) = (nz(T) + uc(T) + t + |J|) * cCol + idx

  nz(T) : unique nonzeros in the tile from A (and B when sparse; when B is
          dense the tile's full B rows, t*bCol, are charged instead)
  uc(T) : nonzeros with unique columns in the tile (distinct D1/C rows touched
          by the tile's second-op iterations)
  t     : rows of D1 produced by the tile (first-op iterations)
  |J|   : fused second-op iterations (rows of D written)
  idx   : indexing cost for the sparse operand(s) (int32 per nonzero)

A copy of ``repro.core.tilefusion.cost_model`` (the parts the
single-device forward and training paths, the reorder transform and the
serving tier's buckets price with), keeping the reference's constants for parity.  The unit
is *elements* scaled by dtype bytes so the same model serves f32/bf16/f64.
"""
from __future__ import annotations

import numpy as np

from ..sparse.formats import CSR, csr_gather_rows

#: Bytes of one sparse index (int32), whatever the operand dtype.
INDEX_BYTES = 4

#: Elements a spilled hybrid-ELL entry streams (row, col, val) vs the 2
#: (col, val) of a body slot — shared by the packer's cap search
#: (``formats.hybrid_width_cap``) and the pricing here.
SPILL_ELEMENTS = 3


def operand_dtype_bytes(*operands, default: int = 4) -> int:
    """Itemsize of the first operand that has a dtype (the dense operand's
    itemsize is what every byte price in the system should scale with —
    bf16 operands move half the bytes of f32, f64 twice).  Non-array
    operands (e.g. a CSR op-1) are skipped; ``default`` covers the
    all-sparse / empty case."""
    for op in operands:
        dt = getattr(op, "dtype", None)
        if dt is not None:
            # torch and numpy dtypes both carry ``itemsize``
            size = getattr(dt, "itemsize", None)
            if size is not None:
                return int(size)
    return int(default)

def _row_counts(a: CSR) -> np.ndarray:
    """Per-row nonzero counts, memoized per CSR instance (immutable, like
    ``row_extents``) — the capped Eq-3 pricing reads them on every tile."""
    rc = getattr(a, "_row_counts", None)
    if rc is None:
        rc = np.diff(a.indptr).astype(np.int64)
        object.__setattr__(a, "_row_counts", rc)
    return rc


def _spill_cumsum(a: CSR, w: int) -> np.ndarray:
    """``cs[i] = Σ_{r<i} max(counts[r] - w, 0)``, memoized per (matrix, w):
    any row range's spill count is one subtraction, so the recursive step-2
    split pays O(1) per tile instead of re-diffing the whole indptr."""
    cache = getattr(a, "_spill_cumsum_cache", None)
    if cache is None:
        cache = {}
        object.__setattr__(a, "_spill_cumsum_cache", cache)
    cs = cache.get(w)
    if cs is None:
        cs = np.concatenate(
            [[0], np.cumsum(np.maximum(_row_counts(a) - w, 0))])
        cache[w] = cs
    return cs


def _capped_body_width(a: CSR, width_cap: int) -> int:
    counts = _row_counts(a)
    w_max = max(int(counts.max()), 1) if counts.size else 1
    return max(min(int(width_cap), w_max), 1)


def _op1_packed_range(a: CSR, lo: int, hi: int, width_cap: int) -> int:
    """Capped-width op-1 charge for rows [lo, hi): body slots at the global
    capped width plus the range's spill entries (3 elements each)."""
    w = _capped_body_width(a, width_cap)
    cs = _spill_cumsum(a, w)
    return (hi - lo) * w + SPILL_ELEMENTS * int(cs[hi] - cs[lo])


def tile_cost_elements(
    a: CSR,
    i_start: int,
    i_end: int,
    j_rows: np.ndarray,
    b_col: int,
    c_col: int,
    b_is_sparse: bool,
    width_cap: int | None = None,
) -> float:
    """Eq 3 in elements (multiply by dtype bytes for a byte budget).

    ``width_cap`` (sparse-B only): price the op-1 operand as the hybrid-ELL
    traffic the executor actually streams — body rows padded to the capped
    width plus 3 elements per spilled entry — instead of the raw nonzero
    count.  ``None`` keeps the paper's idealized nnz charge."""
    t = max(i_end - i_start, 0)
    if j_rows.size:
        # one flat gather of the tile's A entries (no per-row concatenate)
        flat, lens = csr_gather_rows(a, j_rows)
        nnz_a = int(lens.sum())
        uc = int(np.unique(a.indices[flat]).shape[0]) if nnz_a else 0
    else:
        nnz_a, uc = 0, 0
    if b_is_sparse:
        # nonzeros of the B rows in [i_start, i_end) — approximated by the
        # same CSR when B == A (SpMM-SpMM case), else caller passes its own.
        lo, hi = min(i_start, a.n_rows), min(i_end, a.n_rows)
        if width_cap is None:
            nz_b = int(a.indptr[hi] - a.indptr[lo])
        else:
            nz_b = _op1_packed_range(a, lo, hi, width_cap)
        nz = nnz_a + nz_b
        idx = nnz_a + nz_b  # int32 per nonzero
    else:
        nz = nnz_a + t * b_col  # dense B rows charged in full
        idx = nnz_a
    return float((nz + uc + t + j_rows.size) * c_col + idx)


def tile_costs_batch(
    a: CSR,
    i_starts: np.ndarray,
    i_ends: np.ndarray,
    j_rows_list,
    b_col: int,
    c_col: int,
    b_is_sparse: bool,
    width_cap: int | None = None,
) -> np.ndarray:
    """Eq 3 for many tiles in one vectorized pass.

    Element-for-element identical to calling ``tile_cost_elements`` per
    tile, but O(total nnz log nnz) instead of a Python loop: per-tile nnz
    comes from a bincount over tile ids, and per-tile unique-column counts
    from one sort of ``tile_id * n_cols + col`` keys.  The scheduler's
    step-2 loops (uniform halving, split entry, wavefront-1 balance) call
    this once per candidate set instead of once per tile.
    """
    n_t = len(j_rows_list)
    if n_t == 0:
        return np.zeros(0, np.float64)
    i_starts = np.asarray(i_starts, dtype=np.int64)
    i_ends = np.asarray(i_ends, dtype=np.int64)
    t = np.maximum(i_ends - i_starts, 0)
    sizes = np.asarray([jr.size for jr in j_rows_list], dtype=np.int64)
    all_j = np.concatenate(j_rows_list).astype(np.int64)
    nnz_a = np.zeros(n_t, dtype=np.int64)
    uc = np.zeros(n_t, dtype=np.int64)
    if all_j.size:
        tile_of = np.repeat(np.arange(n_t, dtype=np.int64), sizes)
        flat, lens = csr_gather_rows(a, all_j)
        nnz_a = np.bincount(tile_of, weights=lens,
                            minlength=n_t).astype(np.int64)
        if flat.size:
            keys = (np.repeat(tile_of, lens) * np.int64(a.n_cols)
                    + a.indices[flat])
            uniq = np.unique(keys)
            uc = np.bincount(uniq // np.int64(a.n_cols),
                             minlength=n_t).astype(np.int64)
    if b_is_sparse:
        lo = np.minimum(i_starts, a.n_rows)
        hi = np.minimum(i_ends, a.n_rows)
        if width_cap is None:
            nz_b = (a.indptr[hi] - a.indptr[lo]).astype(np.int64)
        else:
            w = _capped_body_width(a, width_cap)
            sp_cum = _spill_cumsum(a, w)
            nz_b = ((hi - lo) * w
                    + SPILL_ELEMENTS * (sp_cum[hi] - sp_cum[lo]))
        nz = nnz_a + nz_b
        idx = nnz_a + nz_b
    else:
        nz = nnz_a + t * b_col
        idx = nnz_a
    return ((nz + uc + t + sizes) * c_col + idx).astype(np.float64)


#: Element-moves one inspected nonzero costs end to end (Algorithm 1 pass
#: + device ELL pack + traffic model), calibrated from inspector_bench on
#: the vectorized pipeline — the amortized side of the bucket price.
INSPECT_ELEMENTS_PER_NNZ = 40.0


def serving_bucket_price(*, n_rows: int, n_pad: int, nnz: int, b_col: int,
                         c_col: int, expected_reuse: float = 8.0,
                         inspect_elements_per_nnz: float =
                         INSPECT_ELEMENTS_PER_NNZ) -> dict:
    """Eq-3-style price of serving a request padded into a shape bucket of
    ``n_pad`` rows vs re-inspecting its exact shape.

    Padding charge (paid on *every* call): the ``n_pad - n_rows`` appended
    empty rows still stream their dense-B rows and D writes —
    ``extra * (b_col + c_col)`` elements of pure overhead per call.
    Inspection charge (amortized): the O(nnz) Algorithm-1 inspection +
    device pack, priced at ``inspect_elements_per_nnz`` element-moves per
    nonzero and paid once per ``expected_reuse`` calls of the bucket's
    resident schedule.  ``bucketed`` says the per-call padding traffic
    undercuts the per-call inspection share; ``break_even_reuse`` is the
    reuse count at which the two sides tie (above it, bucket)."""
    extra = max(int(n_pad) - int(n_rows), 0)
    pad_elements = float(extra) * (float(b_col) + float(c_col))
    inspect_elements = float(max(int(nnz), 1)) * float(
        inspect_elements_per_nnz)
    per_call_inspect = inspect_elements / max(float(expected_reuse), 1.0)
    return {
        "pad_elements_per_call": pad_elements,
        "inspect_elements_per_call": per_call_inspect,
        "bucketed": pad_elements <= per_call_inspect,
        "break_even_reuse": inspect_elements / max(pad_elements, 1.0),
    }


def reorder_gain(base_tm: dict, perm_tm: dict) -> float:
    """Relative Eq-3 fused-traffic saving of a permuted schedule over the
    identity ordering — ``1 - fused_bytes'/fused_bytes``, the quantity
    ``api._priced_reorder`` holds against ``MIN_TRAFFIC_SAVING`` before
    baking a permutation into a cached entry.  Both dicts are
    ``hbm_traffic_model`` outputs.  >= 0 means the reorder helps; a
    degenerate zero-traffic base reports 0 (never apply)."""
    base = float(base_tm["fused_bytes"])
    if base <= 0.0:
        return 0.0
    return 1.0 - float(perm_tm["fused_bytes"]) / base


def spmm_bytes(nnz: int, n_rows: int, n_cols: int, c_col: int,
               dtype_bytes: int = 4) -> float:
    """Bytes one plain SpMM ``(n_rows × n_cols) @ (n_cols × c_col)``
    streams: the dense input and output plus the sparse operand's values
    (at the operand dtype) and indices (int32)."""
    return (float(n_cols + n_rows) * c_col + float(nnz)) * dtype_bytes \
        + float(nnz) * INDEX_BYTES


def train_step_traffic(forward_tm: dict, transpose_tm: dict, *, nnz: int,
                       n_i: int, n_j: int, c_col: int,
                       dtype_bytes: int = 4) -> dict:
    """Per-training-step traffic of the differentiable fused path.

    The backward of ``D = A·(B·C)`` is two sparse-dense products against
    ``Aᵀ``: the fused ``dB = Aᵀ·(Ḋ·Cᵀ)`` — priced by the transpose
    entry's own Eq-3 model, inspected with the swapped (b_col, c_col) —
    plus the plain ``g1 = Aᵀ·Ḋ`` SpMM feeding ``dC = Bᵀ·g1``.
    ``forward_tm`` / ``transpose_tm`` are the two entries'
    ``traffic_model`` dicts."""
    g1 = spmm_bytes(nnz, n_i, n_j, c_col, dtype_bytes)
    fwd = float(forward_tm["fused_bytes"])
    bwd = float(transpose_tm["fused_bytes"]) + g1
    bwd_unfused = float(transpose_tm["unfused_bytes"]) + g1
    return {
        "forward_bytes": fwd,
        "backward_bytes": bwd,
        "backward_unfused_bytes": bwd_unfused,
        "train_step_bytes": fwd + bwd,
        "backward_saving": 1.0 - bwd / max(bwd_unfused, 1.0),
    }
