"""Data-movement cost model — Equation 3 of the paper, dtype-aware.

cost(T, bCol, cCol) = (nz(T) + uc(T) + t + |J|) * cCol + idx

  nz(T) : unique nonzeros in the tile from A (and B when sparse; when B is
          dense the tile's full B rows, t*bCol, are charged instead)
  uc(T) : nonzeros with unique columns in the tile (distinct D1/C rows touched
          by the tile's second-op iterations)
  t     : rows of D1 produced by the tile (first-op iterations)
  |J|   : fused second-op iterations (rows of D written)
  idx   : indexing cost for the sparse operand(s) (int32 per nonzero)

A copy of ``repro.core.tilefusion.cost_model``, keeping the reference's
constants for parity, without its TPU VMEM budget.  The unit is
*elements* scaled by dtype bytes so the same model serves f32/bf16/f64.
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

#: The paper's CPU setting, used by benchmarks that mirror it: L1 + L2 +
#: L3 a core on the CascadeLake host of its experiments (~2.4 MB).
DEFAULT_CPU_CACHE_BYTES = int(2.4 * 1024 * 1024)


def hybrid_packed_elements(counts: np.ndarray, cap: int | None) -> int:
    """Value slots a HybridELL pack of rows with nonzero ``counts`` streams:
    padded body (``n_rows * width``) plus ``SPILL_ELEMENTS`` per spilled
    entry.  ``cap=None`` means pad-to-max (no spill)."""
    counts = np.asarray(counts, dtype=np.int64)
    if counts.size == 0:
        return 0
    w_max = max(int(counts.max()), 1)
    w = w_max if cap is None else max(min(int(cap), w_max), 1)
    spill = int(np.maximum(counts - w, 0).sum())
    return int(counts.shape[0]) * w + SPILL_ELEMENTS * spill


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


def tile_cost_bytes(a, i_start, i_end, j_rows, b_col, c_col, b_is_sparse,
                    dtype_bytes: int = 4) -> float:
    """Eq 3's cost of one tile in bytes: ``tile_cost_elements`` at
    ``dtype_bytes`` an element."""
    return tile_cost_elements(a, i_start, i_end, j_rows, b_col, c_col,
                              b_is_sparse) * dtype_bytes


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


#: Fraction of the modeled wavefront-0 streaming time the async halo
#: all-gather can realistically hide under.  wf0 is communication-free by
#: the fusion criterion, but the gather is issued *after* the halo rows'
#: own D1 contributions are computed (the duplicate-compute prologue), so
#: only part of the wf0 window remains to overlap into; 0.5 is the
#: conservative half-window used by the pricing below.
OVERLAP_WINDOW_RATIO = 0.5


def shard_comm_model(n_shards: int, halo_rows: int, n_i: int, c_col: int,
                     dtype_bytes: int = 4, n_j: int | None = None,
                     n_repl: int = 1,
                     combine_rows: int | None = None,
                     n_depth: int = 1,
                     overlap: bool | str = False,
                     wf0_bytes: float = 0.0) -> dict:
    """Communication terms of the sharded dispatch: ``n_shards`` row-block
    shards of the wavefront-0 tile grid × ``n_repl`` column replicas of the
    dense operand (the 1.5D layout; ``n_repl=1`` is the pure-1D partition).

    Wavefront 0 is communication-free (the fusion criterion makes every
    fused row's dependencies tile-local, hence shard-local).  Each column
    replica carries ``c_col / n_repl`` columns of C/D1/D, so every term
    below shrinks with replication — the price is memory, not bytes on the
    wire: the sparse operand and B are stored ``n_repl`` times
    (``choose_mesh_layout`` weighs the two).  Terms:

      ``halo_bytes``       all-gather of just the wavefront-1 halo — the
                           ``halo_rows`` D1 rows the post-barrier wavefront
                           reads: every device receives the (S-1)/S
                           fraction it doesn't own.
      ``combine_bytes``    the *psum* output combine: each shard's rows of
                           D are disjoint but scattered (fused rows follow
                           the pattern, not contiguous blocks), so the
                           psum executors all-reduce the full
                           ``(n_j, c_col)`` partial — the dominant term
                           for small halos.
      ``combine_bytes_reduce_scatter``
                           the row-remapped reduce-scatter combine: D rows
                           are permuted so every shard owns one contiguous
                           block (``combine_rows`` = padded permuted row
                           count, ≈ n_j); partials are owner-disjoint, so
                           each block crosses the wire exactly once when
                           the output is consumed instead of every row
                           reaching every device.
      ``replicate_bytes``  the alternative to the halo exchange —
                           all-gather the full D1 so wavefront 1 needs no
                           index sets (or, equivalently, replicate op-1
                           compute).

    ``combine`` is the model's choice between the two combine strategies
    (fewest bytes wins; ties keep the simpler psum).  ``halo_fraction``
    (halo / full D1) is the exchange-strategy decision variable: a near-1
    fraction says the pattern scatters its wavefront-1 deps so widely that
    replication costs the same bytes and saves the index bookkeeping.

    2.5D (``n_depth > 1``): the wavefront-1 tiles and spill lanes are
    split over ``n_depth`` layers that each gather a 1/n_depth slice of
    the halo in parallel (the staged exchange), so the total halo bytes
    are unchanged but every device moves ``1/n_depth`` of its 1.5D share;
    the partial D blocks are then psum-combined over the depth axis
    (``depth_combine_bytes``).  Overlap (``overlap=True`` or ``"auto"``):
    the halo gather is issued *before* the wf0 body, hiding per-device
    halo bytes up to ``OVERLAP_WINDOW_RATIO`` of the modeled per-device
    wf0 streaming (``wf0_bytes`` total, split over the s·r compute grid);
    bytes beyond the window cost full rate.  The price of overlap is the
    duplicate halo-row compute prologue (``overlap_dup_bytes``);
    ``overlap="auto"`` enables it iff the hidden bytes beat the duplicate
    compute.  ``critical_bytes`` is the per-device effective communication
    on the critical path — the number layout comparisons should rank."""
    s = max(int(n_shards), 1)
    r = max(int(n_repl), 1)
    z = max(int(n_depth), 1)
    remote = (s - 1) / s
    cc_r = c_col / r                     # columns per replica group
    out_rows = float(n_i if n_j is None else n_j)
    perm_rows = out_rows if combine_rows is None else float(combine_rows)
    halo = float(halo_rows) * cc_r * dtype_bytes * remote * s * r
    full = float(n_i) * cc_r * dtype_bytes * remote * s * r
    combine = out_rows * cc_r * dtype_bytes * remote * s * r
    combine_rs = perm_rows * cc_r * dtype_bytes * remote * r
    combine_choice = min(combine, combine_rs)
    # 2.5D terms: per-device halo shrinks 1/z; depth layers psum partials.
    halo_per_dev = halo / (s * r * z)
    depth_combine = perm_rows * cc_r * dtype_bytes * (z - 1) * r
    # Overlap window: per-device wf0 streaming share, discounted to the
    # fraction the post-prologue gather can actually hide under.
    window = (float(wf0_bytes) / (s * r)) * OVERLAP_WINDOW_RATIO
    halo_eff_per_dev = max(halo_per_dev - window, 0.0)
    saving = (halo_per_dev - halo_eff_per_dev) * s * r * z
    # Duplicate-compute prologue: every replica fiber recomputes the halo
    # rows' D1 values ahead of the gather (charged at the value dtype).
    dup = float(halo_rows) * cc_r * dtype_bytes * r
    if isinstance(overlap, str):
        overlap_on = saving > dup
    else:
        overlap_on = bool(overlap)
    if not overlap_on:
        halo_eff_per_dev = halo_per_dev
        saving = 0.0
    halo_eff = halo_eff_per_dev * s * r * z
    critical = (halo_eff_per_dev + combine_choice / (s * r)
                + depth_combine / (s * r * z)
                + (dup / (s * r * z) if overlap_on else 0.0))
    return {
        "n_shards": s,
        "n_repl": r,
        "n_depth": z,
        "halo_rows": int(halo_rows),
        "halo_bytes": halo,
        "halo_bytes_per_device": halo_per_dev,
        "halo_bytes_effective": halo_eff,
        "combine_bytes": combine,
        "combine_bytes_reduce_scatter": combine_rs,
        "combine": "reduce_scatter" if combine_rs < combine else "psum",
        "depth_combine_bytes": depth_combine,
        "replicate_bytes": full,
        "halo_fraction": float(halo_rows) / max(n_i, 1),
        "overlap": overlap_on,
        "overlap_saving_bytes": saving,
        "overlap_dup_bytes": dup if overlap_on else 0.0,
        "critical_bytes": critical,
        "layout": ("2.5d" if z > 1 else ("1d" if r == 1 else "1.5d")),
    }


def choose_mesh_layout(mesh_shape, *, halo_rows: int, n_i: int, n_j: int,
                       c_col: int, operand_bytes: float,
                       dtype_bytes: int = 4,
                       serial_bytes: float = 0.0,
                       overlap: bool | str = False,
                       wf0_bytes: float = 0.0) -> dict:
    """How the sharded dispatch should use a mesh's axes: pure-1D (flatten
    every axis into row-block shards) vs replicated-1.5D (leading axis row
    shards, trailing axes column replicas of the dense operand) vs 2.5D
    (a third depth axis replicating wf0 and splitting the halo exchange),
    vs not sharding at all (``"fallback"``, priced only when the caller
    supplies the serial Eq-3 traffic via ``serial_bytes``).

    The replication ladder of Bharadwaj et al. trades memory for
    communication: with ``n_repl`` column replicas each device stores the
    sparse operand and B ``n_repl`` times over
    (``replication_cost_bytes``) but moves only ``c_col / n_repl`` columns
    of halo and combine traffic; a depth factor ``n_depth`` further splits
    the per-device halo (at the price of full wf0 replication and a depth
    psum).  Candidates are ranked on a *per-device* total: the compute
    share (``serial_bytes`` over the s·r compute grid — depth replicates
    wf0, it does not shrink compute) plus the per-device critical
    communication from ``shard_comm_model`` (overlap-discounted when
    ``overlap`` is on or ``"auto"``) plus the extra operand copies.

    Returns ``{"layout", "n_row", "n_repl", "n_depth", "overlap",
    "candidates"}`` where ``candidates`` maps each layout to its modeled
    cost terms."""
    shape = tuple(int(x) for x in mesh_shape)
    total = 1
    for x in shape:
        total *= x

    def cost(n_row: int, n_repl: int, n_depth: int = 1) -> dict:
        m = shard_comm_model(n_row, halo_rows, n_i, c_col,
                             dtype_bytes=dtype_bytes, n_j=n_j,
                             n_repl=n_repl, n_depth=n_depth,
                             overlap=overlap, wf0_bytes=wf0_bytes)
        comm = (m["halo_bytes_effective"]
                + min(m["combine_bytes"],
                      m["combine_bytes_reduce_scatter"])
                + m["depth_combine_bytes"])
        repl_cost = float(operand_bytes) * (n_repl * n_depth - 1)
        compute = float(serial_bytes) / (n_row * n_repl)
        n_dev = n_row * n_repl * max(n_depth, 1)
        return {"comm_bytes": comm, "replication_cost_bytes": repl_cost,
                "critical_bytes": m["critical_bytes"],
                "compute_bytes_per_device": compute,
                "total_bytes": comm + repl_cost,
                "total_per_device": (compute + m["critical_bytes"]
                                     + repl_cost / n_dev),
                "overlap": m["overlap"],
                "n_row": n_row, "n_repl": n_repl, "n_depth": n_depth}

    candidates = {"1d": cost(total, 1)}
    if len(shape) >= 2 and total > shape[0]:
        candidates["1.5d"] = cost(shape[0], total // shape[0])
    from .scheduler import resolve_mesh_layout
    r25 = resolve_mesh_layout(shape, "2.5d")
    if r25[2] > 1:
        candidates["2.5d"] = cost(*r25)
    if serial_bytes > 0.0:
        candidates["fallback"] = {
            "comm_bytes": 0.0, "replication_cost_bytes": 0.0,
            "critical_bytes": 0.0,
            "compute_bytes_per_device": float(serial_bytes),
            "total_bytes": float(serial_bytes),
            "total_per_device": float(serial_bytes),
            "overlap": False, "n_row": 1, "n_repl": 1, "n_depth": 1}
    # Rank on per-device totals when compute is priced; fall back to the
    # pure-bytes total (the pre-2.5D ranking rule) otherwise.
    rank_key = "total_per_device" if serial_bytes > 0.0 else "total_bytes"
    layout = min(candidates, key=lambda k: candidates[k][rank_key])
    best = candidates[layout]
    return {"layout": layout, "n_row": best["n_row"],
            "n_repl": best["n_repl"], "n_depth": best["n_depth"],
            "overlap": best["overlap"], "candidates": candidates}
