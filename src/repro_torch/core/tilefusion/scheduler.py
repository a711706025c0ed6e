"""Tile-fusion scheduler — Algorithm 1 of the paper.

Builds a two-wavefront schedule of fused tiles from the sparsity pattern of
``A`` in ``D = A(BC)``:

  Step 1 (coarse tile fusion): uniform coarse tiles of ``t`` consecutive
    first-op iterations; a second-op iteration ``j`` is fused into tile ``v``
    iff *all* of its dependencies (nonzero column indices of row ``j`` of
    ``A``) fall inside tile ``v``'s contiguous range.  Unfused iterations go
    to wavefront 1 and are balanced.

  Step 2 (fused tile splitting): tiles whose Eq-3 data-movement cost exceeds
    ``cache_size`` are split recursively (factor 2) until they fit.  A fused
    ``j`` whose dependencies span both halves of a split can no longer run
    synchronization-free in wavefront 0 and is demoted to wavefront 1 (the
    paper's locality constraint takes precedence over its fused ratio).

The schedule is computed once per sparsity pattern (numpy, host side) and
reused across steps — the amortization argument of paper §4.2.3.

A copy of ``repro.core.tilefusion.scheduler``: the inspector, the
mesh partition helpers the sharded dispatch uses, and Figure 1's
``fused_compute_ratio``.  The inspector is O(nnz) vectorized: the fusion
test ``all deps of row j in [i_start, i_end)`` is equivalent to
``row_min[j] >= i_start and row_max[j] < i_end`` where the per-row column
extents come from one ``ufunc.reduceat`` pass (``CSR.row_extents``,
memoized per matrix).  Step 1 classifies every candidate row in one shot
instead of re-scanning CSR rows per tile; step 2's recursive split reuses
the same extents.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

from ..sparse.formats import CSR, csr_gather_rows
from .cost_model import tile_cost_elements, tile_costs_batch


@dataclasses.dataclass
class Tile:
    """One fused tile: first-op rows [i_start, i_end) + fused second-op rows."""

    i_start: int
    i_end: int
    j_rows: np.ndarray  # int32, sorted

    @property
    def n_i(self) -> int:
        return self.i_end - self.i_start

    @property
    def n_j(self) -> int:
        return int(self.j_rows.size)


@dataclasses.dataclass
class Schedule:
    wavefronts: List[List[Tile]]  # exactly two
    n_i: int                      # |I|  (first-op iterations)
    n_j: int                      # |J|  (second-op iterations)
    t: int                        # coarse tile size chosen in step 1

    @property
    def fused_ratio(self) -> float:
        """Equation 2: fused second-op iterations over total iterations."""
        fused = sum(tl.n_j for tl in self.wavefronts[0])
        return fused / max(self.n_i + self.n_j, 1)

    def validate(self) -> None:
        """Structural invariants (used by tests)."""
        assert len(self.wavefronts) == 2
        i_seen = np.zeros(self.n_i, dtype=bool)
        for tl in self.wavefronts[0]:
            assert 0 <= tl.i_start <= tl.i_end <= self.n_i
            assert not i_seen[tl.i_start:tl.i_end].any(), "I ranges overlap"
            i_seen[tl.i_start:tl.i_end] = True
        assert i_seen.all(), "I iterations not fully covered by wavefront 0"
        j_seen = np.zeros(self.n_j, dtype=np.int32)
        for wf in self.wavefronts:
            for tl in wf:
                np.add.at(j_seen, tl.j_rows, 1)
        assert (j_seen == 1).all(), "J iterations not covered exactly once"


def _fused_mask(a: CSR, i_start: int, i_end: int, j_candidates: np.ndarray) -> np.ndarray:
    """True for candidate rows whose every dependency lies in [i_start, i_end).

    O(len(j_candidates)) after the matrix's one-time extents pass; empty
    rows are vacuously fusable (extents sentinel (n_cols, -1))."""
    row_min, row_max = a.row_extents()
    j = np.asarray(j_candidates)
    return (row_min[j] >= i_start) & (row_max[j] < i_end)


def row_extents_for(a: CSR, rows: np.ndarray):
    """Per-row (min, max) column extents for just ``rows``.

    The dirty-row slice of the incremental inspector: O(nnz of the given
    rows) instead of the full-matrix pass of ``CSR.row_extents`` — on a
    request whose pattern differs from the resident one in a few rows,
    this is what keeps the patch sublinear in the matrix.  Empty rows get
    the same ``(n_cols, -1)`` vacuous-containment sentinel."""
    rows = np.asarray(rows, dtype=np.int64)
    flat, lens = csr_gather_rows(a, rows)
    rmin = np.full(rows.shape[0], a.n_cols, dtype=np.int64)
    rmax = np.full(rows.shape[0], -1, dtype=np.int64)
    nonempty = lens > 0
    if nonempty.any():
        cum = np.concatenate([[0], np.cumsum(lens)])
        cols = a.indices[flat].astype(np.int64)
        starts = cum[:-1][nonempty]
        rmin[nonempty] = np.minimum.reduceat(cols, starts)
        rmax[nonempty] = np.maximum.reduceat(cols, starts)
    return rmin, rmax


def _split_tile(a: CSR, tile: Tile, b_col: int, c_col: int, b_is_sparse: bool,
                cache_size: float, demoted: list,
                cost: float | None = None,
                width_cap: int | None = None) -> List[Tile]:
    """Step-2 recursive split (factor 2) until the Eq-3 cost fits cache_size.

    ``cost`` lets the caller pass the tile's already-batched Eq-3 cost so
    the common all-tiles-fit case never re-derives it; recursive children
    compute their own."""
    if cost is None:
        cost = tile_cost_elements(a, tile.i_start, tile.i_end, tile.j_rows,
                                  b_col, c_col, b_is_sparse,
                                  width_cap=width_cap)
    if cost <= cache_size or tile.n_i <= 1:
        if cost > cache_size and tile.n_j > 0 and tile.n_i <= 1:
            # cannot shrink the producer side further; shed consumers instead
            keep = tile.j_rows[: max(tile.n_j // 2, 0)]
            demoted.append(tile.j_rows[keep.shape[0]:])
            return [Tile(tile.i_start, tile.i_end, keep)]
        return [tile]
    mid = tile.i_start + tile.n_i // 2
    mask_lo = _fused_mask(a, tile.i_start, mid, tile.j_rows)
    mask_hi = _fused_mask(a, mid, tile.i_end, tile.j_rows)
    j_lo = tile.j_rows[mask_lo]
    j_hi = tile.j_rows[mask_hi & ~mask_lo]
    spanning = tile.j_rows[~(mask_lo | mask_hi)]
    if spanning.size:
        demoted.append(spanning)
    lo = Tile(tile.i_start, mid, j_lo)
    hi = Tile(mid, tile.i_end, j_hi)
    return (_split_tile(a, lo, b_col, c_col, b_is_sparse, cache_size, demoted,
                        width_cap=width_cap)
            + _split_tile(a, hi, b_col, c_col, b_is_sparse, cache_size,
                          demoted, width_cap=width_cap))


def _split_wf1_tile(a: CSR, j_rows: np.ndarray, b_col: int, c_col: int,
                    b_is_sparse: bool, cache_size: float,
                    cost: float | None = None,
                    width_cap: int | None = None) -> List[Tile]:
    if cost is None:
        cost = tile_cost_elements(a, 0, 0, j_rows, b_col, c_col, b_is_sparse,
                                  width_cap=width_cap)
    if cost <= cache_size or j_rows.size <= 1:
        return [Tile(0, 0, j_rows)]
    mid = j_rows.size // 2
    return (_split_wf1_tile(a, j_rows[:mid], b_col, c_col, b_is_sparse,
                            cache_size, width_cap=width_cap)
            + _split_wf1_tile(a, j_rows[mid:], b_col, c_col, b_is_sparse,
                              cache_size, width_cap=width_cap))


def _balance(j_all: np.ndarray, t: int, p: int) -> List[np.ndarray]:
    """Evenly distribute wavefront-1 iterations (line 15 of Algorithm 1)."""
    if j_all.size == 0:
        return []
    n_tiles = max(p, -(-j_all.size // max(t, 1)))
    n_tiles = min(n_tiles, j_all.size)
    return [chunk.astype(np.int32) for chunk in np.array_split(np.sort(j_all), n_tiles)]


def _step1(a: CSR, t: int, n_i: int, n_j: int):
    """Coarse tile fusion at tile size t (lines 5-14 of Algorithm 1).

    Fully vectorized: every candidate row j < min(n_i, n_j) belongs to
    coarse tile v = j // t, and the fusion test is one extents comparison
    over all candidates at once; rows are then grouped per tile by
    splitting the (already tile-sorted) index vector at tile boundaries.
    """
    tile_lo = np.arange(0, n_i, t, dtype=np.int64)
    tile_hi = np.minimum(tile_lo + t, n_i)
    j_all = np.arange(min(n_i, n_j), dtype=np.int64)
    row_min, row_max = a.row_extents()
    v = j_all // t
    fused = (row_min[j_all] >= tile_lo[v]) & (row_max[j_all] < tile_hi[v])
    f_j = j_all[fused].astype(np.int32)
    u_j = j_all[~fused].astype(np.int32)
    f_parts = np.split(f_j, np.searchsorted(f_j, tile_lo[1:]))
    u_parts = np.split(u_j, np.searchsorted(u_j, tile_lo[1:]))
    wf0 = [Tile(int(lo), int(hi), fp)
           for lo, hi, fp in zip(tile_lo, tile_hi, f_parts)]
    unfused: List[np.ndarray] = [up for up in u_parts if up.size]
    if n_j > n_i:  # second op has more rows than first op produces tiles for
        unfused.append(np.arange(n_i, n_j, dtype=np.int32))
    return wf0, unfused


def build_schedule(
    a: CSR,
    b_col: int,
    c_col: int,
    p: int = 8,
    cache_size: float = 600_000.0,   # elements; see cost_model for byte budgets
    ct_size: int = 2048,
    b_is_sparse: bool = False,
    uniform_split: bool = False,
    width_cap: int | None = None,
) -> Schedule:
    """Algorithm 1.  ``a`` is the sparse matrix of the *second* operation
    (its pattern defines the iteration DAG: row j of op2 depends on D1 rows
    given by its nonzero columns).  For GeMM-SpMM |I| = a.n_cols (rows of
    D1 = BC), for SpMM-SpMM (D = A(AC)) |I| = |J| = n.

    ``uniform_split=True`` is the reference's accelerator adaptation of
    step 2: instead of recursively splitting individual oversized tiles,
    the tile size is halved *globally* until every tile's cost fits — all
    tiles share one size, so the fused code is a single batched matmul with
    zero padding waste (and maps 1:1 onto the kernels' uniform grid).

    ``width_cap`` (sparse-B only) makes the Eq-3 cost price the op-1 operand
    as capped-width hybrid-ELL traffic (padded body + spill lanes) instead of
    raw nonzeros — the width the executors actually stream.  ``None`` keeps
    the paper's idealized charge (and the pre-cap schedules bit-for-bit).
    """
    n_i = a.n_cols
    n_j = a.n_rows

    # ---- Step 1: coarse tile fusion (lines 3-15) ----
    if -(-n_i // ct_size) >= p:
        t = ct_size
    else:
        t = max(-(-n_i // p), 1)

    def _wf0_costs(wf0):
        return tile_costs_batch(a, [tl.i_start for tl in wf0],
                                [tl.i_end for tl in wf0],
                                [tl.j_rows for tl in wf0],
                                b_col, c_col, b_is_sparse,
                                width_cap=width_cap)

    if uniform_split:
        # ---- Step 2 (uniform variant): halve t globally until it fits ----
        while True:
            wf0, unfused = _step1(a, t, n_i, n_j)
            costs = _wf0_costs(wf0)
            worst = float(costs.max()) if costs.size else 0.0
            if worst <= cache_size or t <= 64:
                break
            t //= 2
        split_wf0, demoted = wf0, []
    else:
        wf0, unfused = _step1(a, t, n_i, n_j)
        # ---- Step 2: fused tile splitting (lines 16-23); entry costs are
        # batched so only genuinely oversized tiles pay the recursion ----
        demoted = []
        split_wf0 = []
        for tl, cost in zip(wf0, _wf0_costs(wf0)):
            split_wf0.extend(_split_tile(a, tl, b_col, c_col, b_is_sparse,
                                         cache_size, demoted, cost=cost,
                                         width_cap=width_cap))

    j_wf1 = np.concatenate(unfused + demoted) if (unfused or demoted) \
        else np.zeros(0, np.int32)
    wf1: List[Tile] = []
    chunks = _balance(j_wf1, t, p)
    chunk_costs = tile_costs_batch(a, np.zeros(len(chunks), np.int64),
                                   np.zeros(len(chunks), np.int64),
                                   chunks, b_col, c_col, b_is_sparse,
                                   width_cap=width_cap)
    for chunk, cost in zip(chunks, chunk_costs):
        wf1.extend(_split_wf1_tile(a, chunk, b_col, c_col, b_is_sparse,
                                   cache_size, cost=cost,
                                   width_cap=width_cap))

    sched = Schedule(wavefronts=[split_wf0, wf1], n_i=n_i, n_j=n_j, t=t)
    sched.validate()
    return sched


def balanced_contiguous_partition(costs: np.ndarray,
                                  n_parts: int) -> np.ndarray:
    """Split a tile sequence into ``n_parts`` contiguous groups minimizing
    the max group Eq-3 cost (the shard balance term of the sharded
    dispatch: every shard gets comparable fused-tile work, and contiguity
    preserves the 1-D row-block partition of D1).

    Binary search on the bottleneck cost over the prefix sums; returns
    ``(n_parts + 1,)`` tile-index bounds (trailing groups may be empty when
    there are fewer tiles than parts).
    """
    costs = np.asarray(costs, dtype=np.float64)
    n = costs.shape[0]
    bounds = np.zeros(n_parts + 1, dtype=np.int64)
    if n == 0 or n_parts <= 0:
        return bounds
    prefix = np.concatenate([[0.0], np.cumsum(costs)])

    def cuts_for(bottleneck: float) -> np.ndarray:
        """Greedy left-to-right packing at a given bottleneck; may use
        fewer than n_parts groups (never more than n)."""
        cut = [0]
        while cut[-1] < n:
            # furthest end with group sum <= bottleneck, at least one tile
            end = int(np.searchsorted(prefix, prefix[cut[-1]] + bottleneck,
                                      side="right")) - 1
            cut.append(max(end, cut[-1] + 1))
        return np.asarray(cut, dtype=np.int64)

    lo = float(costs.max())
    hi = float(prefix[-1])
    for _ in range(48):
        mid = 0.5 * (lo + hi)
        if cuts_for(mid).shape[0] - 1 <= n_parts:
            hi = mid
        else:
            lo = mid
    cut = cuts_for(hi)
    k = cut.shape[0] - 1              # groups actually used (<= n_parts)
    bounds[: k + 1] = cut
    bounds[k + 1:] = n                # trailing empty shards
    return bounds


#: Layouts a mesh's axes can be resolved into (plus "auto" upstream).
MESH_LAYOUTS = ("1d", "1.5d", "2.5d")


def resolve_mesh_layout(mesh_shape, layout: str) -> tuple:
    """THE layout rule, defined once: how many row shards × column
    replicas × depth replicas a mesh shape yields under a layout.

    Returns ``(n_row, n_repl, n_depth)``.  ``"1d"`` flattens every mesh
    axis into row-block shards (a 2-D mesh in C order, the order in
    which ``models.sharding.Mesh.grid`` lays its devices out); ``"1.5d"`` partitions tiles
    over the *leading* axis only and leaves the trailing axes as column
    replicas of the dense operand; ``"2.5d"`` keeps axis 0 for row blocks,
    axis 1 for column replicas, and folds the remaining axes into a depth
    dimension that replicates the wavefront-0 compute and splits the
    wavefront-1 halo work (Bharadwaj et al.'s replication ladder).  A mesh
    without enough axes degenerates down the ladder ("2.5d" → the "1.5d"
    resolution → "1d").  Every consumer (the api dispatch, the partitioner
    below, the executor's axis split in ``models/sharding``) derives its
    split from this function so the layers can never disagree."""
    if layout not in MESH_LAYOUTS:
        raise ValueError(f"layout={layout!r}; expected one of "
                         f"{MESH_LAYOUTS}")
    shape = tuple(int(x) for x in np.atleast_1d(mesh_shape))
    total = 1
    for x in shape:
        total *= x
    if layout == "2.5d" and len(shape) >= 3:
        depth = 1
        for x in shape[2:]:
            depth *= x
        if depth > 1 and shape[1] > 1:
            return shape[0], shape[1], depth
        if depth > 1 and shape[1] == 1:
            # nothing to column-replicate; fold depth into the replica slot
            return shape[0], depth, 1
    if layout in ("1.5d", "2.5d") and len(shape) >= 2 and total > shape[0]:
        return shape[0], total // shape[0], 1
    return total, 1, 1


def balanced_mesh_partition(costs: np.ndarray, mesh_shape,
                            layout: str = "1d") -> tuple:
    """Mesh-aware front end of ``balanced_contiguous_partition``: resolve a
    mesh shape + layout into (row-axis tile bounds, n_row, n_repl,
    n_depth).  Tiles are shared within a replica group (and replicated
    across depth), so only the row axis enters the balance."""
    n_row, n_repl, n_depth = resolve_mesh_layout(mesh_shape, layout)
    return balanced_contiguous_partition(costs, n_row), n_row, n_repl, n_depth


def fused_compute_ratio(a: CSR, ct_size: int = 2048) -> float:
    """Figure 1's metric: fraction of second-op *computation* (nonzeros) whose
    dependencies are contained in coarse tiles of size ct_size.

    One vectorized pass: candidate rows j < min(n_cols, n_rows), tile
    range [ (j//ct)·ct, min((j//ct+1)·ct, n_cols) ), extents containment,
    then a masked sum of per-row nonzero counts."""
    row_min, row_max = a.row_extents()
    j = np.arange(min(a.n_cols, a.n_rows), dtype=np.int64)
    i0 = (j // ct_size) * ct_size
    i1 = np.minimum(i0 + ct_size, a.n_cols)
    m = (row_min[j] >= i0) & (row_max[j] < i1)
    counts = (a.indptr[1:] - a.indptr[:-1]).astype(np.int64)
    fused_nnz = int(counts[j[m]].sum())
    return fused_nnz / max(a.nnz, 1)
