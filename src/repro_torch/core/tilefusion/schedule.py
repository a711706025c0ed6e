"""Device-side (static-shape) representation of a fused schedule.

A copy of ``repro.core.tilefusion.schedule``.  The kernels take fixed-shape
blocks, so the host-side ragged ``Schedule`` is padded once per sparsity
pattern:

  wavefront 0: ``T0`` tiles, each with a contiguous first-op row range
    (padded to ``t_pad`` rows) and up to ``j0_max`` fused second-op rows whose
    A-rows are stored in *tile-local* ELL (column index relative to the tile's
    ``i_start`` — by the fusion criterion every dependency is in-tile).
  wavefront 1: ``T1`` tiles of second-op rows in *global* ELL over D1.

Padding conventions: padded fused-row slots use row index ``n_j`` (the
executors scatter into an ``n_j + 1``-row buffer and drop the last row);
padded ELL slots use col 0 / val 0.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..sparse.formats import CSR, csr_gather_rows, ell_slot_coords
from .scheduler import Schedule


@dataclasses.dataclass(frozen=True)
class DeviceSchedule:
    n_i: int
    n_j: int
    t_pad: int
    # wavefront 0
    i_starts: np.ndarray      # (T0,) int32
    i_lens: np.ndarray        # (T0,) int32
    j_rows0: np.ndarray       # (T0, j0_max) int32, pad = n_j
    ell_cols0: np.ndarray     # (T0, j0_max, w0) int32, tile-LOCAL, pad 0
    ell_vals0: np.ndarray     # (T0, j0_max, w0) f32, pad 0
    # wavefront 1 (hybrid: body ELL capped at width_cap + COO spill lanes)
    j_rows1: np.ndarray       # (T1, j1_max) int32, pad = n_j
    ell_cols1: np.ndarray     # (T1, j1_max, w1) int32, GLOBAL, pad 0
    ell_vals1: np.ndarray     # (T1, j1_max, w1) f32, pad 0
    #: Hub-row tails past ``width_cap``, as flat COO over (D row, D1 row):
    #: executors apply them with one scatter-add after the wf1 body pass.
    #: Empty when ``width_cap`` is None (pad-to-max packing, pre-cap layout).
    spill_rows1: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32))   # global D row
    spill_cols1: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32))   # global D1 row
    spill_vals1: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.float32))
    width_cap: int | None = None

    @property
    def n_tiles0(self) -> int:
        return int(self.i_starts.shape[0])

    @property
    def n_tiles1(self) -> int:
        return int(self.j_rows1.shape[0])

    def padded_flops_overhead(self, b_col: int, c_col: int) -> float:
        """Ratio of padded to useful wavefront-0 product FLOPs (the
        autotune sweep scales its Eq-3 score by it)."""
        useful = float(self.i_lens.sum()) * b_col * c_col
        padded = float(self.n_tiles0 * self.t_pad) * b_col * c_col
        return padded / max(useful, 1.0)

    def wf1_dep_rows(self) -> np.ndarray:
        """Sorted distinct D1 rows the post-barrier wavefront reads (body +
        spill).  This is the *halo* of the schedule: under a sharded
        partition these are the only rows that must cross device
        boundaries, so the sharded executors all-gather exactly this set.

        Memoized on the (immutable) instance — the sharded dispatch reads
        it twice per build (layout choice, then halo tables), and the
        O(nnz) unique scan should run once per schedule, not per read."""
        memo = getattr(self, "_wf1_dep_rows_memo", None)
        if memo is not None:
            return memo
        memo = self._wf1_dep_rows_build()
        object.__setattr__(self, "_wf1_dep_rows_memo", memo)
        return memo

    def _wf1_dep_rows_build(self) -> np.ndarray:
        valid = self.j_rows1 < self.n_j
        parts = []
        if valid.any():
            cols = self.ell_cols1[valid]
            vals = self.ell_vals1[valid]
            parts.append(cols[vals != 0])
        if self.spill_cols1.size:
            # same explicit-zero filter as the body pass, so the count (and
            # with it the traffic model) stays invariant to the width cap
            parts.append(self.spill_cols1[self.spill_vals1 != 0])
        if not parts:
            return np.zeros(0, np.int64)
        return np.unique(np.concatenate(parts)).astype(np.int64)

    def wf1_unique_deps(self) -> int:
        """Distinct D1 rows the post-barrier wavefront reads (body + spill,
        so the count is invariant to the width cap)."""
        return int(self.wf1_dep_rows().shape[0])

    def hbm_traffic_model(self, b_col: int, c_col: int,
                          dtype_bytes: int = 4) -> dict:
        """Exact fast-memory traffic prediction for the kernel path.

        Unfused: D1 is written to and re-read from device memory in full.
        Tile-fused: wavefront-0 consumers read D1 from on-chip memory (the
        CUDA kernels' shared-memory tile); only the rows wavefront 1 needs
        are priced as spilled (the reference's model, kept for parity).

        ``dtype_bytes`` is the *value* itemsize of the dense operands
        (bf16 = 2, f32 = 4, f64 = 8); index traffic is always int32, so the
        sparse operand's column indices are priced at 4 bytes regardless.
        """
        n_i, n_j = self.n_i, self.n_j
        nnz0 = float((self.ell_vals0 != 0).sum())
        nnz1 = float((self.ell_vals1 != 0).sum()) \
            + float((self.spill_vals1 != 0).sum())
        vals = (n_i * b_col          # read B
                + n_j * c_col        # write D
                + (nnz0 + nnz1)      # A vals
                + b_col * c_col)     # C
        idx_bytes = (nnz0 + nnz1) * 4.0   # A idx, int32 at any value dtype
        d1_rt = 2.0 * n_i * c_col    # unfused: D1 write + re-read
        spill = self.wf1_unique_deps()
        d1_fused = 2.0 * spill * c_col
        unfused = (vals + d1_rt) * dtype_bytes + idx_bytes
        fused = (vals + d1_fused) * dtype_bytes + idx_bytes
        return {"unfused_bytes": unfused, "fused_bytes": fused,
                "traffic_saving": 1.0 - fused / unfused,
                "d1_spill_rows": spill, "dtype_bytes": int(dtype_bytes)}


def _ell_arrays(a: CSR, j_rows_list, j_max, pad_row, local_start=None,
                width_cap=None):
    """Pack ragged per-tile row lists into (T, j_max, w) ELL in one shot.

    Flat index arithmetic instead of nested Python loops: every nonzero's
    (tile, slot, width) scatter coordinate is derived from ``indptr`` diffs
    (``csr_gather_rows`` + ``ell_slot_coords``), so packing is O(nnz)
    regardless of tile count.

    ``width_cap`` bounds the body width (hybrid layout): entries past slot
    ``width_cap`` of a row come back as flat COO spill lanes
    ``(spill_rows, spill_cols, spill_vals)`` — global row ids, *global*
    columns (spill is only used for wavefront 1, after the barrier, where
    tile-locality no longer applies; ``local_start`` must be None with a
    cap).  With ``width_cap=None`` the spill arrays are empty and the body
    is the exact pre-cap pad-to-max layout."""
    assert width_cap is None or local_start is None, \
        "capped packing is global-column (wavefront 1) only"
    n_tiles = len(j_rows_list)
    sizes = np.asarray([jr.size for jr in j_rows_list], dtype=np.int64)
    all_j = np.concatenate(j_rows_list).astype(np.int64) if n_tiles \
        else np.zeros(0, np.int64)
    row_nnz = (a.indptr[all_j + 1] - a.indptr[all_j]).astype(np.int64) \
        if all_j.size else np.zeros(0, np.int64)
    w = max(int(row_nnz.max()) if row_nnz.size else 0, 1)
    if width_cap is not None:
        w = max(min(int(width_cap), w), 1)
    j_rows = np.full((n_tiles, j_max), pad_row, dtype=np.int32)
    cols = np.zeros((n_tiles, j_max, w), dtype=np.int32)
    vals = np.zeros((n_tiles, j_max, w), dtype=np.float32)
    spill_rows = np.zeros(0, np.int32)
    spill_cols = np.zeros(0, np.int32)
    spill_vals = np.zeros(0, np.float32)
    if all_j.size:
        # (tile, slot) of every packed row, then (row, width-slot) per nnz
        tile_of, slot_of = ell_slot_coords(sizes)
        j_rows[tile_of, slot_of] = all_j
        flat, lens = csr_gather_rows(a, all_j)
        if flat.size:
            row_rep, w_idx = ell_slot_coords(lens)
            body = w_idx < w
            if not body.all():
                sp = ~body
                spill_rows = all_j[row_rep[sp]].astype(np.int32)
                spill_cols = a.indices[flat[sp]].astype(np.int32)
                spill_vals = a.data[flat[sp]].astype(np.float32)
                row_rep, w_idx, flat = row_rep[body], w_idx[body], flat[body]
            tv, sv = tile_of[row_rep], slot_of[row_rep]
            c = a.indices[flat].astype(np.int64)
            if local_start is not None:
                c = c - np.asarray(local_start, np.int64)[tv]
            cols[tv, sv, w_idx] = c.astype(np.int32)
            vals[tv, sv, w_idx] = a.data[flat].astype(np.float32)
    return j_rows, cols, vals, (spill_rows, spill_cols, spill_vals)


def pad_device_schedule(ds: DeviceSchedule, *, j1_slots: int = 0,
                        spill_slots: int = 0) -> DeviceSchedule:
    """Append no-op wavefront-1 capacity to a device schedule.

    Headroom for the incremental inspector: extra row slots (row index
    ``n_j``, not written; zero ELL entries) and extra spill lanes (row 0,
    val 0: a no-op, which ``fused_ops.wf1_tail_plan`` drops from the
    kernel's tails where row 0 has no slot) let later patches move rows
    into wavefront 1 without changing any array shape, so a bucket's
    device buffers keep their sizes.  Called once per bucket build, never
    on the hot path."""
    if j1_slots <= 0 and spill_slots <= 0:
        return ds
    j_rows1, cols1, vals1 = ds.j_rows1, ds.ell_cols1, ds.ell_vals1
    if j1_slots > 0:
        t1, j1 = j_rows1.shape
        if t1 == 0:
            # fully-fused schedule: stand up one wavefront-1 tile of pure
            # pad slots (body width from the cap so entering rows mostly
            # land in the body, not the spill lanes)
            w = max(ds.width_cap if ds.width_cap is not None else 1, 1)
            j_rows1 = np.full((1, j1_slots), ds.n_j, np.int32)
            cols1 = np.zeros((1, j1_slots, w), np.int32)
            vals1 = np.zeros((1, j1_slots, w), np.float32)
        else:
            w = cols1.shape[2]
            extra = -(-j1_slots // max(j1, 1))
            j_rows1 = np.concatenate(
                [j_rows1, np.full((extra, j1), ds.n_j, np.int32)])
            cols1 = np.concatenate(
                [cols1, np.zeros((extra, j1, w), np.int32)])
            vals1 = np.concatenate(
                [vals1, np.zeros((extra, j1, w), np.float32)])
    sr, sc, sv = ds.spill_rows1, ds.spill_cols1, ds.spill_vals1
    if spill_slots > 0:
        sr = np.concatenate([sr, np.zeros(spill_slots, np.int32)])
        sc = np.concatenate([sc, np.zeros(spill_slots, np.int32)])
        sv = np.concatenate([sv, np.zeros(spill_slots, np.float32)])
    return dataclasses.replace(ds, j_rows1=j_rows1, ell_cols1=cols1,
                               ell_vals1=vals1, spill_rows1=sr,
                               spill_cols1=sc, spill_vals1=sv)


def to_device_schedule(a: CSR, sched: Schedule,
                       width_cap: int | None = None) -> DeviceSchedule:
    """Pad the host schedule to static shapes.

    ``width_cap`` bounds the wavefront-1 ELL body width (hub rows land in
    wavefront 1 — their dependencies span tiles — so this is where one
    max-degree row otherwise inflates the whole (T1, j1_max, w1) block);
    the capped tails come out as the schedule's COO spill lanes.  Wavefront
    0's tile-local ELL is never capped: a fused row's width is already
    bounded by the tile size, and the wavefront-0 kernels consume it as-is."""
    wf0, wf1 = sched.wavefronts
    n_i, n_j = sched.n_i, sched.n_j

    t_pad = max([tl.n_i for tl in wf0] + [1])
    j0_max = max([tl.n_j for tl in wf0] + [1])
    i_starts = np.asarray([tl.i_start for tl in wf0], dtype=np.int32)
    i_lens = np.asarray([tl.n_i for tl in wf0], dtype=np.int32)
    starts = np.asarray([tl.i_start for tl in wf0], dtype=np.int32)
    j_rows0, cols0, vals0, _ = _ell_arrays(
        a, [tl.j_rows for tl in wf0], j0_max, pad_row=n_j, local_start=starts)

    spill1 = (np.zeros(0, np.int32), np.zeros(0, np.int32),
              np.zeros(0, np.float32))
    if wf1:
        j1_max = max(tl.n_j for tl in wf1)
        j_rows1, cols1, vals1, spill1 = _ell_arrays(
            a, [tl.j_rows for tl in wf1], max(j1_max, 1), pad_row=n_j,
            width_cap=width_cap)
    else:
        j_rows1 = np.full((0, 1), n_j, dtype=np.int32)
        cols1 = np.zeros((0, 1, 1), dtype=np.int32)
        vals1 = np.zeros((0, 1, 1), dtype=np.float32)

    return DeviceSchedule(
        n_i=n_i, n_j=n_j, t_pad=int(t_pad),
        i_starts=i_starts, i_lens=i_lens,
        j_rows0=j_rows0, ell_cols0=cols0, ell_vals0=vals0,
        j_rows1=j_rows1, ell_cols1=cols1, ell_vals1=vals1,
        spill_rows1=spill1[0], spill_cols1=spill1[1], spill_vals1=spill1[2],
        width_cap=width_cap,
    )
