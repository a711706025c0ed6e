"""Sharded tile-fusion executors — the wavefront-0 tile grid over a mesh.

Twin of ``repro.core.tilefusion.sharded``.  The paper balances locality
against "sufficient workload for cores" on one node; this module lifts the
same trade-off to a mesh of devices (``models.sharding.Mesh``).  The unit
of distribution is the inspector's fused schedule: the wavefront-0 tile
grid is cut into contiguous row blocks over the mesh's row axis, balanced
by Eq-3 cost (``scheduler.balanced_contiguous_partition``), and a fused
tile never crosses a shard, so wavefront 0 needs no communication.

``mesh_key``, ``ShardedSchedule``, the numpy helpers and
``build_sharded_schedule`` are copies of the reference's, array for array
the same: the layouts (1d row shards, 1.5d column replicas of the dense
operand, 2.5d depth layers that replicate wavefront 0 and split the halo
exchange), the two output combines and the overlap arm's slot indices are
described in the reference's module docstring.

The executors are the port's own.  One process loops over the mesh's
devices, each the cell (row shard ``s``, column replica ``r``, depth layer
``z``) of ``Mesh.grid``, and runs each shard's body on its device:

  wavefront 0   one launch of the wavefront-0 kernel on the shard's
                ``tiles_per_shard`` stacked tiles: ``tile_fused_gemm_spmm_wf0``
                on the shard's rows of B and C's column slice ``r``, or
                ``tile_fused_spmm_spmm_wf0`` on the shard's op-1 hybrid
                ELL and its spill delta.  Only depth layer 0 scatters the
                fused rows into the shard's partial output (``n_j + 1``
                rows for ``psum``, ``rows_per_shard + 1`` for
                ``reduce_scatter``; the last row takes the pad slots).
  halo          each shard's send rows of D1 (``send_local``) are gathered
                over the row axis (``models.sharding.all_gather``) into its
                depth layer's halo table (at ``send_pos``).
  wavefront 1   one ``spmm_ell`` call per group (row shard × depth layer,
                on each column replica) over the halo table, written in
                place at the group's rows; the group's co-located spill
                lanes are the kernel's row tails.
  combine       a depth ``psum``, then a row ``psum``, or the owner blocks
                put back in D's row order by ``out_perm``; the result lands
                on ``C``'s device, and ``_pad_cols``' padding is sliced off.

``overlap=True`` issues the halo gather before the wavefront-0 scatter,
into one of two persistent buffers per dtype that calls alternate, and
wavefront 1 reads the raw gather through the schedule's composed slot
indices (``ell_cols1_ov``), so no table is scattered.  On CUDA the gather
runs on a side stream that waits for the wavefront-0 kernels, and the main
stream waits for it only before wavefront 1.  The kernels read the same
values in the same order on both arms, so the two give the same bits.

Every device copy of the schedule is memoized on the ``ShardedSchedule``
per (shard or group, device, dtype), as ``fused_ops.schedule_tensors``
memoizes a single-device schedule: two meshes of one shape share the
cache entry and each device gets its own upload.  The same code runs on
CPU tensors, where the kernel wrappers take their plain versions.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ...kernels import ops as kops
from ...kernels import spmm as kspmm
from ...models import sharding as mesh_lib
from ..sparse.formats import CSR, csr_content_digest
from . import cost_model, fused_ops
from .schedule import DeviceSchedule
from .scheduler import Schedule, balanced_contiguous_partition, \
    resolve_mesh_layout

#: Valid output-combine strategies (plus "auto" at the dispatch layer).
COMBINE_MODES = ("psum", "reduce_scatter")


def mesh_key(mesh) -> tuple | None:
    """Hashable cache-key component for a mesh: axis names + shape.

    ``None`` for ``mesh=None`` *and* for single-device meshes — a trivial
    mesh dispatches identically to no mesh, so the two must share cache
    entries."""
    if mesh is None:
        return None
    shape = tuple(int(s) for s in np.shape(mesh.devices))
    if int(np.prod(shape)) <= 1:
        return None
    return (tuple(str(n) for n in mesh.axis_names), shape)


@dataclasses.dataclass(frozen=True)
class ShardedSchedule:
    """Per-shard restructuring of a uniform ``DeviceSchedule``.

    All stacked arrays carry the shard dimension flattened into their
    leading axis (``S * per_shard``): shard ``s``'s block is rows ``[s *
    per_shard, (s + 1) * per_shard)``."""

    n_shards: int                 # row-block shards (the mesh's row axis)
    n_repl: int                   # column replicas (1 = pure 1-D layout)
    combine: str                  # "psum" | "reduce_scatter"
    n_depth: int                  # depth layers (1 = no 2.5D replication)
    overlap: bool                 # async halo gather under wf0 compute
    t_pad: int
    n_i: int
    n_j: int
    n_tiles0: int                 # global wavefront-0 tile count
    tiles_per_shard: int          # T0s (padded)
    tile_bounds: np.ndarray       # (S+1,) contiguous tile-index bounds
    tile_map: np.ndarray          # (S*T0s,) global tile id, pad = n_tiles0
    row_map: np.ndarray           # (S*T0s*t,) global padded D1 row, pad = 0
    # wavefront 0 (gathered from DeviceSchedule in shard order)
    j_rows0: np.ndarray           # (S*T0s, j0_max) global D rows, pad = n_j
    ell_cols0: np.ndarray         # (S*T0s, j0_max, w0) tile-local
    ell_vals0: np.ndarray
    # wavefront 1, stacked over G = S*Z groups (cols remapped to the
    # group's depth layer's halo-table positions)
    wf1_per_shard: int            # T1s (padded; 0 = empty wavefront)
    j_rows1: np.ndarray           # (G*T1s, j1_max) pad = n_j
    ell_cols1: np.ndarray         # (G*T1s, j1_max, w1) halo positions
    ell_vals1: np.ndarray
    spill_per_shard: int          # L (padded)
    spill_rows1: np.ndarray       # (G*L,) global D rows, pad = n_j
    spill_cols1: np.ndarray       # (G*L,) halo positions, pad = 0
    spill_vals1: np.ndarray       # (G*L,) pad = 0
    # halo exchange (per depth layer; Z = 1 is the flat single-table case)
    halo_rows: np.ndarray         # (H,) sorted global D1 rows wf1 reads
    halo_pad: int                 # Hp: padded per-layer halo-table height
    send_per_shard: int           # Hs (padded)
    send_local: np.ndarray        # (G*Hs,) shard-local padded row, pad = 0
    send_pos: np.ndarray          # (Z, S, Hs) layer-table position, pad=Hp
    # async-overlap composed indexing: wavefront-1 column/spill indices
    # remapped from layer-table POSITIONS to SLOTS of the raw all-gather
    # result (s * Hs + k), so the deferred exchange never materializes the
    # halo table at all — the gather's flat output is read directly
    ell_cols1_ov: np.ndarray      # (G*T1s, j1_max, w1) gather slots
    spill_cols1_ov: np.ndarray    # (G*L,) gather slots, pad = 0
    # output ownership (the reduce-scatter row remap): every D row is
    # owned by the one shard that writes it — wf0 fused rows by their
    # tile's shard, wf1 rows by their wf1 tile's shard
    rows_per_shard: int           # R: padded owned rows per shard
    out_perm: np.ndarray          # (n_j,) permuted block position of row j
    out_rows0: np.ndarray         # (S*T0s, j0_max) shard-local out, pad = R
    out_rows1: np.ndarray         # (G*T1s, j1_max) shard-local out, pad = R
    out_spill: np.ndarray         # (S*L,) shard-local out, pad = R
    #: ``cost_model.shard_comm_model`` of this partition (halo all-gather
    #: bytes vs full-D1 replication; psum vs reduce-scatter combine) —
    #: surfaced through the schedule entry's traffic model.
    comm_model: dict = dataclasses.field(default_factory=dict)

    @property
    def halo_size(self) -> int:
        return int(self.halo_rows.shape[0])

    @property
    def layout(self) -> str:
        """"1d" (row shards only), "1.5d" (column replicas too), or
        "2.5d" (depth layers as well)."""
        if self.n_depth > 1:
            return "2.5d"
        return "1d" if self.n_repl == 1 else "1.5d"

    def shard_tile_counts(self) -> np.ndarray:
        """Real (unpadded) wavefront-0 tiles per shard — the balance the
        Eq-3 partition produced, pinned by tests."""
        return np.diff(self.tile_bounds)

    def shard_owned_counts(self) -> np.ndarray:
        """Real (unpadded) owned output rows per shard — the row blocks of
        the reduce-scatter combine, disjoint and exhaustive over D."""
        pos = np.sort(self.out_perm)
        bounds = np.searchsorted(pos, np.arange(self.n_shards + 1)
                                 * self.rows_per_shard)
        return np.diff(bounds)


def _pad_gather(src: np.ndarray, idx: np.ndarray, pad_value) -> np.ndarray:
    """Gather ``src[idx]`` where ``idx == src.shape[0]`` selects a padding
    element filled with ``pad_value``."""
    pad = np.full((1,) + src.shape[1:], pad_value, dtype=src.dtype)
    return np.concatenate([src, pad], axis=0)[idx]


def _remap_to_halo(cols: np.ndarray, halo_rows: np.ndarray) -> np.ndarray:
    """Global D1 rows -> positions in the halo table; rows not in the halo
    (only possible for zero-valued slots, which the halo set filters) map
    to position 0 where the zero value makes the read a no-op."""
    if halo_rows.size == 0:
        return np.zeros_like(cols)
    pos = np.searchsorted(halo_rows, cols)
    pos = np.minimum(pos, halo_rows.size - 1)
    hit = halo_rows[pos] == cols
    return np.where(hit, pos, 0).astype(np.int32)


def _owner_of_tiles(bounds: np.ndarray, tile_ids: np.ndarray,
                    n_shards: int) -> np.ndarray:
    """Owning shard of each tile id under contiguous ``bounds``."""
    own = np.searchsorted(bounds, tile_ids, side="right") - 1
    return np.clip(own, 0, n_shards - 1)


def _pack_by_group(owners: np.ndarray, n_groups: int) -> tuple:
    """Pack items into equal-stride per-group slots — the one packing rule
    behind the halo send tables, the output-ownership permutation, and the
    spill-lane co-location.

    Returns ``(counts, stride, order, dst)``: item ``order[k]`` lands at
    flat slot ``dst[k] = group * stride + rank_within_group`` where
    ``stride = max(counts, 1)`` (so every group's block is padded to the
    same height) and ``order`` walks the items in stable group order."""
    owners = np.asarray(owners, dtype=np.int64)
    counts = np.bincount(owners, minlength=n_groups)
    stride = max(int(counts.max()) if owners.size else 0, 1)
    order = np.argsort(owners, kind="stable")
    offsets = np.concatenate([[0], np.cumsum(counts)])
    dst = (np.repeat(np.arange(n_groups, dtype=np.int64), counts) * stride
           + np.arange(owners.size, dtype=np.int64)
           - np.repeat(offsets[:-1], counts))
    return counts, stride, order, dst


def _local_out_rows(stacked_rows: np.ndarray, shard_of: np.ndarray,
                    pos_of_row: np.ndarray, n_j: int,
                    r_per: int) -> np.ndarray:
    """Shard-local output positions for a stacked global-row array: real
    rows map to ``pos_of_row - shard * R`` (in [0, R) — every row in a
    shard's stack is owned by that shard), pad slots map to ``R``
    (scatter-dropped)."""
    if stacked_rows.size == 0 or n_j == 0:
        return np.full(stacked_rows.shape, r_per, np.int32)
    real = stacked_rows < n_j
    safe = np.minimum(stacked_rows, max(n_j - 1, 0))
    loc = pos_of_row[safe] - shard_of.reshape(
        shard_of.shape + (1,) * (stacked_rows.ndim - shard_of.ndim)) * r_per
    return np.where(real, loc, r_per).astype(np.int32)


def build_sharded_schedule(a: CSR, sched: Schedule, dsched: DeviceSchedule,
                           mesh_shape, *, b_col: int, c_col: int,
                           b_is_sparse: bool,
                           width_cap: int | None = None,
                           layout: str = "1d",
                           combine: str = "auto",
                           dtype_bytes: int = 4,
                           overlap: bool | str = False):
    """Partition a uniform schedule over a mesh shape (an int or a shape
    tuple) under a layout — ``scheduler.resolve_mesh_layout`` is the one
    place the shape becomes (row shards × column replicas × depth layers).

    ``combine`` picks the output-combine strategy (``"auto"`` defers to
    ``shard_comm_model``'s byte pricing); ``overlap`` enables the async
    halo gather (``"auto"`` defers to the same model's hidden-bytes vs
    duplicate-compute pricing).  Returns ``None`` when the schedule is not
    a uniform wavefront-0 grid (the caller falls back to single-device
    dispatch)."""
    if combine not in COMBINE_MODES + ("auto",):
        raise ValueError(f"combine={combine!r}; expected one of "
                         f"{COMBINE_MODES + ('auto',)}")
    if not isinstance(overlap, (bool, np.bool_)) and overlap != "auto":
        raise ValueError(f"overlap={overlap!r}; expected a bool or 'auto'")
    s_n, n_repl, n_depth = resolve_mesh_layout(mesh_shape, layout)
    if s_n * n_repl * n_depth <= 1 or not fused_ops._is_uniform(dsched):
        return None
    n_groups = s_n * n_depth       # wf1 work groups: row shard × depth
    t = dsched.t_pad
    n_t = dsched.n_tiles0
    n_j = dsched.n_j
    wf0, wf1 = sched.wavefronts

    # ---- wavefront 0: Eq-3-balanced contiguous tile partition over the
    # mesh's row axis (replica groups share tiles) ----
    costs0 = cost_model.tile_costs_batch(
        a, [tl.i_start for tl in wf0], [tl.i_end for tl in wf0],
        [tl.j_rows for tl in wf0], b_col, c_col, b_is_sparse,
        width_cap=width_cap)
    tile_bounds = balanced_contiguous_partition(costs0, s_n)
    per = np.diff(tile_bounds)
    t0s = max(int(per.max()) if per.size else 0, 1)
    tile_map = np.full((s_n, t0s), n_t, dtype=np.int64)
    for s in range(s_n):
        ids = np.arange(tile_bounds[s], tile_bounds[s + 1], dtype=np.int64)
        tile_map[s, : ids.size] = ids
    tile_map = tile_map.reshape(-1)

    j_rows0 = _pad_gather(dsched.j_rows0, tile_map, n_j)
    ell_cols0 = _pad_gather(dsched.ell_cols0, tile_map, 0)
    ell_vals0 = _pad_gather(dsched.ell_vals0, tile_map, 0)

    valid = tile_map < n_t
    row_map = (np.where(valid, tile_map, 0)[:, None] * t
               + np.arange(t, dtype=np.int64)[None, :])
    row_map = np.where(valid[:, None], row_map, 0).reshape(-1)

    # ---- wavefront 1: cost-balanced tile partition over S*Z groups
    # (group g = shard * Z + layer; Z = 1 reduces to the per-shard split).
    halo_rows = dsched.wf1_dep_rows()
    h = int(halo_rows.shape[0])
    row_bounds = tile_bounds * t
    n_t1 = dsched.n_tiles1
    if n_t1:
        costs1 = cost_model.tile_costs_batch(
            a, np.zeros(n_t1, np.int64), np.zeros(n_t1, np.int64),
            [tl.j_rows for tl in wf1], b_col, c_col, b_is_sparse,
            width_cap=width_cap)
        bounds1 = balanced_contiguous_partition(costs1, n_groups)
        per1 = np.diff(bounds1)
        t1s = max(int(per1.max()), 1)
        tmap1 = np.full((n_groups, t1s), n_t1, dtype=np.int64)
        for g in range(n_groups):
            ids = np.arange(bounds1[g], bounds1[g + 1], dtype=np.int64)
            tmap1[g, : ids.size] = ids
        tmap1 = tmap1.reshape(-1)
        j_rows1 = _pad_gather(dsched.j_rows1, tmap1, n_j)
        cols1_g = _pad_gather(dsched.ell_cols1, tmap1, 0)    # global rows
        vals1 = _pad_gather(dsched.ell_vals1, tmap1, 0)
        grp_of_t1 = _owner_of_tiles(bounds1, np.arange(n_t1, dtype=np.int64),
                                    n_groups)
    else:
        bounds1 = np.zeros(n_groups + 1, dtype=np.int64)
        t1s = 0
        j_rows1 = np.full((0, 1), n_j, dtype=np.int32)
        cols1_g = np.zeros((0, 1, 1), dtype=np.int32)
        vals1 = np.zeros((0, 1, 1), dtype=np.float32)
        grp_of_t1 = np.zeros(0, dtype=np.int64)

    # ---- output ownership: row -> owning shard -> permuted position ----
    # Every D row is written by exactly one tile (Schedule.validate), so
    # the per-shard write sets are disjoint and exhaustive: wf0 fused rows
    # belong to their tile's shard, wf1 rows to their wf1 tile's shard
    # (= its group's row shard).  ``grp_row`` additionally remembers the
    # full (shard, layer) group for wf1 rows, which co-locates spill lanes
    # and assigns halo deps to depth layers; wf0 rows sit at layer 0.
    own_row = np.zeros(max(n_j, 1), dtype=np.int64)
    sizes0 = np.asarray([tl.n_j for tl in wf0], dtype=np.int64)
    if sizes0.sum():
        j0_all = np.concatenate([tl.j_rows for tl in wf0]).astype(np.int64)
        t0_of = np.repeat(np.arange(len(wf0), dtype=np.int64), sizes0)
        own_row[j0_all] = _owner_of_tiles(tile_bounds, t0_of, s_n)
    grp_row = own_row * n_depth
    if n_t1:
        sizes1 = np.asarray([tl.n_j for tl in wf1], dtype=np.int64)
        j1_all = np.concatenate([tl.j_rows for tl in wf1]).astype(np.int64)
        t1_of = np.repeat(np.arange(n_t1, dtype=np.int64), sizes1)
        own_row[j1_all] = grp_of_t1[t1_of] // n_depth
        grp_row[j1_all] = grp_of_t1[t1_of]
    own_row = own_row[:n_j]
    grp_row = grp_row[: max(n_j, 1)]
    _, r_per, o_ord, o_dst = _pack_by_group(own_row, s_n)
    pos_of_row = np.empty(n_j, dtype=np.int64)
    pos_of_row[o_ord] = o_dst

    # ---- spill-lane grouping (needed before the halo tables: a spill's
    # halo dep must live in its depth layer's table) ----
    n_sp = int(dsched.spill_rows1.shape[0])
    if n_sp:
        sp_grp = grp_row[dsched.spill_rows1.astype(np.int64)]
    else:
        sp_grp = np.zeros(0, dtype=np.int64)

    # ---- halo: per-depth-layer dependency tables + send schedules ----
    # Layer z's table H_z is the union of its groups' wf1 deps; Z = 1
    # makes H_0 exactly ``wf1_dep_rows()`` (the flat single-table case).
    if n_depth > 1:
        layer_of_t1 = grp_of_t1 % n_depth
        halo_layers_list = []
        for z in range(n_depth):
            parts = []
            if n_t1:
                tz = np.where(layer_of_t1 == z)[0]
                if tz.size:
                    cz = dsched.ell_cols1[tz][dsched.ell_vals1[tz] != 0]
                    parts.append(cz.ravel().astype(np.int64))
            if n_sp:
                m = (sp_grp % n_depth == z) & (dsched.spill_vals1 != 0)
                parts.append(dsched.spill_cols1[m].astype(np.int64))
            hz = (np.unique(np.concatenate(parts)) if parts
                  else np.zeros(0, dtype=np.int64))
            halo_layers_list.append(hz)
    else:
        halo_layers_list = [halo_rows.astype(np.int64)]
    h_pad = max(max((hz.size for hz in halo_layers_list), default=0), 1)
    cnt = np.zeros((s_n, n_depth), dtype=np.int64)
    own_z = []
    for z, hz in enumerate(halo_layers_list):
        if hz.size:
            oz = np.clip(np.searchsorted(row_bounds, hz, side="right") - 1,
                         0, s_n - 1)
        else:
            oz = np.zeros(0, dtype=np.int64)
        own_z.append(oz)
        cnt[:, z] = np.bincount(oz, minlength=s_n)
    hs = max(int(cnt.max()), 1)
    send_local = np.zeros(n_groups * hs, dtype=np.int32)
    send_pos = np.full((n_depth, s_n, hs), h_pad, dtype=np.int32)
    for z, hz in enumerate(halo_layers_list):
        if not hz.size:
            continue
        oz = own_z[z]
        # hz is sorted and ownership is contiguous, so the stable group
        # order is the identity: slot = rank within the shard's run
        offs = np.concatenate([[0], np.cumsum(cnt[:, z])])
        rank = np.arange(hz.size, dtype=np.int64) - offs[oz]
        g = oz * n_depth + z
        send_local[g * hs + rank] = (hz - row_bounds[oz]).astype(np.int32)
        send_pos[z, oz, rank] = np.arange(hz.size, dtype=np.int32)
    if h == 0:
        send_pos = np.zeros((n_depth, s_n, hs), dtype=np.int32)

    # overlap slot composition: per layer, table position p lives at slot
    # (s * hs + k) of the raw all-gather output — composing wf1's position
    # indices with that map at build time lets the async path skip the
    # per-call table scatter entirely (pad positions fold to slot 0, whose
    # junk value is killed by the matching zero pad values)
    slot_of = np.zeros((n_depth, h_pad + 1), dtype=np.int32)
    for z in range(n_depth):
        pz = send_pos[z]                        # (S, Hs) positions
        valid_p = pz < h_pad
        slot = (np.arange(s_n, dtype=np.int32)[:, None] * hs
                + np.arange(hs, dtype=np.int32)[None, :])
        slot_of[z][pz[valid_p]] = slot[valid_p]

    # ---- wavefront-1 halo remap: each group's cols against its layer ----
    if n_depth > 1 and n_t1:
        cols1 = np.zeros_like(cols1_g, dtype=np.int32)
        layer_of_stack = (np.repeat(np.arange(n_groups, dtype=np.int64),
                                    t1s) % n_depth)
        for z in range(n_depth):
            m = layer_of_stack == z
            if m.any():
                cols1[m] = _remap_to_halo(cols1_g[m], halo_layers_list[z])
    else:
        cols1 = _remap_to_halo(cols1_g, halo_layers_list[0]) if n_t1 \
            else cols1_g

    shard_of0 = np.repeat(np.arange(s_n, dtype=np.int64), t0s)
    out_rows0 = _local_out_rows(j_rows0, shard_of0, pos_of_row, n_j, r_per)
    if t1s:
        shard_of1 = np.repeat(np.arange(n_groups, dtype=np.int64)
                              // n_depth, t1s)
        out_rows1 = _local_out_rows(j_rows1, shard_of1, pos_of_row, n_j,
                                    r_per)
    else:
        out_rows1 = np.full(j_rows1.shape, r_per, dtype=np.int32)

    # ---- spill lanes: co-located with their target row's owning group
    # (the group whose wf1 tile wrote the body, so the reduce-scatter
    # partials stay owner-disjoint and the body .set precedes the .add,
    # and the spill's halo dep is in the same layer's table) ----
    if n_sp:
        if n_depth > 1:
            sp_remap = np.zeros(n_sp, dtype=np.int32)
            for z in range(n_depth):
                m = sp_grp % n_depth == z
                if m.any():
                    sp_remap[m] = _remap_to_halo(
                        dsched.spill_cols1[m], halo_layers_list[z])
        else:
            sp_remap = _remap_to_halo(dsched.spill_cols1,
                                      halo_layers_list[0])
        _, sp_l, sp_order, dst = _pack_by_group(sp_grp, n_groups)
        spill_rows = np.full(n_groups * sp_l, n_j, np.int32)
        spill_cols = np.zeros(n_groups * sp_l, np.int32)
        spill_vals = np.zeros(n_groups * sp_l, np.float32)
        spill_rows[dst] = dsched.spill_rows1[sp_order]
        spill_cols[dst] = sp_remap[sp_order]
        spill_vals[dst] = dsched.spill_vals1[sp_order]
        out_spill = np.full(n_groups * sp_l, r_per, np.int32)
        out_spill[dst] = (pos_of_row[dsched.spill_rows1[sp_order].astype(
            np.int64)] - (sp_grp[sp_order] // n_depth) * r_per).astype(
            np.int32)
    else:
        sp_l = 0
        spill_rows = np.zeros(0, np.int32)
        spill_cols = np.zeros(0, np.int32)
        spill_vals = np.zeros(0, np.float32)
        out_spill = np.zeros(0, np.int32)

    # wf1 position indices composed through each group's layer slot map
    # (the overlap executor's direct-from-gather read)
    if t1s:
        layer1 = (np.repeat(np.arange(n_groups, dtype=np.int64), t1s)
                  % n_depth)
        cols1_ov = slot_of[layer1[:, None, None],
                           cols1.astype(np.int64)].astype(np.int32)
    else:
        cols1_ov = cols1
    if sp_l:
        layer_sp = (np.repeat(np.arange(n_groups, dtype=np.int64), sp_l)
                    % n_depth)
        spill_cols_ov = slot_of[layer_sp,
                                spill_cols.astype(np.int64)].astype(np.int32)
    else:
        spill_cols_ov = spill_cols

    wf0_bytes = float(costs0.sum()) * dtype_bytes
    comm = cost_model.shard_comm_model(s_n, h, dsched.n_i, c_col,
                                       n_j=n_j, n_repl=n_repl,
                                       combine_rows=s_n * r_per,
                                       dtype_bytes=dtype_bytes,
                                       n_depth=n_depth, overlap=overlap,
                                       wf0_bytes=wf0_bytes)
    mode = comm["combine"] if combine == "auto" else combine
    overlap_on = bool(comm["overlap"]) and h > 0
    return ShardedSchedule(
        n_shards=s_n, n_repl=n_repl, combine=mode,
        n_depth=n_depth, overlap=overlap_on,
        t_pad=t, n_i=dsched.n_i, n_j=n_j, n_tiles0=n_t,
        tiles_per_shard=t0s, tile_bounds=tile_bounds, tile_map=tile_map,
        row_map=row_map,
        j_rows0=j_rows0, ell_cols0=ell_cols0, ell_vals0=ell_vals0,
        wf1_per_shard=t1s, j_rows1=j_rows1, ell_cols1=cols1,
        ell_vals1=vals1,
        spill_per_shard=sp_l, spill_rows1=spill_rows,
        spill_cols1=spill_cols, spill_vals1=spill_vals,
        halo_rows=halo_rows, halo_pad=h_pad, send_per_shard=hs,
        send_local=send_local.reshape(-1), send_pos=send_pos,
        ell_cols1_ov=cols1_ov, spill_cols1_ov=spill_cols_ov,
        rows_per_shard=r_per, out_perm=pos_of_row,
        out_rows0=out_rows0, out_rows1=out_rows1, out_spill=out_spill,
        comm_model=comm,
    )


# --------------------------------------------------------------------------
# Executors
# --------------------------------------------------------------------------
def _memoized(shard: ShardedSchedule, key: tuple, build):
    """``build()``, memoized on the (cached, frozen) schedule by ``key``."""
    memo = fused_ops._memo(shard)
    value = memo.get(key)
    if value is None:
        value = memo[key] = build()
    return value


def _idx(a, device, dtype=torch.int64) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a)).to(device, dtype)


def _val(a, device, dtype) -> torch.Tensor:
    """Values through f32 first, as the reference casts them."""
    return torch.as_tensor(np.asarray(a, np.float32)).to(device, dtype)


def _reduce_scatter(shard: ShardedSchedule) -> bool:
    return shard.combine == "reduce_scatter"


def _out_height(shard: ShardedSchedule) -> int:
    """Rows of a shard's partial output (its pad index): ``n_j`` for the
    psum combine, ``rows_per_shard`` for the owner blocks."""
    return shard.rows_per_shard if _reduce_scatter(shard) else shard.n_j


@dataclasses.dataclass
class Wf0Tensors:
    """Row shard ``s``'s wavefront-0 arrays on one device."""

    cols0: torch.Tensor        # (T0s, j0, w0) int32 tile-local
    vals0: torch.Tensor        # (T0s, j0, w0) operand dtype
    rows0: torch.Tensor        # (T0s * j0,) int64 partial row, pad = height


def _wf0_tensors(shard: ShardedSchedule, s: int, device,
                 dtype) -> Wf0Tensors:
    def build():
        lo = s * shard.tiles_per_shard
        hi = lo + shard.tiles_per_shard
        rows = shard.out_rows0 if _reduce_scatter(shard) else shard.j_rows0
        return Wf0Tensors(
            cols0=_idx(shard.ell_cols0[lo:hi], device, torch.int32),
            vals0=_val(shard.ell_vals0[lo:hi], device, dtype),
            rows0=_idx(rows[lo:hi].reshape(-1), device))
    return _memoized(shard, ("wf0", s, fused_ops.device_key(device), dtype),
                     build)


@dataclasses.dataclass
class Wf1Tensors:
    """Group ``g`` (row shard × depth layer)'s wavefront-1 arrays and halo
    tables on one device.  ``cols`` and the tails' columns index the halo
    table (``send_pos`` places the gathered rows there), or with overlap
    the raw gather's slots."""

    cols: torch.Tensor         # (T1s * j1, w1) int32
    vals: torch.Tensor         # (T1s * j1, w1) operand dtype
    rows: torch.Tensor         # (T1s * j1,) int32 partial row, pad = height
    tails: kspmm.Tails         # the group's spill lanes, by packed slot
    send_local: torch.Tensor   # (Hs,) int64 D1 rows this group sends
    send_pos: torch.Tensor     # (S * Hs,) int64 layer-table row, pad = Hp


def _wf1_tensors(shard: ShardedSchedule, g: int, device,
                 dtype) -> Wf1Tensors:
    def build():
        t1s, sp_l, hs = (shard.wf1_per_shard, shard.spill_per_shard,
                         shard.send_per_shard)
        lo, hi = g * t1s, (g + 1) * t1s
        lanes = slice(g * sp_l, (g + 1) * sp_l)
        w1 = shard.ell_cols1.shape[2]
        cols = shard.ell_cols1_ov if shard.overlap else shard.ell_cols1
        scols = shard.spill_cols1_ov if shard.overlap else shard.spill_cols1
        rows = shard.out_rows1 if _reduce_scatter(shard) else shard.j_rows1
        # the group's lanes keyed by D row against its own packed rows:
        # pad lanes (row n_j, value 0) are dropped
        plan = fused_ops.rows_tail_plan(
            shard.j_rows1[lo:hi], shard.n_j, shard.spill_rows1[lanes],
            shard.spill_vals1[lanes])
        return Wf1Tensors(
            cols=_idx(cols[lo:hi].reshape(-1, w1), device, torch.int32),
            vals=_val(shard.ell_vals1[lo:hi].reshape(-1, w1), device, dtype),
            rows=_idx(rows[lo:hi].reshape(-1), device, torch.int32),
            tails=kspmm.Tails.upload(plan, scols[lanes],
                                     shard.spill_vals1[lanes], device, dtype),
            send_local=_idx(shard.send_local[g * hs:(g + 1) * hs], device),
            send_pos=_idx(shard.send_pos[g % shard.n_depth].reshape(-1),
                          device))
    return _memoized(shard, ("wf1", g, fused_ops.device_key(device), dtype),
                     build)


def _row_map(shard: ShardedSchedule, s: int, device) -> torch.Tensor:
    """Row shard ``s``'s padded D1 rows (``row_map``), on ``device``."""
    n = shard.tiles_per_shard * shard.t_pad
    return _memoized(shard, ("row_map", s, fused_ops.device_key(device)),
                     lambda: _idx(shard.row_map[s * n:(s + 1) * n], device))


def _grid(shard: ShardedSchedule, mesh) -> np.ndarray:
    """The mesh's devices as ``(n_shards, n_repl, n_depth)``; raises when
    the mesh's shape does not give the schedule's partition."""
    want = (shard.n_shards, shard.n_repl, shard.n_depth)
    if resolve_mesh_layout(mesh.shape, shard.layout) != want:
        raise ValueError(
            f"mesh shape {mesh.shape} does not match the schedule's "
            f"{want[0]}x{want[1]}x{want[2]} ({shard.layout}) partition")
    return mesh.grid(shard.layout)


_side_streams_by_device: dict = {}


def _side_stream(device: torch.device):
    key = fused_ops.device_key(device)
    stream = _side_streams_by_device.get(key)
    if stream is None:
        stream = _side_streams_by_device[key] = torch.cuda.Stream(device)
    return stream


@contextlib.contextmanager
def _on_side_streams(devices, ready: list):
    """Run the body on each CUDA device's side stream, after the work its
    current stream has queued; ``ready`` tensors (made on the current
    streams, read by the body) are kept from reuse until the side streams
    are done with them.  A no-op off CUDA."""
    cuda = {fused_ops.device_key(d): d for d in devices if d.type == "cuda"}
    if not cuda:
        yield
        return
    for d in cuda.values():
        _side_stream(d).wait_stream(torch.cuda.current_stream(d))
    for x in ready:
        if x.device.type == "cuda":
            x.record_stream(_side_stream(x.device))
    with contextlib.ExitStack() as stack:
        for d in cuda.values():
            stack.enter_context(torch.cuda.stream(_side_stream(d)))
        yield


def _join_side_streams(devices) -> None:
    """Make each CUDA device's current stream wait for its side stream."""
    for d in {fused_ops.device_key(d): d for d in devices
              if d.type == "cuda"}.values():
        torch.cuda.current_stream(d).wait_stream(_side_stream(d))


def _halo_buffers(shard: ShardedSchedule, grid: np.ndarray, dtype,
                  cc: int) -> dict:
    """The overlap arm's gather outputs, one ``(S * Hs, cc)`` buffer per
    device of the mesh and per call parity: calls alternate between the
    two sets per dtype, so a gather never writes the buffer a wavefront 1
    of the previous call may still read."""
    parity_key = ("halo-parity", dtype)
    memo = fused_ops._memo(shard)
    parity = memo.get(parity_key, 0)
    memo[parity_key] = parity ^ 1
    rows = shard.n_shards * shard.send_per_shard

    def build(device):
        # normal tensors even when the first call runs under
        # torch.inference_mode(): later calls write them outside it too
        with torch.inference_mode(False):
            return [torch.empty((rows, cc), dtype=dtype, device=device)
                    for _ in range(2)]
    return {cell: _memoized(shard, ("halo-buf", cell,
                                    fused_ops.device_key(grid[cell]), dtype,
                                    cc), lambda: build(grid[cell]))[parity]
            for cell in np.ndindex(*grid.shape)}


def _gather_halo(shard: ShardedSchedule, grid: np.ndarray, d1: dict,
                 dtype) -> dict:
    """Each cell's halo table: the send rows of every row shard of its
    fiber (same column replica and depth layer) gathered over the row
    axis.  Sync: scattered into a ``(halo_pad + 1, cc)`` table at the
    layer's ``send_pos`` (pad positions land in the last row).  Overlap:
    the raw gather, into the call's halo buffers on the side streams."""
    n_s, n_r, n_z = grid.shape
    cells = list(np.ndindex(n_s, n_r, n_z))
    contrib = {cell: d1[cell].index_select(
        0, _wf1_tensors(shard, cell[0] * n_z + cell[2], grid[cell],
                        dtype).send_local) for cell in cells}
    cc = next(iter(contrib.values())).shape[1]
    bufs = _halo_buffers(shard, grid, dtype, cc) if shard.overlap else None
    tables = {}
    ctx = (_on_side_streams(grid.flat, list(contrib.values()))
           if shard.overlap else contextlib.nullcontext())
    with ctx:
        for r, z in np.ndindex(n_r, n_z):
            fiber = [(s, r, z) for s in range(n_s)]
            group = [grid[cell] for cell in fiber]
            parts = [contrib[cell] for cell in fiber]
            if shard.overlap:
                flats = mesh_lib.all_gather(
                    parts, group, out=[bufs[cell] for cell in fiber])
                tables.update(zip(fiber, flats))
                continue
            for cell, flat in zip(fiber, mesh_lib.all_gather(parts, group)):
                pos = _wf1_tensors(shard, cell[0] * n_z + z, grid[cell],
                                   dtype).send_pos
                table = torch.zeros((shard.halo_pad + 1, cc), dtype=dtype,
                                    device=flat.device)
                tables[cell] = table.index_copy_(0, pos, flat)
    return tables


def _combine(shard: ShardedSchedule, grid: np.ndarray, parts: dict,
             device) -> torch.Tensor:
    """Depth psum and the output combine, onto ``device``: the row psum of
    each column replica's partials side by side, or each (row shard,
    column replica) owner block in place and the rows put back in D's
    order by ``out_perm``."""
    n_s, n_r, n_z = grid.shape

    def reduce(cells):
        return mesh_lib.psum([parts[c] for c in cells],
                             [grid[c] for c in cells])[0]

    if _reduce_scatter(shard):
        blocks = mesh_lib.gather(
            [reduce([(s, r, z) for z in range(n_z)])
             for s, r in np.ndindex(n_s, n_r)], device)
        full = torch.cat([torch.cat(blocks[s * n_r:(s + 1) * n_r], dim=1)
                          for s in range(n_s)])
        perm = _memoized(shard, ("out_perm", fused_ops.device_key(device)),
                         lambda: _idx(shard.out_perm, device))
        return full.index_select(0, perm)
    cols = [reduce([(s, r, z) for s in range(n_s) for z in range(n_z)])
            for r in range(n_r)]
    return torch.cat(mesh_lib.gather(cols, device), dim=1)


def _execute(shard: ShardedSchedule, mesh, c: torch.Tensor,
             launch_wf0) -> torch.Tensor:
    """Run every shard's body on its device and combine onto ``c``'s.
    ``launch_wf0(s, r, device)`` launches the wavefront-0 kernel of row
    shard ``s`` on column replica ``r`` and returns its ``(d1, rows0)``."""
    grid = _grid(shard, mesh)
    n_s, n_r, n_z = grid.shape
    dtype = c.dtype
    cc = c.shape[1] // n_r
    height = _out_height(shard)
    run_wf1 = shard.halo_size > 0 and shard.wf1_per_shard > 0
    cells = list(np.ndindex(n_s, n_r, n_z))
    d1, rows0 = {}, {}
    for s, r, z in cells:
        with mesh_lib.on_device(grid[s, r, z]):
            d1[s, r, z], rows0[s, r, z] = launch_wf0(s, r, grid[s, r, z])
    halo = (_gather_halo(shard, grid, d1, dtype)
            if run_wf1 and shard.overlap else None)
    partial = {}
    for s, r, z in cells:
        p = torch.zeros((height + 1, cc), dtype=dtype, device=grid[s, r, z])
        if z == 0:
            # only depth layer 0 emits the (replicated) fused rows: the
            # depth psum would otherwise count them n_depth times
            rows = _wf0_tensors(shard, s, grid[s, r, z], dtype).rows0
            p.index_copy_(0, rows, rows0[s, r, z].reshape(-1, cc))
        partial[s, r, z] = p
    if run_wf1:
        if shard.overlap:
            _join_side_streams(grid.flat)
        else:
            halo = _gather_halo(shard, grid, d1, dtype)
        for s, r, z in cells:
            w1 = _wf1_tensors(shard, s * n_z + z, grid[s, r, z], dtype)
            with mesh_lib.on_device(grid[s, r, z]):
                kops.spmm_ell(w1.cols, w1.vals, halo[s, r, z],
                              tails=w1.tails, out=partial[s, r, z][:height],
                              out_rows=w1.rows)
    return _combine(shard, grid,
                    {cell: p[:height] for cell, p in partial.items()},
                    c.device)


def _pad_cols(c: torch.Tensor, n_repl: int):
    """Pad C's trailing dim to a multiple of ``n_repl`` so the replicas
    split it evenly; callers slice the padding back off the output."""
    cc = int(c.shape[1])
    cc_pad = -(-cc // n_repl) * n_repl
    if cc_pad != cc:
        c = F.pad(c, (0, cc_pad - cc))
    return c, cc


def _finish(out: torch.Tensor, c_col: int) -> torch.Tensor:
    return out if out.shape[1] == c_col else out[:, :c_col]


class _PerDevice:
    """One call's copies of an operand piece per (index, device): shards
    that share a device share one copy."""

    def __init__(self, make):
        self._make, self._done = make, {}

    def __call__(self, i: int, device) -> torch.Tensor:
        key = (i, fused_ops.device_key(device))
        x = self._done.get(key)
        if x is None:
            x = self._done[key] = self._make(i, device)
        return x


def _column_slices(shard: ShardedSchedule, c: torch.Tensor) -> _PerDevice:
    """Column replica ``r``'s contiguous slice of C on a device (the
    kernels take contiguous, 16-byte aligned operands)."""
    cc = c.shape[1] // shard.n_repl
    return _PerDevice(lambda r, device: c[:, r * cc:(r + 1) * cc]
                      .contiguous().to(device, non_blocking=True))


def sharded_gemm_spmm(shard: ShardedSchedule, mesh, b: torch.Tensor,
                      c: torch.Tensor) -> torch.Tensor:
    """GeMM-SpMM over the mesh: each row shard's B rows, C's column slice
    per replica, on the GeMM-SpMM wavefront-0 kernel."""
    if b.shape[0] != shard.n_i:
        raise ValueError(f"b has {b.shape[0]} rows, schedule expects "
                         f"{shard.n_i}")
    c, c_col = _pad_cols(c, shard.n_repl)
    n_pad = shard.n_tiles0 * shard.t_pad
    b_pad = F.pad(b, (0, 0, 0, n_pad - b.shape[0]))
    c_slice = _column_slices(shard, c)
    b_block = _PerDevice(lambda s, device: b_pad.index_select(
        0, _row_map(shard, s, b.device)).to(device, non_blocking=True))

    def launch(s, r, device):
        w0 = _wf0_tensors(shard, s, device, c.dtype)
        return kops.tile_fused_gemm_spmm_wf0(
            w0.cols0, w0.vals0, b_block(s, device), c_slice(r, device),
            t=shard.t_pad)
    return _finish(_execute(shard, mesh, c, launch), c_col)


@dataclasses.dataclass
class Op1Tensors:
    """Row shard ``s``'s op-1 hybrid-ELL body on one device."""

    cols: torch.Tensor         # (T0s, t, w1) int32 global rows of C
    vals: torch.Tensor         # (T0s, t, w1) operand dtype


def _op1_tensors(shard: ShardedSchedule, dsched: DeviceSchedule, a1: CSR,
                 s: int, device, dtype) -> Op1Tensors:
    """The shard-ordered op-1 pack (``fused_ops._op1_ell``, memoized on the
    schedule per content) of row shard ``s``; pad tiles are zero ELL."""
    def build():
        o_cols, o_vals = fused_ops._op1_ell(a1, dsched,
                                            width_cap=dsched.width_cap)[:2]
        lo = s * shard.tiles_per_shard
        tiles = shard.tile_map[lo:lo + shard.tiles_per_shard]
        return Op1Tensors(
            cols=_idx(_pad_gather(o_cols, tiles, 0), device, torch.int32),
            vals=_val(_pad_gather(o_vals, tiles, 0), device, dtype))
    key = ("op1", csr_content_digest(a1), dsched.width_cap, s,
           fused_ops.device_key(device), dtype)
    return _memoized(shard, key, build)


def _op1_spill_delta(shard: ShardedSchedule, dsched: DeviceSchedule,
                     a1: CSR, c: torch.Tensor) -> torch.Tensor:
    """The op-1 spill lanes' delta on the tile-padded D1 rows, on ``c``'s
    device (the input ``fused_ops.op1_spill`` gives the single-device
    kernel arm)."""
    def build():
        _, _, flat, cols, vals = fused_ops._op1_ell(
            a1, dsched, width_cap=dsched.width_cap)
        return (_idx(flat, c.device), _idx(cols, c.device),
                _val(vals, c.device, c.dtype))
    key = ("op1-spill", csr_content_digest(a1), dsched.width_cap,
           fused_ops.device_key(c.device), c.dtype)
    flat, cols, vals = _memoized(shard, key, build)
    delta = torch.zeros((shard.n_tiles0 * shard.t_pad, c.shape[1]),
                        dtype=c.dtype, device=c.device)
    return fused_ops._spill_add(delta, flat, cols, vals, c)


def sharded_spmm_spmm(shard: ShardedSchedule, dsched: DeviceSchedule,
                      mesh, a1: CSR, c: torch.Tensor) -> torch.Tensor:
    """SpMM-SpMM over the mesh: each row shard's op-1 hybrid ELL against
    C's column slice per replica, plus its rows of the op-1 spill delta,
    on the SpMM-SpMM wavefront-0 kernel."""
    if a1.n_rows != shard.n_i:
        raise ValueError(f"op-1 has {a1.n_rows} rows, schedule expects "
                         f"{shard.n_i}")
    if c.shape[0] != a1.n_cols:
        raise ValueError(f"c has {c.shape[0]} rows, op-1 has {a1.n_cols} "
                         f"columns")
    c, c_col = _pad_cols(c, shard.n_repl)
    cc = c.shape[1] // shard.n_repl
    c_slice = _column_slices(shard, c)
    delta = _op1_spill_delta(shard, dsched, a1, c)
    delta_rows = _PerDevice(lambda s, device: delta.index_select(
        0, _row_map(shard, s, c.device)))
    delta_block = _PerDevice(lambda i, device: delta_rows(
        i // shard.n_repl, c.device)[:, (i % shard.n_repl) * cc:
                                     (i % shard.n_repl + 1) * cc]
        .contiguous().to(device, non_blocking=True))

    def launch(s, r, device):
        w0 = _wf0_tensors(shard, s, device, c.dtype)
        o1 = _op1_tensors(shard, dsched, a1, s, device, c.dtype)
        return kops.tile_fused_spmm_spmm_wf0(
            o1.cols, o1.vals, delta_block(s * shard.n_repl + r, device),
            w0.cols0, w0.vals0, c_slice(r, device), t=shard.t_pad)
    return _finish(_execute(shard, mesh, c, launch), c_col)
