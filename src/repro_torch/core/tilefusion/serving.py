"""Dynamic-pattern serving tier: bucketed schedule reuse and incremental
inspection for sampled-subgraph request streams.

Twin of ``repro.core.tilefusion.serving``.  The inspector cache in
``api.py`` is content-keyed, and production GNN serving streams
neighbour-sampled subgraphs where every request is a new pattern, so
Algorithm 1 would run O(nnz) on the hot path and the amortization argument
(paper §4.2.3, Fig. 10) would never pay off.  ``ServingTier`` makes
schedules reusable across similar patterns, not just identical ones:

  1. **Bucketed canonicalization.**  Requests are padded (empty trailing
     rows and columns, a no-op in every executor) into a small set of
     ``(rows, cols, width_cap)`` shape buckets of pow2-quantized dims, so
     one cached ``DeviceSchedule`` serves a whole bucket.  The choice is
     priced: ``cost_model.serving_bucket_price`` weighs the padded traffic
     each call pays against the amortized inspection a bucket saves, and
     requests where padding costs more keep their exact shape.

  2. **Incremental inspection.**  When a request differs from the
     bucket's resident pattern in few rows (``csr_dirty_rows``),
     ``incremental_update`` patches the resident schedule instead of
     re-running Algorithm 1: the fusion test (``scheduler.row_extents_for``,
     O(dirty nnz)) and the ELL repack run only for dirty tiles; rows
     entering wavefront 1 land in pad slots reserved by
     ``schedule.pad_device_schedule`` at bucket build, so no array changes
     shape.  A patched schedule keeps the resident tiling, so it can be
     less optimal than a fresh inspection: patch cost is O(dirty), full
     inspection O(nnz).

  3. **Cache integration.**  Entries are published under the bucket key
     (``api.get_schedule`` with ``spec.bucket``, and
     ``api.store_bucket_schedule``): N patterns in one bucket occupy one
     cache slot, and ``schedule_cache_stats()`` counts ``bucket_entries``
     and ``incremental_patches``.

The operands are torch tensors and stay on their device: they are padded
there (``F.pad``) and the product runs through ``api.tile_fused_matmul``,
so on the card a request launches the kernels, or raises, exactly as that
entry point does.  Every patched entry is a new ``DeviceSchedule``, and its
device copies are uploaded at its first call.  The request-batching front
end lives in ``launch/serve.py::SubgraphFrontEnd``.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..sparse.formats import (CSR, csr_content_digest, csr_gather_rows,
                              ell_slot_coords)
from . import api, cost_model, fused_ops
from .schedule import _ell_arrays, pad_device_schedule
from .scheduler import Schedule, Tile, row_extents_for, tile_costs_batch


# --------------------------------------------------------------------------
# Pattern canonicalization
# --------------------------------------------------------------------------
def pad_csr(a: CSR, n_rows: int, n_cols: int) -> CSR:
    """Embed ``a`` in the top-left of an ``(n_rows, n_cols)`` pattern.

    Appended rows are empty (vacuously fusable under the Algorithm-1
    extents sentinel, and a zero row of D in every executor), and appended
    columns are never referenced, so the padded product's leading
    ``a.n_rows`` rows equal the unpadded product exactly."""
    if n_rows < a.n_rows or n_cols < a.n_cols:
        raise ValueError(f"cannot pad ({a.n_rows}, {a.n_cols}) down to "
                         f"({n_rows}, {n_cols})")
    if (n_rows, n_cols) == (a.n_rows, a.n_cols):
        return a
    indptr = np.concatenate(
        [a.indptr, np.full(n_rows - a.n_rows, a.indptr[-1], a.indptr.dtype)])
    return CSR(n_rows, n_cols, indptr.astype(np.int32), a.indices, a.data)


def csr_dirty_rows(old: CSR, new: CSR) -> np.ndarray | None:
    """Rows whose pattern or values differ between two same-shape CSRs
    (None when the shapes differ: no row-level diff exists).

    Rows with different nonzero counts are dirty outright; equal-count
    rows are compared entry by entry through one flat gather per matrix,
    robust to the row-start offsets shifting between the two."""
    if (old.n_rows, old.n_cols) != (new.n_rows, new.n_cols):
        return None
    lo = np.diff(old.indptr)
    ln = np.diff(new.indptr)
    dirty = lo != ln
    same = np.nonzero(~dirty)[0]
    if same.size:
        fo, lens = csr_gather_rows(old, same)
        fn, _ = csr_gather_rows(new, same)
        diff = (old.indices[fo] != new.indices[fn]) \
            | (old.data[fo] != new.data[fn])
        if diff.any():
            row_rep = np.repeat(same, lens)
            dirty[np.unique(row_rep[diff])] = True
    return np.nonzero(dirty)[0].astype(np.int64)


# --------------------------------------------------------------------------
# Incremental inspector
# --------------------------------------------------------------------------
def incremental_update(a_old: CSR, entry: api.ScheduleEntry, a_new: CSR,
                       dirty: np.ndarray, *,
                       cache_size: float) -> api.ScheduleEntry | None:
    """Patch ``entry`` (inspected for ``a_old``) to serve ``a_new`` when
    only ``dirty`` rows differ; None means "rebuild instead".

    The patch re-runs exactly the per-row work Algorithm 1 would redo: the
    fusion test for the dirty rows (one ``row_extents_for`` pass over their
    nonzeros), the tile-local ELL repack for the wavefront-0 tiles they
    touch, and slot surgery in the wavefront-1 arrays: freed slots (row
    index ``n_j``, zero entries) absorb leaving rows, reserved pad slots
    absorb entering ones, so every array keeps its shape.  Leaving rows'
    spill lanes become row-0, value-0 lanes, and entering rows' tails are
    written into the first lanes of value 0, so the lanes are not sorted
    by row: ``fused_ops.wf1_tail_plan`` puts them in the kernel's order.
    Bails to None (full rebuild) when capacity runs out (more entering
    rows than free slots, a row wider than the packed width) or a patched
    tile's Eq-3 cost exceeds ``cache_size``, the budget step 2 enforces,
    and on a sharded or mesh-keyed entry (the patch is single-device)."""
    t0 = time.perf_counter()
    ds = entry.dsched
    sched = entry.sched
    if entry.shard is not None or entry.mesh_key is not None:
        return None
    if entry.reorder_perm is not None:
        # a baked permutation renumbers every row the dirty diff names:
        # patch-by-position would corrupt it (bucket entries never carry
        # one: get_schedule rejects bucket with reorder)
        return None
    if not fused_ops._is_uniform(ds):
        return None
    n_i, n_j, t = sched.n_i, sched.n_j, sched.t
    if (a_new.n_rows, a_new.n_cols) != (n_j, n_i):
        return None
    dirty = np.unique(np.asarray(dirty, dtype=np.int64))
    if dirty.size == 0:
        return entry
    wf0, wf1 = sched.wavefronts

    # ---- fusion test, dirty rows only (Algorithm 1 line 8, sliced) ----
    cand = dirty < min(n_i, n_j)
    rmin, rmax = row_extents_for(a_new, dirty)
    v = dirty // t                      # uniform grid: tile of row j
    tile_lo = v * t
    tile_hi = np.minimum(tile_lo + t, n_i)
    fusable = cand & (rmin >= tile_lo) & (rmax < tile_hi)

    old_fused = np.zeros(n_j, dtype=bool)
    if wf0:
        f_all = np.concatenate([tl.j_rows for tl in wf0])
        if f_all.size:
            old_fused[f_all] = True
    dirty_mask = np.zeros(n_j, dtype=bool)
    dirty_mask[dirty] = True

    # ---- host wavefront 0: rewrite only the affected tiles ----
    aff = np.unique(v[(old_fused[dirty] | fusable) & cand])
    wf0_new = list(wf0)
    for tv in aff:
        tl = wf0[int(tv)]
        keep = tl.j_rows[~dirty_mask[tl.j_rows]]
        add = dirty[fusable & (v == tv)]
        j_new = np.sort(np.concatenate(
            [keep.astype(np.int64), add])).astype(np.int32)
        wf0_new[int(tv)] = Tile(tl.i_start, tl.i_end, j_new)
    if aff.size:
        costs = tile_costs_batch(
            a_new, [wf0_new[int(tv)].i_start for tv in aff],
            [wf0_new[int(tv)].i_end for tv in aff],
            [wf0_new[int(tv)].j_rows for tv in aff],
            entry.b_col, entry.c_col, entry.b_is_sparse,
            width_cap=entry.width_cap)
        if costs.size and float(costs.max()) > cache_size:
            return None                 # patched tile busts the budget

    # ---- host wavefront 1: drop dirty rows, append the entering ones ----
    entering = np.sort(dirty[~fusable]).astype(np.int32)
    wf1_new = []
    for tl in wf1:
        m = dirty_mask[tl.j_rows]
        wf1_new.append(Tile(0, 0, tl.j_rows[~m]) if m.any() else tl)
    if entering.size:
        wf1_new.append(Tile(0, 0, entering))
    wf1_new = [tl for tl in wf1_new if tl.j_rows.size]
    new_sched = Schedule(wavefronts=[wf0_new, wf1_new], n_i=n_i, n_j=n_j,
                         t=t)
    new_sched.validate()

    # ---- device wavefront 0: repack only the affected tiles ----
    j_rows0, cols0, vals0 = ds.j_rows0, ds.ell_cols0, ds.ell_vals0
    if aff.size:
        j0_max = ds.j_rows0.shape[1]
        w0 = ds.ell_cols0.shape[2]
        lists = [wf0_new[int(tv)].j_rows for tv in aff]
        if max(jr.size for jr in lists) > j0_max:
            return None                 # more fused rows than slots
        starts = np.asarray([wf0[int(tv)].i_start for tv in aff], np.int64)
        sub_jr, sub_c, sub_v, _ = _ell_arrays(
            a_new, lists, j0_max, pad_row=n_j, local_start=starts)
        ws = sub_c.shape[2]
        if ws > w0:
            return None                 # a fused row outgrew the ELL width
        j_rows0 = ds.j_rows0.copy()
        cols0 = ds.ell_cols0.copy()
        vals0 = ds.ell_vals0.copy()
        j_rows0[aff] = sub_jr
        cols0[aff] = 0
        vals0[aff] = 0.0
        cols0[aff, :, :ws] = sub_c
        vals0[aff, :, :ws] = sub_v

    # ---- device wavefront 1: slot surgery on the flat view ----
    t1, j1 = ds.j_rows1.shape
    w1 = ds.ell_cols1.shape[2] if ds.ell_cols1.size else 1
    jr1 = ds.j_rows1.reshape(-1).copy()
    c1 = ds.ell_cols1.reshape(-1, w1).copy()
    v1 = ds.ell_vals1.reshape(-1, w1).copy()
    sr = ds.spill_rows1.copy()
    sc = ds.spill_cols1.copy()
    sv = ds.spill_vals1.copy()
    rmask = np.zeros(n_j + 1, dtype=bool)   # index n_j = pad slot, clean
    rmask[dirty] = True
    slot_dirty = rmask[jr1]
    jr1[slot_dirty] = n_j
    c1[slot_dirty] = 0
    v1[slot_dirty] = 0.0
    if sr.size:
        sp_dirty = rmask[sr]
        sr[sp_dirty] = 0
        sc[sp_dirty] = 0
        sv[sp_dirty] = 0.0              # value-0 lanes are no-ops
    if entering.size:
        free = np.nonzero(jr1 == n_j)[0]
        if entering.size > free.size:
            return None                 # headroom exhausted
        slots = free[: entering.size]
        jr1[slots] = entering
        flat, lens = csr_gather_rows(a_new, entering)
        if flat.size:
            row_rep, w_idx = ell_slot_coords(lens)
            body = w_idx < w1
            c1[slots[row_rep[body]], w_idx[body]] = a_new.indices[flat[body]]
            v1[slots[row_rep[body]], w_idx[body]] = a_new.data[flat[body]]
            sp = ~body
            n_sp = int(sp.sum())
            if n_sp:
                # explicit-zero lanes read as free; overwriting one only
                # replaces a zero contribution, so this stays sound
                free_sp = np.nonzero(sv == 0.0)[0]
                if n_sp > free_sp.size:
                    return None         # spill headroom exhausted
                idx = free_sp[:n_sp]
                sr[idx] = entering[row_rep[sp]]
                sc[idx] = a_new.indices[flat[sp]]
                sv[idx] = a_new.data[flat[sp]]

    ds_new = dataclasses.replace(
        ds, j_rows0=j_rows0, ell_cols0=cols0, ell_vals0=vals0,
        j_rows1=jr1.reshape(t1, j1), ell_cols1=c1.reshape(t1, j1, w1),
        ell_vals1=v1.reshape(t1, j1, w1), spill_rows1=sr, spill_cols1=sc,
        spill_vals1=sv)
    tm = ds_new.hbm_traffic_model(entry.b_col, entry.c_col)
    tm["packed_ell_bytes"] = api._packed_ell_bytes(a_new, ds_new,
                                                   entry.b_is_sparse)
    return dataclasses.replace(
        entry, sched=new_sched, dsched=ds_new, traffic_model=tm, hits=0,
        inspector_s=time.perf_counter() - t0,
        content_digest=csr_content_digest(a_new))


# --------------------------------------------------------------------------
# The tier
# --------------------------------------------------------------------------
@dataclasses.dataclass
class _Resident:
    """What a bucket currently serves: the padded pattern, its digest, and
    the (headroom-padded or patched) cache entry."""

    a: CSR
    digest: bytes
    entry: api.ScheduleEntry


class ServingTier:
    """Bucketed and incremental front of ``tile_fused_matmul`` for request
    streams (one instance per served (b_col, c_col) model head).

    ``matmul(a, b_or_a1, c)`` pads the request into its shape bucket,
    resolves the bucket's schedule (exact digest hit → cached entry;
    ≤ ``max_dirty_frac`` rows changed → incremental patch; otherwise a
    full rebuild with wavefront-1 headroom for future patches), and
    dispatches through the ``api`` seam with the ``bucket`` knob.
    ``stats`` / ``hit_rate()`` report how often the O(nnz) inspector was
    avoided."""

    def __init__(self, *, b_col: int, c_col: int, b_is_sparse: bool = False,
                 p: int = 8, cache_size: float = 600_000.0,
                 ct_size: int = 2048, width_cap: int | str | None = "auto",
                 backend: str = "auto", max_dirty_frac: float = 0.05,
                 expected_reuse: float = 8.0, min_bucket_rows: int = 64):
        # the Eq-3 b_col is C's width for SpMM-SpMM (D1 = a1 @ c)
        self.b_col = c_col if b_is_sparse else b_col
        self.c_col = c_col
        self.b_is_sparse = b_is_sparse
        self.p = p
        self.cache_size = cache_size
        self.ct_size = ct_size
        self.width_cap = width_cap
        self.backend = backend
        self.max_dirty_frac = max_dirty_frac
        self.expected_reuse = expected_reuse
        self.min_bucket_rows = min_bucket_rows
        self._residents: dict = {}
        self.stats = {"requests": 0, "exact_hits": 0, "incremental": 0,
                      "rebuilds": 0}

    # -- bucket choice ----------------------------------------------------
    def _quantize(self, n: int) -> int:
        n = max(int(n), self.min_bucket_rows, 1)
        return 1 << (n - 1).bit_length()

    def bucket_for(self, a: CSR) -> tuple:
        """The ``(rows, cols, width_cap)`` bucket serving ``a``: pow2 shape
        quantization when ``serving_bucket_price`` says the padded traffic
        undercuts the amortized inspection, the exact shape when it does
        not (an exact-shape bucket still shares its one cache slot)."""
        cap = api._resolve_width_cap(a, self.width_cap)
        cap_q = None if cap is None else 1 << (max(cap, 1) - 1).bit_length()
        r_pad, c_pad = self._quantize(a.n_rows), self._quantize(a.n_cols)
        price = cost_model.serving_bucket_price(
            n_rows=a.n_rows, n_pad=r_pad, nnz=a.nnz, b_col=self.b_col,
            c_col=self.c_col, expected_reuse=self.expected_reuse)
        if not price["bucketed"]:
            r_pad, c_pad = a.n_rows, a.n_cols
        return (r_pad, c_pad, cap_q)

    def _spec(self, *, width_cap, bucket: tuple | None = None):
        """The tier's ``FusionSpec``: one construction point, so the
        lookup, the bucket publish and the dispatch cut the same key."""
        return api.FusionSpec(p=self.p, cache_size=self.cache_size,
                              ct_size=self.ct_size, uniform_split=True,
                              width_cap=width_cap, bucket=bucket)

    # -- schedule resolution ----------------------------------------------
    def schedule_for(self, a: CSR) -> tuple:
        """Resolve ``(entry, padded_csr, how)`` for a request; ``how`` is
        ``"hit"`` / ``"incremental"`` / ``"rebuild"``."""
        bucket = self.bucket_for(a)
        ap = pad_csr(a, bucket[0], bucket[1])
        digest = csr_content_digest(ap)
        self.stats["requests"] += 1
        res = self._residents.get(bucket)
        if res is not None and res.digest == digest:
            self.stats["exact_hits"] += 1
            entry = api.get_schedule(
                ap, b_col=self.b_col, c_col=self.c_col,
                b_is_sparse=self.b_is_sparse,
                spec=self._spec(width_cap=bucket[2], bucket=bucket))
            return entry, ap, "hit"
        if res is not None:
            dirty = csr_dirty_rows(res.a, ap)
            limit = max(self.max_dirty_frac * ap.n_rows, 1.0)
            if dirty is not None and dirty.size <= limit:
                patched = incremental_update(res.a, res.entry, ap, dirty,
                                             cache_size=self.cache_size)
                if patched is not None:
                    api.store_bucket_schedule(
                        patched, bucket=bucket, patched=True,
                        spec=self._spec(width_cap=bucket[2]))
                    self._residents[bucket] = _Resident(ap, digest, patched)
                    self.stats["incremental"] += 1
                    return patched, ap, "incremental"
        entry = api.get_schedule(
            ap, b_col=self.b_col, c_col=self.c_col,
            b_is_sparse=self.b_is_sparse,
            spec=self._spec(width_cap=bucket[2], bucket=bucket))
        entry = self._with_headroom(ap, entry, bucket)
        self._residents[bucket] = _Resident(ap, digest, entry)
        self.stats["rebuilds"] += 1
        return entry, ap, "rebuild"

    def _with_headroom(self, ap: CSR, entry: api.ScheduleEntry,
                       bucket: tuple) -> api.ScheduleEntry:
        """Reserve wavefront-1 capacity for future patches (row slots for
        ``max_dirty_frac`` of the bucket plus spill lanes for their tails)
        and publish the padded entry under the bucket key."""
        slack = int(np.ceil(self.max_dirty_frac * ap.n_rows)) + 8
        counts = np.diff(ap.indptr)
        avg = float(counts.mean()) if counts.size else 1.0
        spill_slack = slack * int(max(2.0 * avg, 8.0))
        ds = pad_device_schedule(entry.dsched, j1_slots=slack,
                                 spill_slots=spill_slack)
        tm = ds.hbm_traffic_model(entry.b_col, entry.c_col)
        tm["packed_ell_bytes"] = api._packed_ell_bytes(ap, ds,
                                                       entry.b_is_sparse)
        padded = dataclasses.replace(entry, dsched=ds, traffic_model=tm,
                                     content_digest=csr_content_digest(ap))
        return api.store_bucket_schedule(
            padded, bucket=bucket, spec=self._spec(width_cap=bucket[2]))

    # -- the hot path -----------------------------------------------------
    def matmul(self, a: CSR, b_or_a1, c: torch.Tensor) -> torch.Tensor:
        """``D = a @ (b_or_a1 @ c)`` through the bucket's schedule, where
        the tensors live: the operands are zero-padded to the bucket shape
        on their device on the way in, and the result is the view of its
        first ``a.n_rows`` rows."""
        entry, ap, _ = self.schedule_for(a)
        bucket = entry.bucket
        if not isinstance(c, torch.Tensor):
            raise TypeError(f"c must be a torch.Tensor, got "
                            f"{type(c).__name__}")
        if self.b_is_sparse:
            if not isinstance(b_or_a1, CSR):
                raise ValueError("tier built with b_is_sparse=True needs a "
                                 "CSR op-1")
            a1 = b_or_a1
            if (a1.n_rows, a1.n_cols) == (a.n_rows, a.n_cols):
                # self-multiply (D = A(AC)): pad both sides, and C's rows
                op1 = pad_csr(a1, bucket[1], bucket[1])
                cp = F.pad(c, (0, 0, 0, bucket[1] - c.shape[0]))
            else:
                op1 = pad_csr(a1, bucket[1], a1.n_cols)
                cp = c
        else:
            if not isinstance(b_or_a1, torch.Tensor):
                raise TypeError(f"b must be a torch.Tensor, got "
                                f"{type(b_or_a1).__name__}")
            if b_or_a1.shape[1] != self.b_col:
                raise ValueError(f"b has {b_or_a1.shape[1]} columns, tier "
                                 f"serves b_col={self.b_col}")
            op1 = F.pad(b_or_a1, (0, 0, 0, bucket[1] - b_or_a1.shape[0]))
            cp = c
        if cp.shape[1] != self.c_col:
            raise ValueError(f"c has {cp.shape[1]} columns, tier serves "
                             f"c_col={self.c_col}")
        d = api.tile_fused_matmul(
            ap, op1, cp, backend=self.backend,
            spec=self._spec(width_cap=bucket[2], bucket=bucket))
        return d[: a.n_rows]

    def hit_rate(self) -> float:
        """Fraction of requests served without a full Algorithm-1 run
        (exact digest hits plus incremental patches)."""
        served = self.stats["exact_hits"] + self.stats["incremental"]
        return served / max(self.stats["requests"], 1)
