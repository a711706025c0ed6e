"""Unified tile-fusion dispatch of the port — its one fused-matmul entrypoint.

Twin of ``repro.core.tilefusion.api``, forward and backward, on one device
or over a mesh.  ``tile_fused_matmul(a, b_or_a1, c)`` computes ``D = a @
(b_or_a1 @ c)``
(GeMM-SpMM when ``b_or_a1`` is a dense tensor, SpMM-SpMM when it is a
``CSR``) where its tensors live, and owns two decisions:

  1. **Inspector amortization (paper §4.2.3).**  Algorithm 1 runs once per
     (matrix content, shapes, resolved spec) and the ``DeviceSchedule`` is
     memoized in a content-keyed LRU cache (``REPRO_SCHEDULE_CACHE_ENTRIES``
     entries, 128 by default); the device copies of its arrays
     are memoized on it per (device, dtype), so a repeated call neither
     re-inspects nor re-uploads.

  2. **Executor selection (Eq. 3 + capability).**  ``backend="auto"``
     keeps the reference's Eq-3 gates (``MIN_FUSED_RATIO``,
     ``MIN_TRAFFIC_SAVING``): a pattern that fuses too little runs the
     unfused baseline.  Otherwise CPU tensors run the plain PyTorch
     executors (``"torch"``, the twin of ``"xla"``), and CUDA tensors the
     hand-written CUDA kernels (``"cuda"``, the twin of ``"pallas"``) — or
     a raise, where the schedule is not uniform or the card is not one the
     kernels are built for (compute capability 9.0+, ``kernels.config``):
     ``"auto"`` never drops a CUDA tensor to the plain path.  Explicit
     ``backend=`` overrides serve benchmarks and checks; ``"torch"`` is the
     plain path on the card.

The ``"cuda"`` arm is wavefront 0 in one fused kernel, the kernel boundary
as the paper's single barrier, then wavefront 1 (hybrid-ELL body and spill
tails) as one call of the ELL SpMM kernel over the finished D1, written in
place into D.  The unfused arm runs ``B @ C`` as a plain matmul and each
hybrid-ELL product, tails included, through the same ELL kernel on the
card.  The reference's VMEM feasibility check of the
SpMM-SpMM kernel has no counterpart: the CUDA kernel gathers rows of ``C``
from device memory instead of staging all of it.

**Differentiable.**  When grad mode is on and a dense operand requires
grad, the call runs inside a ``torch.autograd.Function`` (one per op
pair) whose backward runs the transposed sparse products through this
same dispatch, off schedule entries cached with ``spec.transpose=True``
(inspected once per (content, shape), like the forward): on the card
they launch the same three kernels.  Calls under
``torch.inference_mode()`` or ``torch.no_grad()`` — the serving path —
dispatch directly and record nothing.

**Tile-size autotuning (``spec.autotune=True``).**  ``get_schedule``
replaces the single inspection with a memoized Eq-3 sweep over
``ct_size`` × ``cache_size`` (``AUTOTUNE_CT_GRID`` ×
``AUTOTUNE_CACHE_SCALES``) and, for a sparse op 1, candidate width caps;
the winner never predicts more traffic than the ``ct_size=2048`` default.
It lives under its own ``"autotune"`` key, beside its candidates.

**Reordering as a schedule transform (``spec.reorder``).**  The pattern
is symmetrically permuted (``reorder.rcm_order`` or
``reorder.similarity_order``; ``"auto"`` tries both and applies the better
only past the Eq-3 floor) before inspection, and the permutation is baked
into the cached entry.  The fused arms permute the row-indexed operand in
(``P·B`` by ``index_select``, ``P·A1`` by ``reorder.permute_rows_cached``)
and the output back out; the unfused arm runs unpermuted.

**Serving buckets (``spec.bucket``).**  The serving tier
(``serving.ServingTier``) keys entries by a ``(rows, cols, width_cap)``
shape bucket instead of content, so every request padded into one bucket
shares one cache slot.  A bucket hit is trusted only when the entry's
``content_digest`` names the request's pattern; a mismatch re-inspects and
replaces the entry under the same key.  The tier publishes headroom-padded
and incrementally patched entries with ``store_bucket_schedule``.  A bucket
is an inference knob: with ``autotune``, ``transpose`` or ``reorder`` it
raises ``ValueError``, and the backward drops it.

**Sharded dispatch (``spec.mesh``).**  A ``models.sharding.Mesh`` of more
than one device keys its own entry (``sharded.mesh_key``: axis names and
shape, with the ``shard_combine`` / ``shard_layout`` / ``overlap`` /
``n_repl`` knobs), which carries the per-shard restructuring of the
mesh-free entry's schedule (``ScheduleEntry.shard``; the mesh-free entry is
inspected once and shared by every mesh).  ``select_backend`` then picks
``"sharded"``: ``sharded.py``'s executors run each shard's wavefront 0 and
wavefront 1 on the same kernels as the ``"cuda"`` arm (their plain versions
for CPU tensors), and the result lands on ``c``'s device.  The backward
keeps the mesh.  Where ``backend="sharded"`` meets an entry without a shard
(a trivial mesh, a non-uniform grid, or the layout pricing's single-device
fallback), it takes the single-device pick for that entry: ``"torch"`` for
CPU tensors, ``"cuda"`` or ``"unfused"`` by Eq 3 for CUDA tensors (the
reference drops to its XLA executor there; the port never runs the plain
path on a CUDA tensor unasked).  A mesh whose device type is not the
operands' raises ``ValueError``.

**Spans** (``repro_torch.tracing``).  ``tile_fusion.call`` covers a call
from entry to return; inside it ``tile_fusion.get_schedule`` (with
``tile_fusion.inspect`` around a miss's build), ``tile_fusion.select_backend``,
``tile_fusion.unfused``, and the kernel arm's ``tile_fusion.pad`` /
``wf0`` / ``scatter`` / ``wf1``.  The Functions' backward is
``tile_fusion.backward``, the GeMM-SpMM's ``dC`` in
``tile_fusion.backward.dc`` and its ``dB`` a nested call.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from ... import tracing
from ...kernels import ops as kops
from ...kernels.config import kernel_library
from ..sparse.formats import (CSR, DEFAULT_WIDTH_QUANTILE,
                               csr_content_digest, hybrid_width_cap)
from ...models import sharding as mesh_lib
from . import cost_model, fused_ops, reorder, sharded
from .schedule import DeviceSchedule, to_device_schedule
from .scheduler import (MESH_LAYOUTS, Schedule, build_schedule,
                        resolve_mesh_layout)
from .spec import (FusionSpec, reset_legacy_warning,  # noqa: F401 (re-export)
                   spec_from_legacy_kwargs)

#: Valid ``backend=`` values for tile_fused_matmul.
BACKENDS = ("auto", "cuda", "torch", "unfused", "sharded")

#: Below this Eq-2 fused ratio the schedule fuses so little that the fused
#: executor's padding/scatter overhead cannot pay for itself — dispatch to
#: the unfused baseline instead (the reference's gate, kept exactly).
MIN_FUSED_RATIO = 0.02

#: Minimum modeled Eq-3 traffic saving the tiled executors must clear (the
#: reference's gate, kept exactly).
MIN_TRAFFIC_SAVING = 0.10

#: The paper's ct_size heuristic (§4: ratio gains saturate past 2048); the
#: autotune sweep is anchored on it — the winner never predicts more Eq-3
#: traffic than this default.
DEFAULT_CT_SIZE = 2048

#: Coarse tile sizes the autotune sweep tries (the caller's ct_size and the
#: 2048 anchor are always added).
AUTOTUNE_CT_GRID = (512, 1024, 2048, 4096)

#: Cache-budget scales the sweep tries per tile size: the full budget and a
#: half budget (step 2 splits earlier, trading padding for locality).
AUTOTUNE_CACHE_SCALES = (1.0, 0.5)

#: Env var capping the schedule cache, the ELL cache and the ordering
#: cache (entries each).
CACHE_ENTRIES_ENV = "REPRO_SCHEDULE_CACHE_ENTRIES"
DEFAULT_CACHE_ENTRIES = 128

# --------------------------------------------------------------------------
# Inspector cache
# --------------------------------------------------------------------------
@dataclasses.dataclass
class ScheduleEntry:
    """One memoized inspection: host schedule + device schedule + metadata."""

    sched: Schedule
    dsched: DeviceSchedule
    b_col: int
    c_col: int
    b_is_sparse: bool
    inspector_s: float          # wall time of the one build (not per call)
    #: Eq-3-derived traffic prediction, computed once at build
    #: (select_backend reads it on every "auto" call)
    traffic_model: dict = dataclasses.field(default_factory=dict)
    hits: int = 0               # cache hits since the build
    #: set on autotune winners: the (ct_size, cache_size, width_cap) the
    #: sweep picked
    autotuned: tuple | None = None
    #: resolved hybrid-ELL width cap the schedule was packed with (None =
    #: pad-to-max); part of the cache key
    width_cap: int | None = None
    #: True when this entry was inspected on ``a.transpose()`` — the
    #: backward pass's schedule, keyed by the *forward* matrix's digest plus
    #: this bit, so forward and backward entries live side by side
    transpose: bool = False
    #: itemsize of the dense operand the entry prices traffic for; part of
    #: the cache key
    dtype_bytes: int = 4
    #: reorder transform baked into the schedule ("rcm" | "similarity";
    #: None = identity ordering, also for ``reorder="auto"`` builds where
    #: no candidate cleared the Eq-3 floor)
    reorder: str | None = None
    #: the symmetric permutation the schedule was inspected under
    #: (``perm[new] = old``) and its inverse; dispatch permutes the dense
    #: operands in and the output back out
    reorder_perm: np.ndarray | None = None
    reorder_inv: np.ndarray | None = None
    #: device copies of (perm, inv) as int64 index tensors, per device
    perm_tensors: dict = dataclasses.field(default_factory=dict, repr=False)
    #: content digest of the matrix this entry was inspected (or patched)
    #: for.  Bucket-keyed entries are looked up by shape bucket, not
    #: content, so ``get_schedule`` checks it against the request before
    #: trusting a hit
    content_digest: bytes | None = None
    #: the ``(rows, cols, width_cap)`` shape bucket this entry serves
    #: (``serving.ServingTier``), None for plain content-keyed entries
    bucket: tuple | None = None
    #: ``sharded.mesh_key`` of the mesh this entry was built for (None for
    #: single-device entries); part of the cache key
    mesh_key: tuple | None = None
    #: the per-shard restructuring (``sharded.ShardedSchedule``) when the
    #: entry was built for a non-trivial mesh and the grid is uniform; None
    #: means the dispatch runs on one device
    shard: object = None


_schedule_cache: "collections.OrderedDict" = collections.OrderedDict()
_ell_cache: "collections.OrderedDict" = collections.OrderedDict()
#: (content, ordering name) -> (perm, permuted CSR), under ``_lock``
_ordering_cache: "collections.OrderedDict" = collections.OrderedDict()
_stats = {"hits": 0, "misses": 0, "evictions": 0, "ell_evictions": 0,
          "ordering_evictions": 0, "autotune_sweeps": 0,
          "incremental_patches": 0, "inspect_s": 0.0}
_lock = threading.Lock()
#: The ELL cache has its own lock so a full-matrix pack never stalls
#: schedule-cache hits.  Lock order where both are held: _lock, _ell_lock.
_ell_lock = threading.Lock()


def _cache_budget() -> int:
    """Per-cache entry cap from ``REPRO_SCHEDULE_CACHE_ENTRIES`` (>= 1)."""
    raw = os.environ.get(CACHE_ENTRIES_ENV, "")
    try:
        return max(int(raw), 1)
    except ValueError:
        return DEFAULT_CACHE_ENTRIES


def _cache_get(cache, key):
    """LRU lookup; caller holds the cache's lock."""
    value = cache.get(key)
    if value is not None:
        cache.move_to_end(key)
    return value


def _cache_put(cache, key, value, evict_key: str = "evictions") -> None:
    """LRU insert with oldest-first eviction; caller holds the cache's lock."""
    cache[key] = value
    cache.move_to_end(key)
    budget = _cache_budget()
    while len(cache) > budget:
        cache.popitem(last=False)
        _stats[evict_key] += 1


def _coerce_spec(spec, legacy: dict, caller: str) -> FusionSpec:
    """Resolve the ``spec= | **legacy-kwargs`` surface to one FusionSpec.

    Mixing both raises (two sources of truth for one knob is exactly the
    bug class the spec removes); bare calls get the default spec."""
    if legacy:
        if spec is not None:
            raise TypeError(
                f"{caller}() got both spec= and legacy keyword(s) "
                f"{sorted(legacy)}; put every knob on the FusionSpec")
        return spec_from_legacy_kwargs(legacy, caller=caller)
    if spec is None:
        return FusionSpec()
    if not isinstance(spec, FusionSpec):
        raise TypeError(f"{caller}() spec= expects a FusionSpec, got "
                        f"{type(spec).__name__}")
    return spec


def _check_mesh(spec: FusionSpec, device=None) -> None:
    """``spec.mesh`` must be None or a ``models.sharding.Mesh``; with
    ``device``, of that device's type."""
    mesh = spec.mesh
    if mesh is None:
        return
    if not isinstance(mesh, mesh_lib.Mesh):
        raise TypeError(f"FusionSpec.mesh expects a "
                        f"repro_torch.models.sharding.Mesh, got "
                        f"{type(mesh).__name__}")
    if device is not None and mesh.device_type != torch.device(device).type:
        raise ValueError(f"the mesh holds {mesh.device_type} devices and the "
                         f"operands live on {torch.device(device)}")


def _shard_for_mesh(a: CSR, sched, dsched, mk: tuple, *, b_col: int,
                    c_col: int, b_is_sparse: bool, width_cap,
                    shard_combine: str, shard_layout: str,
                    dtype_bytes: int = 4, overlap="auto",
                    n_repl: int | None = None, serial_bytes: float = 0.0):
    """Mesh-shape-aware shard build (the reference's, unchanged): resolve
    how the mesh's axes are used (1d row shards, 1.5d row × column
    replica, 2.5d row × replica × depth) and which output combine runs,
    then build the per-shard schedule.

    ``shard_layout="auto"`` consults ``cost_model.choose_mesh_layout``,
    which ranks every layout's per-device critical-path bytes plus the
    serial compute split over the row shards against the operand bytes
    replication copies; when its winner is the single-device fallback the
    entry carries ``shard=None``.  ``n_repl`` restricts the candidates to
    layouts whose replication (column replicas × depth) matches, or
    validates an explicit layout.  ``shard_combine="auto"`` defers to
    ``shard_comm_model``'s psum-vs-reduce-scatter pricing in the
    builder."""
    shape = mk[1]
    layout = shard_layout
    # wf0's Eq-3 share bounds the overlap window the chooser prices; the
    # builder re-resolves "auto" overlap with its exact per-tile costs
    wf0_bytes = float(serial_bytes) * float(getattr(sched, "fused_ratio",
                                                    0.0))
    if layout == "auto":
        operand_bytes = (
            float(a.nnz) * (dtype_bytes + cost_model.INDEX_BYTES)
            + float(dsched.n_i * b_col) * dtype_bytes)
        choice = cost_model.choose_mesh_layout(
            shape, halo_rows=int(dsched.wf1_dep_rows().shape[0]),
            n_i=dsched.n_i, n_j=dsched.n_j, c_col=c_col,
            operand_bytes=operand_bytes, dtype_bytes=dtype_bytes,
            serial_bytes=float(serial_bytes), overlap=overlap,
            wf0_bytes=wf0_bytes)
        if n_repl is not None:
            cands = {k: v for k, v in choice["candidates"].items()
                     if k != "fallback"
                     and v["n_repl"] * v["n_depth"] == int(n_repl)}
            if not cands:
                raise ValueError(
                    f"n_repl={n_repl} is unsatisfiable on mesh shape "
                    f"{shape}: no layout replicates the operands "
                    f"{n_repl}x")
            rank = ("total_per_device" if serial_bytes > 0.0
                    else "total_bytes")
            layout = min(cands, key=lambda k: cands[k][rank])
        else:
            layout = choice["layout"]
        if layout == "fallback":
            return None
    else:
        _, nr, nd = resolve_mesh_layout(shape, layout)
        if n_repl is not None and nr * nd != int(n_repl):
            raise ValueError(
                f"n_repl={n_repl} does not match layout {layout!r} on "
                f"mesh shape {shape} (resolves to {nr}x{nd} replicas)")
    return sharded.build_sharded_schedule(
        a, sched, dsched, shape, b_col=b_col, c_col=c_col,
        b_is_sparse=b_is_sparse, width_cap=width_cap, layout=layout,
        combine=shard_combine, dtype_bytes=dtype_bytes, overlap=overlap)


def _shard_knobs_key(mk: tuple | None, shard_combine: str,
                     shard_layout: str) -> tuple:
    """Validated cache-key part of the sharding knobs: a typo'd knob fails
    loudly, and on a trivial mesh the pair collapses to (None, None) so
    ``mesh=None`` and a one-device mesh share entries whatever the (then
    inert) knobs say."""
    if shard_combine not in sharded.COMBINE_MODES + ("auto",):
        raise ValueError(
            f"shard_combine={shard_combine!r}; expected one of "
            f"{sharded.COMBINE_MODES + ('auto',)}")
    if shard_layout not in MESH_LAYOUTS + ("auto",):
        raise ValueError(f"shard_layout={shard_layout!r}; expected one of "
                         f"{MESH_LAYOUTS + ('auto',)}")
    if mk is None:
        return (None, None)
    return (str(shard_combine), str(shard_layout))


def _check_bucket(spec: FusionSpec, mk) -> None:
    """Raise for the knobs a serving bucket does not compose with."""
    if spec.autotune:
        raise ValueError("bucket= does not compose with autotune=True (the "
                         "sweep is per-content; bucket entries are "
                         "shape-keyed)")
    if mk is not None:
        raise ValueError("bucket= is single-device; pass a trivial mesh or "
                         "none")
    if spec.transpose:
        raise ValueError("bucket= is a serving (inference) knob; it does "
                         "not compose with transpose=True")
    if spec.reorder is not None:
        raise ValueError("bucket= does not compose with reorder= — the "
                         "incremental inspector patches by row position, "
                         "which a baked permutation would silently "
                         "invalidate")


def _resolve_width_cap(a: CSR, width_cap) -> int | None:
    """Resolve the ``width_cap`` knob to a concrete cap (the cache key):
    ``"auto"`` is the traffic-optimal cap of the matrix's degrees (memoized
    per CSR instance), ``None`` pad-to-max, an int is clamped to >= 1."""
    if width_cap is None:
        return None
    if width_cap == "auto":
        cap = getattr(a, "_auto_width_cap", None)
        if cap is None:
            cap = hybrid_width_cap(np.diff(a.indptr))
            object.__setattr__(a, "_auto_width_cap", cap)
        return cap
    return max(int(width_cap), 1)


def _spec_key(spec: FusionSpec, *, cap, mk=None, sk=(None, None)) -> tuple:
    """The resolved-spec cache-key tail (``spec.dtype_bytes`` resolved),
    shared by every key site (content key, ``"autotune"`` key, bucket
    publish).  ``cap`` / ``mk`` / ``sk`` are the resolved width cap, mesh
    key and shard-knob pair; on a trivial mesh the ``overlap`` and
    ``n_repl`` knobs are inert and collapse to None, so such entries are
    the ``mesh=None`` ones."""
    if mk is None:
        ov, nr = None, None
    else:
        ov = spec.overlap
        nr = None if spec.n_repl is None else int(spec.n_repl)
    return (int(spec.p), float(spec.cache_size), int(spec.ct_size),
            bool(spec.uniform_split), cap, mk, sk, ov, nr,
            bool(spec.transpose), int(spec.dtype_bytes), spec.reorder)


def _candidate_width_caps(a: CSR, caller_cap: int | None) -> list:
    """Caps the autotune sweep tries: the caller's, the traffic-optimal,
    the high-quantile, and pad-to-max (as an explicit max-degree cap)."""
    counts = np.diff(a.indptr)
    w_max = max(int(counts.max()), 1) if counts.size else 1
    caps = {w_max if caller_cap is None else caller_cap,
            hybrid_width_cap(counts),
            hybrid_width_cap(counts, DEFAULT_WIDTH_QUANTILE),
            w_max}
    return sorted(caps)


def _packed_ell_bytes(a: CSR, dsched: DeviceSchedule, b_is_sparse: bool,
                      dtype_bytes: int = 4) -> float:
    """Bytes the executors stream for the packed sparse operands: the
    wavefront-1 hybrid body (col+val per slot, padding included) plus 3
    elements per spill lane, and — for SpMM-SpMM — the op-1 hybrid at the
    schedule's cap.  This is the term the width cap moves (Eq-3 traffic is
    cap-invariant), so the autotune sweep scores with it.  Value slots are
    priced at the operand itemsize, index slots at ``INDEX_BYTES``."""
    vals = float(dsched.ell_cols1.size + dsched.spill_rows1.size)
    idx = float(dsched.ell_cols1.size
                + (cost_model.SPILL_ELEMENTS - 1) * dsched.spill_rows1.size)
    if b_is_sparse:
        # a.n_cols = no-cap sentinel: no row can be wider
        w = cost_model._capped_body_width(
            a, dsched.width_cap if dsched.width_cap is not None
            else max(a.n_cols, 1))
        spill = int(cost_model._spill_cumsum(a, w)[-1])
        vals += float(a.n_rows * w + spill)
        idx += float(a.n_rows * w + (cost_model.SPILL_ELEMENTS - 1) * spill)
    return vals * dtype_bytes + idx * cost_model.INDEX_BYTES


def get_schedule(a: CSR, *, b_col: int, c_col: int,
                 b_is_sparse: bool = False,
                 spec: FusionSpec | None = None, **legacy) -> ScheduleEntry:
    """Run Algorithm 1 once per (content, shapes, resolved spec) and
    memoize; later calls with the same key return the cached entry.
    ``spec.dtype_bytes=None`` defaults to 4 here (``tile_fused_matmul``
    infers it from the operands before it gets here).

    ``spec.transpose=True`` inspects ``a.transpose()`` instead — the
    backward pass's schedule — with the width cap resolved on the
    transpose (its row degrees are ``a``'s column degrees).  The key stays
    on ``a``'s digest plus the transpose bit; ``b_col`` / ``c_col`` are
    the transposed product's, which the caller passes already swapped.

    ``spec.autotune=True`` replaces the single inspection with the
    memoized sweep of ``_autotune_schedule``; the spec's own ``ct_size``,
    ``cache_size`` and ``width_cap`` then seed the candidate grid.

    ``spec.reorder`` permutes the pattern (of ``a.transpose()`` under the
    transpose bit) before inspection, priced by ``_priced_reorder``; an
    applied permutation is baked into the entry (``reorder``,
    ``reorder_perm``, ``reorder_inv``).  ``"auto"`` skips rectangular
    patterns; a forced ordering raises on them.  The knob is in the key.

    ``spec.bucket`` (the serving tier's knob) keys the entry by the shape
    bucket instead of the content: a hit is trusted only when the entry's
    ``content_digest`` matches the request, and a mismatch re-inspects and
    replaces the entry under the same key, so N patterns in one bucket
    hold one entry.  It raises ``ValueError`` with ``autotune``, a
    non-trivial mesh, ``transpose`` or ``reorder``.

    ``spec.mesh`` (a ``models.sharding.Mesh`` of more than one device)
    keys a mesh entry by ``sharded.mesh_key`` and the sharding knobs; it
    shards the mesh-free entry of the same spec (``_mesh_schedule``).  A
    trivial mesh keys exactly like no mesh.

    ``**legacy`` is the historical keyword surface (``p=``, ``ct_size=``,
    ...): a deprecation shim that builds the spec and warns once per
    process (``spec.spec_from_legacy_kwargs``)."""
    with tracing.span("tile_fusion.get_schedule"):
        spec = _coerce_spec(spec, legacy, "get_schedule")
        _check_mesh(spec)
        spec = dataclasses.replace(
            spec, dtype_bytes=4 if spec.dtype_bytes is None
            else int(spec.dtype_bytes))
        mk = sharded.mesh_key(spec.mesh)
        sk = _shard_knobs_key(mk, spec.shard_combine, spec.shard_layout)
        bucket = spec.bucket
        if bucket is not None:
            _check_bucket(spec, mk)
        a_eff = a.transpose() if spec.transpose else a
        cap = _resolve_width_cap(a_eff, spec.width_cap)
        if mk is not None:
            return _mesh_schedule(a, b_col=b_col, c_col=c_col,
                                  b_is_sparse=b_is_sparse, spec=spec,
                                  cap=cap, mk=mk, sk=sk)
        if spec.autotune:
            return _autotune_schedule(a, b_col=b_col, c_col=c_col,
                                      b_is_sparse=b_is_sparse, spec=spec,
                                      cap=cap)
        digest = csr_content_digest(a)
        keybase = ("bucket", bucket) if bucket is not None else digest
        key = (keybase, b_col, c_col, b_is_sparse, _spec_key(spec, cap=cap))
        with _lock:
            entry = _cache_get(_schedule_cache, key)
            if entry is not None and (bucket is None
                                      or entry.content_digest == digest):
                entry.hits += 1
                _stats["hits"] += 1
                return entry
        with tracing.span("tile_fusion.inspect"):
            entry = _inspect(a_eff, b_col=b_col, c_col=c_col,
                             b_is_sparse=b_is_sparse, spec=spec, cap=cap)
        entry.content_digest, entry.bucket = digest, bucket
        with _lock:
            _stats["misses"] += 1
            _stats["inspect_s"] += entry.inspector_s
            _cache_put(_schedule_cache, key, entry)
        return entry


def _inspect(a_eff: CSR, *, b_col: int, c_col: int, b_is_sparse: bool,
             spec: FusionSpec, cap) -> ScheduleEntry:
    """Algorithm 1 on ``a_eff`` (the transpose under ``spec.transpose``),
    with ``spec.reorder``'s priced permutation and the traffic model: a
    new entry, ``inspector_s`` its wall time."""
    t0 = time.perf_counter()
    sched = build_schedule(a_eff, b_col=b_col, c_col=c_col, p=spec.p,
                           cache_size=spec.cache_size, ct_size=spec.ct_size,
                           b_is_sparse=b_is_sparse,
                           uniform_split=spec.uniform_split, width_cap=cap)
    dsched = to_device_schedule(a_eff, sched, width_cap=cap)
    tm = dsched.hbm_traffic_model(b_col, c_col, dtype_bytes=spec.dtype_bytes)
    a_sched = a_eff
    applied = perm = inv = None
    if spec.reorder is not None:
        picked = _priced_reorder(a_eff, spec, cap=cap, b_col=b_col,
                                 c_col=c_col, b_is_sparse=b_is_sparse,
                                 base_tm=tm)
        if picked is not None:
            applied, perm, inv, a_sched, sched, dsched, tm = picked
    tm["packed_ell_bytes"] = _packed_ell_bytes(a_sched, dsched, b_is_sparse,
                                               spec.dtype_bytes)
    return ScheduleEntry(sched=sched, dsched=dsched, b_col=b_col,
                         c_col=c_col, b_is_sparse=b_is_sparse,
                         inspector_s=time.perf_counter() - t0,
                         traffic_model=tm, width_cap=cap,
                         transpose=spec.transpose,
                         dtype_bytes=spec.dtype_bytes, reorder=applied,
                         reorder_perm=perm, reorder_inv=inv)


def _mesh_schedule(a: CSR, *, b_col: int, c_col: int, b_is_sparse: bool,
                   spec: FusionSpec, cap, mk: tuple,
                   sk: tuple) -> ScheduleEntry:
    """The entry of a non-trivial mesh: the mesh-free entry of the same
    spec (Algorithm 1 run once, its reorder or autotune winner included,
    and shared by every mesh shape and knob) with the per-shard
    restructuring of ``_shard_for_mesh`` added.  A reordered schedule is
    sharded on the permuted matrix it was inspected under.  The key is the
    content key (``"autotune"``-prefixed under ``spec.autotune``) with the
    mesh key and shard knobs in its tail; building the entry counts as a
    miss, and ``inspector_s`` adds the shard build to the inspection's
    (``inspect_s`` counts the shard build alone: the base's is counted
    where the base is built)."""
    prefix = ("autotune",) if spec.autotune else ()
    key = prefix + (csr_content_digest(a), b_col, c_col, b_is_sparse,
                    _spec_key(spec, cap=cap, mk=mk, sk=sk))
    with _lock:
        entry = _cache_get(_schedule_cache, key)
        if entry is not None:
            entry.hits += 1
            _stats["hits"] += 1
            return entry
    base = get_schedule(a, b_col=b_col, c_col=c_col, b_is_sparse=b_is_sparse,
                        spec=dataclasses.replace(spec, mesh=None))
    with tracing.span("tile_fusion.inspect"):
        t0 = time.perf_counter()
        a_eff = a.transpose() if spec.transpose else a
        a_sched = (_ordering(a_eff, base.reorder)[1]
                   if base.reorder is not None else a_eff)
        shard = _shard_for_mesh(
            a_sched, base.sched, base.dsched, mk, b_col=b_col, c_col=c_col,
            b_is_sparse=b_is_sparse, width_cap=base.width_cap,
            shard_combine=sk[0], shard_layout=sk[1],
            dtype_bytes=spec.dtype_bytes, overlap=spec.overlap,
            n_repl=spec.n_repl,
            serial_bytes=base.traffic_model["fused_bytes"])
        tm = dict(base.traffic_model)
        if shard is not None:
            tm["sharded"] = shard.comm_model
        shard_s = time.perf_counter() - t0
    entry = dataclasses.replace(
        base, hits=0, mesh_key=mk, shard=shard, traffic_model=tm,
        inspector_s=base.inspector_s + shard_s)
    with _lock:
        _stats["misses"] += 1
        _stats["inspect_s"] += shard_s
        _cache_put(_schedule_cache, key, entry)
    return entry


def store_bucket_schedule(entry: ScheduleEntry, *, bucket: tuple,
                          patched: bool = False,
                          spec: FusionSpec | None = None,
                          **legacy) -> ScheduleEntry:
    """Publish a serving-tier entry (headroom-padded at bucket build, or
    patched by the incremental inspector) under its bucket cache key,
    replacing whatever the bucket held.

    The key is cut by the same ``_spec_key`` that ``get_schedule`` uses
    (bucket keybase, the entry's own resolved width cap, transpose and
    reorder forced off: buckets are inference-only), so the next
    ``tile_fused_matmul(..., spec=...bucket...)`` dispatch finds this
    entry; ``entry.content_digest`` must already name the pattern it
    serves.  ``patched=True`` counts the publish as an incremental patch
    in ``schedule_cache_stats()``."""
    if entry.content_digest is None:
        raise ValueError("bucket entries need content_digest set")
    spec = _coerce_spec(spec, legacy, "store_bucket_schedule")
    spec = dataclasses.replace(
        spec, mesh=None, transpose=False, reorder=None,
        dtype_bytes=4 if spec.dtype_bytes is None else int(spec.dtype_bytes))
    key = (("bucket", tuple(bucket)), entry.b_col, entry.c_col,
           entry.b_is_sparse, _spec_key(spec, cap=entry.width_cap))
    entry.bucket = tuple(bucket)
    with _lock:
        if patched:
            _stats["incremental_patches"] += 1
        _cache_put(_schedule_cache, key, entry)
    return entry


def _ordering(a: CSR, name: str) -> tuple:
    """``(perm, P·A·Pᵀ)`` of candidate ordering ``name`` ("rcm" |
    "similarity") of square ``a``, memoized per (content, name) in an LRU
    beside the schedule cache: the two op pairs, both layer shapes, every
    autotune candidate and a symmetric matrix's transpose entry share one
    ordering (RCM is a host BFS)."""
    key = (csr_content_digest(a), name)
    with _lock:
        hit = _cache_get(_ordering_cache, key)
    if hit is None:
        fn = reorder.rcm_order if name == "rcm" else reorder.similarity_order
        perm = fn(a)
        hit = (perm, reorder.permute_csr(a, perm))
        with _lock:
            _cache_put(_ordering_cache, key, hit,
                       evict_key="ordering_evictions")
    return hit


def _priced_reorder(a_eff: CSR, spec: FusionSpec, *, cap, b_col: int,
                    c_col: int, b_is_sparse: bool, base_tm: dict):
    """Resolve ``spec.reorder`` into an applied schedule transform.

    Builds a full candidate schedule per ordering (RCM or the similarity
    grouping; ``"auto"`` tries both) on the symmetrically permuted pattern
    and prices it with the same Eq-3 model as the dispatch floor.  A forced
    ordering always applies; ``"auto"`` applies the best candidate only
    when its modeled fused traffic beats the identity ordering by
    ``MIN_TRAFFIC_SAVING`` (``cost_model.reorder_gain``), so it never
    raises modeled traffic.  Returns ``(name, perm, inv, a_perm, sched,
    dsched, tm)`` or None for the identity.  ``"auto"`` skips a
    rectangular pattern; a forced ordering raises on one."""
    if a_eff.n_rows != a_eff.n_cols:
        if spec.reorder == "auto":
            return None
        raise ValueError(
            f"reorder={spec.reorder!r} needs a square matrix (symmetric "
            f"permutation P·A·Pᵀ); got ({a_eff.n_rows}, {a_eff.n_cols}). "
            f"Use reorder='auto' to skip rectangular patterns.")
    names = (("rcm", "similarity") if spec.reorder == "auto"
             else (spec.reorder,))
    best = None
    for name in names:
        cand_perm, a_p = _ordering(a_eff, name)
        sched_p = build_schedule(a_p, b_col=b_col, c_col=c_col, p=spec.p,
                                 cache_size=spec.cache_size,
                                 ct_size=spec.ct_size,
                                 b_is_sparse=b_is_sparse,
                                 uniform_split=spec.uniform_split,
                                 width_cap=cap)
        dsched_p = to_device_schedule(a_p, sched_p, width_cap=cap)
        tm_p = dsched_p.hbm_traffic_model(b_col, c_col,
                                          dtype_bytes=spec.dtype_bytes)
        if best is None or tm_p["fused_bytes"] < best[5]["fused_bytes"]:
            best = (name, cand_perm, a_p, sched_p, dsched_p, tm_p)
    name, cand_perm, a_p, sched_p, dsched_p, tm_p = best
    if (spec.reorder == "auto"
            and cost_model.reorder_gain(base_tm, tm_p) < MIN_TRAFFIC_SAVING):
        return None
    inv = np.empty_like(cand_perm)
    inv[cand_perm] = np.arange(cand_perm.shape[0])
    return name, cand_perm, inv, a_p, sched_p, dsched_p, tm_p


def _autotune_schedule(a: CSR, *, b_col: int, c_col: int,
                       b_is_sparse: bool, spec: FusionSpec,
                       cap: int | None) -> ScheduleEntry:
    """Eq-3 tile-size × width-cap sweep, memoized under its own entry.

    Candidates: (``AUTOTUNE_CT_GRID`` ∪ {spec.ct_size, 2048}) ×
    ``AUTOTUNE_CACHE_SCALES`` × candidate width caps (for a sparse op 1
    only: with a dense B every cap gives the same host schedule), each one
    ``get_schedule`` entry.  Ranking: Eq-3 fused traffic scaled by the
    schedule's padded-FLOPs overhead, plus the packed-ELL bytes the cap
    moves; only candidates whose traffic does not exceed the default
    ``ct_size=2048`` schedule's at the caller's cap are eligible, and that
    anchor is one of them, so the sweep never regresses the paper's
    heuristic.  The winner is a copy of its candidate with ``autotuned``
    set and the whole sweep's seconds as ``inspector_s``, published under
    the ``"autotune"`` key prefix (first publish wins; ``autotune_sweeps``
    counts publishes)."""
    cache_size = spec.cache_size
    key = ("autotune", csr_content_digest(a), b_col, c_col, b_is_sparse,
           _spec_key(spec, cap=cap))
    with _lock:
        entry = _cache_get(_schedule_cache, key)
        if entry is not None:
            entry.hits += 1
            _stats["hits"] += 1
            return entry
    t0 = time.perf_counter()
    a_eff = a.transpose() if spec.transpose else a
    cts = sorted(set(AUTOTUNE_CT_GRID) | {spec.ct_size, DEFAULT_CT_SIZE})
    if cap is None:
        # pad-to-max resolves to the max-degree cap so keys stay concrete
        counts = np.diff(a_eff.indptr)
        anchor_cap = max(int(counts.max()), 1) if counts.size else 1
    else:
        anchor_cap = cap
    caps = (_candidate_width_caps(a_eff, cap) if b_is_sparse
            else [anchor_cap])
    candidates = {}
    for ct in cts:
        for scale in AUTOTUNE_CACHE_SCALES:
            for cand_cap in caps:
                cand_spec = dataclasses.replace(
                    spec, autotune=False, cache_size=cache_size * scale,
                    ct_size=ct, width_cap=cand_cap, mesh=None)
                candidates[(ct, cache_size * scale, cand_cap)] = \
                    get_schedule(a, b_col=b_col, c_col=c_col,
                                 b_is_sparse=b_is_sparse, spec=cand_spec)

    def traffic(e: ScheduleEntry) -> float:
        return e.traffic_model["fused_bytes"]

    def score(e: ScheduleEntry) -> float:
        return (traffic(e)
                * (1.0 + e.dsched.padded_flops_overhead(b_col, c_col))
                + e.traffic_model["packed_ell_bytes"])

    anchor = candidates[(DEFAULT_CT_SIZE, cache_size, anchor_cap)]
    eligible = {k: e for k, e in candidates.items()
                if traffic(e) <= traffic(anchor)}
    best_key = min(eligible, key=lambda k: score(eligible[k]))
    best = dataclasses.replace(eligible[best_key], hits=0,
                               autotuned=best_key,
                               inspector_s=time.perf_counter() - t0)
    with _lock:
        # first-wins publish: a concurrent sweep on the same key may have
        # finished while this one ran (its candidates were memoized, so
        # the duplicate work is bounded); only the published sweep counts
        existing = _cache_get(_schedule_cache, key)
        if existing is not None:
            existing.hits += 1
            _stats["hits"] += 1
            return existing
        _stats["autotune_sweeps"] += 1
        _cache_put(_schedule_cache, key, best)
    return best


def _csr_ell(a: CSR, width_cap: int | None, device,
             dtype) -> fused_ops.HybridTensors:
    """Full-matrix hybrid ELL of ``a`` on ``device`` (the unfused arm's
    format), memoized per (content, cap); its device copies, with the
    kernel's tail plan, per (device, dtype) beside it.  Check-and-build
    happens under one lock hold."""
    key = (csr_content_digest(a), width_cap)
    with _ell_lock:
        hit = _cache_get(_ell_cache, key)
        if hit is None:
            hit = (fused_ops.csr_to_ell(a, width_cap=width_cap), {})
            _cache_put(_ell_cache, key, hit, evict_key="ell_evictions")
        hell, on_device = hit
        dkey = (fused_ops.device_key(device), dtype)
        tensors = on_device.get(dkey)
        if tensors is None:
            tensors = on_device[dkey] = fused_ops.HybridTensors.upload(
                hell, device, dtype)
    return tensors


def clear_schedule_cache() -> None:
    with _lock, _ell_lock:
        _schedule_cache.clear()
        _ell_cache.clear()
        _ordering_cache.clear()
        for k in _stats:
            _stats[k] = 0
    # re-arm the once-per-process legacy-kwargs deprecation warning so
    # warning tests stay order-independent across the suite
    reset_legacy_warning()


def schedule_cache_stats() -> dict:
    """Counters plus live entry counts of both caches; ``spec_entries``
    counts the distinct resolved-spec key tails among live entries,
    ``transpose_entries`` the live backward-pass (``transpose=True``)
    schedules (one per (graph, shape) when the transpose cache amortizes),
    ``reorder_entries`` the live entries with a permutation baked in,
    ``bucket_entries`` the live shape-bucket entries of the serving tier
    (N patterns in K buckets hold it at K), ``autotune_sweeps`` the sweeps
    published and ``incremental_patches`` the patched bucket entries
    published.  ``inspect_s`` sums the seconds of every build counted as a
    miss (each entry's ``inspector_s``; a mesh entry's shard build alone,
    its base being counted where it is built).  ``mesh_entries`` counts
    the live entries built for a non-trivial mesh, by the layout the
    dispatch resolved: ``layout_1d``
    (row shards), ``layout_15d`` (column replicas too), ``layout_25d``
    (depth layers too) and ``layout_fallback`` (mesh-keyed entries that run
    on one device: a non-uniform grid, or a layout priced worse than
    serial)."""
    with _lock, _ell_lock:
        entries = list(_schedule_cache.values())
        meshed = [e for e in entries if e.mesh_key is not None]
        layouts = [e.shard.layout if e.shard is not None else "fallback"
                   for e in meshed]
        return dict(_stats, entries=len(_schedule_cache),
                    ell_entries=len(_ell_cache),
                    spec_entries=len({k[-1] for k in _schedule_cache}),
                    bucket_entries=sum(e.bucket is not None
                                       for e in entries),
                    transpose_entries=sum(e.transpose for e in entries),
                    reorder_entries=sum(e.reorder is not None
                                        for e in entries),
                    mesh_entries=len(meshed),
                    layout_1d=layouts.count("1d"),
                    layout_15d=layouts.count("1.5d"),
                    layout_25d=layouts.count("2.5d"),
                    layout_fallback=layouts.count("fallback"))


# --------------------------------------------------------------------------
# Backend selection (Eq-3 cost model + capability)
# --------------------------------------------------------------------------
def select_backend(entry: ScheduleEntry, device) -> str:
    """Resolve ``backend="auto"`` for an inspected schedule whose operands
    live on ``device``: ``"sharded"`` for an entry built for a mesh and
    partitioned (the mesh outranks every single-device arm, the unfused
    one included, as in the reference), else ``_single_device_backend``."""
    with tracing.span("tile_fusion.select_backend"):
        if entry.shard is not None:
            return "sharded"
        return _single_device_backend(entry, device)


def _single_device_backend(entry: ScheduleEntry, device) -> str:
    """The single-device pick: past the Eq-3 gates, ``"torch"`` for CPU
    tensors and ``"cuda"`` for any other device, which raises unless the
    kernels run there on this schedule (a uniform one, on a card of
    compute capability 9.0+)."""
    tm = entry.traffic_model
    if (entry.sched.fused_ratio < MIN_FUSED_RATIO
            or tm["traffic_saving"] <= MIN_TRAFFIC_SAVING):
        # fusion saves no traffic (or too little to cover the tile loop's
        # off-model fixed costs): take the simpler code
        return "unfused"
    if torch.device(device).type == "cpu":
        return "torch"
    _require_uniform(entry.dsched)
    kernel_library(device)      # raises off CUDA, below sm_90, on no build
    return "cuda"


def _require_uniform(ds: DeviceSchedule) -> None:
    if not fused_ops._is_uniform(ds):
        raise ValueError(
            "the CUDA kernel arm needs a uniform schedule; inspect with "
            "uniform_split=True (the default), or pass backend='torch' for "
            "the plain executors")


def _gemm_spmm_cuda(entry: ScheduleEntry, b: torch.Tensor,
                    c: torch.Tensor) -> torch.Tensor:
    """Wavefront 0 through the fused GeMM-SpMM kernel, wavefront 1 through
    the ELL SpMM kernel — the kernel boundary is the barrier."""
    ds = entry.dsched
    _require_uniform(ds)
    t, n_t = ds.t_pad, ds.n_tiles0
    if b.shape[0] != ds.n_i:
        raise ValueError(f"b has {b.shape[0]} rows, schedule expects {ds.n_i}")
    with tracing.span("tile_fusion.pad"):
        if n_t * t != b.shape[0]:       # only the last tile can be short
            b = F.pad(b, (0, 0, 0, n_t * t - b.shape[0]))
    with tracing.span("tile_fusion.wf0"):
        st = fused_ops.schedule_tensors(ds, c.device, c.dtype)
        d1, rows0 = kops.tile_fused_gemm_spmm_wf0(st.cols0, st.vals0, b, c,
                                                  t=t)
    with tracing.span("tile_fusion.scatter"):
        d = fused_ops.scatter_rows(ds.n_j, st.j_rows0, rows0)
    with tracing.span("tile_fusion.wf1"):
        return fused_ops._wf1(st, d, d1[: ds.n_i], kernel=True)[: ds.n_j]


def _spmm_spmm_cuda(entry: ScheduleEntry, a1: CSR,
                    c: torch.Tensor) -> torch.Tensor:
    """SpMM-SpMM wavefront 0 through the fused kernel: the hybrid op-1 ELL
    (spill pre-accumulated outside the kernel) feeds the tile-local second
    SpMM; wavefront 1 runs over the finished D1."""
    ds = entry.dsched
    _require_uniform(ds)
    t, n_t = ds.t_pad, ds.n_tiles0
    if a1.n_rows != ds.n_i:
        raise ValueError(
            f"op-1 has {a1.n_rows} rows, schedule expects {ds.n_i}")
    if c.shape[0] != a1.n_cols:
        raise ValueError(
            f"c has {c.shape[0]} rows, op-1 has {a1.n_cols} columns")
    with tracing.span("tile_fusion.pad"):    # op 1 over the padded tiles
        ot = fused_ops.op1_tensors(a1, ds, c.device, c.dtype)
        d1_spill = fused_ops.op1_spill(ot, c, n_t * t)
    with tracing.span("tile_fusion.wf0"):
        st = fused_ops.schedule_tensors(ds, c.device, c.dtype)
        d1, rows0 = kops.tile_fused_spmm_spmm_wf0(
            ot.cols, ot.vals, d1_spill, st.cols0, st.vals0, c, t=t)
    with tracing.span("tile_fusion.scatter"):
        d = fused_ops.scatter_rows(ds.n_j, st.j_rows0, rows0)
    with tracing.span("tile_fusion.wf1"):
        return fused_ops._wf1(st, d, d1[: ds.n_i], kernel=True)[: ds.n_j]


# --------------------------------------------------------------------------
# The entrypoint
# --------------------------------------------------------------------------
def _dispatch(a: CSR, b_or_a1, c: torch.Tensor, *, backend: str,
              spec: FusionSpec) -> torch.Tensor:
    """The schedule-then-execute tail of ``tile_fused_matmul``.
    ``spec.transpose=True`` runs the product with every sparse operand
    transposed: ``D = aᵀ·(b·c)`` for GeMM-SpMM, ``D = aᵀ·(a1ᵀ·c)`` for
    SpMM-SpMM, off the transpose-keyed schedule entry."""
    b_is_sparse = isinstance(b_or_a1, CSR)
    a_run = a.transpose() if spec.transpose else a
    a1_run = (b_or_a1.transpose() if b_is_sparse and spec.transpose
              else b_or_a1)

    def run_unfused():
        with tracing.span("tile_fusion.unfused"):
            hell_a = _csr_ell(a_run,
                              _resolve_width_cap(a_run, spec.width_cap),
                              c.device, c.dtype)
            if b_is_sparse:
                hell_a1 = _csr_ell(a1_run,
                                   _resolve_width_cap(a1_run,
                                                      spec.width_cap),
                                   c.device, c.dtype)
                return fused_ops.unfused_spmm_spmm(hell_a, hell_a1, c)
            return fused_ops.unfused_gemm_spmm(hell_a, b_or_a1, c)

    if backend == "unfused":
        return run_unfused()          # no inspection needed for the baseline

    # the cost model's b_col is the width of D1's inputs: dense-B column
    # count for GeMM-SpMM, C's column count for SpMM-SpMM
    b_col = c.shape[1] if b_is_sparse else b_or_a1.shape[1]
    if spec.dtype_bytes is None:
        spec = dataclasses.replace(spec, dtype_bytes=(
            cost_model.operand_dtype_bytes(c if b_is_sparse else b_or_a1,
                                           c)))
    entry = get_schedule(a, b_col=b_col, c_col=c.shape[1],
                         b_is_sparse=b_is_sparse, spec=spec)
    chosen = select_backend(entry, c.device) if backend == "auto" else backend
    if chosen == "sharded" and entry.shard is None:
        # a trivial mesh, a non-uniform grid or the priced single-device
        # fallback: the entry's own single-device pick, never the plain
        # path on a CUDA tensor
        chosen = _single_device_backend(entry, c.device)
    if chosen == "unfused":
        return run_unfused()          # unpermuted operands: no reorder math
    # an entry built under spec.reorder carries its permutation: the
    # row-indexed operand goes in permuted (P·B by index_select, P·A1 as a
    # memoized host CSR) and the output comes back out by the inverse
    perm = entry.reorder_perm
    if perm is not None:
        perm_t, inv_t = _perm_tensors(entry, c.device)
    if b_is_sparse:
        if perm is not None:
            a1_run = reorder.permute_rows_cached(a1_run, perm)
        if chosen == "sharded":
            d = sharded.sharded_spmm_spmm(entry.shard, entry.dsched,
                                          spec.mesh, a1_run, c)
        elif chosen == "cuda":
            d = _spmm_spmm_cuda(entry, a1_run, c)
        else:
            d = fused_ops.fused_spmm_spmm(entry.dsched, a1_run, c)
    else:
        b = b_or_a1 if perm is None else b_or_a1.index_select(0, perm_t)
        if chosen == "sharded":
            d = sharded.sharded_gemm_spmm(entry.shard, spec.mesh, b, c)
        elif chosen == "cuda":
            d = _gemm_spmm_cuda(entry, b, c)
        else:
            d = fused_ops.fused_gemm_spmm(entry.dsched, b, c)
    return d if perm is None else d.index_select(0, inv_t)


def _perm_tensors(entry: ScheduleEntry, device) -> tuple:
    """The entry's ``(reorder_perm, reorder_inv)`` as int64 index tensors
    on ``device``, uploaded once per device."""
    key = fused_ops.device_key(device)
    pair = entry.perm_tensors.get(key)
    if pair is None:
        pair = entry.perm_tensors[key] = tuple(
            torch.as_tensor(p, dtype=torch.int64).to(device)
            for p in (entry.reorder_perm, entry.reorder_inv))
    return pair


# --------------------------------------------------------------------------
# Autograd: the backward runs the transposed products on the same dispatch
# --------------------------------------------------------------------------
def _bwd_spec(spec: FusionSpec) -> FusionSpec:
    """The backward dispatch's spec: the transpose bit flipped, so the
    backward of an already-transposed product runs on the forward entry
    ((Aᵀ)ᵀ = A); every other knob carries over (``reorder`` and
    ``autotune`` too: the transpose entry prices its own ordering of
    ``Aᵀ`` and runs its own sweep; the mesh, so ``dB`` and SpMM-SpMM's
    ``dC`` run sharded on the transpose entries), and with it the same
    ``select_backend``.  The serving ``bucket``, an inference-only shape
    key, is dropped: it never reaches a training entry."""
    return dataclasses.replace(spec, transpose=not spec.transpose,
                               bucket=None)


def _transpose_spmm(a: CSR, x: torch.Tensor, *, transpose: bool,
                    width_cap, backend: str) -> torch.Tensor:
    """``Aᵀ·x`` (``A·x`` when the forward was transposed): the second
    sparse product of the GeMM-SpMM backward, one call of the hybrid-ELL
    kernel wrapper over the same content-keyed full-matrix hybrid ELL the
    unfused executor uses (its plain version under ``backend="torch"``).
    ``x`` must be contiguous, as the kernel takes it."""
    a_eff = a.transpose() if transpose else a
    return fused_ops.spmm_hybrid(
        _csr_ell(a_eff, _resolve_width_cap(a_eff, width_cap), x.device,
                 x.dtype), x, kernel=backend != "torch")


class _GemmSpmmFn(torch.autograd.Function):
    """``D = A·(B·C)`` with its backward:

      ``dB = Aᵀ·(Ḋ·Cᵀ)`` — a GeMM-SpMM against ``Aᵀ``, dispatched through
      ``tile_fused_matmul`` with the transpose bit flipped, so it hits the
      cached transpose entry and the same backend selection;
      ``dC = Bᵀ·(Aᵀ·Ḋ)`` — one full-matrix hybrid SpMM against ``Aᵀ``,
      then a dense product.

    Only the gradients autograd asks for are computed (a first layer's
    features need no ``dB``).  One dtype throughout: ``tile_fused_matmul``
    holds ``b`` and ``c`` to one, and autograd hands ``Ḋ`` in ``D``'s."""

    @staticmethod
    def forward(ctx, b, c, a, backend, spec):
        ctx.a, ctx.backend, ctx.spec = a, backend, spec
        ctx.save_for_backward(b, c)
        return _dispatch(a, b, c, backend=backend, spec=spec)

    @staticmethod
    @once_differentiable
    def backward(ctx, dd):
        with tracing.span("tile_fusion.backward"):
            b, c = ctx.saved_tensors
            spec = _bwd_spec(ctx.spec)
            # the kernels take contiguous tensors; a cotangent may come
            # strided (``D.sum()`` expands a scalar with stride 0): one
            # copy for both
            dd = dd.contiguous()
            db = dc = None
            if ctx.needs_input_grad[0]:
                db = tile_fused_matmul(ctx.a, dd, c.t(), backend=ctx.backend,
                                       spec=spec)
            if ctx.needs_input_grad[1]:
                with tracing.span("tile_fusion.backward.dc"):
                    dc = b.t() @ _transpose_spmm(
                        ctx.a, dd, transpose=spec.transpose,
                        width_cap=spec.width_cap, backend=ctx.backend)
            return db, dc, None, None, None


class _SpmmSpmmFn(torch.autograd.Function):
    """``D = A·(A1·C)`` with its backward ``dC = A1ᵀ·(Aᵀ·Ḋ)``: itself a
    SpMM-SpMM with the operand roles swapped, dispatched through
    ``tile_fused_matmul`` with the transpose bit flipped, so it runs the
    fused two-wavefront schedule of the cached transpose entry."""

    @staticmethod
    def forward(ctx, c, a, a1, backend, spec):
        ctx.a, ctx.a1, ctx.backend, ctx.spec = a, a1, backend, spec
        return _dispatch(a, a1, c, backend=backend, spec=spec)

    @staticmethod
    @once_differentiable
    def backward(ctx, dd):
        with tracing.span("tile_fusion.backward"):
            dc = tile_fused_matmul(ctx.a1, ctx.a, dd, backend=ctx.backend,
                                   spec=_bwd_spec(ctx.spec))
        return dc, None, None, None, None


def tile_fused_matmul(a: CSR, b_or_a1, c: torch.Tensor, *,
                      backend: str = "auto",
                      spec: FusionSpec | None = None,
                      **legacy) -> torch.Tensor:
    """``D = a @ (b_or_a1 @ c)`` through the tile-fusion schedule, on the
    device where the dense operands live.

    Args:
      a: CSR matrix of the second (consumer) operation.
      b_or_a1: dense ``(n_i, b_col)`` tensor → GeMM-SpMM, or a ``CSR`` →
        SpMM-SpMM (op-1 rows gathered per tile).
      c: dense ``(b_col, c_col)`` (GeMM-SpMM) / ``(n, c_col)`` (SpMM-SpMM);
        on the same device and of the same dtype as a dense ``b_or_a1``.
      backend: "auto" (Eq-3 cost model + capability, ``"sharded"`` for a
        partitioned mesh entry), or an explicit "cuda" / "torch" /
        "unfused" / "sharded" override.  "cuda" on CPU tensors runs the
        kernel arm's glue with the kernels' plain versions; "sharded"
        without a partitioned entry takes the entry's single-device pick.
      spec: a ``FusionSpec`` (``None`` = the default spec); its resolved
        form keys the schedule cache.  ``spec.transpose=True`` computes
        the product with the sparse operands transposed; ``spec.mesh``
        (a ``models.sharding.Mesh`` of the operands' device type) spreads
        it over the mesh's devices.
      **legacy: the historical keyword surface (``p=``, ``ct_size=``,
        ``mesh=``, ...) — a deprecation shim that builds the spec for you
        and warns once per process.  Mixing ``spec=`` with legacy
        keywords raises.

    Differentiable in the dense operands: under grad mode, when one of
    them requires grad, the backward runs on the transpose entries (see
    the module docstring).
    """
    with tracing.span("tile_fusion.call"):
        spec = _coerce_spec(spec, legacy, "tile_fused_matmul")
        if backend not in BACKENDS:
            raise ValueError(
                f"backend={backend!r}; expected one of {BACKENDS}")
        if not isinstance(c, torch.Tensor):
            raise TypeError(
                f"c must be a torch.Tensor, got {type(c).__name__}")
        _check_mesh(spec, c.device)
        c = c.contiguous()
        if isinstance(b_or_a1, CSR):
            if torch.is_grad_enabled() and c.requires_grad:
                return _SpmmSpmmFn.apply(c, a, b_or_a1, backend, spec)
            return _dispatch(a, b_or_a1, c, backend=backend, spec=spec)
        if not isinstance(b_or_a1, torch.Tensor):
            raise TypeError(f"b_or_a1 must be a torch.Tensor or a CSR, got "
                            f"{type(b_or_a1).__name__}")
        if b_or_a1.device != c.device or b_or_a1.dtype != c.dtype:
            raise ValueError(
                f"b ({b_or_a1.dtype} on {b_or_a1.device}) and c ({c.dtype} "
                f"on {c.device}) must share a dtype and a device")
        b = b_or_a1.contiguous()
        if torch.is_grad_enabled() and (b.requires_grad or c.requires_grad):
            return _GemmSpmmFn.apply(b, c, a, backend, spec)
        return _dispatch(a, b, c, backend=backend, spec=spec)
