"""Unified tile-fusion dispatch of the port — its one fused-matmul entrypoint.

Twin of ``repro.core.tilefusion.api``, forward path.
``tile_fused_matmul(a, b_or_a1, c)`` computes ``D = a @ (b_or_a1 @ c)``
(GeMM-SpMM when ``b_or_a1`` is a dense tensor, SpMM-SpMM when it is a
``CSR``) where its tensors live, and owns two decisions:

  1. **Inspector amortization (paper §4.2.3).**  Algorithm 1 runs once per
     (matrix content, shapes, resolved spec) and the ``DeviceSchedule`` is
     memoized in a content-keyed LRU cache; the device copies of its arrays
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

Knobs outside this slice — ``spec.autotune``, ``spec.mesh``,
``spec.bucket``, ``spec.reorder``, ``spec.transpose``,
``backend="sharded"``, and dense operands that require grad while grad
mode is on — raise ``NotImplementedError`` (see ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from ...kernels import ops as kops
from ...kernels.config import kernel_library
from ..sparse.formats import CSR, csr_content_digest, hybrid_width_cap
from . import cost_model, fused_ops
from .schedule import DeviceSchedule, to_device_schedule
from .scheduler import Schedule, build_schedule
from .spec import FusionSpec

#: Valid ``backend=`` values for tile_fused_matmul.
BACKENDS = ("auto", "cuda", "torch", "unfused")

#: Below this Eq-2 fused ratio the schedule fuses so little that the fused
#: executor's padding/scatter overhead cannot pay for itself — dispatch to
#: the unfused baseline instead (the reference's gate, kept exactly).
MIN_FUSED_RATIO = 0.02

#: Minimum modeled Eq-3 traffic saving the tiled executors must clear (the
#: reference's gate, kept exactly).
MIN_TRAFFIC_SAVING = 0.10

#: Entries each of the schedule cache and the ELL cache keeps (LRU).
CACHE_ENTRIES = 128

_NOT_PORTED = ("is not ported yet (see ROADMAP.md, Queue 1: the port's "
               "forward slice serves single-device inference)")


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
    #: resolved hybrid-ELL width cap the schedule was packed with (None =
    #: pad-to-max); part of the cache key
    width_cap: int | None = None


_schedule_cache: "collections.OrderedDict" = collections.OrderedDict()
_ell_cache: "collections.OrderedDict" = collections.OrderedDict()
_stats = {"hits": 0, "misses": 0, "evictions": 0, "ell_evictions": 0}
_lock = threading.Lock()
#: The ELL cache has its own lock so a full-matrix pack never stalls
#: schedule-cache hits.  Lock order where both are held: _lock, _ell_lock.
_ell_lock = threading.Lock()


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
    while len(cache) > CACHE_ENTRIES:
        cache.popitem(last=False)
        _stats[evict_key] += 1


def _coerce_spec(spec) -> FusionSpec:
    if spec is None:
        return FusionSpec()
    if not isinstance(spec, FusionSpec):
        raise TypeError(f"spec= expects a FusionSpec, got "
                        f"{type(spec).__name__}")
    return spec


def _check_slice(spec: FusionSpec) -> None:
    """Raise for the knobs this slice of the port does not serve."""
    for name, on in (("autotune", spec.autotune),
                     ("mesh", spec.mesh is not None),
                     ("bucket", spec.bucket is not None),
                     ("reorder", spec.reorder is not None),
                     ("transpose", spec.transpose)):
        if on:
            raise NotImplementedError(f"FusionSpec.{name} {_NOT_PORTED}")


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


def _spec_key(spec: FusionSpec, *, cap) -> tuple:
    """The resolved-spec cache-key tail (``spec.dtype_bytes`` resolved)."""
    return (int(spec.p), float(spec.cache_size), int(spec.ct_size),
            bool(spec.uniform_split), cap, int(spec.dtype_bytes))


def get_schedule(a: CSR, *, b_col: int, c_col: int,
                 b_is_sparse: bool = False,
                 spec: FusionSpec | None = None) -> ScheduleEntry:
    """Run Algorithm 1 once per (content, shapes, resolved spec) and
    memoize; later calls with the same key return the cached entry.
    ``spec.dtype_bytes=None`` defaults to 4 here (``tile_fused_matmul``
    infers it from the operands before it gets here)."""
    spec = _coerce_spec(spec)
    _check_slice(spec)
    spec = dataclasses.replace(
        spec, dtype_bytes=4 if spec.dtype_bytes is None
        else int(spec.dtype_bytes))
    cap = _resolve_width_cap(a, spec.width_cap)
    digest = csr_content_digest(a)
    key = (digest, b_col, c_col, b_is_sparse, _spec_key(spec, cap=cap))
    with _lock:
        entry = _cache_get(_schedule_cache, key)
        if entry is not None:
            entry.hits += 1
            _stats["hits"] += 1
            return entry
    t0 = time.perf_counter()
    sched = build_schedule(a, b_col=b_col, c_col=c_col, p=spec.p,
                           cache_size=spec.cache_size, ct_size=spec.ct_size,
                           b_is_sparse=b_is_sparse,
                           uniform_split=spec.uniform_split, width_cap=cap)
    dsched = to_device_schedule(a, sched, width_cap=cap)
    tm = dsched.hbm_traffic_model(b_col, c_col, dtype_bytes=spec.dtype_bytes)
    entry = ScheduleEntry(sched=sched, dsched=dsched, b_col=b_col,
                          c_col=c_col, b_is_sparse=b_is_sparse,
                          inspector_s=time.perf_counter() - t0,
                          traffic_model=tm, width_cap=cap)
    with _lock:
        _stats["misses"] += 1
        _cache_put(_schedule_cache, key, entry)
    return entry


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
        for k in _stats:
            _stats[k] = 0


def schedule_cache_stats() -> dict:
    """Counters plus live entry counts of both caches; ``spec_entries``
    counts the distinct resolved-spec key tails among live entries."""
    with _lock, _ell_lock:
        return dict(_stats, entries=len(_schedule_cache),
                    ell_entries=len(_ell_cache),
                    spec_entries=len({k[-1] for k in _schedule_cache}))


# --------------------------------------------------------------------------
# Backend selection (Eq-3 cost model + capability)
# --------------------------------------------------------------------------
def select_backend(entry: ScheduleEntry, device) -> str:
    """Resolve ``backend="auto"`` for an inspected schedule whose operands
    live on ``device``: past the Eq-3 gates, ``"torch"`` for CPU tensors
    and ``"cuda"`` for any other device, which raises unless the kernels
    run there on this schedule (a uniform one, on a card of compute
    capability 9.0+)."""
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
    st = fused_ops.schedule_tensors(ds, c.device, c.dtype)
    if n_t * t != b.shape[0]:       # only the last tile can be short
        b = F.pad(b, (0, 0, 0, n_t * t - b.shape[0]))
    d1, rows0 = kops.tile_fused_gemm_spmm_wf0(st.cols0, st.vals0, b, c, t=t)
    d = fused_ops.scatter_rows(ds.n_j, st.j_rows0, rows0)
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
    st = fused_ops.schedule_tensors(ds, c.device, c.dtype)
    ot = fused_ops.op1_tensors(a1, ds, c.device, c.dtype)
    d1_spill = fused_ops.op1_spill(ot, c, n_t * t)
    d1, rows0 = kops.tile_fused_spmm_spmm_wf0(ot.cols, ot.vals, d1_spill,
                                              st.cols0, st.vals0, c, t=t)
    d = fused_ops.scatter_rows(ds.n_j, st.j_rows0, rows0)
    return fused_ops._wf1(st, d, d1[: ds.n_i], kernel=True)[: ds.n_j]


# --------------------------------------------------------------------------
# The entrypoint
# --------------------------------------------------------------------------
def _dispatch(a: CSR, b_or_a1, c: torch.Tensor, *, backend: str,
              spec: FusionSpec) -> torch.Tensor:
    """The schedule-then-execute tail of ``tile_fused_matmul``."""
    b_is_sparse = isinstance(b_or_a1, CSR)

    def run_unfused():
        hell_a = _csr_ell(a, _resolve_width_cap(a, spec.width_cap),
                          c.device, c.dtype)
        if b_is_sparse:
            hell_a1 = _csr_ell(b_or_a1,
                               _resolve_width_cap(b_or_a1, spec.width_cap),
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
    if chosen == "unfused":
        return run_unfused()
    if b_is_sparse:
        if chosen == "cuda":
            return _spmm_spmm_cuda(entry, b_or_a1, c)
        return fused_ops.fused_spmm_spmm(entry.dsched, b_or_a1, c)
    if chosen == "cuda":
        return _gemm_spmm_cuda(entry, b_or_a1, c)
    return fused_ops.fused_gemm_spmm(entry.dsched, b_or_a1, c)


def tile_fused_matmul(a: CSR, b_or_a1, c: torch.Tensor, *,
                      backend: str = "auto",
                      spec: FusionSpec | None = None) -> torch.Tensor:
    """``D = a @ (b_or_a1 @ c)`` through the tile-fusion schedule, on the
    device where the dense operands live.

    Args:
      a: CSR matrix of the second (consumer) operation.
      b_or_a1: dense ``(n_i, b_col)`` tensor → GeMM-SpMM, or a ``CSR`` →
        SpMM-SpMM (op-1 rows gathered per tile).
      c: dense ``(b_col, c_col)`` (GeMM-SpMM) / ``(n, c_col)`` (SpMM-SpMM);
        on the same device and of the same dtype as a dense ``b_or_a1``.
      backend: "auto" (Eq-3 cost model + capability), or an explicit
        "cuda" / "torch" / "unfused" override.  "cuda" on CPU tensors runs
        the kernel arm's glue with the kernels' plain versions.
      spec: a ``FusionSpec`` (``None`` = the default spec); its resolved
        form keys the schedule cache.
    """
    spec = _coerce_spec(spec)
    if backend == "sharded":
        raise NotImplementedError(f"backend='sharded' {_NOT_PORTED}")
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}; expected one of {BACKENDS}")
    _check_slice(spec)
    if not isinstance(c, torch.Tensor):
        raise TypeError(f"c must be a torch.Tensor, got {type(c).__name__}")
    dense = [c]
    if not isinstance(b_or_a1, CSR):
        if not isinstance(b_or_a1, torch.Tensor):
            raise TypeError(f"b_or_a1 must be a torch.Tensor or a CSR, got "
                            f"{type(b_or_a1).__name__}")
        if b_or_a1.device != c.device or b_or_a1.dtype != c.dtype:
            raise ValueError(
                f"b ({b_or_a1.dtype} on {b_or_a1.device}) and c ({c.dtype} "
                f"on {c.device}) must share a dtype and a device")
        b_or_a1 = b_or_a1.contiguous()
        dense.append(b_or_a1)
    if torch.is_grad_enabled() and any(x.requires_grad for x in dense):
        raise NotImplementedError(
            f"autograd through tile_fused_matmul {_NOT_PORTED}; run under "
            f"torch.inference_mode() or torch.no_grad()")
    return _dispatch(a, b_or_a1, c.contiguous(), backend=backend, spec=spec)
