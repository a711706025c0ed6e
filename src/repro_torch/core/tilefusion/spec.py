"""``FusionSpec`` — the one consolidated knob object of the tile-fusion API.

The dispatch seam (``api.get_schedule`` / ``api.tile_fused_matmul``) grew
twelve keyword knobs, duplicated across four cache-key derivations
(main key, autotune key, bucket publish, custom_vjp backward).  This
dataclass is the single source of truth for all of them: callers build one
frozen ``FusionSpec`` and pass ``spec=``; the spec's *resolved* form
(width cap concretized, mesh reduced to its hashable key, inert knobs
canonicalized on trivial meshes) **is** the schedule-cache key tail, so a
knob can never be part of dispatch without being part of the key.

The legacy keyword surface still works as a deprecation shim:
``get_schedule(a, ..., p=2, ct_size=32)`` builds a ``FusionSpec`` from the
kwargs and emits one structured ``DeprecationWarning`` per process (not
one per call — serving hot loops would drown in them).  New capability
lands as a spec field (``overlap``, ``n_repl``), not signature growth.

A copy of ``repro.core.tilefusion.spec``: the same fields, validation and
shim.  ``mesh`` takes a ``repro_torch.models.sharding.Mesh`` (``api``
raises ``TypeError`` for anything else).
"""
from __future__ import annotations

import dataclasses
import threading
import warnings

#: Legacy keyword names the shim maps onto spec fields (the historical
#: twelve plus the knobs added since).  Anything else is a typo and raises.
LEGACY_KNOBS = ("p", "cache_size", "ct_size", "uniform_split", "autotune",
                "width_cap", "mesh", "shard_combine", "shard_layout",
                "bucket", "transpose", "dtype_bytes", "overlap", "n_repl")


@dataclasses.dataclass(frozen=True)
class FusionSpec:
    """Every dispatch/inspection knob of the tile-fusion seam.

    Algorithm-1 knobs: ``p``, ``cache_size``, ``ct_size``,
    ``uniform_split``; sweep: ``autotune``; packing: ``width_cap``
    ("auto" | int | None); distribution: ``mesh``, ``shard_combine``,
    ``shard_layout`` ("auto" | "1d" | "1.5d" | "2.5d"), ``overlap``
    ("auto" | bool — async halo gather under wf0 compute), ``n_repl``
    (required total operand-replication factor across the mesh's
    replica × depth axes, None = let the layout pricing decide); serving:
    ``bucket``; training: ``transpose``; pricing: ``dtype_bytes`` (None =
    infer from the call's dense operands; ``get_schedule`` without
    operands defaults it to 4); schedule transform: ``reorder`` (None |
    "auto" | "rcm" | "similarity" — permute the pattern before
    inspection, "auto" applies the best candidate ordering only when the
    Eq-3 traffic model says it beats the identity by the dispatch floor;
    the permutation is baked into the cached entry, callers never
    apply/undo it themselves).

    Frozen and hashable on its own, but the *cache key* uses the resolved
    form ``api``'s key helper derives (a live ``Mesh`` object is not a
    cache key; "auto" width caps resolve per matrix).
    """

    p: int = 8
    cache_size: float = 600_000.0
    ct_size: int = 2048
    uniform_split: bool = True
    autotune: bool = False
    width_cap: int | str | None = "auto"
    mesh: object = None
    shard_combine: str = "auto"
    shard_layout: str = "auto"
    overlap: bool | str = "auto"
    n_repl: int | None = None
    bucket: tuple | None = None
    transpose: bool = False
    dtype_bytes: int | None = None
    reorder: str | None = None

    def __post_init__(self):
        if self.reorder not in (None, "auto", "rcm", "similarity"):
            raise ValueError(
                f"reorder={self.reorder!r}; expected None, 'auto', 'rcm' "
                f"or 'similarity'")
        if not isinstance(self.overlap, bool) and self.overlap != "auto":
            raise ValueError(
                f"overlap={self.overlap!r}; expected a bool or 'auto'")
        if self.n_repl is not None and int(self.n_repl) < 1:
            raise ValueError(f"n_repl={self.n_repl!r}; expected >= 1 or "
                             f"None")
        if self.bucket is not None:
            object.__setattr__(self, "bucket", tuple(self.bucket))


_warned = False
_warn_lock = threading.Lock()


def spec_from_legacy_kwargs(kwargs: dict, *, caller: str) -> FusionSpec:
    """Deprecation shim: build a ``FusionSpec`` from the historical keyword
    surface, warning once per process (structured, category
    ``DeprecationWarning``) with the caller and the knobs that triggered
    it.  Unknown keywords raise ``TypeError`` exactly like a real
    signature would."""
    global _warned
    unknown = sorted(set(kwargs) - set(LEGACY_KNOBS))
    if unknown:
        raise TypeError(f"{caller}() got unexpected keyword argument(s) "
                        f"{unknown}; knobs live on FusionSpec (spec=)")
    with _warn_lock:
        if not _warned:
            _warned = True
            warnings.warn(
                f"{caller}(**{sorted(kwargs)}): passing tile-fusion knobs "
                f"as keywords is deprecated; build a FusionSpec and pass "
                f"spec= (this warning is emitted once per process)",
                DeprecationWarning, stacklevel=3)
    return FusionSpec(**kwargs)


def reset_legacy_warning() -> None:
    """Re-arm the once-per-process deprecation warning (test hook, called
    by ``api.clear_schedule_cache`` so warning tests stay order-independent)."""
    global _warned
    with _warn_lock:
        _warned = False
