"""Roofline terms of a step the port counted, the twin of
``repro.roofline.analysis``.

  compute term    = FLOPs_per_device / peak_FLOP/s
  memory term     = bytes_per_device / HBM_bw
  collective term = collective_bytes_per_device / link_bw

The reference reads its FLOPs and bytes from XLA's
``compiled.cost_analysis()`` (the per-device module, after partitioning)
and its collective bytes from the optimized HLO text.  The port compiles
nothing, so it counts the step as it runs:

- ``StepCounter`` is a ``TorchDispatchMode`` that sums over the aten ops
  of one step their FLOPs, by the formulas of ``torch.utils.flop_counter``
  (2·M·N·K a product; elementwise work is not counted, where XLA's figure
  counts it too), and their bytes accessed, each non-view op's inputs and
  outputs at their full size.  XLA counts its bytes after fusion, so an
  intermediate kept on chip inside a fusion costs it nothing: eager
  PyTorch fuses nothing, and the two are not the same measure.  A kernel
  of the port charges its own work instead of its operations
  (``kernels.config.kernel_work``: flash attention's kept pairs and its
  compulsory bytes).  The counter also tracks each member's live bytes to
  find its peak.
- ``collective_bytes`` reads the collectives the port's mesh executor ran
  (``models.sharding.comm_bytes`` and ``comm_counts``).

The roofline takes figures per device: the counted totals over every
member of the mesh divided by the number of members, the mean member.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..kernels import config as _config
from ..launch.mesh import HBM_BW, LINK_BW, PEAK_FLOPS_BF16
from ..models import sharding

#: the reference's collective kinds, in its order
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
#: the port's collectives under the reference's kinds
PORT_KINDS = {"all_gather": "all-gather", "psum": "all-reduce",
              "gather": "collective-permute"}


def collective_bytes(n_devices: int, comm: dict | None = None,
                     counts: dict | None = None) -> dict:
    """Per-kind collective bytes and counts of one member, in the
    reference's shape of result (``{"bytes": {kind: n}, "counts": {kind:
    n}, "total_bytes": n}`` under its five kind names), from the executor's
    counters (default: ``sharding.comm_bytes`` / ``comm_counts`` as they
    stand).

    ``all_gather`` is the reference's ``all-gather`` and ``psum`` its
    ``all-reduce``.  ``gather``, the parts handed to one consumer (the
    logits collected for the caller), is point-to-point sends, filed under
    ``collective-permute``; ``reduce-scatter`` and ``all-to-all`` stay 0,
    since the executor runs neither.

    The figures differ in kind from the reference's.  XLA's is the result
    bytes of each collective in the per-device module.  ``comm_bytes``
    counts the bytes handed from one member to another, summed over each
    group: an all-gather of ``n`` parts counts the ``n - 1`` parts each
    member receives, a psum the ``2 (n - 1)`` partials of a ring
    all-reduce.  Divided by ``n_devices`` it is the mean member's traffic,
    the figure reported here; XLA's all-gather result is ``n / (n - 1)``
    of it, and its all-reduce result ``n / (2 (n - 1))``.  A count is the
    members that took part, over ``n_devices``: the collectives the mean
    member joined."""
    comm = sharding.comm_bytes if comm is None else comm
    counts = sharding.comm_counts if counts is None else counts
    out = dict.fromkeys(KINDS, 0.0)
    cnt = dict.fromkeys(KINDS, 0.0)
    for port, kind in PORT_KINDS.items():
        out[kind] += comm[port] / n_devices
        cnt[kind] += counts[port] / n_devices
    return {"bytes": out, "counts": cnt, "total_bytes": sum(out.values())}


@dataclasses.dataclass
class Roofline:
    flops: float
    bytes_accessed: float
    coll_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops_per_device: float
    useful_ratio: float

    def to_dict(self):
        return dataclasses.asdict(self)


def roofline(cost: dict, coll: dict, *, model_flops_global: float,
             n_devices: int, peak=PEAK_FLOPS_BF16, hbm=HBM_BW,
             link=LINK_BW) -> Roofline:
    """The three terms of a step from its per-device ``cost`` (``flops``,
    ``bytes accessed``) and collective bytes (``coll["total_bytes"]``), on
    the H100's peaks unless others are given; ``useful_ratio`` is the
    model's FLOPs per device over the counted ones."""
    flops = float(cost.get("flops", 0.0))
    by = float(cost.get("bytes accessed", 0.0))
    cb = float(coll["total_bytes"])
    terms = {
        "compute": flops / peak,
        "memory": by / hbm,
        "collective": cb / link,
    }
    bottleneck = max(terms, key=terms.get)
    mf = model_flops_global / n_devices
    return Roofline(
        flops=flops, bytes_accessed=by, coll_bytes=cb,
        compute_s=terms["compute"], memory_s=terms["memory"],
        collective_s=terms["collective"], bottleneck=bottleneck,
        model_flops_per_device=mf,
        useful_ratio=(mf / flops) if flops else 0.0,
    )


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N·D for training, 2·N_active·D for inference."""
    n_active = cfg.param_count(active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


# ----------------------------------------------------------- the counter ----
_META = torch.device("meta")
_SCALARS = (bool, int, float)


def _key(args, tensors: list) -> tuple:
    """A hashable stand-in of an op's arguments: a tensor's shape, strides
    and dtype (the tensor collected into ``tensors``), a scalar's type and
    value (``True`` and ``1`` promote differently), anything else as it
    is."""
    out = []
    for x in args:
        if isinstance(x, torch.Tensor):
            tensors.append(x)
            out.append((x.shape, x.stride(), x.dtype))
        elif type(x) in (list, tuple):
            out.append(_key(x, tensors))
        elif type(x) in _SCALARS:
            out.append((type(x), x))
        else:
            out.append(x)
    return tuple(out)


def _tensors(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _spec(out):
    """``out``'s shapes, strides and dtypes (None: not a tensor result)."""
    if isinstance(out, torch.Tensor):
        return (out.shape, out.stride(), out.dtype)
    if isinstance(out, (list, tuple)) and out:
        specs = [_spec(o) for o in out]
        return None if None in specs else (type(out), specs)
    return None


def _build(spec):
    if isinstance(spec[0], type):
        return spec[0]([_build(s) for s in spec[1]])
    shape, stride, dtype = spec
    return torch.empty_strided(shape, stride, dtype=dtype, device=_META)


_KINDS: dict = {}


def _kind(func) -> str:
    """How an op is counted, from its schema: ``"composite"`` (it has a
    decomposition and no flop formula of its own: autograd did not
    decompose it, as under inference mode, so its parts are counted, as
    ``FlopCounterMode`` does), ``"fresh"`` (new outputs), ``"inplace"``
    (writes and returns its first argument), ``"view"`` (its outputs alias
    an input), ``"out"`` (writes another argument, or mutates without
    returning it)."""
    kind = _KINDS.get(func)
    if kind is not None:
        return kind
    s = func._schema
    rets = [r.alias_info for r in s.returns]
    first = s.arguments[0].alias_info if s.arguments else None
    if func._overloadpacket not in flop_registry and \
            torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), torch._C.DispatchKey.CompositeImplicitAutograd):
        kind = "composite"
    elif not any(rets):
        kind = "out" if s.is_mutable else "fresh"
    elif (len(rets) == 1 and rets[0].is_write and first is not None
          and first.is_write and rets[0].before_set == first.before_set):
        kind = "inplace"
    elif not any(r is not None and r.is_write for r in rets):
        kind = "view"
    else:
        kind = "out"
    _KINDS[func] = kind
    return kind


def _dense(t: torch.Tensor) -> bool:
    """Whether ``t`` spans its whole storage from offset 0, as a tensor
    made by ``empty_strided`` of its shape and strides does."""
    span = 1 + sum((n - 1) * st for n, st in zip(t.shape, t.stride())) \
        if t.numel() else 0
    return t.storage_offset() == 0 and \
        t.untyped_storage().nbytes() == span * t.element_size()


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class StepCounter(TorchDispatchMode):
    """Counts one step's aten ops: ``flops`` and ``bytes`` (totals over
    every member), and each member's live bytes (``live``) and their
    high-water mark (``high``), beyond the arguments it held before the
    step (``launch.dryrun`` counts those from the specs).

    A new tensor is charged to the member whose turn it is
    (``models.sharding.turn``: the mesh executor's ``on(who)``, and each
    member's iteration inside ``all_gather``, ``psum`` and ``gather``); a
    result several members share on one device is charged to each of them
    (``sharding.hold``).  The autograd nodes of a turn's ops carry its
    member into the backward: hooks make it the member whose turn it is
    while the node runs.  Any other op (a node made outside every turn,
    the optimizer's norm) is charged to the member owning the most bytes
    of its inputs (arguments registered with ``own``), or to ``first``
    where no input is owned, which is the only member on a mesh of one.
    Bytes are a storage's, freed when the storage is.

    On ``meta`` tensors every op that makes new outputs, or writes its
    first argument in place, runs once a shape: the outputs of a later
    call of it on the same shapes, strides and arguments are made from a
    cache (``empty_strided``), as are its counts.  The hundreds of members
    of a production mesh repeat one another's shapes, and a meta kernel
    costs far more than the lookup."""

    #: the member charged where no input is owned: the mesh's first
    first = (0, 0)

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = collections.Counter()
        self.high = collections.Counter()
        self._who = None
        self._muted = 0
        self._depth = 0
        self._charges = {}       # id(storage) -> (charges, weakref)
        self._owners = {}        # id(storage) -> member, for arguments
        self._keep = []          # the arguments' storages (ids stay unique)
        self._cache = {}
        self._raw = [0, 0]       # flops and bytes, muted or not
        self._windows = []       # allocations inside each decomposition
        self._pending = []       # (outputs, member) awaiting their nodes

    def __enter__(self):
        if _config.counter is None:
            _config.counter = self
        elif _config.counter is not self:
            raise RuntimeError("a StepCounter is already counting")
        self._depth += 1
        return super().__enter__()

    def __exit__(self, *exc):
        self._depth -= 1
        if not self._depth:
            _config.counter = None
        return super().__exit__(*exc)

    # ---------------------------------------------------------- hooks --
    @contextlib.contextmanager
    def turn(self, who):
        prev, self._who = self._who, who
        try:
            yield
        finally:
            self._mark()
            self._who = prev

    def _mark(self) -> None:
        """Give the autograd nodes of the ops run in the current turn that
        turn's member: hooks make it the member whose turn it is while
        the backward runs each node."""
        pending, self._pending = self._pending, []
        done = set()
        for out, who in pending:
            for t in (out,) if isinstance(out, torch.Tensor) else \
                    _tensors(out):
                fn = t.grad_fn
                if fn is None or id(fn) in done:
                    continue
                done.add(id(fn))
                fn.register_prehook(
                    lambda _, w=who: setattr(self, "_who", w))
                fn.register_hook(lambda *_: setattr(self, "_who", None))

    def hold(self, t: torch.Tensor, who) -> None:
        st = t.untyped_storage()
        rec = self._charges.get(id(st))
        if rec is None or any(w == who for w, _ in rec[0]):
            return
        rec[0].append((who, st.nbytes()))
        self._add(who, st.nbytes())

    @contextlib.contextmanager
    def kernel(self, flops: int, nbytes: int):
        self._charge(flops, nbytes)
        self._muted += 1
        try:
            yield
        finally:
            self._muted -= 1

    def own(self, tensors, who) -> None:
        """Register ``tensors`` (arguments made before the step) as
        ``who``'s, for the charge of the ops outside a turn."""
        for t in tensors:
            st = t.untyped_storage()
            if id(st) not in self._owners:
                self._owners[id(st)] = who
                self._keep.append(st)

    # ------------------------------------------------------- counting --
    def _add(self, who, n: int) -> None:
        live = self.live[who] + n
        self.live[who] = live
        if live > self.high[who]:
            self.high[who] = live

    def _release(self, key) -> None:
        for who, n in self._charges.pop(key)[0]:
            self.live[who] -= n

    def _charge(self, flops: int, nbytes: int) -> None:
        self._raw[0] += flops
        self._raw[1] += nbytes
        if not self._muted:
            self.flops += flops
            self.bytes += nbytes

    def _owner(self, ts):
        best, most = self.first, -1
        for t in ts:
            st = t.untyped_storage()
            rec = self._charges.get(id(st))
            who = rec[0][0][0] if rec else self._owners.get(id(st))
            if who is not None and st.nbytes() > most:
                best, most = who, st.nbytes()
        return best

    def _track(self, out, ins) -> None:
        who = self._who if self._who is not None else self._owner(ins)
        for t in (out,) if isinstance(out, torch.Tensor) else _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key in self._charges:
                continue
            n = st.nbytes()
            self._charges[key] = ([(who, n)], weakref.ref(
                st, lambda _, k=key: self._release(k)))
            self._add(who, n)
            for w in self._windows:
                w.append(key)

    def _count(self, func, args, kwargs, out, ins) -> tuple:
        formula = flop_registry.get(func._overloadpacket)
        flops = formula(*args, **kwargs, out_val=out) if formula else 0
        if func._overloadpacket.__name__.startswith("empty"):
            return flops, 0
        return flops, _nbytes(ins) + _nbytes(_tensors(out))

    def _decompose(self, func, args, kwargs, key, ins):
        """A composite op counted by its parts.  On ``meta`` its result is
        cached by what the decomposition did: returned its first argument
        (``"self"``), made one new output and nothing else (its spec and
        counts), or made nothing and counted nothing (``"pass"``: a view,
        run directly next time)."""
        raw, window = list(self._raw), []
        self._windows.append(window)
        try:
            with self:
                out = func.decompose(*args, **kwargs)
        finally:
            self._windows.pop()
        if out is NotImplemented:
            _KINDS[func] = "fresh"
            return self._dispatch(func, args, kwargs)
        if key is not None:
            counts = (self._raw[0] - raw[0], self._raw[1] - raw[1])
            spec = None
            if ins and out is ins[0]:
                spec = "self"
            elif not window and counts == (0, 0):
                spec = "pass"
            elif isinstance(out, torch.Tensor) and window == [
                    id(out.untyped_storage())] and _dense(out):
                spec = _spec(out)
            if spec is not None:
                self._cache[key] = (spec,) + counts
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self._pending:
            self._mark()
        out = self._dispatch(func, args, kwargs or {})
        if self._who is not None and torch.is_grad_enabled():
            self._pending.append((out, self._who))
        return out

    def _dispatch(self, func, args, kwargs):
        kind = _kind(func)
        if kind == "view":
            return func(*args, **kwargs)
        ins = []
        key = None
        if kind == "out":
            ins = _tensors(args) + _tensors(tuple(kwargs.values()))
        else:
            key = (func, _key(args, ins), _key(kwargs.values(), ins),
                   tuple(kwargs))
            on_meta = all(t.is_meta for t in ins) if ins else \
                kwargs.get("device") == _META
            if not on_meta:
                key = None
        if key is not None:
            try:
                hit = self._cache.get(key)
            except TypeError:            # an unhashable argument
                key = hit = None
            if hit is not None:
                spec, flops, nbytes = hit
                if spec == "pass":
                    return func(*args, **kwargs)
                self._charge(flops, nbytes)
                if spec == "self":
                    return args[0]
                out = _build(spec)
                self._track(out, ins)
                return out
        if kind == "composite":
            return self._decompose(func, args, kwargs, key, ins)
        out = func(*args, **kwargs)
        flops, nbytes = self._count(func, args, kwargs, out, ins)
        self._charge(flops, nbytes)
        if key is not None:
            spec = _spec(out) if kind == "fresh" else "self"
            if spec is not None:
                self._cache[key] = (spec, flops, nbytes)
        if kind == "fresh":
            self._track(out, ins)
        return out
