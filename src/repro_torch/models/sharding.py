"""Device meshes of the port and the collectives of its sharded executor.

Twin of the mesh parts of ``repro.models.sharding``.  The reference runs
the sharded tile-fusion executors under ``shard_map`` on a
``jax.sharding.Mesh``: one program over every device, its collectives
(``all_gather``, ``psum``) lowered by XLA.  The port is single-controller
too, without a compiler in between: a ``Mesh`` is an array of
``torch.device`` with axis names, one Python process runs each shard's
body on its device in a loop (``core.tilefusion.sharded``), and the
collectives below are explicit device-to-device copies and sums.

A device may appear more than once in a mesh, so four or eight shards can
share one card (or the CPU): the port's counterpart of the reference's
forced host platform (``--xla_force_host_platform_device_count``).  A copy
to the device a tensor already lives on is then a no-op that returns the
tensor itself.  No collective writes into its inputs, so no shard writes
through such an alias into another shard's tensors; the results are new
tensors, except that members of a group on one device share one ``psum``
result.

Each collective adds the bytes it hands from one member of its group to
another to ``comm_bytes`` (by collective), whether or not the two members
share a device: the traffic the partition implies between shards, which
``cost_model.shard_comm_model`` prices; ``comm_counts`` counts the
members that took part, one a member a call (``roofline.analysis``'s
``collective_bytes`` reads both).

In a dry run (``launch.dryrun``, on a mesh of ``meta`` entries, which are
all one device) a tensor's device cannot say which member it belongs to.
The collectives take ``who``, the member ``(j, m)`` of each entry of their
group, and charge what each member's turn makes to it (``turn``); where
members on one device share one result (a ``psum``'s, or parts handed to a
consumer without a copy), each of them is charged a copy (``hold``), as
each would hold one on a mesh of distinct cards.  Both hooks do nothing
outside a dry run.

The LM's partitioning rules are the twins of the reference's GSPMD half:
``P`` (a ``PartitionSpec``), ``ShardingRules`` with its activation specs,
``param_spec`` (the same path patterns, in the same order) and
``param_shardings`` (with the divisibility guard).  The port has no
compiler to propagate a layout from those anchors, so
``models.transformer`` runs an explicit executor that computes what the
specs imply, shard by shard (``MeshExecutor``, ``MeshCache``).  The
reference's ``shard_map`` shim has no twin: it only bridges JAX releases
whose ``shard_map`` moved and renamed its keyword.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re

import numpy as np
import torch

from ..core.tilefusion.scheduler import resolve_mesh_layout
from ..kernels import config as _config

#: bytes each collective moved between shards since the counts were last
#: set to 0
comm_bytes = {"all_gather": 0, "psum": 0, "gather": 0}
#: the members that took part in each collective since then (a call over
#: a group of ``n`` counts ``n``; a copy from one member to another, 2)
comm_counts = {"all_gather": 0, "psum": 0, "gather": 0}


def reset_comm_bytes() -> None:
    for k in comm_bytes:
        comm_bytes[k] = 0
        comm_counts[k] = 0


def count(kind: str, nbytes: int, members: int = 2) -> None:
    """Add ``nbytes`` handed between ``members`` members to collective
    ``kind`` (a copy from one member's block to another's: 2)."""
    comm_bytes[kind] += nbytes
    comm_counts[kind] += members


def turn(who):
    """In a dry run, charge the tensors made inside to member ``who``
    (``(j, m)``); a no-op context otherwise, or for ``who=None``."""
    if _config.counter is None or who is None:
        return contextlib.nullcontext()
    return _config.counter.turn(who)


def hold(t: torch.Tensor, who) -> None:
    """In a dry run, member ``who`` holds a copy of ``t``, a result it
    shares with another member on one device; a no-op otherwise."""
    if _config.counter is not None and who is not None:
        _config.counter.hold(t, who)


def _at(who, k):
    return None if who is None else who[k]


class Mesh:
    """An n-d array of ``torch.device`` with one name per axis.

    ``devices`` may hold ``torch.device`` objects or strings (``"cuda:0"``,
    ``"cpu"``), nested to any depth; every entry must have one device type.
    ``mesh_key`` reads ``devices`` (its shape) and ``axis_names``, as it
    reads a ``jax.sharding.Mesh``."""

    def __init__(self, devices, axis_names):
        raw = np.asarray(devices, dtype=object)
        if raw.ndim == 0:
            raw = raw.reshape(1)
        grid = np.empty(raw.shape, dtype=object)
        for idx, d in np.ndenumerate(raw):
            grid[idx] = torch.device(d)
        names = (axis_names,) if isinstance(axis_names, str) else axis_names
        names = tuple(str(n) for n in names)
        if len(names) != grid.ndim:
            raise ValueError(f"{len(names)} axis names {names} for a mesh of "
                             f"shape {grid.shape}")
        types = {d.type for d in grid.flat}
        if len(types) > 1:
            raise ValueError(f"a mesh holds one device type, got "
                             f"{sorted(types)}")
        self.devices = grid
        self.axis_names = names

    @property
    def shape(self) -> tuple:
        return tuple(self.devices.shape)

    @property
    def device_type(self) -> str:
        return self.devices.flat[0].type

    def grid(self, layout: str) -> np.ndarray:
        """The devices as a ``(row shards, column replicas, depth layers)``
        array under ``layout``: the C-order fold of ``resolve_mesh_layout``
        (and of ``mesh_row_repl_axes``'s axis split)."""
        return self.devices.reshape(resolve_mesh_layout(self.shape, layout))


def mesh_row_repl_axes(mesh, layout: str = "1d") -> tuple:
    """Split a mesh's axis names into (row_axes, repl_axes, depth_axes) for
    the sharded tile-fusion executors.

    ``"1d"`` flattens every axis into the row-block dimension;
    ``"1.5d"`` keeps the leading axis for row blocks and hands the trailing
    axes to the dense operand's column replicas; ``"2.5d"`` also peels the
    axes past the second into a depth dimension that replicates the
    wavefront-0 compute and splits the wavefront-1 halo work.  Halo
    all-gathers run over ``row_axes`` only, depth layers combine their
    partial outputs with a psum over ``depth_axes``, and the column-replica
    groups never exchange bytes.  The split is derived from
    ``scheduler.resolve_mesh_layout``, so it cannot disagree with the
    partitioner's shard counts; a 1-D mesh degenerates to (all axes, (),
    ())."""
    names = tuple(str(n) for n in mesh.axis_names)
    _, n_repl, n_depth = resolve_mesh_layout(np.shape(mesh.devices), layout)
    if n_depth > 1:
        return names[:1], names[1:2], names[2:]
    if n_repl > 1:
        return names[:1], names[1:], ()
    return names, (), ()


def on_device(device):
    """Make ``device`` current for what runs inside (the kernel launchers
    take the current device's stream and launch there); a no-op off
    CUDA."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def on_member(device, who):
    """``on_device(device)``, and in a dry run member ``who``'s turn."""
    if _config.counter is None:
        return on_device(device)
    stack = contextlib.ExitStack()
    stack.enter_context(on_device(device))
    stack.enter_context(turn(who))
    return stack


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _to(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``x`` on ``device``: the tensor itself where it already lives
    there, else a copy ordered on the current streams."""
    if x.device == device:
        return x
    return x.to(device, non_blocking=True)


def all_gather(parts: list, group, *, out: list | None = None,
               dim: int = 0, who=None) -> list:
    """Every part of a fiber on each device of it: ``parts[k]`` lives on
    ``group[k]``, and member ``k`` (``who[k]`` in a dry run) gets the
    parts concatenated along ``dim`` in group order on ``group[k]`` (a new
    tensor, or, along rows, ``out[k]`` of ``len(group) * rows`` rows,
    written in place).  Counts the ``n - 1`` parts each member receives
    from the others."""
    rows = parts[0].shape[0]
    res = []
    for k, dev in enumerate(group):
        if out is None:
            with turn(_at(who, k)):
                res.append(torch.cat([_to(p, dev) for p in parts], dim=dim))
            continue
        for i, p in enumerate(parts):
            out[k][i * rows:(i + 1) * rows].copy_(p, non_blocking=True)
        res.append(out[k])
    count("all_gather", (len(parts) - 1) * sum(map(_nbytes, parts)),
          len(parts))
    return res


def psum(parts: list, group, who=None) -> list:
    """The sum of a group's partials on each device of the group: reduced
    in member order onto the first member's device, then handed to the
    others (members on one device share the one result, each charged a
    copy of it in a dry run).  Counts ``2 (n - 1)`` partials, the bytes a
    ring all-reduce moves.  The inputs are never written; a group of one
    returns its partial."""
    n = len(parts)
    if n == 1:
        return [parts[0]]
    root = torch.device(group[0])
    with turn(_at(who, 0)):
        total = _to(parts[0], root) + _to(parts[1], root)
        for p in parts[2:]:
            total += _to(p, root)
    copies = {str(root): total}
    res = []
    for k, dev in enumerate(group):
        key = str(torch.device(dev))
        if key not in copies:
            with turn(_at(who, k)):
                copies[key] = _to(total, torch.device(dev))
        elif k:
            hold(copies[key], _at(who, k))
        res.append(copies[key])
    count("psum", 2 * (n - 1) * _nbytes(parts[0]), n)
    return res


def gather(parts: list, device, who=None) -> list:
    """The parts on one consumer's ``device`` (the output's; member
    ``who`` in a dry run), the first part standing for the consumer's own
    shard: counts every other part, each block crossing to the consumer
    once."""
    device = torch.device(device)
    count("gather", sum(map(_nbytes, parts[1:])), len(parts))
    out = []
    with turn(who):
        for k, p in enumerate(parts):
            t = _to(p, device)
            if k and t is p:
                hold(t, who)
            out.append(t)
    return out


# --------------------------------------------------------------------------
# The LM's partitioning rules
# --------------------------------------------------------------------------
class P(tuple):
    """The twin of ``jax.sharding.PartitionSpec``: one entry a dimension,
    each ``None`` (replicated), an axis name, or a tuple of axis names
    (the dimension split over their product, in that order); dimensions
    past the last entry are replicated.  A tuple of one name is that name,
    as ``PartitionSpec`` normalizes it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Logical-axis assignment.  ``batch_axes`` composes ("pod", "data")."""
    batch_axes: tuple = ("data",)
    model_axis: str = "model"
    #: whether the attention heads divide the model axis (else every
    #: member computes all heads)
    shard_heads: bool = True
    #: the ``Mesh`` the executor runs on; None = one device
    mesh: object = None

    @property
    def act_btd(self) -> P:   # (batch, seq, d_model)
        return P(self.batch_axes, None, None)

    @property
    def act_btf(self) -> P:   # (batch, seq, d_ff): the FFN's hidden
        return P(self.batch_axes, None, self.model_axis)

    @property
    def act_bhtd(self) -> P:  # (batch, heads, seq, head_dim)
        if self.shard_heads:
            return P(self.batch_axes, self.model_axis, None, None)
        return P(self.batch_axes, None, None, None)

    @property
    def logits(self) -> P:    # (batch, seq, vocab)
        return P(self.batch_axes, None, self.model_axis)


#: path pattern -> spec of a matrix (the leading stack axes unsharded):
#: matmul weights split their contraction-free big axis over "model",
#: everything else replicates.  sLSTM's ``w_rec`` is left out on purpose:
#: it contracts inside the per-time-step scan.
_PARAM_RULES = [
    (r"embed", lambda nd: P(*([None] * (nd - 2) + ["model", None]))),
    (r"(lm_head|w_out_proj)",
     lambda nd: P(*([None] * (nd - 2) + [None, "model"]))),
    (r"(wq|wk|wv|w_up|w_gate|w_in|w1|w3)$",
     lambda nd: P(*([None] * (nd - 2) + [None, "model"]))),
    (r"(wo|w_down|w2)$", lambda nd: P(*([None] * (nd - 2) + ["model", None]))),
    (r"(router|w_dkv|w_uk|w_uv|w_dq|w_uq)$", lambda nd: P()),
]


def param_spec(path: str, ndim: int) -> P:
    """The spec of the parameter at ``path`` ("layers/attn/wq") of rank
    ``ndim`` (its rank in the stacked tree): the first pattern that
    matches; a vector or an unmatched path replicates."""
    for pat, fn in _PARAM_RULES:
        if re.search(pat, path):
            if ndim >= 2:
                return fn(ndim)
            return P()
    return P()


def axis_sizes(mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _guarded(spec: P, shape, mesh) -> P:
    """``spec``, or ``P()`` where a dimension it splits does not divide by
    its axes' size (the reference's divisibility guard)."""
    sizes = axis_sizes(mesh)
    for d, ax in enumerate(spec):
        if ax is None or d >= len(shape):
            continue
        names = ax if isinstance(ax, tuple) else (ax,)
        n = int(np.prod([sizes.get(a, 1) for a in names]))
        if shape[d] % n:
            return P()
    return spec


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a nested dict / tuple / list ``tree``
    (tensors, shapes' stand-ins), with the matching entries of ``rest``
    (trees of the same structure whose leaves may be ``P``s)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not isinstance(tree, P):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a nested dict of leaves; ``path`` is the
    tuple of keys down to the leaf."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return fn(path, tree)


def param_shardings(params, mesh) -> dict:
    """The spec of every parameter of ``params`` (a nested dict in the
    reference's layout, each per-layer weight stacked on its leading
    axes; tensors of any device, ``meta`` too), keyed as ``params``:
    ``param_spec`` of its path on its stacked rank, replicated where the
    guard finds a dimension that does not divide."""
    def one(path, leaf):
        shape = tuple(leaf.shape)
        return _guarded(param_spec("/".join(path), len(shape)), shape, mesh)
    return tree_map_with_path(one, params)


def spec_region(shape, spec: P, coords: dict, sizes: dict) -> tuple:
    """The block of a leaf of ``shape`` that the member at mesh ``coords``
    (axis name -> index; ``sizes`` axis name -> size) holds under
    ``spec``: one ``(start, stop)`` a dimension."""
    out = []
    for d, n in enumerate(shape):
        ax = spec[d] if d < len(spec) else None
        if ax is None:
            out.append((0, n))
            continue
        k, idx = 1, 0
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            idx = idx * sizes[a] + coords[a]
            k *= sizes[a]
        c = n // k
        out.append((idx * c, (idx + 1) * c))
    return tuple(out)


class Members:
    """The members of a mesh under ``rules``: data shard ``j`` (the batch
    axes raveled in order) and model index ``m`` of each, its device
    ``devices[j][m]`` and its mesh coordinates ``coords[j][m]``.  Every
    axis must be a batch axis or the model axis."""

    def __init__(self, rules):
        mesh = rules.mesh
        self.sizes = axis_sizes(mesh)
        extra = set(mesh.axis_names) - set(rules.batch_axes) - \
            {rules.model_axis}
        missing = [a for a in rules.batch_axes if a not in self.sizes]
        if extra or missing:
            raise ValueError(f"mesh axes {mesh.axis_names} for batch axes "
                             f"{rules.batch_axes} and model axis "
                             f"{rules.model_axis!r}")
        self.n_data = int(np.prod([self.sizes[a] for a in rules.batch_axes]))
        self.n_model = self.sizes.get(rules.model_axis, 1)
        self.devices = [[None] * self.n_model for _ in range(self.n_data)]
        self.coords = [[None] * self.n_model for _ in range(self.n_data)]
        for idx in np.ndindex(mesh.devices.shape):
            c = dict(zip(mesh.axis_names, idx))
            j = 0
            for a in rules.batch_axes:
                j = j * self.sizes[a] + c[a]
            m = c.get(rules.model_axis, 0)
            self.devices[j][m] = mesh.devices[idx]
            self.coords[j][m] = c
        self.first = mesh.devices.flat[0]

    def all(self):
        """``(j, m)`` of every member, data shard major."""
        return [(j, m) for j in range(self.n_data)
                for m in range(self.n_model)]

    def rows(self, b: int) -> list:
        """Each data shard's rows of a batch of ``b``: equal slices where
        the batch divides, else every row on each (replicated)."""
        if b % self.n_data:
            return [slice(0, b)] * self.n_data
        c = b // self.n_data
        return [slice(j * c, (j + 1) * c) for j in range(self.n_data)]
