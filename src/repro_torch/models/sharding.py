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
``cost_model.shard_comm_model`` prices.

The LM's partitioning rules (``ShardingRules``, ``param_spec``) come with
the LM's distribution (ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.tilefusion.scheduler import resolve_mesh_layout

#: bytes each collective moved between shards since the counts were last
#: set to 0
comm_bytes = {"all_gather": 0, "psum": 0, "gather": 0}


def reset_comm_bytes() -> None:
    for k in comm_bytes:
        comm_bytes[k] = 0


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


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _to(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``x`` on ``device``: the tensor itself where it already lives
    there, else a copy ordered on the current streams."""
    return x.to(device, non_blocking=True)


def all_gather(parts: list, group, *, out: list | None = None) -> list:
    """Every part of a fiber on each device of it: ``parts[k]`` lives on
    ``group[k]``, and member ``k`` gets the parts concatenated in group
    order on ``group[k]`` (a new tensor, or ``out[k]`` of ``len(group) *
    rows`` rows, written in place).  Counts the ``n - 1`` parts each
    member receives from the others."""
    rows = parts[0].shape[0]
    res = []
    for k, dev in enumerate(group):
        if out is None:
            res.append(torch.cat([_to(p, dev) for p in parts]))
            continue
        for i, p in enumerate(parts):
            out[k][i * rows:(i + 1) * rows].copy_(p, non_blocking=True)
        res.append(out[k])
    comm_bytes["all_gather"] += (len(parts) - 1) * sum(map(_nbytes, parts))
    return res


def psum(parts: list, group) -> list:
    """The sum of a group's partials on each device of the group: reduced
    in member order onto the first member's device, then handed to the
    others (members on one device share the one result).  Counts ``2 (n -
    1)`` partials, the bytes a ring all-reduce moves.  The inputs are never
    written; a group of one returns its partial."""
    n = len(parts)
    if n == 1:
        return [parts[0]]
    root = torch.device(group[0])
    total = _to(parts[0], root) + _to(parts[1], root)
    for p in parts[2:]:
        total += _to(p, root)
    copies = {str(root): total}
    res = []
    for dev in group:
        key = str(torch.device(dev))
        if key not in copies:
            copies[key] = _to(total, torch.device(dev))
        res.append(copies[key])
    comm_bytes["psum"] += 2 * (n - 1) * _nbytes(parts[0])
    return res


def gather(parts: list, device) -> list:
    """The parts on one consumer's ``device`` (the output's), the first
    part standing for the consumer's own shard: counts every other part,
    each block crossing to the consumer once."""
    device = torch.device(device)
    comm_bytes["gather"] += sum(map(_nbytes, parts[1:]))
    return [_to(p, device) for p in parts]
