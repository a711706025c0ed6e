"""Meshes of the port and the H100's roofline constants, the twin of
``repro.launch.mesh``.

``make_host_mesh`` lays every visible device of one type out as a
``(n, 1)`` mesh over ``("data", "model")``; ``batch_axes`` names the axes
the batch splits over.  ``make_production_mesh`` gives the reference's
production meshes, shape for shape and axis for axis: ``(16, 16)`` over
``("data", "model")`` (256 members) or ``(2, 16, 16)`` over ``("pod",
"data", "model")`` (512), every entry one device, ``"meta"`` by default,
so ``launch.dryrun`` lays a cell out on them without a card.

The roofline constants are the published peaks of one H100 SXM5 80 GB at
its 700 W limit (NVIDIA's data sheet): the dense bf16 tensor-core rate,
the HBM rate, and NVLink's rate in one direction.  ``LINK_BW`` prices
every collective as if its members shared one HGX host's NVLink.  A mesh
axis wider than the 8 cards of one host crosses InfiniBand between
hosts, which is slower and which this one constant does not price
(ROADMAP open questions).
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.sharding import Mesh

#: dense bf16 tensor-core rate of one H100 SXM5 (FLOP/s)
PEAK_FLOPS_BF16 = 989e12
#: HBM3 bandwidth of one H100 SXM5 80 GB (bytes/s)
HBM_BW = 3.35e12
#: NVLink bandwidth of one H100 SXM5, one direction (bytes/s)
LINK_BW = 450e9


def make_production_mesh(*, multi_pod: bool = False,
                         device: str = "meta") -> Mesh:
    """The reference's production mesh, every entry ``device``: ``(16,
    16)`` over ``("data", "model")``, or with ``multi_pod`` ``(2, 16, 16)``
    over ``("pod", "data", "model")``; the ``pod`` axis composes with
    ``data`` for the batch (``batch_axes``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(np.full(shape, device, dtype=object), axes)


def make_host_mesh(device: str = "cuda") -> Mesh:
    """Every visible device of type ``device`` ("cuda" or "cpu"; the CPU is
    one device) as an ``(n, 1)`` mesh over ``("data", "model")``."""
    if device == "cuda":
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("make_host_mesh('cuda') found no CUDA device; "
                               "pass device='cpu' for the CPU")
        devices = [[f"cuda:{i}"] for i in range(n)]
    else:
        devices = [[device]]
    return Mesh(devices, ("data", "model"))


def batch_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)
