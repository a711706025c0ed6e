"""Host meshes of the port, the twin of ``repro.launch.mesh``.

``make_host_mesh`` lays every visible device of one type out as a
``(n, 1)`` mesh over ``("data", "model")``; ``batch_axes`` names the axes
the batch splits over.  The reference's ``make_production_mesh`` (its
256- and 512-chip TPU meshes) and its v5e roofline constants wait for the
dry run and the roofline, which need H100 figures (ROADMAP Queue 1): no
TPU number is carried here.
"""
from __future__ import annotations

import torch

from ..models.sharding import Mesh


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
