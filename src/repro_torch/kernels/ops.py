"""Public entry points of the port's three CUDA kernels.

Each wrapper runs its kernel for CUDA tensors and its plain PyTorch version
(``ref``) for CPU tensors, and counts its launches in a plain integer
attribute (``spmm_ell.launches``); ``launch_counts`` / ``reset_launch_counts``
read and clear all three, so a run can show that its path went through the
kernels.
"""
from __future__ import annotations

from .spmm import spmm_ell
from .tile_fused_gemm_spmm import tile_fused_gemm_spmm_wf0
from .tile_fused_spmm_spmm import tile_fused_spmm_spmm_wf0

KERNELS = (spmm_ell, tile_fused_gemm_spmm_wf0, tile_fused_spmm_spmm_wf0)


def launch_counts() -> dict:
    """``{kernel name: launches}`` since the counts were last cleared."""
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
