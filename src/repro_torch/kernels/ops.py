"""Public entry points of the port's six CUDA kernels.

Each wrapper runs its kernel for CUDA tensors and its plain PyTorch version
(``ref``) for CPU tensors, and counts its launches in a plain integer
attribute (``spmm_ell.launches``); ``launch_counts`` / ``reset_launch_counts``
read and clear all six, so a run can show that its path went through the
kernels.  Unlike the JAX ``ops`` entries, no wrapper drops to the plain
version at a shape the kernel's blocks do not divide: on the card it
launches at any shape or raises.  The three LM wrappers also take
``impl="torch"`` (the twin of the reference's ``impl="xla"``) to run the
plain version on purpose; their kernels have no backward, so on the card
they raise ``NotImplementedError`` under grad mode for an input that
requires grad instead of returning an output cut from the graph.
"""
from __future__ import annotations

from .flash_attention import flash_attention
from .fused_ffn import fused_ffn
from .moe import fused_moe_ffn
from .spmm import spmm_ell
from .tile_fused_gemm_spmm import tile_fused_gemm_spmm_wf0
from .tile_fused_spmm_spmm import tile_fused_spmm_spmm_wf0

KERNELS = (spmm_ell, tile_fused_gemm_spmm_wf0, tile_fused_spmm_spmm_wf0,
           flash_attention, fused_ffn, fused_moe_ffn)


def launch_counts() -> dict:
    """``{kernel name: launches}`` since the counts were last cleared."""
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
