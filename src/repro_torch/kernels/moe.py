"""Fused MoE expert FFN, ``act(X_e @ W1_e) @ W2_e`` for every expert ``e``
over capacity-dispatched tokens.

Replaces the TPU kernel ``repro.kernels.moe._fused_moe_ffn`` with the
template of ``csrc/fused_ffn.cu``, the expert index as the grid's third
axis.  The token gather and scatter around it stay in PyTorch, as they
stayed in XLA around the Pallas kernel.
"""
from __future__ import annotations

import torch

from . import config, ref
from .fused_ffn import launch_ffn


def fused_moe_ffn(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, *,
                  act: str = "silu", impl: str = "cuda") -> torch.Tensor:
    """x ``(E, cap, d)``, w1 ``(E, d, f)``, w2 ``(E, f, d)`` →
    ``(E, cap, d)`` in x's dtype; ``act="none"`` applies no activation, as
    the TPU kernel does.

    CPU tensors, or ``impl="torch"``, take the plain PyTorch version; CUDA
    tensors launch the kernel or raise.  The kernel has no backward: under
    grad mode, for an input that requires grad, the kernel arm raises
    ``NotImplementedError`` (``config.refuse_grad``)."""
    if config.plain_arm(x, impl):
        return ref.moe_ffn(x, w1, w2, act=act)
    config.refuse_grad("fused_moe_ffn", x, w1, w2)
    if x.dim() != 3 or w1.dim() != 3 or w2.dim() != 3:
        raise ValueError(f"fused_moe_ffn: x {tuple(x.shape)}, w1 "
                         f"{tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    out = launch_ffn("fused_moe_ffn", x, w1, w2, act)
    fused_moe_ffn.launches += 1
    return out


#: kernel launches since the count was last set to 0
fused_moe_ffn.launches = 0
