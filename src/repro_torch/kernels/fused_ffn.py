"""Fused ungated FFN, ``act(X @ W1) @ W2`` with H kept on chip.

The hand-written CUDA kernel (``csrc/fused_ffn.cu``) that replaces the TPU
kernel ``repro.kernels.fused_ffn._fused_ffn``; the MoE expert FFN
(``moe.py``) runs the same kernel with one expert per grid slice.
"""
from __future__ import annotations

import torch

from . import config, ref

#: activation codes of ``csrc/fused_ffn.cu``
ACT_CODES = {"none": 0, "gelu": 1, "silu": 2}


def launch_ffn(name: str, x: torch.Tensor, w1: torch.Tensor,
               w2: torch.Tensor, act: str) -> torch.Tensor:
    """Check a 3-D ``(E, m, d)`` / ``(E, d, f)`` / ``(E, f, d)`` launch and
    run ``csrc/fused_ffn.cu``'s launcher ``<name>_launch`` on it."""
    if act not in ACT_CODES:
        raise ValueError(f"act must be one of {list(ACT_CODES)}, got {act!r}")
    lib = config.kernel_library(x.device)
    device = config.check_launch({}, dict(x=x, w1=w1, w2=w2))
    e, m, d = x.shape
    f = w1.shape[2]
    if w1.shape != (e, d, f) or w2.shape != (e, f, d):
        raise ValueError(f"{name}: x {tuple(x.shape)}, w1 "
                         f"{tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    out = torch.empty_like(x)
    args = (x.data_ptr(), w1.data_ptr(), w2.data_ptr(), out.data_ptr())
    if name == "fused_ffn":
        args += (m, d, f)
    else:
        args += (e, m, d, f)
    err = getattr(lib, f"{name}_launch")(
        *args, ACT_CODES[act], config.DTYPE_CODES[x.dtype],
        config.stream_of(device))
    config.raise_on_error(err, name)
    return out


def fused_ffn(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, *,
              act: str = "gelu", impl: str = "cuda") -> torch.Tensor:
    """x ``(m, d)``, w1 ``(d, f)``, w2 ``(f, d)`` → ``(m, d)`` in x's dtype;
    act ∈ {gelu (tanh approximation), silu, none}; f32 sums, one rounding
    of the output.  In bf16 the kernel rounds H to bf16 between the two
    products, as the TPU kernel does; the plain version keeps H in f32.

    CPU tensors, or ``impl="torch"``, take the plain PyTorch version; CUDA
    tensors launch the kernel or raise.  The kernel has no backward: under
    grad mode, for an input that requires grad, the kernel arm raises
    ``NotImplementedError`` (``config.refuse_grad``)."""
    if config.plain_arm(x, impl):
        return ref.ffn(x, w1, w2, act=act)
    config.refuse_grad("fused_ffn", x, w1, w2)
    if x.dim() != 2 or w1.dim() != 2 or w2.dim() != 2:
        raise ValueError(f"fused_ffn: x {tuple(x.shape)}, w1 "
                         f"{tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    out = launch_ffn("fused_ffn", x[None], w1[None], w2[None], act)[0]
    fused_ffn.launches += 1
    return out


#: kernel launches since the count was last set to 0
fused_ffn.launches = 0
