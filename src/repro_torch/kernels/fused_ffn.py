"""Fused ungated FFN, ``act(X @ W1) @ W2`` with H kept on chip.

The hand-written CUDA kernel (``csrc/fused_ffn.cu``) that replaces the TPU
kernel ``repro.kernels.fused_ffn._fused_ffn``; the MoE expert FFN
(``moe.py``) runs the same kernel with one expert per grid slice.  Both
products run on Hopper's tensor cores (``wgmma``), H exchanged across a
thread-block cluster: bf16 directly (``fused_ffn_wgmma_kernel``), f32 as
three TF32 products (``fused_ffn_tf32_kernel``: each operand split into
tf32 hi and lo, ``lo·hi + hi·lo + hi·hi``, summed in f32, about f32
accuracy).  f32 with ``d`` not a multiple of 4 (rows that are not 16-byte
vectors) or unaligned ``x`` / ``w2`` runs the first port's CUDA-core
kernel (``fused_ffn_kernel``).
"""
from __future__ import annotations

import torch

from . import config, ref

#: activation codes of ``csrc/fused_ffn.cu``
ACT_CODES = {"none": 0, "gelu": 1, "silu": 2}
#: the device function of each path the launcher reports
PATHS = {0: "fused_ffn_tf32_kernel", 1: "fused_ffn_kernel",
         2: "fused_ffn_wgmma_kernel", -1: "none"}


def last_path() -> str:
    """The device function that the last FFN or MoE-FFN launch on the card
    ran (the launcher records its dispatch): ``"fused_ffn_wgmma_kernel"``
    for bf16, ``"fused_ffn_tf32_kernel"`` for f32 with ``d`` a multiple of
    4 and 16-byte aligned ``x``, ``w2`` and output, ``"fused_ffn_kernel"``
    (CUDA cores) for other f32 launches, ``"none"`` before any launch or
    for an empty one (no rows, or ``f`` 0)."""
    return PATHS[config.kernel_library("cuda").fused_ffn_last_path()]


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
    In f32 the kernel keeps H in f32 and computes both products as 3xTF32
    (within 1e-4 of the plain version row by row; ``last_path`` names
    the device function).

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
