"""Products at a stated precision, for the plain references and their
controls.

``matmul(a, b, prec)`` and ``spmm(a, at, x, prec)`` round both operands of
every product to ``prec`` (forward and backward alike) and accumulate in
f32:

- ``"f32"``: no rounding, TF32 off (the reference itself);
- ``"tf32"``: 10 mantissa bits, round to nearest even (what a TF32 tensor
  core reads);
- ``"fp8"``: float8 e4m3, each tensor scaled so that its largest magnitude
  is 448 (the usual per-tensor scaling of fp8 training).
"""
from __future__ import annotations

import torch

PRECISIONS = ("f32", "tf32", "fp8")


def disable_tf32() -> None:
    """Plain f32 products on the card: cuBLAS and cuDNN without TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_to(x: torch.Tensor, prec: str) -> torch.Tensor:
    x = x.float()
    if prec == "f32":
        return x
    if prec == "tf32":
        bits = x.contiguous().view(torch.int32)
        bias = ((bits >> 13) & 1) + 0xFFF
        return ((bits + bias) & ~0x1FFF).view(torch.float32)
    if prec == "fp8":
        amax = x.abs().amax().clamp_min(1e-30)
        scale = 448.0 / amax
        return (x * scale).to(torch.float8_e4m3fn).float() / scale
    raise ValueError(f"precision {prec!r}; expected one of {PRECISIONS}")


class _Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, prec):
        ctx.prec = prec
        ctx.save_for_backward(a, b)
        return round_to(a, prec) @ round_to(b, prec)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        p = ctx.prec
        gr = round_to(g, p)
        da = gr @ round_to(b, p).transpose(-1, -2) \
            if ctx.needs_input_grad[0] else None
        db = round_to(a, p).transpose(-1, -2) @ gr \
            if ctx.needs_input_grad[1] else None
        return da, db, None


class _Spmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, a, at, prec):
        ctx.at, ctx.prec = at, prec
        return torch.sparse.mm(a, round_to(x, prec))

    @staticmethod
    def backward(ctx, g):
        return (torch.sparse.mm(ctx.at, round_to(g, ctx.prec)), None, None,
                None)


def matmul(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """``a @ b`` in f32 with both operands rounded to ``prec``."""
    return _Matmul.apply(a.float(), b.float(), prec)


def spmm(a: torch.Tensor, at: torch.Tensor, x: torch.Tensor,
         prec: str) -> torch.Tensor:
    """``a @ x`` for a sparse CSR ``a`` (its values already rounded to
    ``prec`` by the caller) and its transpose ``at``, which the backward
    multiplies by."""
    return _Spmm.apply(x.float(), a, at, prec)
