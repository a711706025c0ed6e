"""Row-ELL SpMM, ``D[i] = Σ_w vals[i, w] · X[cols[i, w]]``.

The hand-written CUDA kernel (``csrc/spmm_ell.cu``) that replaces the TPU
kernel ``repro.kernels.spmm._spmm_ell``.  It runs wavefront 1 of both fused
kernel arms and the ELL body of the unfused arm on the card.  Unlike the
TPU kernel it never stages ``X`` on chip: rows are gathered from device
memory, so any ``X`` fits.
"""
from __future__ import annotations

import torch

from . import config, ref


def spmm_ell(cols: torch.Tensor, vals: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """cols ``(n_rows, w)`` int32, vals ``(n_rows, w)`` in ``x``'s dtype,
    x ``(n, c)`` f32/bf16 → ``(n_rows, c)`` in ``x``'s dtype, f32 sums.

    CPU tensors take the plain PyTorch version; CUDA tensors launch the
    kernel or raise."""
    if x.device.type == "cpu":
        return ref.spmm_ell(cols, vals, x)
    lib = config.kernel_library(x.device)
    device = config.check_launch(dict(cols=cols), dict(vals=vals, x=x))
    if cols.dim() != 2 or vals.shape != cols.shape or x.dim() != 2:
        raise ValueError(f"spmm_ell: cols {tuple(cols.shape)}, vals "
                         f"{tuple(vals.shape)}, x {tuple(x.shape)}")
    n_rows, w = cols.shape
    c = x.shape[1]
    out = torch.empty((n_rows, c), dtype=x.dtype, device=device)
    err = lib.spmm_ell_launch(
        cols.data_ptr(), vals.data_ptr(), x.data_ptr(), out.data_ptr(),
        n_rows, w, c, config.DTYPE_CODES[x.dtype], config.stream_of(device))
    config.raise_on_error(err, "spmm_ell")
    spmm_ell.launches += 1
    return out


#: kernel launches since the count was last set to 0
spmm_ell.launches = 0
