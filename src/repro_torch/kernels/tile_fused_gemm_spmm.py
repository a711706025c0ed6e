"""Wavefront 0 of fused GeMM-SpMM (the paper's Listing 1) for one grid of
uniform tiles.

The hand-written CUDA kernel (``csrc/tile_fused_gemm_spmm.cu``) that
replaces the TPU kernel
``repro.kernels.tile_fused_gemm_spmm._tile_fused_gemm_spmm_wf0``.  Per tile
``v`` of ``t`` rows: ``D1_t = B_t @ C`` (f32 sums, written to ``d1`` in the
operand dtype), then the tile's fused rows
``rows0[v, j] = Σ_w vals0[v, j, w] · D1_t[cols0[v, j, w]]`` gathered from
the f32 tile in shared memory.  Wavefront 1 runs after the launch over the
finished ``d1`` (``spmm.spmm_ell``): the kernel boundary is the paper's
single barrier.
"""
from __future__ import annotations

import torch

from . import config, ref


def tile_fused_gemm_spmm_wf0(cols0: torch.Tensor, vals0: torch.Tensor,
                             b: torch.Tensor, c: torch.Tensor, *, t: int):
    """Run wavefront 0.

    Args:
      cols0: ``(T0, j0_max, w)`` int32 tile-local ELL columns of fused rows.
      vals0: ``(T0, j0_max, w)`` values, in the operand dtype.
      b: ``(T0 * t, b_col)`` dense B (padded to a multiple of t).
      c: ``(b_col, c_col)`` dense C.
      t: uniform tile size.
    Returns:
      ``d1 (T0 * t, c_col)``, ``rows0 (T0, j0_max, c_col)``.

    CPU tensors take the plain PyTorch version; CUDA tensors launch the
    kernel or raise."""
    if c.device.type == "cpu":
        return ref.tile_fused_gemm_spmm_wf0(cols0, vals0, b, c, t=t)
    lib = config.kernel_library(c.device)
    device = config.check_launch(dict(cols0=cols0),
                                 dict(vals0=vals0, b=b, c=c))
    n_tiles, j0, w0 = cols0.shape
    b_col, c_col = c.shape
    if vals0.shape != cols0.shape or tuple(b.shape) != (n_tiles * t, b_col):
        raise ValueError(
            f"tile_fused_gemm_spmm_wf0: cols0 {tuple(cols0.shape)}, vals0 "
            f"{tuple(vals0.shape)}, b {tuple(b.shape)}, c {tuple(c.shape)}, "
            f"t={t}")
    cb = config.column_block(t + b_col, c_col)
    d1 = torch.empty((n_tiles * t, c_col), dtype=c.dtype, device=device)
    rows0 = torch.empty((n_tiles, j0, c_col), dtype=c.dtype, device=device)
    err = lib.tile_fused_gemm_spmm_wf0_launch(
        cols0.data_ptr(), vals0.data_ptr(), b.data_ptr(), c.data_ptr(),
        d1.data_ptr(), rows0.data_ptr(), n_tiles, t, b_col, c_col, j0, w0,
        cb, config.DTYPE_CODES[c.dtype], config.stream_of(device))
    config.raise_on_error(err, "tile_fused_gemm_spmm_wf0")
    tile_fused_gemm_spmm_wf0.launches += 1
    return d1, rows0


#: kernel launches since the count was last set to 0
tile_fused_gemm_spmm_wf0.launches = 0
