"""Wavefront 0 of fused SpMM-SpMM (the paper's Listing 3) for one grid of
uniform tiles.

The hand-written CUDA kernel (``csrc/tile_fused_spmm_spmm.cu``) that
replaces the TPU kernel
``repro.kernels.tile_fused_spmm_spmm._tile_fused_spmm_spmm_wf0``.  Per tile
``v`` of ``t`` rows: ``D1_t[k] = Σ_w op1_vals[v, k, w] · C[op1_cols[v, k, w]]
+ d1_spill[v·t + k]`` (op-1 hybrid-ELL body over global rows of ``C``, plus
the caller's pre-accumulated hub-row tails), written to ``d1``; then the
fused rows from the f32 tile, by the stage the GeMM-SpMM kernel shares.
A warp computes a D1 row with 16-byte gathers of ``C``'s rows from device
memory (L2), so unlike the TPU kernel (which stages all of ``C`` and a
``(t, n)`` one-hot on chip) the kernel has no bound on ``n``.
"""
from __future__ import annotations

import torch

from . import config, ref


def tile_fused_spmm_spmm_wf0(op1_cols: torch.Tensor, op1_vals: torch.Tensor,
                             d1_spill: torch.Tensor, cols0: torch.Tensor,
                             vals0: torch.Tensor, c: torch.Tensor, *, t: int):
    """Run wavefront 0 of SpMM-SpMM.

    Args:
      op1_cols: ``(T0, t, w1)`` int32 op-1 ELL columns, global rows of C.
      op1_vals: ``(T0, t, w1)`` values.
      d1_spill: ``(T0 * t, c_col)`` spill delta (zeros when nothing spills).
      cols0: ``(T0, j0_max, w0)`` int32 tile-local ELL columns of fused rows.
      vals0: ``(T0, j0_max, w0)`` values.
      c: ``(n, c_col)`` dense C.
      t: uniform tile size.
    Returns:
      ``d1 (T0 * t, c_col)``, ``rows0 (T0, j0_max, c_col)``.

    CPU tensors take the plain PyTorch version; CUDA tensors launch the
    kernel or raise."""
    if c.device.type == "cpu":
        return ref.tile_fused_spmm_spmm_wf0(op1_cols, op1_vals, d1_spill,
                                            cols0, vals0, c, t=t)
    lib = config.kernel_library(c.device)
    device = config.check_launch(
        dict(op1_cols=op1_cols, cols0=cols0),
        dict(op1_vals=op1_vals, d1_spill=d1_spill, vals0=vals0, c=c))
    n_tiles, t_in, w1 = op1_cols.shape
    _, j0, w0 = cols0.shape
    c_col = c.shape[1]
    if (t_in != t or op1_vals.shape != op1_cols.shape
            or vals0.shape != cols0.shape or cols0.shape[0] != n_tiles
            or tuple(d1_spill.shape) != (n_tiles * t, c_col)):
        raise ValueError(
            f"tile_fused_spmm_spmm_wf0: op1 {tuple(op1_cols.shape)}, d1_spill "
            f"{tuple(d1_spill.shape)}, cols0 {tuple(cols0.shape)}, c "
            f"{tuple(c.shape)}, t={t}")
    # the D1 block, then the tile's op-1 and fused-row entries on a
    # 16-byte boundary
    cb = config.column_block(t, c_col,
                             fixed_bytes=(t * w1 + j0 * w0) * 8 + 16)
    d1 = torch.empty((n_tiles * t, c_col), dtype=c.dtype, device=device)
    rows0 = torch.empty((n_tiles, j0, c_col), dtype=c.dtype, device=device)
    err = lib.tile_fused_spmm_spmm_wf0_launch(
        op1_cols.data_ptr(), op1_vals.data_ptr(), d1_spill.data_ptr(),
        cols0.data_ptr(), vals0.data_ptr(), c.data_ptr(), d1.data_ptr(),
        rows0.data_ptr(), n_tiles, t, w1, c_col, j0, w0, cb,
        config.DTYPE_CODES[c.dtype], config.stream_of(device))
    config.raise_on_error(err, "tile_fused_spmm_spmm_wf0")
    tile_fused_spmm_spmm_wf0.launches += 1
    return d1, rows0


#: kernel launches since the count was last set to 0
tile_fused_spmm_spmm_wf0.launches = 0
