"""Plain PyTorch versions of the three CUDA kernels.

Twins of the oracles in ``repro.kernels.ref``, written for the kernels'
arithmetic: every sum runs in float32 and the result is cast to the
operand dtype once.  The wavefront-0 versions gather the fused rows from
the float32 ``D1`` tile, as the kernels (and the Pallas kernels they
replace) do, before ``d1`` is rounded to the operand dtype.  The wrappers
use these for CPU tensors; on the card they are what ``chip_smoke.py``
holds each kernel against.  Sums over the ELL width run slot by slot, so
no ``(..., w, c)`` gather is ever materialized.
"""
from __future__ import annotations

import torch


def ell_rows_f32(cols: torch.Tensor, vals: torch.Tensor,
                 table: torch.Tensor) -> torch.Tensor:
    """``rows[..., :] = Σ_w vals[..., w] · table[cols[..., w], :]`` in f32."""
    cols = cols.long()
    acc = torch.zeros(cols.shape[:-1] + (table.shape[-1],),
                      dtype=torch.float32, device=table.device)
    for w in range(cols.shape[-1]):
        acc += vals[..., w, None].float() * table[cols[..., w]].float()
    return acc


def _tile_offsets(cols0: torch.Tensor, t: int) -> torch.Tensor:
    """Tile-local ELL columns → rows of the flattened ``(T0 * t, c)`` D1."""
    base = torch.arange(cols0.shape[0], device=cols0.device) * t
    return cols0.long() + base[:, None, None]


def spmm_ell(cols, vals, x):
    """``D[i] = Σ_w vals[i, w] · X[cols[i, w]]``."""
    return ell_rows_f32(cols, vals, x).to(x.dtype)


def tile_fused_gemm_spmm_wf0(cols0, vals0, b, c, *, t: int):
    """``(d1, rows0)``: ``d1 = B @ C`` and the tiles' fused rows."""
    d1 = b.float() @ c.float()
    rows = ell_rows_f32(_tile_offsets(cols0, t), vals0, d1)
    return d1.to(b.dtype), rows.to(b.dtype)


def tile_fused_spmm_spmm_wf0(op1_cols, op1_vals, d1_spill, cols0, vals0, c,
                             *, t: int):
    """``(d1, rows0)``: op-1 ELL over global ``C`` plus the spill delta,
    then the tiles' fused rows."""
    c_col = c.shape[1]
    d1 = (ell_rows_f32(op1_cols, op1_vals, c).reshape(-1, c_col)
          + d1_spill.float())
    rows = ell_rows_f32(_tile_offsets(cols0, t), vals0, d1)
    return d1.to(c.dtype), rows.to(c.dtype)
