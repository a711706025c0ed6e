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

Three device functions compute it; ``choose_path`` picks one by shape:
``tile_fused_gemm_spmm_wf0_wgmma_kernel`` runs the product on Hopper's
tensor cores (``wgmma``; f32 as three TF32 products, bf16 directly) in a
persistent grid that stages C once per block, for B rows of at most 512
bytes; ``tile_fused_gemm_spmm_wf0_wgmma_wide_kernel`` does the same for
wider rows, streaming C through a ring of 128-byte k chunks that a
pre-pass writes into a scratch buffer; and
``tile_fused_gemm_spmm_wf0_kernel`` runs it on the CUDA cores for the
shapes neither takes (``t`` not a multiple of 64, ragged widths,
unaligned operands, shared memory over budget).
"""
from __future__ import annotations

import torch

from . import config, ref

WGMMA_KERNEL = "tile_fused_gemm_spmm_wf0_wgmma_kernel"
CORE_KERNEL = "tile_fused_gemm_spmm_wf0_kernel"
WIDE_KERNEL = "tile_fused_gemm_spmm_wf0_wgmma_wide_kernel"
#: the device function of each path code the launcher takes and reports
PATHS = {0: WGMMA_KERNEL, 1: CORE_KERNEL, 2: WIDE_KERNEL, -1: "none"}
_CODES = {name: code for code, name in PATHS.items()}
#: columns of C a block of the wgmma kernels takes at once (the wide
#: kernel's N, zero-padded past ``c_col``)
WGMMA_COLUMN_BLOCK = 128
#: C chunks in flight in the wide kernel's ring
WIDE_STAGES = 2


def _esize(dtype: torch.dtype) -> int:
    return torch.tensor([], dtype=dtype).element_size()


def wgmma_smem_bytes(t: int, b_col: int, c_col: int, j0: int, w0: int,
                     dtype: torch.dtype) -> int:
    """Dynamic shared memory of the wgmma kernel (``csrc`` twin:
    ``wgmma_smem_bytes``): C's column block as the K-major B operand, in
    128-byte blocks of k (1, 2 or 4) over N = 32 or 128 columns, twice for
    f32 (tf32 hi and lo); a f32 D1 tile of row stride N + 8 and the tile's
    fused-row entries (8 bytes each) for each of the two warpgroups; 1,024
    bytes of alignment slack."""
    kb = -(-b_col * _esize(dtype) // 128)
    kb = kb if kb <= 2 else 4
    n = 32 if c_col <= 32 else 128
    copies = 2 if dtype == torch.float32 else 1
    return (copies * kb * n * 128 + 2 * t * (n + 8) * 4 + 2 * j0 * w0 * 8
            + 1024)


def wide_smem_bytes(t: int, j0: int, w0: int, dtype: torch.dtype) -> int:
    """Dynamic shared memory of the wide kernel (``csrc`` twin:
    ``wide_smem_bytes``): a ring of ``WIDE_STAGES`` stages, each 128 bytes
    of k over N = 128 columns of C (16 KiB, twice for f32: tf32 hi and
    lo); a f32 D1 tile of row stride N + 8 and the tile's fused-row entries
    (8 bytes each) for each of the two warpgroups; 64 bytes of mbarriers
    and 1,024 of alignment slack.  B's rows take none (registers)."""
    copies = 2 if dtype == torch.float32 else 1
    n = WGMMA_COLUMN_BLOCK
    return (WIDE_STAGES * copies * n * 128 + 2 * t * (n + 8) * 4
            + 2 * j0 * w0 * 8 + 64 + 1024)


def wide_panel_bytes(b_col: int, c_col: int, dtype: torch.dtype) -> int:
    """Bytes of the wide kernel's scratch: C written once per call as
    ring stages, one per 128-column block and 128 bytes of k."""
    n_chunks = -(-b_col * _esize(dtype) // 128)
    n_cb = -(-c_col // WGMMA_COLUMN_BLOCK)
    copies = 2 if dtype == torch.float32 else 1
    return n_cb * n_chunks * copies * WGMMA_COLUMN_BLOCK * 128


def choose_path(t: int, b_col: int, c_col: int, j0: int, w0: int,
                dtype: torch.dtype, aligned: bool = True) -> str:
    """The device function that runs the shape.  Both tensor-core kernels
    need ``t`` a multiple of 64 (the wgmma's rows), ``b_col`` and
    ``c_col`` multiples of 8 (16-byte rows) and B and C 16-byte aligned
    (``aligned``).  Then ``WGMMA_KERNEL`` takes B rows of at most 512 bytes
    (f32 ``b_col`` ≤ 128, bf16 ≤ 256) and ``WIDE_KERNEL`` wider ones, each
    where its shared memory fits ``config.SMEM_BYTES``; every other shape
    goes to ``CORE_KERNEL``."""
    if t % 64 or b_col % 8 or c_col % 8 or not aligned:
        return CORE_KERNEL
    if b_col * _esize(dtype) > 512:
        fits = wide_smem_bytes(t, j0, w0, dtype) <= config.SMEM_BYTES
        return WIDE_KERNEL if fits else CORE_KERNEL
    if wgmma_smem_bytes(t, b_col, c_col, j0, w0, dtype) > config.SMEM_BYTES:
        return CORE_KERNEL
    return WGMMA_KERNEL


def last_path() -> str:
    """The device function that the last launch on the card ran (the
    launcher records its dispatch), ``"none"`` before any launch or for an
    empty one."""
    lib = config.kernel_library("cuda")
    return PATHS[lib.tile_fused_gemm_spmm_wf0_last_path()]


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
    aligned = b.data_ptr() % 16 == 0 and c.data_ptr() % 16 == 0
    path = choose_path(t, b_col, c_col, j0, w0, c.dtype, aligned)
    panels = None
    if path == WGMMA_KERNEL:
        cb = min(c_col, WGMMA_COLUMN_BLOCK)
    elif path == WIDE_KERNEL:
        cb = WGMMA_COLUMN_BLOCK
        panels = torch.empty(wide_panel_bytes(b_col, c_col, c.dtype),
                             dtype=torch.uint8, device=device)
    else:
        # C and D1 blocks, then the tile's entries on a 16-byte boundary
        cb = config.column_block(t + b_col, c_col,
                                 fixed_bytes=j0 * w0 * 8 + 16)
    d1 = torch.empty((n_tiles * t, c_col), dtype=c.dtype, device=device)
    rows0 = torch.empty((n_tiles, j0, c_col), dtype=c.dtype, device=device)
    err = lib.tile_fused_gemm_spmm_wf0_launch(
        cols0.data_ptr(), vals0.data_ptr(), b.data_ptr(), c.data_ptr(),
        d1.data_ptr(), rows0.data_ptr(),
        None if panels is None else panels.data_ptr(), n_tiles, t, b_col,
        c_col, j0, w0, cb, _CODES[path], config.DTYPE_CODES[c.dtype],
        config.stream_of(device))
    config.raise_on_error(err, "tile_fused_gemm_spmm_wf0")
    tile_fused_gemm_spmm_wf0.launches += 1
    return d1, rows0


#: kernel launches since the count was last set to 0
tile_fused_gemm_spmm_wf0.launches = 0
