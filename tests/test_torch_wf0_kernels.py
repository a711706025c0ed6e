"""CPU checks behind the tensor-core wavefront-0 kernels.

- The tolerance: the GeMM-SpMM kernel computes f32 products as three TF32
  products on the tensor cores (3xTF32).  Emulated here with TF32 rounding
  (round to nearest, ties away, on the f32 bits, as ``cvt.rna.tf32.f32``)
  at the GCN's depth of 128: 3xTF32 stays within 1e-5 of an f64 product,
  relative to its largest value, while one TF32 product misses the 1e-4
  the kernel is held to on the card (``tests/test_torch_gpu.py``,
  ``chip_smoke.py``).
- The same at the sparse-band mixer's depth (b_col 2048): 3xTF32 in the
  wide kernel's order, accumulated in f32 over 32-wide k chunks, stays
  within 1e-5 of f64.
- The launcher's choice of device function, a plain rule on the shape
  (``kernels.tile_fused_gemm_spmm.choose_path``), and the shared memory
  each tensor-core kernel reckons with.
- The unfused library chains that ``chip_smoke.py`` times as the fused
  kernels' yardsticks compute the kernels' function (``kernels/ref.py``).
"""
import numpy as np
import pytest
import torch

from _tf32 import tf32 as _tf32
from repro_torch.kernels import config, ref
from repro_torch.kernels import tile_fused_gemm_spmm as gemm


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_three_tf32_products_ground_the_tolerance(seed):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((64, 128), np.float32))
    b = torch.from_numpy(rng.standard_normal((128, 128), np.float32)
                         / np.float32(128 ** 0.5))
    exact = a.double() @ b.double()
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    assert (a_hi.view(torch.int32) & 0x1FFF).eq(0).all()
    # the kernel's order: lo*hi and hi*lo first, then hi*hi; lo*lo dropped
    three = a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi
    one = a_hi @ b_hi
    scale = float(exact.abs().max())

    def rel(x):
        return float((x.double() - exact).abs().max()) / scale

    assert rel(three) <= 1e-5
    assert rel(one) > 1e-4


@pytest.mark.parametrize("seed", [0, 1])
def test_three_tf32_products_hold_at_the_band_depth(seed):
    """The wide kernel's sum at the band (a 64-row tile, K = 2048, C
    scaled by K^-1/2): within each 32-wide k chunk of the ring, each 8-deep
    k step adds lo*hi, hi*lo, then hi*hi to fresh f32 accumulators, which
    are then added to f32 sums held across the chunks (128 of C's
    columns here)."""
    rng = np.random.default_rng(seed)
    k_depth, n = 2048, 128
    a = torch.from_numpy(rng.standard_normal((64, k_depth), np.float32))
    b = torch.from_numpy(rng.standard_normal((k_depth, n), np.float32)
                         / np.float32(k_depth ** 0.5))
    exact = a.double() @ b.double()
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    total = torch.zeros(64, n)
    for k0 in range(0, k_depth, 32):          # a chunk of the ring
        acc = torch.zeros(64, n)
        for s in range(k0, k0 + 32, 8):       # its four k steps
            ks = slice(s, s + 8)
            acc = acc + a_lo[:, ks] @ b_hi[ks]
            acc = acc + a_hi[:, ks] @ b_lo[ks]
            acc = acc + a_hi[:, ks] @ b_hi[ks]
        total = total + acc
    err = float((total.double() - exact).abs().max())
    assert err / float(exact.abs().max()) <= 1e-5


W, C = gemm.WGMMA_KERNEL, gemm.CORE_KERNEL
WIDE = gemm.WIDE_KERNEL


@pytest.mark.parametrize("t,b_col,c_col,j0,w0,dtype,aligned,want", [
    (64, 128, 128, 56, 17, torch.float32, True, W),     # GCN layer 1
    (64, 128, 128, 56, 17, torch.bfloat16, True, W),
    (128, 128, 32, 120, 17, torch.float32, True, W),    # GCN layer 2
    (128, 128, 32, 120, 17, torch.bfloat16, True, W),
    (64, 8, 8, 30, 5, torch.float32, True, W),          # K = N = 8
    (64, 64, 200, 60, 9, torch.float32, True, W),       # 2 col blocks
    (128, 256, 64, 100, 9, torch.bfloat16, True, W),    # 512-byte rows
    (5, 6, 7, 4, 3, torch.float32, True, C),       # narrow cell
    (5, 6, 7, 4, 3, torch.bfloat16, True, C),
    (2048, 128, 128, 300, 9, torch.float32, True, C),  # t 2048
    (96, 128, 128, 56, 17, torch.float32, True, C),  # t % 64
    (64, 132, 128, 56, 17, torch.float32, True, C),  # b_col % 8
    (64, 128, 100, 56, 17, torch.float32, True, C),  # c_col % 8
    (64, 256, 128, 56, 17, torch.float32, True, WIDE),  # 1 KB rows
    (64, 128, 128, 56, 17, torch.float32, False, C),  # unaligned
    (256, 128, 128, 250, 17, torch.float32, True, C),  # smem
    (64, 2048, 2048, 64, 32, torch.float32, True, WIDE),  # the band
    (64, 1024, 128, 64, 1, torch.float32, True, WIDE),    # mag stack
    (64, 512, 128, 56, 17, torch.bfloat16, True, WIDE),   # bf16 1 KB rows
    (64, 136, 64, 30, 5, torch.float32, True, WIDE),      # 544-byte rows
    (128, 512, 64, 120, 17, torch.bfloat16, True, WIDE),  # 2 m blocks
    (96, 1024, 128, 64, 1, torch.float32, True, C),       # t % 64
    (2048, 2048, 2048, 64, 32, torch.float32, True, C),   # t 2048
    (64, 1024, 128, 64, 1, torch.float32, False, C),      # unaligned
    (64, 1020, 128, 64, 1, torch.float32, True, C),       # b_col % 8
    (64, 1024, 100, 64, 1, torch.float32, True, C),       # c_col % 8
    (64, 2048, 2048, 64, 100, torch.float32, True, C),    # smem: entries
    (128, 256, 64, 100, 9, torch.float32, True, WIDE),    # 2 m blocks
    (192, 256, 64, 100, 9, torch.float32, True, C),       # smem: D1 tiles
])
def test_gemm_spmm_path_rule(t, b_col, c_col, j0, w0, dtype, aligned, want):
    assert gemm.choose_path(t, b_col, c_col, j0, w0, dtype, aligned) == want
    fits = (gemm.wgmma_smem_bytes(t, b_col, c_col, j0, w0, dtype)
            <= config.SMEM_BYTES)
    wide_fits = gemm.wide_smem_bytes(t, j0, w0, dtype) <= config.SMEM_BYTES
    if want == W:
        assert fits
    if want == WIDE:
        assert wide_fits


def test_gcn_layer_1_fills_shared_memory_once():
    """f32 at GCN layer 1: C's hi and lo halves (128 KB), two D1 tiles of
    64 × 136 floats and two tiles' entries fit one block an SM."""
    got = gemm.wgmma_smem_bytes(64, 128, 128, 56, 17, torch.float32)
    assert got == (2 * 4 * 128 * 128 + 2 * 64 * 136 * 4 + 2 * 56 * 17 * 8
                   + 1024)
    assert config.SMEM_BYTES // 2 < got <= config.SMEM_BYTES


def test_band_fits_the_wide_kernel():
    """f32 at the sparse-band mixer's schedule (t 64, j0 64, w0 32): two
    ring stages of C's hi and lo chunk (32 KiB each), two D1 tiles of 64 ×
    136 floats, two tiles' entries, 64 bytes of mbarriers and 1,024 of
    slack fit one block an SM.  The scratch holds C once as stages: 2 ·
    2048 · 2048 · 4 bytes."""
    got = gemm.wide_smem_bytes(64, 64, 32, torch.float32)
    assert got == (2 * 2 * 128 * 128 + 2 * 64 * 136 * 4 + 2 * 64 * 32 * 8
                   + 64 + 1024) == 169_024
    assert config.SMEM_BYTES // 2 < got <= config.SMEM_BYTES
    assert gemm.wide_smem_bytes(64, 64, 32, torch.bfloat16) == got - 2 * (
        128 * 128)
    assert gemm.wide_panel_bytes(2048, 2048, torch.float32) == 32 * 2 ** 20
    # ragged: 2 column blocks (c_col 200) of 5 chunks (b_col 136 f32)
    assert gemm.wide_panel_bytes(136, 200, torch.float32) == (
        2 * 5 * 2 * 128 * 128)


@pytest.mark.parametrize("smem_rows,c_col,fixed,want", [
    (64 + 128, 128, 56 * 17 * 8 + 16, 128),   # CUDA-core GeMM, t = 64
    (2048 + 128, 128, 300 * 9 * 8 + 16, 16),  # t = 2048 with its entries
    (128, 128, (128 * 13 + 120 * 17) * 8 + 16, 128),  # SpMM-SpMM t = 128
])
def test_column_block_leaves_room_for_the_entries(smem_rows, c_col, fixed,
                                                  want):
    cb = config.column_block(smem_rows, c_col, fixed_bytes=fixed)
    assert cb == want
    assert smem_rows * cb * 4 + fixed <= config.SMEM_BYTES


def _ell(rng, shape, n_targets):
    cols = rng.integers(0, n_targets, shape).astype(np.int32)
    vals = rng.standard_normal(shape).astype(np.float32)
    vals[rng.random(shape) < 0.2] = 0.0          # pad slots
    return torch.from_numpy(cols), torch.from_numpy(vals)


@pytest.mark.parametrize("n_tiles,t,j0,w0,b_col,c_col",
                         [(3, 5, 4, 3, 6, 7), (4, 16, 12, 5, 8, 16)])
def test_gemm_spmm_library_chain_matches_ref(n_tiles, t, j0, w0, b_col,
                                             c_col):
    rng = np.random.default_rng(t)
    cols0, vals0 = _ell(rng, (n_tiles, j0, w0), t)
    b = torch.from_numpy(rng.standard_normal((n_tiles * t, b_col),
                                             np.float32))
    c = torch.from_numpy(rng.standard_normal((b_col, c_col), np.float32))
    d1, rows = ref.gemm_spmm_wf0_library(
        ref.fused_rows_csr(cols0, vals0, t), b, c)
    want_d1, want_rows = ref.tile_fused_gemm_spmm_wf0(cols0, vals0, b, c,
                                                      t=t)
    torch.testing.assert_close(d1, want_d1, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rows.reshape(want_rows.shape), want_rows,
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_tiles,t,j0,w0,w1,n,c_col",
                         [(3, 5, 4, 3, 2, 40, 7), (4, 16, 12, 5, 3, 70, 8)])
def test_spmm_spmm_library_chain_matches_ref(n_tiles, t, j0, w0, w1, n,
                                             c_col):
    """op 1 with spill lanes: the chain's CSR holds the lanes, the kernel
    (and ``ref``) take their pre-accumulated delta ``d1_spill``."""
    rng = np.random.default_rng(n)
    op1_cols, op1_vals = _ell(rng, (n_tiles, t, w1), n)
    cols0, vals0 = _ell(rng, (n_tiles, j0, w0), t)
    c = torch.from_numpy(rng.standard_normal((n, c_col), np.float32))
    n_spill = 9
    s_rows = torch.from_numpy(rng.integers(0, n_tiles * t, n_spill))
    s_cols = torch.from_numpy(rng.integers(0, n, n_spill))
    s_vals = torch.from_numpy(rng.standard_normal(n_spill).astype(np.float32))
    spill = torch.zeros(n_tiles * t, c_col)
    spill.index_add_(0, s_rows, s_vals[:, None] * c[s_cols])
    csr1 = ref.ell_csr(op1_cols, op1_vals, n, (s_rows, s_cols, s_vals))
    d1, rows = ref.spmm_spmm_wf0_library(
        csr1, ref.fused_rows_csr(cols0, vals0, t), c)
    want_d1, want_rows = ref.tile_fused_spmm_spmm_wf0(
        op1_cols, op1_vals, spill, cols0, vals0, c, t=t)
    torch.testing.assert_close(d1, want_d1, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(rows.reshape(want_rows.shape), want_rows,
                               rtol=1e-5, atol=1e-5)
