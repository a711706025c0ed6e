"""Card-only checks of the port: each CUDA kernel against its plain PyTorch
version, the ``cuda`` arm against the ``torch`` arm (forward, gradients
and a GCN training step, the serving tier's requests), the LM served on
the card, and LM training (the sparse-band mixer and train step on the
kernel arm against the plain arm; the dense train step through
``scan_attention`` against an f64 oracle, remat's gradients, the
trainer's resume), the gated MoE layer (against the same call on the
CPU, bit for bit twice, a MoE prefill launching flash and not the MoE
kernel), MLA, the mamba heads and the chunked recurrence (against the
CPU; the MLA and hybrid prefills launching flash), and the flash kernel at
the cross-attention's shapes with the xLSTM stack, the encoder-decoder and
the vision stub's ``REDUCED`` models against the same models on the CPU,
and the LM over meshes of the card (prefill + decode against one device,
the flash kernel on each member's heads; the MoE layer's mesh path; a
ZeRO-1 train step), and the paper's overlapped and atomic tiling
baselines (one ``spmm_ell`` launch a partition or tile, against the same
schedule on the plain version).

Every test here carries the ``gpu`` marker and skips, with its reason,
where there is no CUDA device of compute capability 9.0+ (the decision is
made in the ``card`` fixture, so every test process collects the same
tests).  This file imports neither ``jax`` nor ``repro``, so it also runs
on a machine with only the port installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances: f32 results within 1e-4 of the plain version relative to its
largest magnitude (the kernels sum in another order), bf16 within 2e-2
(one bf16 rounding of either side).  The LM kernels are held row by row,
each output row against its own largest magnitude (under a causal mask
the first rows are the largest), f32 within 1e-4 and bf16 within 2^-6:
two units in the last place for flash attention (P and the output are
rounded); for the FFN and MoE kernels one rounding of the output plus
the bf16 rounding of H summed over f (test_torch_lm_kernels.py grounds
that limit at published widths, and the f32 kernels' 3xTF32 arithmetic).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.gcn import GCNConfig
from repro_torch.core.sparse import random as gen
from repro_torch.core.sparse.formats import CSR
from repro_torch.core.tilefusion import (api, fused_ops, hetero, reorder,
                                         serving)
from repro_torch.kernels import flash_attention, fused_ffn, ops, ref, spmm
from repro_torch.kernels import tile_fused_gemm_spmm as gemm_wf0
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.models.gcn import GCN
from repro_torch.models.hetero_gcn import HeteroGCNLayer, HeteroGraph

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
ATTN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}
FFN_TOL = ATTN_TOL


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; run on the card")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("the kernels are built for sm_90a (H100 or newer)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel_err(got, want) -> float:
    got, want = got.float(), want.float()
    scale = max(float(want.abs().max()), 1e-30)
    return float((got - want).abs().max()) / scale


def _row_rel_err(got, want) -> float:
    """The largest over rows (last axis) of a row's error relative to the
    row's own largest magnitude."""
    got, want = got.float(), want.float()
    err = (got - want).abs().amax(-1)
    return float((err / want.abs().amax(-1).clamp_min(1e-30)).max())


def _ell(gen_, shape, n_targets, device):
    cols = torch.randint(0, n_targets, shape, generator=gen_,
                         dtype=torch.int32)
    vals = torch.randn(shape, generator=gen_)
    vals[torch.rand(shape, generator=gen_) < 0.2] = 0.0
    return cols.to(device), vals.to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_rows,w,n,c", [(37, 3, 50, 5), (1000, 13, 777, 128),
                                          (4099, 2, 4099, 32)])
def test_spmm_ell_kernel(card, n_rows, w, n, c, dtype):
    g = torch.Generator().manual_seed(n_rows)
    cols, vals = _ell(g, (n_rows, w), n, card)
    x = torch.randn(n, c, generator=g).to(card, dtype)
    vals = vals.to(dtype)
    before = ops.spmm_ell.launches
    got = ops.spmm_ell(cols, vals, x)
    torch.cuda.synchronize()
    assert ops.spmm_ell.launches == before + 1
    assert _rel_err(got, ref.spmm_ell(cols, vals, x)) <= TOL[dtype]


def _hub_hybrid(device, dtype):
    """``hub_powerlaw(16384, 8)`` as a full-matrix hybrid ELL of width cap
    2 with the default tail plan: 33 rows' tails are split (the hub's has
    8,190 entries)."""
    a = gen.hub_powerlaw(16384, 8, seed=0)
    return a, fused_ops.HybridTensors.upload(
        fused_ops.csr_to_ell(a, width_cap=2), device, dtype)


# c = 32 and 128 are the GCN's layer widths (8 and 32 lanes a row), 36 takes
# 16 lanes a row (9 used); mapped rows go to a permuted target in a larger
# out, with pad targets that must stay unwritten
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mapped", [False, True])
@pytest.mark.parametrize("c", [32, 128, 36])
def test_spmm_hybrid_kernel(card, c, mapped, dtype):
    a, hell = _hub_hybrid(card, dtype)
    g = torch.Generator().manual_seed(c)
    x = torch.randn(a.n_cols, c, generator=g).to(card, dtype)
    kw = dict(tails=hell.tails)
    n_rows = a.n_rows
    if mapped:
        n_out = n_rows + 100
        target = torch.randperm(n_out, generator=g)[:n_rows]
        target[torch.rand(n_rows, generator=g) < 0.1] = n_out    # pads
        kw["out_rows"] = target.to(card, torch.int32)

    def run():
        if not mapped:
            return ops.spmm_ell(hell.cols, hell.vals, x, **kw)
        out = torch.full((n_out, c), -7.0, device=card, dtype=dtype)
        return ops.spmm_ell(hell.cols, hell.vals, x, out=out, **kw)
    before = ops.spmm_ell.launches
    got = run()
    torch.cuda.synchronize()
    assert ops.spmm_ell.launches == before + 1     # two device launches
    assert spmm.last_path() == "row+split"
    out0 = (None if not mapped else
            torch.full((n_out, c), -7.0, device=card, dtype=dtype))
    want = ref.spmm_ell(hell.cols, hell.vals, x, out=out0, **kw)
    assert _rel_err(got, want) <= TOL[dtype]
    if mapped:
        kept = torch.ones(n_out, dtype=torch.bool, device=card)
        kept[kw["out_rows"].long()[kw["out_rows"] < n_out]] = False
        assert bool((got[kept] == -7.0).all())
    assert torch.equal(got, run())               # the same bits again


def test_spmm_body_only_runs_one_pass(card):
    g = torch.Generator().manual_seed(3)
    cols, vals = _ell(g, (500, 4), 300, card)
    x = torch.randn(300, 64, generator=g).to(card)
    ops.spmm_ell(cols, vals, x)
    torch.cuda.synchronize()
    assert spmm.last_path() == "row"


# (3, 5, ...) and t = 2048 run the CUDA-core kernel, rows of 1 KB (b_col
# 256, f32: two m blocks a tile) the wide wgmma kernel; the others the
# wgmma kernel: N = 128
# and N = 32 (GCN layers 1 and 2), tile counts that leave warpgroups idle
# or uneven (7, 37, 300), K = N = 8, c_col > 128 (two column blocks), w0 >
# 32 with a ragged last k block (b_col 40), 512-byte rows of B in bf16, and
# one k block at N = 128 over 2,048 tiles (b_col 32: the backward's dB of
# GCN layer 2)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_tiles,t,j0,w,b_col,c_col",
                         [(3, 5, 4, 3, 6, 7), (64, 64, 56, 17, 128, 128),
                          (16, 128, 120, 17, 128, 32), (2, 2048, 300, 9, 128,
                                                        128),
                          (37, 64, 56, 17, 128, 128), (300, 128, 120, 17, 128,
                                                        32),
                          (7, 64, 30, 5, 8, 8), (5, 64, 60, 9, 64, 200),
                          (3, 64, 60, 33, 40, 48), (9, 128, 100, 9, 256, 64),
                          (2048, 64, 56, 9, 32, 128)])
def test_gemm_spmm_wf0_kernel(card, n_tiles, t, j0, w, b_col, c_col, dtype):
    g = torch.Generator().manual_seed(t)
    cols0, vals0 = _ell(g, (n_tiles, j0, w), t, card)
    b = torch.randn(n_tiles * t, b_col, generator=g).to(card, dtype)
    c = (torch.randn(b_col, c_col, generator=g) / b_col ** 0.5).to(card,
                                                                   dtype)
    vals0 = vals0.to(dtype)
    d1, rows0 = ops.tile_fused_gemm_spmm_wf0(cols0, vals0, b, c, t=t)
    want_d1, want_rows = ref.tile_fused_gemm_spmm_wf0(cols0, vals0, b, c, t=t)
    torch.cuda.synchronize()
    assert gemm_wf0.last_path() == gemm_wf0.choose_path(t, b_col, c_col, j0,
                                                        w, dtype)
    assert _rel_err(d1, want_d1) <= TOL[dtype]
    assert _rel_err(rows0, want_rows) <= TOL[dtype]


def _misaligned_copy(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` that starts one element past an aligned
    address."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = flat[1:].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.parametrize("dtype,t,b_col,c_col,aligned,path", [
    (torch.float32, 64, 128, 128, True, "tile_fused_gemm_spmm_wf0_wgmma_kernel"),
    (torch.bfloat16, 64, 128, 128, True,
     "tile_fused_gemm_spmm_wf0_wgmma_kernel"),
    (torch.float32, 128, 128, 32, True, "tile_fused_gemm_spmm_wf0_wgmma_kernel"),
    (torch.bfloat16, 128, 128, 32, True,
     "tile_fused_gemm_spmm_wf0_wgmma_kernel"),
    # the backward's dB of GCN layer 2: one k block at N = 128
    (torch.float32, 64, 32, 128, True, "tile_fused_gemm_spmm_wf0_wgmma_kernel"),
    (torch.bfloat16, 64, 32, 128, True,
     "tile_fused_gemm_spmm_wf0_wgmma_kernel"),
    (torch.float32, 64, 128, 128, False, "tile_fused_gemm_spmm_wf0_kernel"),
    (torch.float32, 96, 128, 128, True, "tile_fused_gemm_spmm_wf0_kernel"),
    (torch.bfloat16, 64, 128, 36, True, "tile_fused_gemm_spmm_wf0_kernel"),
    # rows over 512 bytes: the wide kernel, or the CUDA-core one where t is
    # not a multiple of 64 or B is unaligned
    (torch.float32, 64, 1024, 128, True,
     "tile_fused_gemm_spmm_wf0_wgmma_wide_kernel"),
    (torch.bfloat16, 64, 512, 128, True,
     "tile_fused_gemm_spmm_wf0_wgmma_wide_kernel"),
    (torch.bfloat16, 128, 512, 64, True,
     "tile_fused_gemm_spmm_wf0_wgmma_wide_kernel"),
    (torch.float32, 128, 160, 64, True, "tile_fused_gemm_spmm_wf0_kernel"),
    (torch.float32, 96, 1024, 128, True, "tile_fused_gemm_spmm_wf0_kernel"),
    (torch.float32, 64, 1024, 128, False, "tile_fused_gemm_spmm_wf0_kernel")])
def test_gemm_spmm_wf0_dispatch_path(card, dtype, t, b_col, c_col, aligned,
                                     path):
    """Each path runs its own device function, as the launcher records it,
    and agrees with the plain version."""
    g = torch.Generator().manual_seed(t + c_col)
    n_tiles, j0, w = 20, t - 8, 17
    cols0, vals0 = _ell(g, (n_tiles, j0, w), t, card)
    b = torch.randn(n_tiles * t, b_col, generator=g).to(card, dtype)
    c = (torch.randn(b_col, c_col, generator=g) / b_col ** 0.5).to(card,
                                                                   dtype)
    if not aligned:
        b = _misaligned_copy(b)
        assert b.data_ptr() % 16 != 0 and b.is_contiguous()
    vals0 = vals0.to(dtype)
    d1, rows0 = ops.tile_fused_gemm_spmm_wf0(cols0, vals0, b, c, t=t)
    torch.cuda.synchronize()
    assert gemm_wf0.last_path() == path
    want_d1, want_rows = ref.tile_fused_gemm_spmm_wf0(cols0, vals0, b, c, t=t)
    assert _rel_err(d1, want_d1) <= TOL[dtype]
    assert _rel_err(rows0, want_rows) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", ["gemm", "spmm"])
def test_wf0_kernels_are_deterministic(card, kernel, dtype):
    """No float atomics: the same inputs give the same bits, at the GCN
    layer-1 shape (GeMM-SpMM, wgmma) and the SpMM-SpMM phase-3 shape."""
    g = torch.Generator().manual_seed(11)
    if kernel == "gemm":
        cols0, vals0 = _ell(g, (64, 56, 17), 64, card)
        args = (cols0, vals0.to(dtype),
                torch.randn(64 * 64, 128, generator=g).to(card, dtype),
                (torch.randn(128, 128, generator=g) / 128 ** 0.5).to(card,
                                                                     dtype))
        run = lambda: ops.tile_fused_gemm_spmm_wf0(*args, t=64)  # noqa: E731
    else:
        op1_cols, op1_vals = _ell(g, (32, 128, 13), 4096, card)
        cols0, vals0 = _ell(g, (32, 120, 17), 128, card)
        args = (op1_cols, op1_vals.to(dtype),
                torch.randn(32 * 128, 128, generator=g).to(card, dtype),
                cols0, vals0.to(dtype),
                torch.randn(4096, 128, generator=g).to(card, dtype))
        run = lambda: ops.tile_fused_spmm_spmm_wf0(*args, t=128)  # noqa: E731
    first = run()
    again = run()
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_tiles,t,j0,w0,w1,n,c_col",
                         [(3, 5, 4, 3, 2, 40, 7), (32, 128, 120, 17, 13,
                                                   4096, 128),
                          # 20 op-1 entries: two rounds of 16 gathers; 32
                          # columns: 4 rows a warp; 200: two column blocks
                          (9, 64, 60, 9, 20, 3000, 32), (4, 96, 90, 5, 3, 500,
                                                         200)])
def test_spmm_spmm_wf0_kernel(card, n_tiles, t, j0, w0, w1, n, c_col, dtype):
    g = torch.Generator().manual_seed(t + n)
    op1_cols, op1_vals = _ell(g, (n_tiles, t, w1), n, card)
    cols0, vals0 = _ell(g, (n_tiles, j0, w0), t, card)
    spill = torch.randn(n_tiles * t, c_col, generator=g).to(card, dtype)
    c = torch.randn(n, c_col, generator=g).to(card, dtype)
    args = (op1_cols, op1_vals.to(dtype), spill, cols0, vals0.to(dtype), c)
    d1, rows0 = ops.tile_fused_spmm_spmm_wf0(*args, t=t)
    want_d1, want_rows = ref.tile_fused_spmm_spmm_wf0(*args, t=t)
    torch.cuda.synchronize()
    assert _rel_err(d1, want_d1) <= TOL[dtype]
    assert _rel_err(rows0, want_rows) <= TOL[dtype]


def test_wrappers_check_their_inputs(card):
    x = torch.randn(8, 4, device=card)
    cols = torch.zeros(8, 2, dtype=torch.int32, device=card)
    with pytest.raises(TypeError, match="int32"):
        ops.spmm_ell(cols.long(), torch.ones(8, 2, device=card), x)
    with pytest.raises(ValueError, match="contiguous"):
        ops.spmm_ell(cols, torch.ones(2, 8, device=card).t(), x)
    with pytest.raises(TypeError, match="dtype"):
        ops.spmm_ell(cols, torch.ones(8, 2, device=card), x.double())
    vals = torch.ones(8, 2, device=card)
    plan = spmm.plan_tails(np.array([0, 0, 3]), 8, 2)
    tails = spmm.Tails.upload(plan, [1, 2, 3], [1.0, 1.0, 1.0], card,
                              torch.float32)
    with pytest.raises(TypeError, match="int32"):
        ops.spmm_ell(cols, vals, x, out=torch.empty(9, 4, device=card),
                     out_rows=torch.zeros(8, dtype=torch.int64,
                                          device=card))
    with pytest.raises(TypeError, match="dtype"):
        ops.spmm_ell(cols, vals, x, tails=dataclasses.replace(
            tails, vals=tails.vals.to(torch.bfloat16)))
    with pytest.raises(ValueError, match="contiguous"):
        ops.spmm_ell(cols, vals, x, out=torch.empty(4, 8, device=card).t())
    with pytest.raises(ValueError, match="out_rows needs out"):
        ops.spmm_ell(cols, vals, x, out_rows=torch.zeros(
            8, dtype=torch.int32, device=card))
    with pytest.raises(ValueError, match="tails"):
        ops.spmm_ell(cols[:5], vals[:5], x, tails=tails)
    with pytest.raises(ValueError, match="several devices"):
        ops.spmm_ell(cols, vals, x, out=torch.empty(8, 4))


@pytest.mark.parametrize("op_pair", ["gemm", "spmm"])
def test_cuda_arm_matches_torch_arm(card, op_pair):
    a = gen.banded_spd(16384, 8, seed=1)
    rng = np.random.default_rng(0)
    c_shape = (a.n_rows, 64) if op_pair == "spmm" else (64, 64)
    c = torch.from_numpy(rng.standard_normal(c_shape, np.float32)).to(card)
    b = (a if op_pair == "spmm" else torch.from_numpy(
        rng.standard_normal((a.n_rows, 64), np.float32)).to(card))
    entry = api.get_schedule(a, b_col=64, c_col=64,
                             b_is_sparse=(op_pair == "spmm"))
    assert api.select_backend(entry, card) == "cuda"
    ops.reset_launch_counts()
    got = api.tile_fused_matmul(a, b, c)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    wf0 = ("tile_fused_spmm_spmm_wf0" if op_pair == "spmm"
           else "tile_fused_gemm_spmm_wf0")
    assert counts[wf0] == 1
    assert counts["spmm_ell"] == (1 if entry.dsched.j_rows1.size else 0)
    want = api.tile_fused_matmul(a, b, c, backend="torch")
    assert _rel_err(got, want) <= 2e-3


def test_auto_raises_for_a_non_uniform_schedule(card):
    """``uniform_split=False`` on the card: ``auto`` raises rather than run
    the plain executors; ``backend="torch"`` still runs them."""
    dense = gen.banded_spd(64, 3, seed=1).to_dense()
    dense[::2, :] = 0.0                 # the parity matrix's empty-rows cell
    a = CSR.from_dense(dense)
    spec = api.FusionSpec(p=2, cache_size=1_000.0, ct_size=32,
                          uniform_split=False)
    c = torch.randn(64, 4, device=card)
    with pytest.raises(ValueError, match="uniform_split"):
        api.tile_fused_matmul(a, a, c, spec=spec)
    want = torch.from_numpy(dense @ (dense @ c.cpu().double().numpy()))
    got = api.tile_fused_matmul(a, a, c, spec=spec, backend="torch")
    assert _rel_err(got.cpu(), want) <= 2e-3


def test_gcn_serves_on_the_card(card):
    cfg = GCNConfig(n_nodes=16384)
    for adj, pick in ((gen.banded_spd(cfg.n_nodes, 8, seed=0), "cuda"),
                      (gen.powerlaw_graph(cfg.n_nodes, 8, seed=0),
                       "unfused")):
        model = GCN(cfg, adj)           # default device: the card
        assert model.weights[0].is_cuda
        assert model.layer_backends()[0] == pick
        x = torch.randn(cfg.n_nodes, cfg.in_dim, device=card)
        ops.reset_launch_counts()
        with torch.inference_mode():
            got = model(x)
            torch.cuda.synchronize()
            assert ops.launch_counts()["spmm_ell"] > 0
            assert _rel_err(got, model(x, backend="torch")) <= 2e-3


def _non_symmetric(n: int) -> CSR:
    """``banded_spd(n, 8)`` with every other row emptied (the parity
    matrix's empty-rows cell at size): ``Aᵀ != A``, and the row and column
    degrees differ."""
    a = gen.banded_spd(n, 8, seed=2)
    lens = np.diff(a.indptr)
    keep = np.arange(a.n_rows) % 2 == 1
    flat = np.repeat(keep, lens)
    indptr = np.concatenate([[0], np.cumsum(np.where(keep, lens, 0))])
    return CSR(a.n_rows, a.n_cols, indptr.astype(a.indptr.dtype),
               a.indices[flat], a.data[flat])


def _grads(a, op_pair, backend, loss, card):
    """Gradients of ``loss(D)`` w.r.t. the dense operands, and the kernel
    launches of the backward alone."""
    rng = np.random.default_rng(4)

    def leaf(*shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            card).requires_grad_()
    if op_pair == "spmm":
        leaves = [leaf(a.n_cols, 64)]
        d = api.tile_fused_matmul(a, a, leaves[0], backend=backend)
    else:
        leaves = [leaf(a.n_cols, 64), leaf(64, 64)]
        d = api.tile_fused_matmul(a, *leaves, backend=backend)
    w = torch.from_numpy(rng.standard_normal(tuple(d.shape),
                                             np.float32)).to(card)
    value = d.sum() if loss == "sum" else (w * d).sum()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    value.backward()
    torch.cuda.synchronize()
    return [x.grad for x in leaves], ops.launch_counts()


@pytest.mark.parametrize("loss", ["sum", "weighted"])
@pytest.mark.parametrize("pattern", ["banded", "non-symmetric"])
@pytest.mark.parametrize("op_pair", ["gemm", "spmm"])
def test_grads_match_torch_arm(card, op_pair, pattern, loss):
    """The backward on the card (transpose entries; the wavefront-0 kernel
    where Eq-3 fuses the transpose entry; ``spmm_ell`` for ``Aᵀ·Ḋ``)
    against ``backend="torch"``; ``D.sum()`` hands it a stride-0
    cotangent."""
    a = (gen.banded_spd(4096, 8, seed=1) if pattern == "banded"
         else _non_symmetric(4096))
    got, counts = _grads(a, op_pair, "auto", loss, card)
    want, _ = _grads(a, op_pair, "torch", loss, card)
    for g, w in zip(got, want, strict=True):
        assert _rel_err(g, w) <= 2e-3
    entry = api.get_schedule(a, b_col=64, c_col=64,
                             b_is_sparse=op_pair == "spmm",
                             spec=api.FusionSpec(transpose=True))
    wf0 = ("tile_fused_spmm_spmm_wf0" if op_pair == "spmm"
           else "tile_fused_gemm_spmm_wf0")
    fused = api.select_backend(entry, card) == "cuda"
    assert counts[wf0] == (1 if fused else 0)
    if pattern == "banded":
        assert fused
    if op_pair == "gemm":
        assert counts["spmm_ell"] >= 1          # Aᵀ·Ḋ


@pytest.mark.parametrize("graph", ["banded", "powerlaw"])
def test_gcn_train_step_matches_plain_path(card, graph):
    """One SGD step of the CONFIG-width GCN on the card against the same
    step with ``backend="torch"``: the loss and the updated weights."""
    from repro_torch.launch.steps import make_gcn_train_step
    cfg = GCNConfig(n_nodes=8192)
    adj = (gen.banded_spd(cfg.n_nodes, 8, seed=0) if graph == "banded"
           else gen.powerlaw_graph(cfg.n_nodes, 8, seed=0))
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((cfg.n_nodes, cfg.in_dim),
                                             np.float32)).to(card)
    y = torch.from_numpy(rng.integers(0, cfg.out_dim, cfg.n_nodes)).to(card)
    out = {}
    for backend in ("auto", "torch"):
        model = GCN(cfg, adj, seed=3)
        ops.reset_launch_counts()
        loss = make_gcn_train_step(model, backend=backend)(x, y)
        torch.cuda.synchronize()
        out[backend] = (float(loss), [w.detach() for w in model.weights],
                        ops.launch_counts())
    (loss, weights, counts), (want, want_w, _) = out["auto"], out["torch"]
    assert abs(loss - want) <= 2e-3 * abs(want)
    for w, v in zip(weights, want_w, strict=True):
        assert _rel_err(w, v) <= 2e-3
    # each layer's Aᵀ·Ḋ runs the hybrid SpMM kernel, besides the forward's
    assert counts["spmm_ell"] >= 2 * cfg.n_layers
    if graph == "banded":
        # two forward layers and layer 2's dB; that dB ran last
        assert counts["tile_fused_gemm_spmm_wf0"] == cfg.n_layers + 1
        assert gemm_wf0.last_path() == gemm_wf0.WGMMA_KERNEL


def test_backward_gives_the_same_bits_twice(card):
    """The GeMM-SpMM backward (the GCN's) has no float atomics.  SpMM-SpMM
    does not promise this: its dense op-1 spill delta is a scatter-add
    (``fused_ops.op1_spill``; ROADMAP Queue 2 item D)."""
    a = gen.banded_spd(4096, 8, seed=1)
    first, _ = _grads(a, "gemm", "auto", "weighted", card)
    again, _ = _grads(a, "gemm", "auto", "weighted", card)
    assert all(torch.equal(x, y) for x, y in zip(first, again, strict=True))


def _shuffled_banded(n: int, seed: int = 0) -> CSR:
    """``banded_spd(n, 8)`` under a seeded symmetric permutation: it fuses
    nothing as given, and ``reorder="auto"`` restores the band (RCM)."""
    return reorder.permute_csr(gen.banded_spd(n, 8, seed=seed),
                               np.random.default_rng(seed).permutation(n))


#: the schedule transforms of FusionSpec, each on the 4,096-node matrix
#: whose entry it changes
TRANSFORMS = {"reorder": (dict(reorder="auto"), _shuffled_banded),
              "autotune": (dict(autotune=True),
                           lambda n: gen.banded_spd(n, 8, seed=1))}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op_pair", ["gemm", "spmm"])
@pytest.mark.parametrize("transform", sorted(TRANSFORMS))
def test_wf0_kernels_on_transformed_schedules(card, transform, op_pair,
                                              dtype):
    """The wavefront-0 kernels at the tile size, fused rows and widths of a
    reordered and of an autotuned schedule, against their plain versions
    (GeMM-SpMM on the device function its rule picks for the shape); then
    the whole product on the kernel arm against the plain arm."""
    knobs, make = TRANSFORMS[transform]
    a = make(4096)
    spec = api.FusionSpec(**knobs)
    sparse = op_pair == "spmm"
    entry = api.get_schedule(a, b_col=128, c_col=128, b_is_sparse=sparse,
                             spec=spec)
    assert (entry.reorder if transform == "reorder"
            else entry.autotuned) is not None
    assert api.select_backend(entry, card) == "cuda"
    ds = entry.dsched
    t, j0, w0 = ds.t_pad, ds.j_rows0.shape[1], ds.ell_cols0.shape[2]
    st = fused_ops.schedule_tensors(ds, card, dtype)
    g = torch.Generator().manual_seed(5)
    if sparse:
        a1 = (a if entry.reorder_perm is None
              else reorder.permute_rows_cached(a, entry.reorder_perm))
        ot = fused_ops.op1_tensors(a1, ds, card, dtype)
        cs = torch.randn(a.n_cols, 128, generator=g).to(card, dtype)
        spill = fused_ops.op1_spill(ot, cs, ds.n_tiles0 * t)
        args = (ot.cols, ot.vals, spill, st.cols0, st.vals0, cs)
        got = ops.tile_fused_spmm_spmm_wf0(*args, t=t)
        want = ref.tile_fused_spmm_spmm_wf0(*args, t=t)
    else:
        b = torch.randn(ds.n_tiles0 * t, 128, generator=g).to(card, dtype)
        c = (torch.randn(128, 128, generator=g) / 128 ** 0.5).to(card, dtype)
        got = ops.tile_fused_gemm_spmm_wf0(st.cols0, st.vals0, b, c, t=t)
        want = ref.tile_fused_gemm_spmm_wf0(st.cols0, st.vals0, b, c, t=t)
        torch.cuda.synchronize()
        assert gemm_wf0.last_path() == gemm_wf0.choose_path(
            t, 128, 128, j0, w0, dtype)
    for x, y in zip(got, want, strict=True):
        assert _rel_err(x, y) <= TOL[dtype]
    if dtype == torch.float32:
        rng = np.random.default_rng(6)
        c = torch.from_numpy(rng.standard_normal(
            (a.n_cols, 128) if sparse else (128, 128), np.float32)).to(card)
        b = a if sparse else torch.from_numpy(rng.standard_normal(
            (a.n_cols, 128), np.float32)).to(card)
        ops.reset_launch_counts()
        got = api.tile_fused_matmul(a, b, c, spec=spec)
        torch.cuda.synchronize()
        wf0 = ("tile_fused_spmm_spmm_wf0" if sparse
               else "tile_fused_gemm_spmm_wf0")
        assert ops.launch_counts()[wf0] == 1
        want = api.tile_fused_matmul(a, b, c, backend="torch")
        assert _rel_err(got, want) <= 2e-3


def test_reordered_gemm_spmm_gives_the_same_bits_twice(card):
    """The permutation in and out (``index_select``) and the kernels keep
    the reordered GeMM-SpMM bit-reproducible."""
    a = _shuffled_banded(4096)
    spec = api.FusionSpec(reorder="auto")
    rng = np.random.default_rng(8)
    b = torch.from_numpy(rng.standard_normal((4096, 128), np.float32)).to(card)
    c = torch.from_numpy(rng.standard_normal((128, 128), np.float32)).to(card)
    first = api.tile_fused_matmul(a, b, c, backend="cuda", spec=spec)
    again = api.tile_fused_matmul(a, b, c, backend="cuda", spec=spec)
    torch.cuda.synchronize()
    assert api.get_schedule(a, b_col=128, c_col=128,
                            spec=spec).reorder is not None
    assert torch.equal(first, again)


def _crop(a: CSR, n_rows: int, n_cols: int) -> CSR:
    """The leading ``n_rows × n_cols`` block of ``a``."""
    end = a.indptr[n_rows]
    rows = np.repeat(np.arange(n_rows), np.diff(a.indptr)[:n_rows])
    keep = a.indices[:end] < n_cols
    return CSR.from_coo(n_rows, n_cols, rows[keep], a.indices[:end][keep],
                        a.data[:end][keep])


def _typed_relations(n: int, in_dim: int, card, dtype, sparse=False):
    """Four relations of distinct rectangular shapes around ``n`` nodes
    (power-law and banded patterns), as ``hetero_fused_matmul`` triples."""
    g = torch.Generator().manual_seed(n)
    rels = []
    for i, (nj, ni) in enumerate([(n, n), (n // 2, n), (n, n // 2),
                                  (n // 4, n // 4)]):
        sq = (gen.banded_spd(max(nj, ni), 8, seed=i) if i % 2
              else gen.powerlaw_graph(max(nj, ni), 8, seed=i))
        a = _crop(sq, nj, ni)
        if sparse:
            a1 = gen.powerlaw_graph(ni, 8, seed=10 + i)
            c = torch.randn(ni, in_dim, generator=g).to(card, dtype)
            rels.append((a, a1, c))
        else:
            b = torch.randn(ni, in_dim, generator=g).to(card, dtype)
            c = (torch.randn(in_dim, 64, generator=g) / in_dim ** 0.5).to(
                card, dtype)
            rels.append((a, b, c))
    return rels


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gemm_spmm_core_path_at_a_hetero_stack_shape(card, dtype,
                                                    monkeypatch):
    """A stacked GeMM-SpMM is ``b_col`` = Σ in-dims wide (512 here): B's
    row is past the wgmma kernel's 512 bytes, so the launcher takes the
    device function ``choose_path`` picks for the stack's schedule (the
    wide kernel where t is a multiple of 64, else the CUDA-core kernel),
    and agrees with the per-relation plain loop.  The loop runs in f32 on
    the same inputs: the plain path in bf16 rounds each product before it
    sums, and on the card it differed from the kernel (which sums in f32)
    by 7.3e-2 of the largest value on the relation with a 629-entry hub
    row."""
    rels = _typed_relations(2048, 128, card, dtype)
    picks = []
    rule = gemm_wf0.choose_path

    def record(*args):
        picks.append(rule(*args))
        return picks[-1]
    monkeypatch.setattr(gemm_wf0, "choose_path", record)
    ops.reset_launch_counts()
    got = hetero.hetero_fused_matmul(rels, backend="cuda")
    torch.cuda.synchronize()
    assert ops.launch_counts()["tile_fused_gemm_spmm_wf0"] == 1
    assert picks and gemm_wf0.last_path() == picks[-1]
    assert picks[-1] != gemm_wf0.WGMMA_KERNEL
    want = hetero.hetero_loop_matmul(
        [(a, b.float(), c.float()) for a, b, c in rels], backend="torch")
    tol = 2e-3 if dtype == torch.float32 else 2e-2
    for x, y in zip(got, want, strict=True):
        assert _rel_err(x, y) <= tol


def test_gemm_spmm_core_path_below_64_row_tiles(card):
    """The twin of the cell above at a shape the tensor-core kernels do
    not take: t 96 (not a multiple of 64) at the stack's 2 KB rows (b_col
    512, f32) and at 4 KB rows (b_col 1024) runs the CUDA-core kernel,
    whose rows never pass the tile, against its plain version."""
    for b_col in (512, 1024):
        g = torch.Generator().manual_seed(b_col)
        t, n_tiles, j0, w = 96, 9, 80, 5
        cols0, vals0 = _ell(g, (n_tiles, j0, w), t, card)
        b = torch.randn(n_tiles * t, b_col, generator=g).to(card)
        c = (torch.randn(b_col, 64, generator=g) / b_col ** 0.5).to(card)
        d1, rows0 = ops.tile_fused_gemm_spmm_wf0(cols0, vals0, b, c, t=t)
        torch.cuda.synchronize()
        assert gemm_wf0.last_path() == gemm_wf0.CORE_KERNEL
        want_d1, want_rows = ref.tile_fused_gemm_spmm_wf0(cols0, vals0, b,
                                                          c, t=t)
        assert _rel_err(d1, want_d1) <= TOL[torch.float32]
        assert _rel_err(rows0, want_rows) <= TOL[torch.float32]


def _band_entry(transpose: bool):
    """The full-width sparse-band mixer's schedule (stablelm-1.6b, S 2048,
    window 32): its forward entry, or its dB entry against Aᵀ."""
    from repro_torch.models import ssm as S
    band = S.decay_band_csr(2048, 32, 0.9)
    spec = dataclasses.replace(S._BAND_SPEC, dtype_bytes=4,
                               transpose=transpose)
    return api.get_schedule(band, b_col=2048, c_col=2048, spec=spec)


@pytest.mark.parametrize("transpose", [False, True])
def test_gemm_spmm_wide_kernel_at_the_band(card, transpose):
    """GeMM-SpMM at the sparse-band mixer's shapes (t 64, 32 tiles, b_col
    = c_col = 2048, f32; the forward entry and the non-symmetric dB entry)
    runs the wide wgmma kernel and agrees with the plain version."""
    ds = _band_entry(transpose).dsched
    st = fused_ops.schedule_tensors(ds, card, torch.float32)
    g = torch.Generator().manual_seed(22 + transpose)
    b = torch.randn(ds.n_tiles0 * ds.t_pad, 2048, generator=g).to(card)
    c = (torch.randn(2048, 2048, generator=g) / 2048 ** 0.5).to(card)
    d1, rows0 = ops.tile_fused_gemm_spmm_wf0(st.cols0, st.vals0, b, c,
                                             t=ds.t_pad)
    torch.cuda.synchronize()
    assert gemm_wf0.last_path() == gemm_wf0.WIDE_KERNEL
    want_d1, want_rows = ref.tile_fused_gemm_spmm_wf0(st.cols0, st.vals0, b,
                                                      c, t=ds.t_pad)
    assert _rel_err(d1, want_d1) <= TOL[torch.float32]
    assert _rel_err(rows0, want_rows) <= TOL[torch.float32]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_tiles,j0,w,c_col", [
    (301, 64, 1, 128),    # the mag-shaped stack's tiles; an odd tile count
    (40, 60, 9, 200)])    # ragged c_col: the second block zero-padded to N
def test_gemm_spmm_wide_kernel_at_a_stack_shape(card, n_tiles, j0, w,
                                                c_col, dtype):
    """The wide kernel at the ogbn-mag-shaped stack's b_col 1024 (t 64),
    f32 and bf16, against the plain version."""
    g = torch.Generator().manual_seed(n_tiles)
    cols0, vals0 = _ell(g, (n_tiles, j0, w), 64, card)
    b = torch.randn(n_tiles * 64, 1024, generator=g).to(card, dtype)
    c = (torch.randn(1024, c_col, generator=g) / 1024 ** 0.5).to(card,
                                                                  dtype)
    vals0 = vals0.to(dtype)
    d1, rows0 = ops.tile_fused_gemm_spmm_wf0(cols0, vals0, b, c, t=64)
    torch.cuda.synchronize()
    assert gemm_wf0.last_path() == gemm_wf0.WIDE_KERNEL
    want_d1, want_rows = ref.tile_fused_gemm_spmm_wf0(cols0, vals0, b, c,
                                                      t=64)
    assert _rel_err(d1, want_d1) <= TOL[dtype]
    assert _rel_err(rows0, want_rows) <= TOL[dtype]


def test_gemm_spmm_wide_kernel_gives_the_same_bits_twice(card):
    """The wide kernel sums every output in one fixed order."""
    g = torch.Generator().manual_seed(3)
    cols0, vals0 = _ell(g, (33, 64, 8), 64, card)
    b = torch.randn(33 * 64, 2048, generator=g).to(card)
    c = (torch.randn(2048, 256, generator=g) / 2048 ** 0.5).to(card)
    first = ops.tile_fused_gemm_spmm_wf0(cols0, vals0, b, c, t=64)
    again = ops.tile_fused_gemm_spmm_wf0(cols0, vals0, b, c, t=64)
    torch.cuda.synchronize()
    assert gemm_wf0.last_path() == gemm_wf0.WIDE_KERNEL
    assert all(torch.equal(x, y) for x, y in zip(first, again))


def test_hetero_spmm_spmm_stack_on_the_card(card):
    rels = _typed_relations(2048, 64, card, torch.float32, sparse=True)
    ops.reset_launch_counts()
    got = hetero.hetero_fused_matmul(rels, backend="cuda")
    torch.cuda.synchronize()
    assert ops.launch_counts()["tile_fused_spmm_spmm_wf0"] == 1
    want = hetero.hetero_loop_matmul(rels, backend="torch")
    for x, y in zip(got, want, strict=True):
        assert _rel_err(x, y) <= 2e-3


@pytest.mark.parametrize("backend", ["auto", "cuda"])
def test_hetero_gcn_layer_on_the_card(card, backend):
    """``HeteroGCNLayer`` (default device: the card) against its loop and
    the plain path, forward and weight gradients."""
    counts = {"paper": 4096, "author": 6144, "field": 512}
    shapes = {("author", "writes", "paper"): (4096, 6144),
              ("paper", "cites", "paper"): (4096, 4096),
              ("paper", "has_topic", "field"): (512, 4096),
              ("paper", "rev_writes", "author"): (6144, 4096)}
    relations = {}
    for i, (key, (nj, ni)) in enumerate(sorted(shapes.items())):
        relations[key] = _crop(gen.powerlaw_graph(max(nj, ni), 8, seed=i),
                               nj, ni)
    in_dims = dict.fromkeys(counts, 64)
    layer = HeteroGCNLayer(HeteroGraph(counts, relations), in_dims, 32,
                           backend=backend)
    assert layer.weights[0].is_cuda
    g = torch.Generator().manual_seed(0)
    feats = {t: torch.randn(n, 64, generator=g).to(card)
             for t, n in counts.items()}
    ops.reset_launch_counts()
    with torch.inference_mode():
        got = layer(feats)
        torch.cuda.synchronize()
        assert ops.launch_counts()["spmm_ell"] > 0
        if backend == "cuda":
            assert ops.launch_counts()["tile_fused_gemm_spmm_wf0"] == 1
        want = layer(feats, backend="torch")
        loop = layer.reference(feats)
    for t in want:
        assert _rel_err(got[t], want[t]) <= 2e-3
        assert _rel_err(loop[t], want[t]) <= 2e-3
    grads = {}
    for be in (backend, "torch"):
        for w in layer.weights:
            w.grad = None
        sum((v ** 2).sum() for v in layer(feats, backend=be).values()
            ).backward()
        grads[be] = [w.grad.clone() for w in layer.weights]
    for x, y in zip(grads[backend], grads["torch"], strict=True):
        assert _rel_err(x, y) <= 2e-3


#: the serving tier on the card: windows of one banded graph, at 4,096 rows
SERVE_NODES = 4096
#: Algorithm 1's budget for the GeMM-SpMM tier at 128 / 128 columns: the
#: 64-row tiles the uniform split stops at cost ≈ 1.17 M elements there, so
#: at the default 600,000 every patch would bail to a rebuild
SERVE_GEMM_CACHE = 1.2e6


def _serve_stream(op_pair, device, requests=12):
    """A drifting stream (jumps among three windows, re-sampled rows)
    through a ``ServingTier`` on ``device``: ``(tier, [(how, a, padded a,
    entry, op 1, c, d)])``."""
    base = gen.banded_spd(8 * SERVE_NODES, 8, seed=0)
    windows = [gen.induced_subgraph(base, s, SERVE_NODES - cut)
               for s, cut in ((0, 96), (2 * SERVE_NODES, 200),
                              (5 * SERVE_NODES, 40))]
    kw = (dict(b_col=128, c_col=128, cache_size=SERVE_GEMM_CACHE)
          if op_pair == "gemm" else dict(b_col=128, c_col=128,
                                         b_is_sparse=True))
    tier = serving.ServingTier(**kw)
    rng = np.random.default_rng(3)
    gen_ = torch.Generator(device=device).manual_seed(3)
    current, out = windows[0], []
    for i in range(requests):
        r = rng.random()
        if i and r < 0.15:
            current = windows[int(rng.integers(len(windows)))]
        elif i and r < 0.6:
            current = gen.perturb_rows(
                current, rng.choice(current.n_rows, current.n_rows // 50,
                                    replace=False), seed=i)
        c = torch.randn((current.n_cols if op_pair == "spmm" else 128, 128),
                        generator=gen_, device=device) * 0.1
        op1 = (current if op_pair == "spmm" else
               torch.randn((current.n_cols, 128), generator=gen_,
                           device=device))
        before = dict(tier.stats)
        d = tier.matmul(current, op1, c)
        how = next(h for h, k in (("hit", "exact_hits"),
                                  ("incremental", "incremental"),
                                  ("rebuild", "rebuilds"))
                   if tier.stats[k] != before[k])
        res = tier._residents[tier.bucket_for(current)]
        out.append((how, current, res.a, res.entry, op1, c, d))
    return tier, out


def _plain_on_entry(entry, ap, op1, c, n_rows):
    """``backend="torch"`` on the tier's entry: the plain executor on the
    operands padded as the tier pads them."""
    if isinstance(op1, CSR):
        c = torch.nn.functional.pad(c, (0, 0, 0, ap.n_cols - c.shape[0]))
        return fused_ops.fused_spmm_spmm(entry.dsched, ap, c)[:n_rows]
    b = torch.nn.functional.pad(op1, (0, 0, 0, ap.n_cols - op1.shape[0]))
    return fused_ops.fused_gemm_spmm(entry.dsched, b, c)[:n_rows]


@pytest.mark.parametrize("op_pair", ["gemm", "spmm"])
def test_serving_tier_matches_plain_path(card, op_pair):
    """Both tiers at 4,096 rows on the card: every request (hits,
    incremental patches, rebuilds; headroom-padded and patched entries)
    launches the kernels its Eq-3 pick names (a drifted pattern may fall
    to the unfused arm) and agrees with ``backend="torch"`` on the same
    entry."""
    ops.reset_launch_counts()
    tier, served = _serve_stream(op_pair, card)
    counts = ops.launch_counts()
    picks = [api.select_backend(s[3], card) for s in served]
    assert set(picks) <= {"cuda", "unfused"}
    assert {"hit", "incremental", "rebuild"} <= {
        s[0] for s, pick in zip(served, picks) if pick == "cuda"}
    for how, a, ap, entry, op1, c, d in served:
        want = _plain_on_entry(entry, ap, op1, c, a.n_rows)
        assert d.shape == (a.n_rows, 128)
        assert _rel_err(d, want) <= 1e-4, how
    wf0 = ("tile_fused_spmm_spmm_wf0" if op_pair == "spmm"
           else "tile_fused_gemm_spmm_wf0")
    n_fused = picks.count("cuda")
    assert counts[wf0] == n_fused
    # the unfused arm runs one hybrid product a sparse operand
    assert counts["spmm_ell"] == n_fused + (len(served) - n_fused) * (
        2 if op_pair == "spmm" else 1)
    assert api.schedule_cache_stats()["bucket_entries"] >= 1


@pytest.mark.parametrize("op_pair", ["gemm", "spmm"])
def test_spmm_ell_on_padded_and_patched_tails(card, op_pair):
    """Wavefront 1 of headroom-padded and patched entries (spill lanes out
    of row order, target rows in any order) through the kernel against
    its plain version, and against the body plus ``_spill_add``."""
    _, served = _serve_stream(op_pair, card, requests=8)
    kinds = set()
    for how, _, _, entry, _, _, _ in served:
        if how == "hit":
            continue
        kinds.add(how)
        ds = entry.dsched
        st = fused_ops.schedule_tensors(ds, card, torch.float32)
        x = torch.randn((ds.n_i, 128), device=card)
        d0 = torch.randn((ds.n_j + 1, 128), device=card)
        outs = [d0.clone() for _ in range(3)]
        ops.spmm_ell(st.cols1, st.vals1, x, tails=st.tails1,
                     out=outs[0][:ds.n_j], out_rows=st.j_rows1_32)
        ref.spmm_ell(st.cols1, st.vals1, x, tails=st.tails1,
                     out=outs[1][:ds.n_j], out_rows=st.j_rows1_32)
        fused_ops._wf1(st, outs[2], x)      # writes pad slots to row n_j
        got, plain, chain = (o[:ds.n_j] for o in outs)
        assert _rel_err(got, plain) <= TOL[torch.float32]
        assert _rel_err(got, chain) <= TOL[torch.float32]
    assert kinds == {"incremental", "rebuild"}


def test_patched_request_gives_the_same_bits_twice(card):
    """A patched GeMM-SpMM entry served twice (a patch, then a hit) gives
    the same bits: no float atomics on the tier's GeMM-SpMM path."""
    tier, served = _serve_stream("gemm", card, requests=4)
    _, a, _, _, op1, c, _ = served[-1]
    a = gen.perturb_rows(a, np.arange(0, a.n_rows, 97), seed=5)
    outs = []
    for key in ("incremental", "exact_hits"):
        before = tier.stats[key]
        outs.append(tier.matmul(a, op1, c))
        assert tier.stats[key] == before + 1
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,sq,sk,d,causal,window", [
    (2, 2, 128, 128, 32, True, 0), (1, 3, 100, 100, 48, True, 0),
    (2, 2, 256, 256, 64, True, 32), (1, 2, 150, 150, 64, False, 0),
    (1, 2, 256, 128, 32, True, 32),       # rows q >= 159 see no key
    (1, 1, 70, 40, 16, True, 7), (1, 4, 512, 512, 128, True, 0),
    (1, 1, 96, 96, 200, True, 0), (1, 2, 64, 1000, 256, False, 0),
    (1, 2, 70, 90, 20, False, 9),         # d % 8 != 0: scalar staging
    # D 64 / 128 runs the wgmma kernels (128 queries a CTA, K/V through
    # the TMA ring; f32 as 3xTF32)
    (2, 3, 1500, 1500, 64, False, 0),     # Sq not a multiple of 128
    (1, 2, 1500, 1500, 128, False, 0),
    (1, 2, 200, 700, 128, True, 0),       # Sq < Sk
    (2, 2, 700, 200, 64, True, 0),        # Sq > Sk
    (1, 2, 333, 777, 64, False, 50),
    (1, 2, 600, 300, 128, True, 64),      # rows q >= 363 see no key
    (1, 2, 130, 70, 64, True, 16)])       # rows q >= 85 see no key
def test_flash_attention_kernel(card, b, h, sq, sk, d, causal, window,
                                dtype):
    g = torch.Generator().manual_seed(sq * d + sk)
    q = torch.randn(b, h, sq, d, generator=g).to(card, dtype)
    k, v = (torch.randn(b, h, sk, d, generator=g).to(card, dtype)
            for _ in range(2))
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    if dtype == torch.float32 and d in (64, 128):
        assert flash_attention.last_path() == "flash_attention_tf32_kernel"
    want = ref.attention(q, k, v, causal=causal, window=window)
    assert _row_rel_err(got, want) <= ATTN_TOL[dtype]


@pytest.mark.parametrize("b,h,sq,sk,d,causal,window", [
    (1, 2, 128, 8192, 128, False, 0),     # 256 kv blocks of 32 keys
    (1, 2, 4096, 4096, 64, True, 1024)])  # up to 17 kv blocks of 64
def test_flash_attention_f32_long_walk(card, b, h, sq, sk, d, causal,
                                       window):
    """f32 on the 3xTF32 kernel over a long kv walk: the tensor cores'
    accumulation rounds toward zero, so each block's P V goes into fresh
    accumulators added to O in f32; the rows stay within 1e-4."""
    g = torch.Generator().manual_seed(sk + d)
    q = torch.randn(b, h, sq, d, generator=g).to(card)
    k, v = (torch.randn(b, h, sk, d, generator=g).to(card)
            for _ in range(2))
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.last_path() == "flash_attention_tf32_kernel"
    want = ref.attention(q, k, v, causal=causal, window=window)
    assert _row_rel_err(got, want) <= ATTN_TOL[torch.float32]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,sq,sk,d,causal,window", [
    (2, 16, 2, 300, 300, 128, True, 0),   # rep 8, as qwen2.5-3b
    (1, 25, 5, 700, 700, 64, True, 128),  # rep 5, as hymba-1.5b
    (1, 6, 2, 200, 500, 96, False, 0),    # rep 3 on mma.sync
    (1, 4, 1, 100, 100, 200, True, 0)])   # rep 4 on the CUDA cores
def test_flash_attention_reads_kv_heads_in_place(card, b, h, hkv, sq, sk, d,
                                                 causal, window, dtype):
    """Grouped K/V heads, read in place (query head i reads K/V head
    i // (H // Hkv)), against the plain version, which repeats them."""
    g = torch.Generator().manual_seed(h * 100 + hkv)
    q = torch.randn(b, h, sq, d, generator=g).to(card, dtype)
    k, v = (torch.randn(b, hkv, sk, d, generator=g).to(card, dtype)
            for _ in range(2))
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    rep = h // hkv
    want = ref.attention(q, k.repeat_interleave(rep, 1),
                         v.repeat_interleave(rep, 1), causal=causal,
                         window=window)
    assert _row_rel_err(got, want) <= ATTN_TOL[dtype]


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data starts 2 bytes past a 16-byte
    boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("dtype,d,aligned,path", [
    (torch.bfloat16, 128, True, "flash_attention_wgmma_kernel"),
    (torch.bfloat16, 64, True, "flash_attention_wgmma_kernel"),
    (torch.bfloat16, 64, False, "flash_attention_mma_kernel"),
    (torch.bfloat16, 96, True, "flash_attention_mma_kernel"),
    (torch.bfloat16, 200, True, "flash_attention_kernel"),
    (torch.float32, 64, True, "flash_attention_tf32_kernel"),
    (torch.float32, 128, True, "flash_attention_tf32_kernel"),
    (torch.float32, 64, False, "flash_attention_kernel"),
    (torch.float32, 96, True, "flash_attention_kernel")])
def test_flash_attention_dispatch_path(card, dtype, d, aligned, path):
    """Each dispatch path runs its own kernel, as the launcher records it,
    and agrees with the plain version."""
    g = torch.Generator().manual_seed(d)
    q, k, v = (torch.randn(1, 2, 200, d, generator=g).to(card, dtype)
               for _ in range(3))
    if not aligned:
        q, k, v = (_misaligned(t) for t in (q, k, v))
        assert q.data_ptr() % 16 != 0 and q.is_contiguous()
    got = ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.last_path() == path
    assert _row_rel_err(got, ref.attention(q, k, v)) <= ATTN_TOL[dtype]


# bf16 runs clusters of C = ceil(min(d, 2048) / 256) CTAs, 128 token rows
# each, and walks f in chunks of 64 C; TMA where d and f are multiples of
# 8, element-wise staging where not.  f32 runs the same clusters over 64
# token rows (3xTF32, 32-deep blocks of d, chunks of 64 C columns of H)
# where d is a multiple of 4 and x and the output are 16-byte aligned, the
# CUDA-core kernel where not.
def _ffn_path(dtype, d, aligned=True):
    if dtype == torch.bfloat16:
        return "fused_ffn_wgmma_kernel"
    if d % 4 == 0 and aligned:
        return "fused_ffn_tf32_kernel"
    return "fused_ffn_kernel"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,d,f,act", [
    (256, 64, 512, "gelu"),               # C = 1
    (100, 48, 200, "silu"),
    (64, 2048, 256, "gelu"),              # C = 8
    (37, 2500, 70, "none"),               # d > 2048: two cluster groups
    (200, 1536, 500, "silu"),             # C = 6; f, m ragged to the chunk
    (300, 2048, 1000, "gelu"),            # C = 8; f, m ragged
    (130, 4096, 300, "gelu"),             # two full cluster groups
    (77, 100, 90, "gelu"),                # bf16: staged, not TMA
    # f32 edges: m ragged to 64 rows, f past several chunks and ragged to
    # a 32-deep panel, the second group's CTAs past d (no output columns)
    (333, 1024, 1100, "gelu"),            # C = 4, chunks of 256
    (65, 2560, 640, "silu"),              # two groups, the second ragged
    (50, 66, 40, "silu")])                # f32: d % 4 != 0, CUDA cores
def test_fused_ffn_kernel(card, m, d, f, act, dtype):
    g = torch.Generator().manual_seed(m + d + f)
    x = torch.randn(m, d, generator=g).to(card, dtype)
    w1 = (torch.randn(d, f, generator=g) / d ** 0.5).to(card, dtype)
    w2 = (torch.randn(f, d, generator=g) / f ** 0.5).to(card, dtype)
    before = ops.fused_ffn.launches
    got = ops.fused_ffn(x, w1, w2, act=act)
    torch.cuda.synchronize()
    assert ops.fused_ffn.launches == before + 1
    assert fused_ffn.last_path() == _ffn_path(dtype, d)
    assert _row_rel_err(got, ref.ffn(x, w1, w2, act=act)) <= FFN_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,cap,d,f,act", [
    (4, 128, 64, 512, "silu"), (3, 40, 24, 56, "gelu"),
    (2, 64, 32, 128, "none"),
    (3, 40, 1536, 512, "silu"),           # C = 6, cap 40
    (2, 200, 2048, 700, "gelu"),          # C = 8, cap and f ragged
    (2, 40, 100, 90, "silu"),             # bf16: staged, not TMA
    (3, 129, 1536, 512, "silu"),          # granite's widths, cap ragged
    (2, 33, 30, 50, "gelu")])             # f32: d % 4 != 0, CUDA cores
def test_fused_moe_ffn_kernel(card, e, cap, d, f, act, dtype):
    g = torch.Generator().manual_seed(e * cap + f)
    x = torch.randn(e, cap, d, generator=g).to(card, dtype)
    w1 = (torch.randn(e, d, f, generator=g) / d ** 0.5).to(card, dtype)
    w2 = (torch.randn(e, f, d, generator=g) / f ** 0.5).to(card, dtype)
    before = ops.fused_moe_ffn.launches
    got = ops.fused_moe_ffn(x, w1, w2, act=act)
    torch.cuda.synchronize()
    assert ops.fused_moe_ffn.launches == before + 1
    assert fused_ffn.last_path() == _ffn_path(dtype, d)
    assert (_row_rel_err(got, ref.moe_ffn(x, w1, w2, act=act))
            <= FFN_TOL[dtype])


def test_fused_ffn_f32_unaligned_takes_the_cuda_cores(card):
    """f32 x that does not start on a 16-byte boundary cannot be read as
    16-byte vectors: the CUDA-core kernel takes it."""
    g = torch.Generator().manual_seed(9)
    x = _misaligned(torch.randn(70, 256, generator=g).to(card))
    w1 = (torch.randn(256, 300, generator=g) / 16).to(card)
    w2 = (torch.randn(300, 256, generator=g) / 300 ** 0.5).to(card)
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    got = ops.fused_ffn(x, w1, w2, act="gelu")
    torch.cuda.synchronize()
    assert fused_ffn.last_path() == _ffn_path(torch.float32, 256, False)
    assert (_row_rel_err(got, ref.ffn(x, w1, w2, act="gelu"))
            <= FFN_TOL[torch.float32])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_ffn_kernel_is_deterministic_and_allocates_only_out(card,
                                                                  dtype):
    """No float atomics: the same inputs give the same bits; and H never
    touches device memory: the launch allocates the output and nothing
    else."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(512, 1024, generator=g).to(card, dtype)
    w1 = (torch.randn(1024, 3000, generator=g) / 32).to(card, dtype)
    w2 = (torch.randn(3000, 1024, generator=g) / 3000 ** 0.5).to(card, dtype)
    first = ops.fused_ffn(x, w1, w2)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # bytes asked of the caching allocator (it may hand out a larger
    # cached block, which max_memory_allocated would count)
    before = torch.cuda.memory_stats()["requested_bytes.all.current"]
    again = ops.fused_ffn(x, w1, w2)
    torch.cuda.synchronize()
    peak = torch.cuda.memory_stats()["requested_bytes.all.peak"]
    assert peak - before == again.numel() * again.element_size()
    assert torch.equal(first, again)


def test_lm_wrappers_check_their_inputs(card):
    q = torch.randn(1, 2, 8, 16, device=card)
    with pytest.raises(ValueError, match="flash_attention"):
        ops.flash_attention(q, q[..., :8], q[..., :8])
    with pytest.raises(ValueError, match="H % Hkv"):
        q3 = torch.randn(1, 3, 8, 16, device=card)
        ops.flash_attention(q3, q, q)
    with pytest.raises(ValueError, match="head dim"):
        big = torch.randn(1, 1, 4, 300, device=card)
        ops.flash_attention(big, big, big)
    x = torch.randn(8, 16, device=card)
    with pytest.raises(ValueError, match="fused_ffn"):
        ops.fused_ffn(x, torch.randn(16, 4, device=card),
                      torch.randn(5, 16, device=card))


def test_reduced_lm_serves_on_the_card(card):
    """The reduced qwen2.5-3b through the serving CLI on its default device;
    one flash launch per layer per prefill, and the kernel's prefill logits
    against the plain attention's."""
    cfg = get_config("qwen2.5-3b", reduced=True)
    ops.reset_launch_counts()
    tokens = serve.main(["--reduced", "--batch", "2", "--prompt-len", "40",
                         "--gen", "5"])
    assert tokens.is_cuda and tokens.shape == (2, 5)
    assert ops.launch_counts()["flash_attention"] == cfg.n_layers
    model = T.Transformer(cfg, seed=1)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), device=card)
    with torch.inference_mode():
        got = model(toks)
        want = model(toks, impl="torch")
    assert _rel_err(got, want) <= 2e-2


#: the three rungs of the sharded dispatch on one card: (mesh shape,
#: layout), every entry of the mesh the same card
SHARD_MESHES = {"1d": ((4,), "1d"), "1.5d": ((2, 2), "1.5d"),
                "2.5d": ((2, 2, 2), "2.5d")}


def _card_mesh(card, shape):
    from repro_torch.models.sharding import Mesh
    return Mesh(np.full(shape, str(card), dtype=object),
                ("x", "y", "z")[:len(shape)])


def _no_plain_executor(monkeypatch):
    """Make the plain executors raise, so a call that reached them
    fails."""
    def plain(*args, **kwargs):
        raise AssertionError("a plain executor ran on the card")
    for name in ("fused_gemm_spmm", "fused_spmm_spmm", "_ell_rows"):
        monkeypatch.setattr(fused_ops, name, plain)


@pytest.mark.parametrize("combine", ["psum", "reduce_scatter"])
@pytest.mark.parametrize("mesh_name", sorted(SHARD_MESHES))
@pytest.mark.parametrize("op_pair", ["gemm", "spmm"])
def test_sharded_arm_matches_cuda_arm(card, op_pair, mesh_name, combine,
                                      monkeypatch):
    """Shards that share the card: each runs its wavefront-0 kernel and
    one ``spmm_ell`` call, against the single-device ``"cuda"`` arm;
    overlap gives the sync arm's bits for GeMM-SpMM, and within 1e-6 for
    SpMM-SpMM, whose op-1 spill delta is summed by float atomics
    (``fused_ops.op1_spill``) anew on each call."""
    a = gen.banded_spd(16384, 8, seed=1)
    rng = np.random.default_rng(0)
    c_shape = (a.n_rows, 64) if op_pair == "spmm" else (64, 64)
    c = torch.from_numpy(rng.standard_normal(c_shape, np.float32)).to(card)
    b = (a if op_pair == "spmm" else torch.from_numpy(
        rng.standard_normal((a.n_rows, 64), np.float32)).to(card))
    want = api.tile_fused_matmul(a, b, c, backend="cuda")
    shape, layout = SHARD_MESHES[mesh_name]
    wf0 = ("tile_fused_spmm_spmm_wf0" if op_pair == "spmm"
           else "tile_fused_gemm_spmm_wf0")
    _no_plain_executor(monkeypatch)
    outs = []
    for overlap in (False, True):
        spec = api.FusionSpec(mesh=_card_mesh(card, shape),
                              shard_layout=layout, shard_combine=combine,
                              overlap=overlap)
        entry = api.get_schedule(a, b_col=64, c_col=64,
                                 b_is_sparse=op_pair == "spmm",
                                 spec=dataclasses.replace(spec,
                                                          dtype_bytes=4))
        sh = entry.shard
        assert sh.layout == layout and api.select_backend(entry, card) \
            == "sharded"
        n_dev = int(np.prod(shape))
        ops.reset_launch_counts()
        got = api.tile_fused_matmul(a, b, c, spec=spec)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        assert counts[wf0] == n_dev
        assert counts["spmm_ell"] == (
            n_dev if sh.halo_size and sh.wf1_per_shard else 0)
        assert got.is_cuda and got.shape == want.shape
        assert _rel_err(got, want) <= TOL[torch.float32]
        outs.append(got)
    if op_pair == "gemm":
        assert torch.equal(outs[0], outs[1])
    assert _rel_err(outs[1], outs[0]) <= 1e-6


@pytest.mark.parametrize("op_pair", ["gemm", "spmm"])
def test_sharded_grads_match_cuda_arm(card, op_pair):
    """The backward keeps the mesh: ``dB`` / SpMM-SpMM's ``dC`` run on the
    transpose entries' shards."""
    a = gen.banded_spd(8192, 8, seed=2)
    rng = np.random.default_rng(1)
    c0 = rng.standard_normal((a.n_rows, 32) if op_pair == "spmm"
                             else (64, 32), np.float32)
    b0 = rng.standard_normal((a.n_rows, 64), np.float32)
    spec = api.FusionSpec(mesh=_card_mesh(card, (4,)))
    grads = []
    for s, backend in ((spec, "sharded"), (api.FusionSpec(), "cuda")):
        c = torch.from_numpy(c0).to(card).requires_grad_()
        b = torch.from_numpy(b0).to(card).requires_grad_()
        ops.reset_launch_counts()
        d = api.tile_fused_matmul(a, a if op_pair == "spmm" else b, c,
                                  backend=backend, spec=s)
        (d * d).sum().backward()
        torch.cuda.synchronize()
        grads.append([c.grad] if op_pair == "spmm" else [b.grad, c.grad])
    for got, want in zip(*grads, strict=True):
        assert _rel_err(got, want) <= TOL[torch.float32]


@pytest.mark.parametrize("graph", ["banded", "powerlaw"])
def test_sharded_backend_on_a_trivial_mesh_runs_a_kernel_arm(card, graph,
                                                            monkeypatch):
    """``backend="sharded"`` without a partition on a CUDA tensor takes the
    entry's single-device pick, ``"cuda"`` or ``"unfused"``: never the
    plain path."""
    adj = (gen.banded_spd(16384, 8, seed=0) if graph == "banded"
           else gen.powerlaw_graph(16384, 8, seed=0))
    b = torch.randn(adj.n_rows, 64, device=card)
    c = torch.randn(64, 64, device=card)
    want = api.tile_fused_matmul(adj, b, c, backend="torch")
    spec = api.FusionSpec(mesh=_card_mesh(card, (1,)))
    entry = api.get_schedule(adj, b_col=64, c_col=64, spec=spec)
    pick = api.select_backend(entry, card)
    assert entry.shard is None and pick in ("cuda", "unfused")
    _no_plain_executor(monkeypatch)
    ops.reset_launch_counts()
    got = api.tile_fused_matmul(adj, b, c, backend="sharded", spec=spec)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["spmm_ell"] >= 1
    assert counts["tile_fused_gemm_spmm_wf0"] == (pick == "cuda")
    assert _rel_err(got, want) <= 2e-3


def test_sharded_gcn_serves_and_trains_on_the_card(card):
    cfg = GCNConfig(n_nodes=8192)
    model = GCN(cfg, gen.banded_spd(cfg.n_nodes, 8, seed=0), device=card)
    mesh = _card_mesh(card, (4,))
    assert model.layer_backends(mesh=mesh) == ["sharded", "sharded"]
    x = torch.randn(cfg.n_nodes, cfg.in_dim, device=card)
    with torch.inference_mode():
        assert _rel_err(model(x, mesh=mesh), model(x)) <= TOL[torch.float32]
    y = torch.randint(0, cfg.out_dim, (cfg.n_nodes,), device=card)
    loss = model.loss(x, y, mesh=mesh)
    loss.backward()
    got = [w.grad.clone() for w in model.weights]
    for w in model.weights:
        w.grad = None
    model.loss(x, y).backward()
    for g, w in zip(got, model.weights, strict=True):
        assert _rel_err(g, w.grad) <= TOL[torch.float32]


# ---------------------------------------------------- LM training ----
def _band_cfg(**kw):
    base = get_config("stablelm-1.6b", reduced=True)
    return dataclasses.replace(base, **{
        "block_pattern": "sparse-band", "band_window": 8, "band_decay": 0.9,
        "ssm_head_dim": 16, "dtype": "float32", **kw})


@pytest.mark.parametrize("b,s,d", [(2, 32, 64), (2, 2048, 2048)])
def test_band_mix_kernel_arm_matches_plain(card, b, s, d, monkeypatch):
    """The mixer on ``backend="cuda"`` (GeMM-SpMM and ``spmm_ell``
    kernels, forward and backward) against ``backend="torch"``: output
    and the gradients of ``x``, ``wv``, ``wz``, ``w_down``; small, and at
    stablelm-1.6b's width (d = inner = 2048, window 32)."""
    from repro_torch.models import ssm as S
    cfg = (_band_cfg() if d == 64 else dataclasses.replace(
        get_config("stablelm-1.6b"), block_pattern="sparse-band",
        dtype="float32"))
    gen_ = torch.Generator(device=card).manual_seed(21)
    p = S.band_mix_init(gen_, cfg, torch.float32, card)
    x = torch.randn(b, s, d, device=card, generator=gen_)
    wgt = torch.randn(b, s, d, device=card, generator=gen_)
    a = S.decay_band_csr(s, cfg.band_window, cfg.band_decay)
    res = {}
    for backend in ("torch", "cuda"):
        leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
        xx = x.clone().requires_grad_()
        if backend == "cuda":
            _no_plain_executor(monkeypatch)
            ops.reset_launch_counts()
        out = S.band_mix_apply(leaves, cfg, xx, a, backend=backend)
        (out * wgt).sum().backward()
        res[backend] = [out.detach(), xx.grad] + [leaves[k].grad
                                         for k in ("wv", "wz", "w_down")]
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    # per batch row: forward and dB one GeMM-SpMM each; forward wf1, dB
    # wf1 and Aᵀ·Ḋ one spmm_ell each
    assert counts["tile_fused_gemm_spmm_wf0"] == 2 * b
    assert counts["spmm_ell"] == 3 * b
    for got, want in zip(res["cuda"], res["torch"], strict=True):
        assert _rel_err(got, want) <= TOL[torch.float32]


def test_sparse_band_train_step_on_the_card(card, monkeypatch):
    """Two steps of the 2-layer sparse-band model on ``impl="cuda"``
    against ``impl="torch"`` from the same weights: the losses, and the
    step-1 gradients of every parameter."""
    from repro_torch.launch import steps
    from repro_torch.optim import OptConfig, adamw
    cfg = _band_cfg()
    gen_ = torch.Generator(device=card).manual_seed(5)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 64), device=card,
                              generator=gen_) for k in ("tokens", "labels")}
    ocfg = OptConfig(lr=1e-2, warmup_steps=1, total_steps=20)
    runs = {}
    for impl in ("torch", "cuda"):
        model = T.Transformer(cfg, seed=3)
        step = steps.make_train_step(model, ocfg, impl=impl)
        state = adamw.init(model.parameters())
        if impl == "cuda":
            _no_plain_executor(monkeypatch)
            ops.reset_launch_counts()
        state, m1 = step(state, batch)
        grads = [p.grad.clone() for p in model.parameters()]
        state, m2 = step(state, batch)
        runs[impl] = (float(m1["loss"]), float(m2["loss"]), grads)
    counts = ops.launch_counts()
    assert counts["tile_fused_gemm_spmm_wf0"] == 2 * 2 * 2 * cfg.n_layers
    assert counts["spmm_ell"] == 2 * 2 * 3 * cfg.n_layers
    (l1, l2, g), (w1, w2, wg) = runs["cuda"], runs["torch"]
    assert abs(l1 - w1) <= 1e-5 * abs(w1) and abs(l2 - w2) <= 1e-4 * abs(w2)
    assert l2 < l1
    for got, want in zip(g, wg, strict=True):
        assert _rel_err(got, want) <= TOL[torch.float32]


def test_dense_attention_training_refuses_the_card(card):
    """The flash kernel has no backward: a dense ``attn`` forward under
    grad that is not a training forward (the route a caller forgot) raises
    on the card instead of leaving the attention weights without
    gradients; the train step, whose forward is ``train=True``, trains
    through ``scan_attention`` and launches no flash kernel; inference on
    the same model still runs."""
    from repro_torch.launch import steps
    from repro_torch.optim import OptConfig, adamw
    cfg = get_config("qwen2.5-3b", reduced=True)
    model = T.Transformer(cfg, seed=0)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), device=card)
    with pytest.raises(NotImplementedError, match="no backward"):
        model(toks)
    step = steps.make_train_step(model, OptConfig())
    ops.reset_launch_counts()
    _, m = step(adamw.init(model.parameters()),
                {"tokens": toks, "labels": toks})
    assert bool(torch.isfinite(m["loss"]))
    assert ops.launch_counts()["flash_attention"] == 0
    logits = steps.make_prefill_step(model)(toks)
    assert logits.shape == (2, 16, cfg.vocab_size)
    assert logits.grad_fn is None and bool(torch.isfinite(logits).all())


def _attention_f64(q, k, v, causal, window):
    """Dense f64 attention with the reference's masks (K/V heads repeated
    to the query heads)."""
    h, hkv, sq, sk = q.shape[1], k.shape[1], q.shape[2], k.shape[2]
    q, k, v = (t.double() for t in (q, k, v))
    k = k.repeat_interleave(h // hkv, dim=1)
    v = v.repeat_interleave(h // hkv, dim=1)
    s = q @ k.transpose(-1, -2) / q.shape[-1] ** 0.5
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window:
        mask &= (qp - kp) < window
    return torch.softmax(s.masked_fill(~mask, float("-inf")), -1) @ v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,hkv,s,d,causal,window", [
    (1, 2, 2, 2048, 64, True, 0), (2, 4, 2, 1500, 64, True, 0),
    (1, 4, 1, 1100, 128, True, 256), (1, 2, 2, 640, 64, False, 0)])
def test_scan_attention_on_the_card(card, b, h, hkv, s, d, causal, window,
                                    dtype):
    """``scan_attention`` (the training attention) and its gradients
    against an f64 dense oracle on the card: f32 within 1e-4 and bf16
    within 2^-7 of the largest magnitude (the output and each gradient are
    rounded to bf16 once, half a unit in the last place: up to 2^-8 of a
    value; the arithmetic is f32)."""
    from repro_torch.models import layers as L
    gen_ = torch.Generator(device=card).manual_seed(s + h)
    q, k, v = (torch.randn(b, n, s, d, device=card, generator=gen_)
               .to(dtype) for n in (h, hkv, hkv))
    w = torch.randn(b, h, s, d, device=card, generator=gen_)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = L.scan_attention(*leaves, causal=causal, window=window)
    (out.float() * w).sum().backward()
    oracle = [t.double().requires_grad_() for t in (q, k, v)]
    want = _attention_f64(*oracle, causal, window)
    (want * w.double()).sum().backward()
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    assert out.dtype == dtype
    assert _rel_err(out, want) <= tol
    for got, ref_ in zip(leaves, oracle):
        assert _rel_err(got.grad, ref_.grad) <= tol


@pytest.mark.parametrize("pattern", ["attn", "sparse-band"])
def test_remat_gradients_on_the_card(card, pattern):
    """Step-1 gradients of a 2-layer f32 model under ``remat`` ``"full"``
    and ``"dots"`` against ``"none"`` on the card (within 1e-6 of each
    tensor's largest value); the sparse-band mixer recomputes its kernel
    launches in the backward (the GeMM-SpMM and ``spmm_ell`` forward
    launches run twice)."""
    from repro_torch.launch import steps
    cfg = (dataclasses.replace(get_config("stablelm-1.6b", reduced=True),
                               dtype="float32") if pattern == "attn"
           else _band_cfg())
    toks = torch.randint(0, cfg.vocab_size, (2, 128), device=card,
                         generator=torch.Generator(device=card)
                         .manual_seed(9))
    grads, counts = {}, {}
    for remat in ("none", "full", "dots"):
        model = T.Transformer(dataclasses.replace(cfg, remat=remat), seed=0)
        ops.reset_launch_counts()
        steps.cross_entropy(model(toks, train=True), toks).backward()
        torch.cuda.synchronize()
        counts[remat] = ops.launch_counts()
        grads[remat] = [p.grad for p in model.parameters()]
    for remat in ("full", "dots"):
        for got, want in zip(grads[remat], grads["none"], strict=True):
            assert _rel_err(got, want) <= 1e-6
    assert counts["none"]["flash_attention"] == 0
    if pattern == "sparse-band":
        n = 2 * cfg.n_layers
        assert counts["none"]["tile_fused_gemm_spmm_wf0"] == 2 * n
        assert counts["none"]["spmm_ell"] == 3 * n
        for remat in ("full", "dots"):
            assert counts[remat]["tile_fused_gemm_spmm_wf0"] == 3 * n
            assert counts[remat]["spmm_ell"] == 4 * n


def test_trainer_resumes_exactly_on_the_card(card, tmp_path, capsys):
    """``launch.train`` at ``--reduced`` on the card: preempted after step
    6 (exit 17), resumed from step 6, and the step-8 leaves equal an
    uninterrupted run's bit for bit."""
    from repro_torch.launch import train
    args = ["--arch", "qwen2.5-3b", "--reduced", "--steps", "8", "--batch",
            "2", "--seq", "64", "--ckpt-every", "3", "--log-every", "100"]
    d1, d2 = str(tmp_path / "interrupted"), str(tmp_path / "clean")
    with pytest.raises(SystemExit) as e:
        train.main(args + ["--ckpt-dir", d1, "--simulate-preemption", "6"])
    assert e.value.code == 17
    run = train.main(args + ["--ckpt-dir", d1])
    assert "[restore] resumed from step 6" in capsys.readouterr().out
    assert run.model.device.type == "cuda"
    train.main(args + ["--ckpt-dir", d2])
    for f in sorted(os.listdir(os.path.join(d2, "step_00000008"))):
        if f.endswith(".npy"):
            a = np.load(os.path.join(d1, "step_00000008", f))
            b = np.load(os.path.join(d2, "step_00000008", f))
            assert a.dtype == b.dtype and np.array_equal(a, b), f


# ----------------------------------------------------------- the MoE layer --
def _moe_case(arch, reduced, b, s, dtype, card, seed):
    """(cfg, weights, x) on the card: ``moe_init`` from a seed, x normal."""
    from repro_torch.models import layers as L
    cfg = dataclasses.replace(get_config(arch, reduced=reduced),
                              dtype=str(dtype).split(".")[1])
    gen = torch.Generator(device=card).manual_seed(seed)
    p = L.moe_init(gen, cfg, dtype, card)
    x = torch.randn(b, s, cfg.d_model, device=card, generator=gen).to(dtype)
    return cfg, p, x


def _to(p, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in p.items()}


#: (arch, reduced, B, S): both REDUCED layers and granite at its published
#: widths (d 1536, 40 experts top-8, f 512)
MOE_CASES = [("granite-moe-3b-a800m", True, 2, 48),
             ("llama4-scout-17b-a16e", True, 2, 48),
             ("granite-moe-3b-a800m", False, 2, 256)]


@pytest.mark.parametrize("arch,reduced,b,s", MOE_CASES)
def test_moe_apply_on_the_card_matches_the_cpu(card, arch, reduced, b, s):
    """``moe_apply`` (f32) on the card against the same call on the CPU:
    the same routing, and the output within 1e-4 row by row.  A routing
    difference is allowed only for a token whose k-th and (k+1)-th gates
    lie within 1e-5 (rounding can flip such a pick); rows holding one are
    left out of the output check, and at least one row is checked."""
    from repro_torch.models import layers as L
    cfg, p, x = _moe_case(arch, reduced, b, s, torch.float32, card, 30)
    routes = {}

    def run(device):
        def record(cfg_, x_, router, cap):
            xe, route = dispatch(cfg_, x_, router, cap)
            routes[device] = route
            return xe, route
        dispatch = L._row_dispatch
        L._row_dispatch = record
        try:
            with torch.no_grad():
                return L.moe_apply(_to(p, device), cfg, x.to(device))
        finally:
            L._row_dispatch = dispatch
    got, want = run(card), run("cpu")
    same = (routes[card].experts.cpu() == routes["cpu"].experts).all(-1)
    if not bool(same.all()):
        gates = torch.softmax(x.cpu().float() @ p["router"].cpu(), -1)
        top = gates.topk(cfg.moe_top_k + 1, -1).values
        gap = top[..., -2] - top[..., -1]
        assert float(gap[~same].max()) < 1e-5
    rows = same.all(-1)
    assert bool(rows.any())
    assert _row_rel_err(got.cpu()[rows], want[rows]) <= 1e-4


def test_moe_apply_on_the_card_is_deterministic(card):
    """granite's layer at its published widths in bf16, B 2 × S 512: two
    forward and backward passes give the same bits (dispatch and combine
    gather rows both ways; no float atomics)."""
    from repro_torch.models import layers as L
    cfg, p, x = _moe_case("granite-moe-3b-a800m", False, 2, 512,
                          torch.bfloat16, card, 31)
    w = torch.randn(x.shape, device=card, dtype=x.dtype)

    def run():
        ps = {k: v.detach().requires_grad_() for k, v in p.items()}
        xs = x.detach().requires_grad_()
        y = L.moe_apply(ps, cfg, xs)
        (y.float() * w).sum().backward()
        return [y, xs.grad] + [v.grad for v in ps.values()]
    for a, b in zip(run(), run(), strict=True):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "llama4-scout-17b-a16e"])
def test_moe_prefill_on_the_card_launches_flash_not_the_moe_kernel(card,
                                                                    arch):
    """A ``REDUCED`` MoE model's prefill on the card (f32): one flash
    launch a layer, and the (ungated) fused MoE kernel never: the layer is
    the reference's gated ``moe_apply`` on cuBLAS.  Against the plain
    attention the routing must agree (f32 router logits differ by about
    1e-6; in bf16 near-tied picks flip) and the logits within 1e-3."""
    from repro_torch.models import layers as L
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype="float32")
    model = T.Transformer(cfg, seed=2)
    gen = torch.Generator(device=card).manual_seed(32)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), device=card,
                         generator=gen)
    routes = []

    def record(cfg_, x, router, cap):
        xe, route = dispatch(cfg_, x, router, cap)
        routes.append(route.experts)
        return xe, route
    dispatch = L._row_dispatch
    L._row_dispatch = record
    try:
        ops.reset_launch_counts()
        with torch.inference_mode():
            got, _ = model.decode_step(toks, model.init_cache(2, 41), 0)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        with torch.inference_mode():
            want, _ = model.decode_step(toks, model.init_cache(2, 41), 0,
                                        impl="torch")
    finally:
        L._row_dispatch = dispatch
    assert counts["flash_attention"] == cfg.n_layers
    assert counts["fused_moe_ffn"] == 0
    n = cfg.n_layers
    assert all(torch.equal(a, b) for a, b in zip(routes[:n], routes[n:],
                                                 strict=True))
    assert _rel_err(got, want) <= 1e-3


# ------------------------------------------- MLA and the mamba hybrid --
def _on(tree, device):
    return {k: v.to(device) for k, v in tree.items()}


@pytest.mark.parametrize("path", ["prefill", "decode"])
@pytest.mark.parametrize("reduced", [True, False])
def test_mla_attention_on_the_card_matches_the_cpu(card, reduced, path):
    """``mla_attention`` (f32) on the card against the same call on the
    CPU, at ``REDUCED`` and at minicpm3-4b's published widths (d 2560, 40
    heads of 64, rank 256): a prefill of 96 tokens into the latent cache
    (the flash kernel on the card) and a decode step at slot 60 of it
    (the whole cache re-expanded); the output and the cache within 1e-4."""
    from repro_torch.models import layers as L
    cfg = dataclasses.replace(get_config("minicpm3-4b", reduced=reduced),
                              dtype="float32")
    gen = torch.Generator(device=card).manual_seed(40)
    p = L.mla_init(gen, cfg, torch.float32, card)
    s, cache_len = (96, 0) if path == "prefill" else (1, 60)
    x = torch.randn(2, s, cfg.d_model, device=card, generator=gen)
    cache = torch.randn(2, 96, cfg.mla_kv_rank, device=card, generator=gen)
    out = {}
    for device in (card, "cpu"):
        c = cache.to(device, copy=True)
        with torch.inference_mode():
            y, _ = L.mla_attention(
                _on(p, device), cfg, x.to(device),
                pos=cache_len + torch.arange(s, device=device), cache=c,
                cache_len=cache_len)
        out[str(device)] = (y.cpu(), c.cpu())
    (got, got_c), (want, want_c) = out[str(card)], out["cpu"]
    assert _rel_err(got, want) <= 1e-4
    assert _rel_err(got_c, want_c) <= 1e-4


@pytest.mark.parametrize("s", [200, 1])
@pytest.mark.parametrize("reduced", [True, False])
def test_mamba_apply_on_the_card_matches_the_cpu(card, reduced, s):
    """``mamba_apply`` (f32) on the card against the CPU, at ``REDUCED``
    and at hymba-1.5b's widths (d 1600, 25 heads of 64, state 16): S 200
    (the chunked recurrence, two chunks of 128) and a decode step (S 1),
    each from a carried-in state; output and state within 1e-4."""
    from repro_torch.models import ssm as S
    cfg = dataclasses.replace(get_config("hymba-1.5b", reduced=reduced),
                              dtype="float32")
    gen = torch.Generator(device=card).manual_seed(41)
    p = S.mamba_init(gen, cfg, torch.float32, card)
    p["a_log"] = torch.randn(cfg.n_heads, device=card, generator=gen) * 0.5
    x = torch.randn(2, s, cfg.d_model, device=card, generator=gen)
    state = torch.randn(2, cfg.n_heads, cfg.ssm_state, cfg.ssm_head_dim,
                        device=card, generator=gen)
    with torch.inference_mode():
        got = S.mamba_apply(p, cfg, x, cache=state)
        want = S.mamba_apply(_on(p, "cpu"), cfg, x.cpu(), cache=state.cpu())
    for a, b in zip(got, want, strict=True):
        assert _rel_err(a.cpu(), b) <= 1e-4


@pytest.mark.parametrize("normalize", [True, False])
def test_chunked_recurrence_on_the_card_matches_the_cpu(card, normalize):
    """``chunked_linear_recurrence`` at hymba's head shape (25 heads, dk
    16, dv 64), B 2 × S 300 (chunks of 128, the last padded), from a
    carried-in state, on the card against the CPU within 1e-4, and its
    gradients too."""
    from repro_torch.models import ssm as S
    gen = torch.Generator(device=card).manual_seed(42)
    b, s, h, dk, dv = 2, 300, 25, 16, 64

    def draw(*shape):
        return torch.randn(*shape, device=card, generator=gen)
    q, k = draw(b, s, h, dk) * 0.25, draw(b, s, h, dk) * 0.25
    v = draw(b, s, h, dv)
    log_a = -draw(b, s, h).abs() * 0.1
    h0 = draw(b, h, dk, dv + normalize)
    w = draw(b, s, h, dv)

    def run(device):
        leaves = [t.detach().to(device).requires_grad_()
                  for t in (q, k, v, log_a, h0)]
        o, hf = S.chunked_linear_recurrence(*leaves[:4], h0=leaves[4],
                                            normalize=normalize)
        ((o * w.to(device)).sum() + hf.sum()).backward()
        return [o.detach(), hf.detach()] + [t.grad for t in leaves]
    for a, b_ in zip(run(card), run("cpu"), strict=True):
        assert _rel_err(a.cpu(), b_) <= 1e-4


@pytest.mark.parametrize("arch", ["minicpm3-4b", "hymba-1.5b"])
def test_mla_and_hybrid_prefills_on_the_card_launch_flash(card, arch):
    """A ``REDUCED`` f32 prefill of 40 tokens (past hymba's 32-slot ring)
    on the card: one flash launch a layer, the logits within 1e-3 of the
    plain attention's (``impl="torch"``), and a decode step after it on
    each cache within 1e-3 too."""
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype="float32")
    model = T.Transformer(cfg, seed=3)
    gen = torch.Generator(device=card).manual_seed(43)
    toks = torch.randint(0, cfg.vocab_size, (2, 41), device=card,
                         generator=gen)
    logits = []
    for impl in ("cuda", "torch"):
        cache = model.init_cache(2, 41)
        ops.reset_launch_counts()
        with torch.inference_mode():
            pre, cache = model.decode_step(toks[:, :40], cache, 0, impl=impl)
            dec, cache = model.decode_step(toks[:, 40:], cache, 40,
                                           impl=impl)
        torch.cuda.synchronize()
        if impl == "cuda":
            assert ops.launch_counts()["flash_attention"] == cfg.n_layers
        logits.append((pre, dec))
    for a, b in zip(*logits, strict=True):
        assert _rel_err(a, b) <= 1e-3


# ------------------------------- xLSTM, the encoder-decoder, the stub --
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,sq,sk,d", [
    (4, 16, 1, 1500, 64),                 # whisper's decode step
    (4, 16, 416, 1500, 64),               # whisper's prefill
    (2, 8, 1, 700, 128)])
def test_flash_attention_at_the_cross_attention_shapes(card, b, h, sq, sk, d,
                                                       dtype):
    """Non-causal attention of Sq queries over Sk = 1500 encoder frames
    (ragged: no kv block divides it), one query row a decode step: bf16
    runs the wgmma kernel; row by row against the plain version."""
    g = torch.Generator().manual_seed(sq + sk + d)
    q = torch.randn(b, h, sq, d, generator=g).to(card, dtype)
    k, v = (torch.randn(b, h, sk, d, generator=g).to(card, dtype)
            for _ in range(2))
    got = ops.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    if dtype == torch.bfloat16:
        assert flash_attention.last_path() == "flash_attention_wgmma_kernel"
    want = ref.attention(q, k, v, causal=False)
    assert _row_rel_err(got, want) <= ATTN_TOL[dtype]


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "whisper-medium",
                                  "qwen2-vl-72b"])
def test_reduced_models_on_the_card_match_the_cpu(card, arch):
    """The ``REDUCED`` model in f32 on the card and on the CPU with the
    same weights, on seeded inputs (whisper's frames and qwen2-vl's
    embeddings unit-normal, never zeros): the forward, a prefill and two
    decode steps within 1e-3; the prefill launches the flash kernel once
    for each attention (whisper: encoder, self and cross; xLSTM: none)."""
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype="float32")
    model = T.Transformer(cfg, seed=3)
    cpu = T.Transformer(cfg, device="cpu")
    cpu.params_from_jax(model.param_tree())
    gen = torch.Generator(device=card).manual_seed(44)
    first = {"tokens": torch.randint(0, cfg.vocab_size, (2, 24),
                                     device=card, generator=gen)}
    if arch == "qwen2-vl-72b":
        first = {"embeds": torch.randn(2, 24, cfg.d_model, device=card,
                                       generator=gen)}
    frames = {}
    if cfg.encoder_layers:
        frames = {"enc_embeds": torch.randn(2, cfg.encoder_seq, cfg.d_model,
                                            device=card, generator=gen)}
    nxt = torch.randint(0, cfg.vocab_size, (2, 2), device=card,
                        generator=gen)
    n_flash = {"xlstm-1.3b": 0, "whisper-medium": cfg.encoder_layers
               + 2 * cfg.n_layers, "qwen2-vl-72b": cfg.n_layers}[arch]
    out = {}
    for m, device in ((model, card), (cpu, torch.device("cpu"))):
        def on(batch):
            return {k: v.to(device) for k, v in {**batch, **frames}.items()}
        cache = m.init_cache(2, 26)
        ops.reset_launch_counts()
        with torch.inference_mode():
            res = [m(on(first))]
            res.append(m.decode_step(on(first), cache, 0)[0])
            if device.type == "cuda":
                torch.cuda.synchronize()
                assert ops.launch_counts()["flash_attention"] == 2 * n_flash
                assert sum(ops.launch_counts().values()) == 2 * n_flash
            for i in range(2):
                res.append(m.decode_step(on({"tokens": nxt[:, i:i + 1]}),
                                         cache, 24 + i)[0])
        out[device.type] = [r.cpu() for r in res]
    for a, b in zip(out["cuda"], out["cpu"], strict=True):
        assert _rel_err(a, b) <= 1e-3


# --------------------------------------------------------- the LM on a mesh --
MESH_CASES = [("qwen2.5-3b", (1, 4)), ("granite-moe-3b-a800m", (2, 2)),
              ("stablelm-1.6b", (2, 2)), ("hymba-1.5b", (2, 2))]


def _lm_mesh(shape):
    from repro_torch.models.sharding import Mesh
    return Mesh(np.full(shape, "cuda:0", dtype=object), ("data", "model"))


@pytest.mark.parametrize("arch,shape", MESH_CASES)
def test_mesh_prefill_and_decode_on_the_card_match_one_device(card, arch,
                                                              shape):
    """``REDUCED`` f32 models over a mesh of the one card: a 64-token
    prefill (the flash kernel on each member's heads in the tensor-parallel
    blocks) and 4 decode steps against the same calls without the mesh."""
    from repro_torch.launch.partitioning import make_rules
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype="float32")
    lm = T.Transformer(cfg, device=card, seed=0)
    rules = make_rules(cfg, _lm_mesh(shape))
    gen_ = torch.Generator(device=card).manual_seed(5)
    tok = torch.randint(0, cfg.vocab_size, (4, 68), device=card,
                        generator=gen_)
    outs = {}
    for name, r in (("mesh", rules), ("one", None)):
        cache = lm.init_cache(4, 68, rules=r)
        decode = lm.decode_step if r is None else \
            T.MeshExecutor(lm, r).decode_step
        ops.reset_launch_counts()
        logits, cache = decode(tok[:, :64], cache, 0)
        flash = ops.launch_counts()["flash_attention"]
        steps_ = [logits]
        for t in range(64, 68):
            lg, cache = decode(tok[:, t:t + 1], cache, t)
            steps_.append(lg)
        outs[name] = (torch.cat(steps_, 1), flash)
    members = shape[0] * shape[1]
    assert outs["mesh"][1] == cfg.n_layers * members
    assert _rel_err(outs["mesh"][0], outs["one"][0]) <= TOL[torch.float32]


def test_moe_mesh_path_on_the_card_matches_the_local_path(card):
    from repro_torch.launch.partitioning import make_rules
    from repro_torch.models import layers as L
    cfg = get_config("granite-moe-3b-a800m")
    gen_ = torch.Generator(device=card).manual_seed(3)
    p = L.moe_init(gen_, cfg, torch.float32, card)
    x = torch.randn(4, 256, cfg.d_model, device=card, generator=gen_)
    rules = make_rules(cfg, _lm_mesh((2, 2)))
    got = L.moe_apply(p, cfg, x, rules=rules)
    want = L.moe_apply(p, cfg, x)
    assert _rel_err(got, want) <= TOL[torch.float32]


def test_zero1_train_step_on_the_card_matches_one_device(card):
    """One AdamW step of ``REDUCED`` stablelm under ZeRO-1 on a (2, 2)
    mesh of the card against one device: the loss, the grad norm, and
    each parameter's update (its change, written back into the model),
    as a normwise relative gap (phase 20c's bar); an update left undone
    reads 1."""
    from repro_torch.launch import steps
    from repro_torch.launch.partitioning import make_rules
    from repro_torch.optim import OptConfig, adamw
    cfg = dataclasses.replace(get_config("stablelm-1.6b", reduced=True),
                              dtype="float32")
    models = [T.Transformer(cfg, device=card, seed=0) for _ in range(2)]
    gen_ = torch.Generator(device=card).manual_seed(7)
    tok = torch.randint(0, cfg.vocab_size, (4, 33), device=card,
                        generator=gen_)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    opt = OptConfig(lr=3e-4, warmup_steps=1, total_steps=10)
    one = steps.make_train_step(models[0], opt)
    mesh = steps.make_train_step(models[1], opt,
                                 rules=make_rules(cfg, _lm_mesh((2, 2))))
    before = [p.detach().clone() for p in models[0].parameters()]
    _, m0 = one(adamw.init(models[0].parameters()), batch)
    _, m1 = mesh(adamw.init(models[1].parameters()), batch)
    assert abs(float(m1["loss"]) / float(m0["loss"]) - 1) <= 1e-5
    assert abs(float(m1["grad_norm"]) / float(m0["grad_norm"]) - 1) <= 1e-4
    for a, b, p0 in zip(models[1].parameters(), models[0].parameters(),
                        before):
        want = (b.detach() - p0).double()
        gap = float(((a.detach() - p0).double() - want).norm() /
                    want.norm().clamp_min(1e-30))
        assert gap <= 1e-2


@pytest.mark.parametrize("baseline", ["overlapped", "atomic"])
@pytest.mark.parametrize("graph", ["banded", "powerlaw"])
def test_prior_work_baseline_matches_its_plain_version(card, graph,
                                                       baseline):
    """The paper's overlapped and atomic tilings on the card: one
    ``spmm_ell`` launch per partition or tile, against the same schedule
    on the kernel's plain version (f32 ``TOL``) and the fused path."""
    a = (gen.banded_spd(16384, 8, seed=0) if graph == "banded"
         else gen.powerlaw_graph(16384, 8, seed=0))
    rng = np.random.default_rng(0)
    b = torch.from_numpy(rng.standard_normal((a.n_rows, 64),
                                             np.float32)).to(card)
    c = torch.from_numpy(rng.standard_normal((64, 64), np.float32)).to(card)
    if baseline == "overlapped":
        run, sched = fused_ops.overlapped_gemm_spmm, \
            fused_ops.overlapped_tiles(a, 8)
    else:
        run, sched = fused_ops.atomic_gemm_spmm, fused_ops.atomic_tiles(a, 8)
    ops.reset_launch_counts()
    got = run(a, sched, b, c)
    torch.cuda.synchronize()
    assert ops.launch_counts()["spmm_ell"] == (8 if baseline == "overlapped"
                                               else 32)
    assert _rel_err(got, run(a, sched, b, c, kernel=False)) <= \
        TOL[torch.float32]
    assert _rel_err(got, api.tile_fused_matmul(a, b, c,
                                               backend="torch")) <= 2e-3
