"""Card-only checks of the port: each CUDA kernel against its plain PyTorch
version, the ``cuda`` arm against the ``torch`` arm (forward, gradients
and a GCN training step), and the LM served on the card.

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
that limit at published widths).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.gcn import GCNConfig
from repro_torch.core.sparse import random as gen
from repro_torch.core.sparse.formats import CSR
from repro_torch.core.tilefusion import api, fused_ops
from repro_torch.kernels import flash_attention, ops, ref, spmm
from repro_torch.kernels import tile_fused_gemm_spmm as gemm_wf0
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.models.gcn import GCN

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


# (3, 5, ...), t = 2048 and f32 rows of 1 KB (b_col 256) run the CUDA-core
# kernel; the others the wgmma kernel: N = 128 and N = 32 (GCN layers 1
# and 2), tile counts that leave warpgroups idle or uneven (7, 37, 300),
# K = N = 8, c_col > 128 (two column blocks), w0 > 32 with a ragged last k
# block (b_col 40), 512-byte rows of B in bf16, and one k block at N = 128
# over 2,048 tiles (b_col 32: the backward's dB of GCN layer 2)
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
    (torch.bfloat16, 64, 128, 36, True, "tile_fused_gemm_spmm_wf0_kernel")])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,sq,sk,d,causal,window", [
    (2, 2, 128, 128, 32, True, 0), (1, 3, 100, 100, 48, True, 0),
    (2, 2, 256, 256, 64, True, 32), (1, 2, 150, 150, 64, False, 0),
    (1, 2, 256, 128, 32, True, 32),       # rows q >= 159 see no key
    (1, 1, 70, 40, 16, True, 7), (1, 4, 512, 512, 128, True, 0),
    (1, 1, 96, 96, 200, True, 0), (1, 2, 64, 1000, 256, False, 0),
    (1, 2, 70, 90, 20, False, 9),         # d % 8 != 0: scalar staging
    # bf16 at D 64 / 128 runs the wgmma kernel (128 queries a CTA, K/V
    # through the TMA ring)
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
    want = ref.attention(q, k, v, causal=causal, window=window)
    assert _row_rel_err(got, want) <= ATTN_TOL[dtype]


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
    (torch.float32, 64, True, "flash_attention_kernel")])
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
# each, and walks f in chunks of 32 C; TMA where d and f are multiples of
# 8, element-wise staging where not
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,d,f,act", [
    (256, 64, 512, "gelu"),               # C = 1
    (100, 48, 200, "silu"),
    (64, 2048, 256, "gelu"),              # C = 8
    (37, 2500, 70, "none"),               # d > 2048: two cluster groups
    (200, 1536, 500, "silu"),             # C = 6; f, m ragged to the chunk
    (300, 2048, 1000, "gelu"),            # C = 8; f, m ragged
    (130, 4096, 300, "gelu"),             # two full cluster groups
    (77, 100, 90, "gelu")])               # d % 8 != 0: staged, not TMA
def test_fused_ffn_kernel(card, m, d, f, act, dtype):
    g = torch.Generator().manual_seed(m + d + f)
    x = torch.randn(m, d, generator=g).to(card, dtype)
    w1 = (torch.randn(d, f, generator=g) / d ** 0.5).to(card, dtype)
    w2 = (torch.randn(f, d, generator=g) / f ** 0.5).to(card, dtype)
    before = ops.fused_ffn.launches
    got = ops.fused_ffn(x, w1, w2, act=act)
    torch.cuda.synchronize()
    assert ops.fused_ffn.launches == before + 1
    assert _row_rel_err(got, ref.ffn(x, w1, w2, act=act)) <= FFN_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,cap,d,f,act", [
    (4, 128, 64, 512, "silu"), (3, 40, 24, 56, "gelu"),
    (2, 64, 32, 128, "none"),
    (3, 40, 1536, 512, "silu"),           # C = 6, cap 40
    (2, 200, 2048, 700, "gelu"),          # C = 8, cap and f ragged
    (2, 40, 100, 90, "silu")])            # d % 8 != 0: staged, not TMA
def test_fused_moe_ffn_kernel(card, e, cap, d, f, act, dtype):
    g = torch.Generator().manual_seed(e * cap + f)
    x = torch.randn(e, cap, d, generator=g).to(card, dtype)
    w1 = (torch.randn(e, d, f, generator=g) / d ** 0.5).to(card, dtype)
    w2 = (torch.randn(e, f, d, generator=g) / f ** 0.5).to(card, dtype)
    before = ops.fused_moe_ffn.launches
    got = ops.fused_moe_ffn(x, w1, w2, act=act)
    torch.cuda.synchronize()
    assert ops.fused_moe_ffn.launches == before + 1
    assert (_row_rel_err(got, ref.moe_ffn(x, w1, w2, act=act))
            <= FFN_TOL[dtype])


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
    got = model(toks)
    want = model(toks, impl="torch")
    assert _rel_err(got, want) <= 2e-2
