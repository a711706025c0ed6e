"""The kernels' plain PyTorch versions against the TPU kernels they replace.

``repro_torch.kernels.ops.*`` on CPU tensors run the plain versions; the
JAX side runs the Pallas kernels in interpret mode.  Shapes are ragged on
purpose (tile sizes that are not powers of two, odd widths, row counts
that do not fill a Pallas block).  Tolerances: f32 ``rtol=atol=2e-3`` (the
reference's own bar); bf16 ``rtol=atol=2e-2``, since bf16 rounds at
different places in the two frameworks.  The CUDA kernels themselves are
held to these plain versions on the card (``test_torch_gpu.py``,
``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import spmm as ref_spmm
from repro.kernels import tile_fused_gemm_spmm as ref_gemm
from repro.kernels import tile_fused_spmm_spmm as ref_spmm_spmm
from repro_torch.kernels import config, ops

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-3),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    jax.clear_caches()


def _pair(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of one dtype."""
    jdt, tdt, _ = DTYPES[dtype]
    if x.dtype.kind in "iu":
        return jnp.asarray(x, jnp.int32), torch.as_tensor(x, dtype=torch.int32)
    return (jnp.asarray(x, jnp.float32).astype(jdt),
            torch.as_tensor(x, dtype=torch.float32).to(tdt))


def _close(got: torch.Tensor, want, dtype: str, msg: str = ""):
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=msg)


def _ell(rng, shape, n_targets):
    """ELL columns/values with a zero-valued tail per row (pad slots)."""
    cols = rng.integers(0, n_targets, shape).astype(np.int32)
    vals = rng.standard_normal(shape)
    keep = rng.random(shape) < 0.8
    return np.where(keep, cols, 0).astype(np.int32), np.where(keep, vals, 0.0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n_rows,w,n,c", [(37, 3, 50, 5), (64, 1, 64, 8),
                                          (300, 7, 129, 33)])
def test_spmm_ell_matches_pallas(n_rows, w, n, c, dtype):
    rng = np.random.default_rng(n_rows + c)
    cols, vals = _ell(rng, (n_rows, w), n)
    x = rng.standard_normal((n, c))
    (jc, tc), (jv, tv), (jx, tx) = (_pair(cols, dtype), _pair(vals, dtype),
                                    _pair(x, dtype))
    want = ref_spmm.spmm_ell(jc, jv, jx, interpret=True)
    got = ops.spmm_ell(tc, tv, tx)
    assert got.dtype == tx.dtype and got.shape == (n_rows, c)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n_tiles,t,j0,w,b_col,c_col",
                         [(3, 5, 4, 3, 6, 7), (2, 16, 9, 5, 8, 4),
                          (1, 33, 12, 2, 3, 17)])
def test_gemm_spmm_wf0_matches_pallas(n_tiles, t, j0, w, b_col, c_col,
                                      dtype):
    rng = np.random.default_rng(t * j0)
    cols0, vals0 = _ell(rng, (n_tiles, j0, w), t)
    b = rng.standard_normal((n_tiles * t, b_col))
    c = rng.standard_normal((b_col, c_col))
    pairs = [_pair(x, dtype) for x in (cols0, vals0, b, c)]
    want_d1, want_rows = ref_gemm.tile_fused_gemm_spmm_wf0(
        *[p[0] for p in pairs], t=t, interpret=True)
    got_d1, got_rows = ops.tile_fused_gemm_spmm_wf0(*[p[1] for p in pairs],
                                                    t=t)
    assert got_d1.shape == (n_tiles * t, c_col)
    assert got_rows.shape == (n_tiles, j0, c_col)
    _close(got_d1, want_d1, dtype, "d1")
    _close(got_rows, want_rows, dtype, "rows0")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n_tiles,t,j0,w0,w1,n,c_col",
                         [(3, 5, 4, 3, 2, 40, 7), (2, 16, 9, 5, 4, 70, 4),
                          (1, 33, 12, 2, 6, 33, 17)])
def test_spmm_spmm_wf0_matches_pallas(n_tiles, t, j0, w0, w1, n, c_col,
                                      dtype):
    rng = np.random.default_rng(t * w1)
    op1_cols, op1_vals = _ell(rng, (n_tiles, t, w1), n)
    spill = rng.standard_normal((n_tiles * t, c_col))
    spill[rng.random(n_tiles * t) < 0.7] = 0.0
    cols0, vals0 = _ell(rng, (n_tiles, j0, w0), t)
    c = rng.standard_normal((n, c_col))
    pairs = [_pair(x, dtype) for x in (op1_cols, op1_vals, spill, cols0,
                                       vals0, c)]
    want_d1, want_rows = ref_spmm_spmm.tile_fused_spmm_spmm_wf0(
        *[p[0] for p in pairs], t=t, interpret=True)
    got_d1, got_rows = ops.tile_fused_spmm_spmm_wf0(*[p[1] for p in pairs],
                                                    t=t)
    _close(got_d1, want_d1, dtype, "d1")
    _close(got_rows, want_rows, dtype, "rows0")


def test_cpu_path_counts_no_launch():
    ops.reset_launch_counts()
    x = torch.randn(6, 4)
    cols = torch.zeros(6, 2, dtype=torch.int32)
    ops.spmm_ell(cols, torch.ones(6, 2), x)
    ops.flash_attention(*(torch.randn(1, 2, 5, 4) for _ in range(3)))
    ops.fused_ffn(x, torch.randn(4, 8), torch.randn(8, 4))
    ops.fused_moe_ffn(x[None], torch.randn(1, 4, 8), torch.randn(1, 8, 4))
    assert ops.launch_counts() == {"spmm_ell": 0,
                                   "tile_fused_gemm_spmm_wf0": 0,
                                   "tile_fused_spmm_spmm_wf0": 0,
                                   "flash_attention": 0,
                                   "fused_ffn": 0,
                                   "fused_moe_ffn": 0}


def test_wrappers_never_fall_back_off_the_cpu():
    """A tensor that is not on the CPU launches the kernel or raises — here
    (no card) the wrappers raise instead of running their plain versions."""
    meta = dict(device="meta")
    cols = torch.empty(4, 2, dtype=torch.int32, **meta)
    vals = torch.empty(4, 2, **meta)
    x = torch.empty(5, 3, **meta)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.spmm_ell(cols, vals, x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.tile_fused_gemm_spmm_wf0(torch.empty(1, 2, 2, dtype=torch.int32,
                                                 **meta),
                                     torch.empty(1, 2, 2, **meta),
                                     torch.empty(4, 3, **meta),
                                     torch.empty(3, 3, **meta), t=4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        config.kernel_library("meta")


@pytest.mark.parametrize("smem_rows,c_col,want", [
    (64 + 128, 128, 128),      # GCN layer 1: t = 64, b_col = 128
    (128 + 128, 32, 32),       # GCN layer 2: t = 128, c_col = 32
    (128, 128, 128),           # SpMM-SpMM at t = 128
    (2048 + 128, 128, 16),     # t = ct_size = 2048
    (5, 4, 4),                 # narrow test widths
])
def test_column_block_fits_shared_memory(smem_rows, c_col, want):
    cb = config.column_block(smem_rows, c_col)
    assert cb == want
    assert smem_rows * cb * 4 <= config.SMEM_BYTES


def test_column_block_raises_when_nothing_fits():
    with pytest.raises(ValueError, match="shared memory"):
        config.column_block(8000, 128)


def test_ctypes_signatures_match_the_sources():
    """Every launcher's ``argtypes`` agree with its ``extern "C"``
    declaration: a wrong count or width would cut a pointer silently."""
    import ctypes
    import re

    from repro_torch.kernels import _build
    c_types = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
               "int64_t": ctypes.c_int64, "int": ctypes.c_int,
               "float": ctypes.c_float}
    found = {}
    for src in _build.SOURCES:
        text = (_build.CSRC / src).read_text()
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                       text):
            types = [" ".join(p.split()[:-1]).replace(" *", "*")
                     for p in params.split(",") if p.strip()]
            found[name] = tuple(c_types[t] for t in types)
    assert found == dict(_build.SIGNATURES)


def test_build_raises_without_a_compiler(monkeypatch, tmp_path):
    from repro_torch.kernels import _build
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
