"""The port's ``tile_fused_matmul`` against the JAX package's, cell by cell.

Cells: six parity patterns × {GeMM-SpMM, SpMM-SpMM} × backends
{torch, unfused, auto, cuda}.  Each port cell is held to the reference
``api.tile_fused_matmul`` under the mapped backend (torch↔xla,
unfused↔unfused, cuda↔pallas in interpret mode — on CPU tensors the cuda
arm runs its glue with the kernels' plain versions, so this checks the
arm's padding, scatter and spill handling against the Pallas arm's) and
to the numpy oracle ``fused_ref.unfused_*``, at ``rtol=atol=2e-3`` in f32
(the reference's bar) and ``2e-2`` in bf16.  The ``auto`` pick must equal
the reference's under the name map on every cell.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cells import KNOBS, PATTERNS, pattern_pair
from repro.core.tilefusion import api as ref_api
from repro.core.tilefusion import fused_ref as ref_oracle
from repro_torch.core.tilefusion import api, fused_ops

#: port backend -> reference backend
BACKEND_MAP = {"torch": "xla", "unfused": "unfused", "cuda": "pallas",
               "auto": "auto"}
#: reference pick -> port pick on a host without the card
PICK_MAP = {"xla": "torch", "pallas": "cuda", "unfused": "unfused"}


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    jax.clear_caches()


def _operands(op_pair: str, n: int, c_col: int, seed: int):
    rng = np.random.default_rng(seed)
    if op_pair == "spmm":
        return None, rng.standard_normal((n, c_col))
    return rng.standard_normal((n, 8)), rng.standard_normal((8, c_col))


def _run_pair(ra, ta, op_pair, b, c, backend, *, dtype="f32", spec_kw=None):
    """(port result, reference result) as float32 numpy arrays."""
    spec_kw = dict(KNOBS, **(spec_kw or {}))
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jc = jnp.asarray(c, jnp.float32).astype(jdt)
    tc = torch.as_tensor(c, dtype=torch.float32).to(tdt)
    if op_pair == "spmm":
        jb, tb = ra, ta
    else:
        jb = jnp.asarray(b, jnp.float32).astype(jdt)
        tb = torch.as_tensor(b, dtype=torch.float32).to(tdt)
    got = api.tile_fused_matmul(ta, tb, tc, backend=backend,
                                spec=api.FusionSpec(**spec_kw))
    rbe = BACKEND_MAP[backend]
    if rbe == "pallas":
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("PALLAS_INTERPRET", "1")
            want = ref_api.tile_fused_matmul(
                ra, jb, jc, backend=rbe, spec=ref_api.FusionSpec(**spec_kw))
    else:
        want = ref_api.tile_fused_matmul(ra, jb, jc, backend=rbe,
                                         spec=ref_api.FusionSpec(**spec_kw))
    assert got.dtype == tdt and tuple(got.shape) == tuple(want.shape)
    return (got.float().numpy(),
            np.asarray(jnp.asarray(want, jnp.float32)))


@pytest.mark.parametrize("backend", ["torch", "unfused", "auto", "cuda"])
@pytest.mark.parametrize("op_pair", ["gemm", "spmm"])
@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_parity_cell(pattern, op_pair, backend):
    ra, ta = pattern_pair(pattern)
    b, c = _operands(op_pair, ra.n_rows, 8, seed=len(pattern))
    got, want = _run_pair(ra, ta, op_pair, b, c, backend)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    oracle = (ref_oracle.unfused_spmm_spmm(ra, ra, c) if op_pair == "spmm"
              else ref_oracle.unfused_gemm_spmm(ra, b, c))
    np.testing.assert_allclose(got, oracle, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("c_col", [4, 8])
@pytest.mark.parametrize("op_pair", ["gemm", "spmm"])
@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_auto_pick_matches_reference(pattern, op_pair, c_col):
    ra, ta = pattern_pair(pattern)
    sparse = op_pair == "spmm"
    b_col = c_col if sparse else 8
    want = ref_api.select_backend(ref_api.get_schedule(
        ra, b_col=b_col, c_col=c_col, b_is_sparse=sparse,
        spec=ref_api.FusionSpec(**KNOBS)))
    got = api.select_backend(api.get_schedule(
        ta, b_col=b_col, c_col=c_col, b_is_sparse=sparse,
        spec=api.FusionSpec(**KNOBS)), torch.device("cpu"))
    assert got == PICK_MAP[want]


@pytest.mark.parametrize("backend", ["torch", "cuda", "unfused"])
@pytest.mark.parametrize("op_pair", ["gemm", "spmm"])
@pytest.mark.parametrize("pattern", ["banded", "single-hub-row"])
def test_bf16_cell(pattern, op_pair, backend):
    """bf16 operands: ELL values are cast from the schedule's f32 to the
    operand dtype at dispatch, in both packages."""
    ra, ta = pattern_pair(pattern)
    b, c = _operands(op_pair, ra.n_rows, 8, seed=3)
    got, want = _run_pair(ra, ta, op_pair, b, c, backend, dtype="bf16")
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got / scale, want / scale, rtol=2e-2,
                               atol=2e-2)


#: Algorithm-1 knobs under which the recursive step 2 splits tiles unevenly
#: on the 64-node patterns (banded GeMM-SpMM: tiles of 8 and 16 rows;
#: empty-rows SpMM-SpMM: six tiles of 8 and one of 16)
NON_UNIFORM = dict(uniform_split=False, cache_size=1_000.0)


@pytest.mark.parametrize("op_pair", ["gemm", "spmm"])
@pytest.mark.parametrize("pattern", ["banded", "empty-rows"])
def test_non_uniform_schedule(pattern, op_pair):
    """``uniform_split=False`` (the paper's recursive step 2) yields tiles
    of several sizes: the torch executors' general path."""
    ra, ta = pattern_pair(pattern)
    b, c = _operands(op_pair, ra.n_rows, 4, seed=11)
    got, want = _run_pair(ra, ta, op_pair, b, c, "torch",
                          spec_kw=NON_UNIFORM)
    oracle = (ref_oracle.unfused_spmm_spmm(ra, ra, c) if op_pair == "spmm"
              else ref_oracle.unfused_gemm_spmm(ra, b, c))
    np.testing.assert_allclose(got, oracle, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


def test_non_uniform_schedule_is_exercised():
    spec = api.FusionSpec(**dict(KNOBS, **NON_UNIFORM))
    _, banded = pattern_pair("banded")
    _, empty = pattern_pair("empty-rows")
    for a, b_col, sparse in ((banded, 8, False), (empty, 4, True)):
        entry = api.get_schedule(a, b_col=b_col, c_col=4, b_is_sparse=sparse,
                                 spec=spec)
        assert not fused_ops._is_uniform(entry.dsched)
    with pytest.raises(ValueError, match="uniform"):
        api.tile_fused_matmul(banded, torch.randn(64, 8), torch.randn(8, 4),
                              backend="cuda", spec=spec)


def test_auto_never_drops_a_device_tensor_to_the_plain_path():
    """Off the CPU, ``auto`` picks the kernel arm or raises — for a
    non-uniform schedule, and for a device the kernels do not run on
    (``meta`` here) — instead of quietly picking ``"torch"``."""
    spec = api.FusionSpec(**dict(KNOBS, **NON_UNIFORM))
    _, empty = pattern_pair("empty-rows")
    ragged = api.get_schedule(empty, b_col=4, c_col=4, b_is_sparse=True,
                              spec=spec)
    uniform = api.get_schedule(empty, b_col=4, c_col=4, b_is_sparse=True,
                               spec=api.FusionSpec(**KNOBS))
    assert api.select_backend(ragged, "cpu") == "torch"
    assert api.select_backend(uniform, "cpu") == "torch"
    with pytest.raises(ValueError, match="uniform"):
        api.select_backend(ragged, "meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        api.select_backend(uniform, "meta")


@pytest.mark.parametrize("knob", ["autotune", "mesh", "bucket", "reorder"])
def test_out_of_slice_knobs_raise(knob):
    _, ta = pattern_pair("banded")
    value = {"autotune": True, "mesh": object(), "bucket": (64, 64, 4),
             "reorder": "rcm"}[knob]
    spec = dataclasses.replace(api.FusionSpec(**KNOBS), **{knob: value})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        api.tile_fused_matmul(ta, torch.randn(64, 8), torch.randn(8, 4),
                              spec=spec)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        api.get_schedule(ta, b_col=8, c_col=4, spec=spec)


def test_sharded_backend_and_grad_raise():
    """``backend="sharded"``, unknown backends and mixed dtypes raise;
    autograd no longer does: the gradient that comes back equals the
    plain path's."""
    _, ta = pattern_pair("banded")
    b, c = torch.randn(64, 8), torch.randn(8, 4, requires_grad=True)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        api.tile_fused_matmul(ta, b, c.detach(), backend="sharded")
    api.tile_fused_matmul(ta, b, c).sum().backward()
    plain = c.detach().clone().requires_grad_()
    api.tile_fused_matmul(ta, b, plain, backend="torch").sum().backward()
    assert c.grad is not None
    torch.testing.assert_close(c.grad, plain.grad, rtol=2e-3, atol=2e-3)
    with torch.no_grad():
        assert not api.tile_fused_matmul(ta, b, c).requires_grad
    with pytest.raises(ValueError, match="backend"):
        api.tile_fused_matmul(ta, b, c.detach(), backend="pallas")
    with pytest.raises(ValueError, match="dtype"):
        api.tile_fused_matmul(ta, b.double(), c.detach())


def test_device_tensors_uploaded_once():
    """The schedule's arrays are copied to a device once per (device,
    dtype) and reused by every later call, fused and unfused."""
    _, ta = pattern_pair("banded")
    b, c = torch.randn(64, 8), torch.randn(8, 4)
    spec = api.FusionSpec(**KNOBS)
    api.tile_fused_matmul(ta, b, c, backend="cuda", spec=spec)
    entry = api.get_schedule(ta, b_col=8, c_col=4,
                             spec=dataclasses.replace(spec, dtype_bytes=4))
    first = fused_ops.schedule_tensors(entry.dsched, "cpu", torch.float32)
    api.tile_fused_matmul(ta, b, c, backend="torch", spec=spec)
    assert fused_ops.schedule_tensors(entry.dsched, "cpu",
                                      torch.float32) is first
    ell = api._csr_ell(ta, 3, "cpu", torch.float32)
    assert api._csr_ell(ta, 3, "cpu", torch.float32) is ell
