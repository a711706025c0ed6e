"""The port's backward through ``tile_fused_matmul`` against the JAX
package's ``custom_vjp``.

Gradients of ``sum(w · D)`` go through the port's autograd Functions and
through ``jax.grad`` of the reference's ``tile_fused_matmul`` on the same
inputs: op pair {GeMM-SpMM, SpMM-SpMM} × the patterns of
``tests/test_grad.py`` (banded, powerlaw-hub, empty-rows; 64 nodes) ×
{f32 at 2e-3, bf16 at 1e-1} × port backend {auto, cuda, torch, unfused}
mapped to {auto, pallas, xla, unfused} (Pallas in interpret mode).  The
cells of ``spec.transpose`` run on non-symmetric patterns only: on a
symmetric one, code that ignored the bit would pass.  The rest pins the
transpose entry as its own cache key with its own width cap, the reuse of
that entry across grads, contiguous operands for the kernels when the
cotangent comes strided (``loss = D.sum()``), and the training traffic
model.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cells import KNOBS, as_port, pattern_pair
from repro.configs.gcn import GCNConfig as RefGCNConfig
from repro.core.sparse.random import banded_spd, powerlaw_graph
from repro.core.tilefusion import api as ref_api
from repro.core.tilefusion import cost_model as ref_cost
from repro.models.gcn import GCN as RefGCN
from repro_torch.configs.gcn import GCNConfig
from repro_torch.core.tilefusion import api, cost_model
from repro_torch.kernels import ops as kops
from repro_torch.models.gcn import GCN

#: port backend -> reference backend
BACKEND_MAP = {"auto": "auto", "cuda": "pallas", "torch": "xla",
               "unfused": "unfused"}
#: name here -> the shared cell of test_torch_cells (test_grad.py's names)
GRAD_PATTERNS = {"banded": "banded", "powerlaw-hub": "single-hub-row",
                 "empty-rows": "empty-rows"}
NON_SYMMETRIC = ("powerlaw-hub", "empty-rows")
DTYPES = {"f32": (jnp.float32, torch.float32, 2e-3),
          "bf16": (jnp.bfloat16, torch.bfloat16, 1e-1)}


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    jax.clear_caches()


def _pattern(name: str):
    """(reference CSR, port CSR) of test_grad.py's pattern at 64 nodes."""
    return pattern_pair(GRAD_PATTERNS[name], seed=3)


def _inputs(op_pair: str, n: int):
    """numpy (b or None, c, w) of test_grad.py's cells."""
    rng = np.random.default_rng(7)
    if op_pair == "spmm":
        return None, rng.standard_normal((n, 6)), rng.standard_normal((n, 6))
    return (rng.standard_normal((n, 8)), rng.standard_normal((8, 6)),
            rng.standard_normal((n, 6)))


def _ref_grads(ra, op_pair, b, c, w, backend, dtype, spec_kw=None):
    """``jax.grad`` of ``sum(w · D)`` through the reference, as f32 numpy."""
    spec = ref_api.FusionSpec(**dict(KNOBS, **(spec_kw or {})))
    jw = jnp.asarray(w, jnp.float32).astype(dtype)
    jc = jnp.asarray(c, jnp.float32).astype(dtype)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PALLAS_INTERPRET", "1")
        if op_pair == "spmm":
            got = jax.grad(lambda c_: jnp.sum(jw * ref_api.tile_fused_matmul(
                ra, ra, c_, backend=backend, spec=spec)))(jc)
            return [np.asarray(jnp.asarray(got, jnp.float32))]
        jb = jnp.asarray(b, jnp.float32).astype(dtype)
        got = jax.grad(lambda b_, c_: jnp.sum(jw * ref_api.tile_fused_matmul(
            ra, b_, c_, backend=backend, spec=spec)), argnums=(0, 1))(jb, jc)
    return [np.asarray(jnp.asarray(g, jnp.float32)) for g in got]


def _port_grads(ta, op_pair, b, c, w, backend, dtype, spec_kw=None):
    """Gradients of ``sum(w · D)`` through the port, as f32 numpy."""
    spec = api.FusionSpec(**dict(KNOBS, **(spec_kw or {})))

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32).to(dtype)
    tw = t(w)
    tc = t(c).requires_grad_()
    if op_pair == "spmm":
        d = api.tile_fused_matmul(ta, ta, tc, backend=backend, spec=spec)
        leaves = [tc]
    else:
        tb = t(b).requires_grad_()
        d = api.tile_fused_matmul(ta, tb, tc, backend=backend, spec=spec)
        leaves = [tb, tc]
    assert d.requires_grad and d.dtype == dtype
    (tw * d).sum().backward()
    for x in leaves:
        assert x.grad.dtype == dtype and x.grad.shape == x.shape
    return [x.grad.float().numpy() for x in leaves]


def _dense_transposed(a, op_pair, b, c):
    ad = a.to_dense().T
    return ad @ (ad @ c) if op_pair == "spmm" else ad @ (b @ c)


@pytest.mark.parametrize("backend", sorted(BACKEND_MAP))
@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("pattern", sorted(GRAD_PATTERNS))
@pytest.mark.parametrize("op_pair", ["gemm", "spmm"])
def test_grad_parity_cell(op_pair, pattern, dtype_name, backend):
    jdt, tdt, tol = DTYPES[dtype_name]
    ra, ta = _pattern(pattern)
    b, c, w = _inputs(op_pair, ra.n_rows)
    want = _ref_grads(ra, op_pair, b, c, w, BACKEND_MAP[backend], jdt)
    got = _port_grads(ta, op_pair, b, c, w, backend, tdt)
    for g, r in zip(got, want, strict=True):
        np.testing.assert_allclose(
            g, r, rtol=tol, atol=tol,
            err_msg=f"{op_pair}/{backend}/{pattern}/{dtype_name}")


@pytest.mark.parametrize("backend", sorted(BACKEND_MAP))
@pytest.mark.parametrize("pattern", NON_SYMMETRIC)
@pytest.mark.parametrize("op_pair", ["gemm", "spmm"])
def test_transposed_forward_matches_reference(op_pair, pattern, backend):
    """``spec.transpose=True`` computes ``aᵀ·(b·c)`` / ``aᵀ·(aᵀ·c)``, as
    the reference's dispatch does, on patterns where ``aᵀ != a``."""
    ra, ta = _pattern(pattern)
    assert not np.array_equal(ra.to_dense(), ra.to_dense().T)
    b, c, _ = _inputs(op_pair, ra.n_rows)
    spec_kw = dict(KNOBS, transpose=True)
    tb = ta if op_pair == "spmm" else torch.as_tensor(b, dtype=torch.float32)
    got = api.tile_fused_matmul(ta, tb, torch.as_tensor(c,
                                                        dtype=torch.float32),
                                backend=backend,
                                spec=api.FusionSpec(**spec_kw))
    jb = ra if op_pair == "spmm" else jnp.asarray(b, jnp.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PALLAS_INTERPRET", "1")
        want = ref_api.tile_fused_matmul(
            ra, jb, jnp.asarray(c, jnp.float32),
            backend=BACKEND_MAP[backend], spec=ref_api.FusionSpec(**spec_kw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(got.numpy(),
                               _dense_transposed(ra, op_pair, b, c),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("op_pair", ["gemm", "spmm"])
def test_backward_of_transposed_forward(op_pair):
    """The backward of a transposed product flips the bit back and runs on
    the forward entry; its gradients equal the reference's."""
    ra, ta = _pattern("empty-rows")
    b, c, w = _inputs(op_pair, ra.n_rows)
    for backend in ("cuda", "torch"):
        want = _ref_grads(ra, op_pair, b, c, w, BACKEND_MAP[backend],
                          jnp.float32, dict(transpose=True))
        got = _port_grads(ta, op_pair, b, c, w, backend, torch.float32,
                          dict(transpose=True))
        for g, r in zip(got, want, strict=True):
            np.testing.assert_allclose(g, r, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("width_cap", ["auto", 4])
def test_transpose_entry_is_its_own_cache_key(width_cap):
    """Forward (16, 16) and transpose (16, 16) of a non-symmetric square
    matrix are two entries, also where both resolve the same width cap
    (an int), and the transpose entry is the reference's array for array
    (``"auto"``: its cap resolved on ``aᵀ``, whose row degrees differ)."""
    api.clear_schedule_cache()
    ra, ta = _pattern("powerlaw-hub")
    kw = dict(KNOBS, width_cap=width_cap)
    fwd = api.get_schedule(ta, b_col=16, c_col=16, spec=api.FusionSpec(**kw))
    bwd = api.get_schedule(ta, b_col=16, c_col=16, spec=api.FusionSpec(
        **kw, transpose=True))
    stats = api.schedule_cache_stats()
    assert bwd is not fwd and (fwd.transpose, bwd.transpose) == (False, True)
    assert (stats["entries"], stats["misses"],
            stats["transpose_entries"]) == (2, 2, 1)
    assert not np.array_equal(fwd.dsched.j_rows0, bwd.dsched.j_rows0)
    if width_cap == "auto":
        assert bwd.width_cap == api._resolve_width_cap(ta.transpose(),
                                                       "auto")
        assert fwd.width_cap != bwd.width_cap
    else:
        assert fwd.width_cap == bwd.width_cap == width_cap
    want = ref_api.get_schedule(ra, b_col=16, c_col=16,
                                spec=ref_api.FusionSpec(**kw,
                                                        transpose=True))
    for f in dataclasses.fields(want.dsched):
        g, w = getattr(bwd.dsched, f.name), getattr(want.dsched, f.name)
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=f.name)
        else:
            assert g == w, f.name
    assert bwd.traffic_model == pytest.approx(
        {k: want.traffic_model[k] for k in bwd.traffic_model})
    assert api.get_schedule(ta, b_col=16, c_col=16, spec=api.FusionSpec(
        **kw, transpose=True)) is bwd


@pytest.mark.parametrize("op_pair", ["gemm", "spmm"])
def test_repeated_grad_inspects_nothing(op_pair):
    """One grad mints the transpose entry; a repeat hits the cache."""
    api.clear_schedule_cache()
    _, ta = _pattern("empty-rows")
    b, c, w = _inputs(op_pair, ta.n_rows)
    _port_grads(ta, op_pair, b, c, w, "auto", torch.float32)
    stats = api.schedule_cache_stats()
    assert stats["transpose_entries"] == 1
    _port_grads(ta, op_pair, b, c, w, "auto", torch.float32)
    after = api.schedule_cache_stats()
    assert after["misses"] == stats["misses"]
    assert after["transpose_entries"] == 1
    assert after["hits"] > stats["hits"]


@pytest.mark.parametrize("op_pair", ["gemm", "spmm"])
def test_backward_hands_the_kernels_contiguous_tensors(op_pair,
                                                        monkeypatch):
    """``loss = D.sum()`` gives the backward an expanded cotangent (stride
    0); every kernel wrapper must still get contiguous tensors, as the CUDA
    launchers demand, and the gradients stay right."""
    seen = []

    def checked(fn):
        def wrapper(*args, **kwargs):
            for x in list(args) + list(kwargs.values()):
                if isinstance(x, torch.Tensor):
                    assert x.is_contiguous(), (fn.__name__, x.stride())
            seen.append(fn.__name__)
            return fn(*args, **kwargs)
        return wrapper
    for name in ("spmm_ell", "tile_fused_gemm_spmm_wf0",
                 "tile_fused_spmm_spmm_wf0"):
        monkeypatch.setattr(kops, name, checked(getattr(kops, name)))
    ra, ta = _pattern("empty-rows")
    b, c, _ = _inputs(op_pair, ra.n_rows)
    tc = torch.as_tensor(c, dtype=torch.float32).requires_grad_()
    ad = ra.to_dense()
    if op_pair == "spmm":
        d = api.tile_fused_matmul(ta, ta, tc, backend="cuda",
                                  spec=api.FusionSpec(**KNOBS))
        want = [ad.T @ (ad.T @ np.ones((ra.n_rows, 6)))]
        leaves = [tc]
    else:
        tb = torch.as_tensor(b, dtype=torch.float32).requires_grad_()
        d = api.tile_fused_matmul(ta, tb, tc, backend="cuda",
                                  spec=api.FusionSpec(**KNOBS))
        g1 = ad.T @ np.ones((ra.n_rows, 6))
        want = [g1 @ c.T, b.T @ g1]
        leaves = [tb, tc]
    n_forward = len(seen)
    d.sum().backward()
    assert len(seen) > n_forward           # the backward reached the kernels
    wf0 = ("tile_fused_spmm_spmm_wf0" if op_pair == "spmm"
           else "tile_fused_gemm_spmm_wf0")
    assert wf0 in seen[n_forward:]
    for x, w in zip(leaves, want, strict=True):
        np.testing.assert_allclose(x.grad.numpy(), w, rtol=2e-3, atol=2e-3)


def test_train_step_traffic_equal():
    fwd = {"fused_bytes": 1.5e6, "unfused_bytes": 2.0e6}
    tr = {"fused_bytes": 1.2e6, "unfused_bytes": 1.9e6}
    kw = dict(nnz=12_345, n_i=700, n_j=650, c_col=32)
    for dtype_bytes in (2, 4):
        assert cost_model.train_step_traffic(
            fwd, tr, **kw, dtype_bytes=dtype_bytes) == pytest.approx(
            ref_cost.train_step_traffic(fwd, tr, **kw,
                                        dtype_bytes=dtype_bytes))
    assert cost_model.spmm_bytes(100, 10, 20, 8) == ref_cost.spmm_bytes(
        100, 10, 20, 8)


@pytest.mark.parametrize("graph", ["banded", "powerlaw"])
def test_gcn_train_step_traffic_models_equal(graph):
    cfg = RefGCNConfig(n_nodes=96, in_dim=16, hidden_dim=16, out_dim=8,
                       n_layers=3)
    adj = (banded_spd(96, 4, seed=1) if graph == "banded"
           else powerlaw_graph(96, 5, seed=1))
    want = RefGCN(cfg, adj, **KNOBS).train_step_traffic_models()
    got = GCN(GCNConfig(**dataclasses.asdict(cfg)), as_port(adj),
              spec=api.FusionSpec(**KNOBS),
              device="cpu").train_step_traffic_models()
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g == pytest.approx(w)
