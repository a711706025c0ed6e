"""The port's autotune sweep against the JAX package's, on the CPU.

The autotune cells of ``tests/test_api.py``: the winner's ``autotuned``
tuple ``(ct_size, cache_size, width_cap)`` and its schedule arrays equal to
the reference's winner's (dense and sparse op 1, where the sweep also tries
width caps), never more Eq-3 traffic than the ``ct_size=2048`` default, the
sweep memoized (``autotune_sweeps``), the width cap and the autotune flag
in the key, and ``tile_fused_matmul`` with ``autotune=True`` and its
gradients against the reference's (rtol=atol=2e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cells import KNOBS, as_port, pattern_pair
from test_torch_grad import BACKEND_MAP, _port_grads, _ref_grads
from repro.core.sparse.random import banded_spd, powerlaw_graph
from repro.core.tilefusion import api as ref_api
from repro.core.tilefusion import fused_ref as ref_oracle
from repro_torch.core.tilefusion import api

MATRICES = {
    "banded-2048": lambda: banded_spd(2048, 6, seed=10),
    "powerlaw-2048": lambda: powerlaw_graph(2048, 8, seed=9),
    "powerlaw-1024": lambda: powerlaw_graph(1024, 4, seed=11),
}
DSCHED_FIELDS = ("i_starts", "i_lens", "j_rows0", "ell_cols0", "ell_vals0",
                 "j_rows1", "ell_cols1", "ell_vals1", "spill_rows1",
                 "spill_cols1", "spill_vals1")


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    jax.clear_caches()


@pytest.mark.parametrize("b_is_sparse", [False, True])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_autotune_winner_equals_the_reference(name, b_is_sparse):
    """Same candidates, same scores, same winner: the ``autotuned`` tuple,
    the traffic model and every device-schedule array; and the winner never
    predicts more traffic than the paper's ``ct_size=2048`` default."""
    ra = MATRICES[name]()
    ta = as_port(ra)
    kw = dict(b_col=32, c_col=32, b_is_sparse=b_is_sparse)
    api.clear_schedule_cache()
    got = api.get_schedule(ta, spec=api.FusionSpec(autotune=True), **kw)
    want = ref_api.get_schedule(ra, spec=ref_api.FusionSpec(autotune=True),
                                **kw)
    assert got.autotuned == want.autotuned is not None
    assert got.width_cap == want.width_cap
    assert got.traffic_model == pytest.approx(want.traffic_model)
    for field in DSCHED_FIELDS:
        np.testing.assert_array_equal(getattr(got.dsched, field),
                                      getattr(want.dsched, field))
    got.sched.validate()
    default = api.get_schedule(
        ta, spec=api.FusionSpec(ct_size=api.DEFAULT_CT_SIZE), **kw)
    assert (got.traffic_model["fused_bytes"]
            <= default.traffic_model["fused_bytes"])
    assert got.inspector_s >= default.inspector_s


def test_autotune_constants_are_the_reference():
    assert api.DEFAULT_CT_SIZE == ref_api.DEFAULT_CT_SIZE
    assert api.AUTOTUNE_CT_GRID == ref_api.AUTOTUNE_CT_GRID
    assert api.AUTOTUNE_CACHE_SCALES == ref_api.AUTOTUNE_CACHE_SCALES


@pytest.mark.parametrize("b_is_sparse", [False, True])
def test_candidate_caps_and_packed_bytes_equal_the_reference(b_is_sparse):
    ra = powerlaw_graph(512, 6, seed=4)
    ta = as_port(ra)
    for cap in (None, 2, 5):
        assert (api._candidate_width_caps(ta, cap)
                == ref_api._candidate_width_caps(ra, cap))
    for width_cap in (None, "auto", 3):
        spec_kw = dict(KNOBS, width_cap=width_cap)
        kw = dict(b_col=8, c_col=8, b_is_sparse=b_is_sparse)
        got = api.get_schedule(ta, spec=api.FusionSpec(**spec_kw), **kw)
        want = ref_api.get_schedule(ra, spec=ref_api.FusionSpec(**spec_kw),
                                    **kw)
        for dtype_bytes in (2, 4):
            assert (api._packed_ell_bytes(ta, got.dsched, b_is_sparse,
                                          dtype_bytes)
                    == ref_api._packed_ell_bytes(ra, want.dsched,
                                                 b_is_sparse, dtype_bytes))
        assert (got.dsched.padded_flops_overhead(8, 8)
                == want.dsched.padded_flops_overhead(8, 8))


def test_autotune_sweep_memoized():
    api.clear_schedule_cache()
    ta = as_port(banded_spd(512, 4, seed=12))
    spec = api.FusionSpec(autotune=True)
    e1 = api.get_schedule(ta, b_col=16, c_col=16, spec=spec)
    stats = api.schedule_cache_stats()
    assert stats["autotune_sweeps"] == 1
    assert e1.hits == 0 and e1.autotuned is not None
    e2 = api.get_schedule(ta, b_col=16, c_col=16, spec=spec)
    assert e2 is e1 and e1.hits == 1
    after = api.schedule_cache_stats()
    assert after["autotune_sweeps"] == 1
    assert after["misses"] == stats["misses"]
    # the winner is a copy of its candidate, published under its own key
    cand = [e for e in api._schedule_cache.values()
            if e.autotuned is None and e.sched is e1.sched]
    assert len(cand) == 1 and cand[0] is not e1


def test_width_cap_and_autotune_invalidate_cache():
    """Changing the width cap or the autotune flag misses the cache; every
    knob repeated verbatim is a pure hit."""
    api.clear_schedule_cache()
    ta = as_port(powerlaw_graph(256, 5, seed=7))
    kw = dict(b_col=8, c_col=8, b_is_sparse=True)

    def spec(**over):
        return api.FusionSpec(cache_size=20_000.0, **over)
    e_auto = api.get_schedule(ta, spec=spec(), **kw)
    assert api.schedule_cache_stats()["misses"] == 1
    e_pad = api.get_schedule(ta, spec=spec(width_cap=None), **kw)
    assert e_pad is not e_auto
    assert api.schedule_cache_stats()["misses"] == 2
    e_int = api.get_schedule(ta, spec=spec(width_cap=e_auto.width_cap + 3),
                             **kw)
    assert e_int is not e_auto and e_int is not e_pad
    assert api.schedule_cache_stats()["misses"] == 3
    e_at = api.get_schedule(ta, spec=spec(autotune=True), **kw)
    assert e_at is not e_auto and e_at.autotuned is not None
    misses = api.schedule_cache_stats()["misses"]
    assert api.get_schedule(ta, spec=spec(), **kw) is e_auto
    assert api.get_schedule(ta, spec=spec(width_cap=None), **kw) is e_pad
    assert api.get_schedule(ta, spec=spec(autotune=True), **kw) is e_at
    assert api.schedule_cache_stats()["misses"] == misses


@pytest.mark.parametrize("backend", ["auto", "torch", "cuda", "unfused"])
@pytest.mark.parametrize("op_pair", ["gemm", "spmm"])
def test_autotune_matmul_matches_reference(op_pair, backend):
    ra = powerlaw_graph(512, 6, seed=13)
    ta = as_port(ra)
    rng = np.random.default_rng(13)
    if op_pair == "spmm":
        c = rng.standard_normal((512, 8)).astype(np.float32)
        tb, jb = ta, ra
        oracle = ref_oracle.unfused_spmm_spmm(ra, ra, c)
    else:
        b = rng.standard_normal((512, 16)).astype(np.float32)
        c = rng.standard_normal((16, 8)).astype(np.float32)
        tb, jb = torch.from_numpy(b), jnp.asarray(b)
        oracle = ref_oracle.unfused_gemm_spmm(ra, b, c)
    got = api.tile_fused_matmul(ta, tb, torch.from_numpy(c), backend=backend,
                                spec=api.FusionSpec(autotune=True))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PALLAS_INTERPRET", "1")
        want = ref_api.tile_fused_matmul(
            ra, jb, jnp.asarray(c), backend=BACKEND_MAP[backend],
            spec=ref_api.FusionSpec(autotune=True))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("backend", ["auto", "torch", "cuda"])
@pytest.mark.parametrize("op_pair", ["gemm", "spmm"])
def test_autotune_grads_match_jax_grad(op_pair, backend):
    """The backward's transpose entry runs its own sweep (``autotune``
    carries over), on a non-symmetric pattern."""
    ra, ta = pattern_pair("empty-rows", seed=3)
    rng = np.random.default_rng(7)
    n = ra.n_rows
    if op_pair == "spmm":
        b, c, w = None, rng.standard_normal((n, 6)), rng.standard_normal((n,
                                                                          6))
    else:
        b, c, w = (rng.standard_normal((n, 8)), rng.standard_normal((8, 6)),
                   rng.standard_normal((n, 6)))
    spec_kw = dict(autotune=True)
    want = _ref_grads(ra, op_pair, b, c, w, BACKEND_MAP[backend],
                      jnp.float32, spec_kw)
    api.clear_schedule_cache()
    got = _port_grads(ta, op_pair, b, c, w, backend, torch.float32, spec_kw)
    for g, r in zip(got, want, strict=True):
        np.testing.assert_allclose(g, r, rtol=2e-3, atol=2e-3)
    # forward and backward each swept once (the GeMM-SpMM dC runs unfused)
    assert api.schedule_cache_stats()["autotune_sweeps"] == 2
    bwd = [e for k, e in api._schedule_cache.items()
           if k[0] == "autotune" and e.transpose]
    assert len(bwd) == 1


def test_gcn_with_autotune_serves_and_trains():
    """A ``GCN`` built with ``FusionSpec(autotune=True)`` sweeps each layer
    shape once at build time and serves from those entries."""
    from repro_torch.configs.gcn import REDUCED
    from repro_torch.models.gcn import GCN
    api.clear_schedule_cache()
    ta = as_port(banded_spd(REDUCED.n_nodes, 4, seed=0))
    model = GCN(REDUCED, ta, spec=api.FusionSpec(autotune=True),
                device="cpu", seed=0)
    plain = GCN(REDUCED, ta, device="cpu", seed=0)
    assert all(e.autotuned is not None for e in model.entries)
    sweeps = api.schedule_cache_stats()["autotune_sweeps"]
    assert sweeps == len({(e.b_col, e.c_col) for e in model.entries})
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (REDUCED.n_nodes, REDUCED.in_dim)).astype(np.float32))
    y = torch.arange(REDUCED.n_nodes) % REDUCED.out_dim
    with torch.inference_mode():
        torch.testing.assert_close(model(x), plain(x, backend="torch"),
                                   rtol=2e-3, atol=2e-3)
    assert api.schedule_cache_stats()["autotune_sweeps"] == sweeps
    model.loss(x, y).backward()
    plain.loss(x, y, backend="torch").backward()
    for w, v in zip(model.weights, plain.weights):
        torch.testing.assert_close(w.grad, v.grad, rtol=2e-3, atol=2e-3)
