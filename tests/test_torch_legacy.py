"""The port's loop-based inspector reference and legacy-keyword shim
against the JAX package's, on the CPU.

- ``core/tilefusion/reference.py``: the row-at-a-time Algorithm 1, Eq-3
  cost and ELL packers equal both the reference's ``reference.py`` and the
  port's vectorized inspector, array for array, on random CSR patterns
  (``tests/_prop.py``) and on empty and rectangular ones;
- the shim (``spec.spec_from_legacy_kwargs``): legacy keywords and the
  equivalent ``FusionSpec`` return the same cache entry, the
  ``DeprecationWarning`` fires once and ``clear_schedule_cache`` re-arms
  it, unknown keywords and ``spec=`` mixed with keywords raise
  ``TypeError``, every message is the reference's;
- ``GCN.forward``'s legacy ``(fused, impl)`` pair picks ``"unfused"`` and
  ``"cuda"`` (the port's names for the reference's ``"pallas"``).
"""
import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _prop import given, settings, st

from repro.core.sparse import formats as ref_formats
from repro.core.sparse.random import powerlaw_graph as ref_powerlaw
from repro.core.tilefusion import api as ref_api
from repro.core.tilefusion import fused_ops as ref_ops
from repro.core.tilefusion import reference as ref_reference
from repro.core.tilefusion import spec as ref_spec
from repro.models.gcn import GCN as RefGCN
from repro_torch.configs.gcn import REDUCED
from repro_torch.core.sparse import random
from repro_torch.core.sparse.formats import CSR, HybridELL, TileELL
from repro_torch.core.tilefusion import (api, build_schedule, fused_ops,
                                         reference, spec,
                                         to_device_schedule)
from repro_torch.models import gcn as gcn_mod
from repro_torch.models.gcn import GCN


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_caches():
    api.clear_schedule_cache()
    ref_api.clear_schedule_cache()
    yield
    api.clear_schedule_cache()
    ref_api.clear_schedule_cache()


def _random_pair(n_rows, n_cols, nnz, seed):
    rng = np.random.default_rng(seed)
    args = (n_rows, n_cols, rng.integers(0, n_rows, nnz),
            rng.integers(0, n_cols, nnz), rng.standard_normal(nnz))
    return ref_formats.CSR.from_coo(*args), CSR.from_coo(*args)


def _square_pair(n, density, seed):
    return _random_pair(n, n, max(int(density * n * n), 1), seed)


def _assert_schedule_equal(got, want):
    assert (got.t, got.n_i, got.n_j) == (want.t, want.n_i, want.n_j)
    assert len(got.wavefronts) == len(want.wavefronts)
    for wf_got, wf_want in zip(got.wavefronts, want.wavefronts):
        assert len(wf_got) == len(wf_want)
        for tg, tw in zip(wf_got, wf_want):
            assert (tg.i_start, tg.i_end) == (tw.i_start, tw.i_end)
            np.testing.assert_array_equal(tg.j_rows, tw.j_rows)
            assert tg.j_rows.dtype == tw.j_rows.dtype


def _assert_dsched_equal(got, want):
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, np.ndarray):
            assert g.shape == w.shape and g.dtype == w.dtype, f.name
            np.testing.assert_array_equal(g, w, err_msg=f.name)
        else:
            assert g == w, f.name


def _assert_arrays_equal(got, want):
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# --------------------------------------------------------------------------
# The loop-based reference
# --------------------------------------------------------------------------
@settings(max_examples=20, deadline=None)
@given(n=st.integers(8, 220), density=st.floats(0.001, 0.1),
       seed=st.integers(0, 10), ct=st.sampled_from([8, 64, 2048]),
       p=st.integers(1, 8), uniform=st.booleans(),
       cache=st.sampled_from([2_000.0, 1e12]), bsp=st.booleans())
def test_loop_scheduler_matches_both(n, density, seed, ct, p, uniform, cache,
                                     bsp):
    ra, ta = _square_pair(n, density, seed)
    kw = dict(b_col=16, c_col=16, p=p, cache_size=cache, ct_size=ct,
              b_is_sparse=bsp, uniform_split=uniform)
    got = reference.build_schedule_ref(ta, **kw)
    _assert_schedule_equal(got, ref_reference.build_schedule_ref(ra, **kw))
    _assert_schedule_equal(got, build_schedule(ta, **kw))
    ds = reference.to_device_schedule_ref(ta, got)
    _assert_dsched_equal(ds, ref_reference.to_device_schedule_ref(
        ra, ref_reference.build_schedule_ref(ra, **kw)))
    _assert_dsched_equal(ds, to_device_schedule(ta, got))


@settings(max_examples=12, deadline=None)
@given(n=st.integers(8, 150), density=st.floats(0.005, 0.1),
       seed=st.integers(0, 5), ct=st.sampled_from([16, 128]))
def test_loop_packers_and_ratio_match_both(n, density, seed, ct):
    ra, ta = _square_pair(n, density, seed)
    r = reference.fused_compute_ratio_ref(ta, ct_size=ct)
    assert r == ref_reference.fused_compute_ratio_ref(ra, ct_size=ct)
    from repro_torch.core.tilefusion import fused_compute_ratio
    assert abs(r - fused_compute_ratio(ta, ct_size=ct)) < 1e-12
    rows = np.arange(ta.n_rows, dtype=np.int64)
    for sub, width in ((rows, None), (rows[:: max(n // 7, 1)], 2)):
        got = reference.tile_ell_from_csr_rows_ref(ta, sub, width=width)
        want = ref_reference.tile_ell_from_csr_rows_ref(ra, sub, width=width)
        vec = TileELL.from_csr_rows(ta, sub, width=width)
        _assert_arrays_equal((got.cols, got.vals), (want.cols, want.vals))
        _assert_arrays_equal((got.cols, got.vals), (vec.cols, vec.vals))


@settings(max_examples=12, deadline=None)
@given(n=st.integers(8, 150), density=st.floats(0.005, 0.1),
       seed=st.integers(0, 6), cap=st.sampled_from([None, 1, 2, 5, 1000]))
def test_loop_hybrid_packer_matches_both(n, density, seed, cap):
    ra, ta = _square_pair(n, density, seed)
    rows = np.arange(ta.n_rows, dtype=np.int64)
    got = reference.hybrid_ell_from_csr_rows_ref(ta, rows, cap=cap)
    want = ref_reference.hybrid_ell_from_csr_rows_ref(ra, rows, cap=cap)
    vec = HybridELL.from_csr_rows(ta, rows, cap=cap)
    fields = ("cols", "vals", "spill_rows", "spill_cols", "spill_vals")
    for other in (want, vec):
        _assert_arrays_equal([getattr(got, f) for f in fields],
                             [getattr(other, f) for f in fields])


@settings(max_examples=8, deadline=None)
@given(n=st.integers(16, 120), density=st.floats(0.01, 0.08),
       seed=st.integers(0, 5))
def test_loop_op1_ell_matches_both(n, density, seed):
    ra, ta = _square_pair(n, density, seed)
    kw = dict(b_col=8, c_col=8, p=2, cache_size=5_000.0, ct_size=16,
              b_is_sparse=True, uniform_split=True)
    ds = to_device_schedule(ta, build_schedule(ta, **kw))
    got = reference.op1_ell_ref(ta, ds)
    from repro.core.tilefusion import build_schedule as ref_build
    from repro.core.tilefusion import to_device_schedule as ref_to_ds
    want = ref_reference.op1_ell_ref(ra, ref_to_ds(ra, ref_build(ra, **kw)))
    _assert_arrays_equal(got, want)
    cols, vals, spill_flat, _, _ = fused_ops._op1_ell(ta, ds)
    assert spill_flat.size == 0
    _assert_arrays_equal(got, (cols, vals))


@settings(max_examples=10, deadline=None)
@given(n=st.integers(8, 200), density=st.floats(0.005, 0.1),
       seed=st.integers(0, 6), bsp=st.booleans())
def test_loop_tile_cost_matches_both(n, density, seed, bsp):
    ra, ta = _square_pair(n, density, seed)
    from repro_torch.core.tilefusion import tile_cost_elements
    rng = np.random.default_rng(seed)
    for i0 in range(0, n, 32):
        jr = np.sort(rng.choice(n, size=int(rng.integers(0, min(n, 24))),
                                replace=False)).astype(np.int32)
        args = (i0, min(i0 + 32, n), jr, 16, 8, bsp)
        got = reference.tile_cost_elements_ref(ta, *args)
        assert got == ref_reference.tile_cost_elements_ref(ra, *args)
        assert got == tile_cost_elements(ta, *args)


@pytest.mark.parametrize("shape,nnz", [((6, 6), 0), ((120, 60), 200),
                                       ((60, 120), 200)])
def test_loop_reference_on_empty_and_rectangular(shape, nnz):
    ra, ta = _random_pair(*shape, nnz, 0)
    kw = dict(b_col=8, c_col=8, p=2, cache_size=2_000.0, ct_size=16)
    got = reference.build_schedule_ref(ta, **kw)
    _assert_schedule_equal(got, ref_reference.build_schedule_ref(ra, **kw))
    _assert_schedule_equal(got, build_schedule(ta, **kw))
    _assert_dsched_equal(reference.to_device_schedule_ref(ta, got),
                         to_device_schedule(ta, got))
    assert reference.fused_compute_ratio_ref(ta, 16) == \
        ref_reference.fused_compute_ratio_ref(ra, 16)


def test_reference_has_the_reference_functions():
    import inspect
    names = {n for n, f in inspect.getmembers(ref_reference,
                                              inspect.isfunction)
             if f.__module__ == ref_reference.__name__}
    assert len(names) == 13
    for name in names:
        assert inspect.isfunction(getattr(reference, name)), name


# --------------------------------------------------------------------------
# The legacy-keyword shim
# --------------------------------------------------------------------------
def test_legacy_knobs_are_the_reference_s():
    assert spec.LEGACY_KNOBS == ref_spec.LEGACY_KNOBS
    assert len(spec.LEGACY_KNOBS) == 14 and "reorder" not in spec.LEGACY_KNOBS


def test_spec_and_legacy_kwargs_cut_the_same_cache_key():
    a = random.banded_spd(256, 4, seed=20)
    s = api.FusionSpec(p=2, cache_size=30_000.0, ct_size=32)
    e_spec = api.get_schedule(a, b_col=8, c_col=8, spec=s)
    assert api.schedule_cache_stats()["misses"] == 1
    with pytest.warns(DeprecationWarning):
        e_legacy = api.get_schedule(a, b_col=8, c_col=8, p=2,
                                    cache_size=30_000.0, ct_size=32)
    assert e_legacy is e_spec
    stats = api.schedule_cache_stats()
    assert (stats["hits"], stats["misses"]) == (1, 1)
    assert stats["spec_entries"] == 1
    e2 = api.get_schedule(a, b_col=8, c_col=8,
                          spec=dataclasses.replace(s, ct_size=64))
    assert e2 is not e_spec
    assert api.schedule_cache_stats()["spec_entries"] == 2


def test_legacy_kwargs_warn_once_per_process():
    a = random.banded_spd(128, 4, seed=21)
    with pytest.warns(DeprecationWarning, match="FusionSpec"):
        api.get_schedule(a, b_col=8, c_col=8, p=2)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        api.get_schedule(a, b_col=8, c_col=8, p=4)
        api.tile_fused_matmul(a, torch.ones(128, 4), torch.ones(4, 4), p=4)
    assert not [w for w in caught
                if issubclass(w.category, DeprecationWarning)]
    api.clear_schedule_cache()                       # re-arms the warning
    with pytest.warns(DeprecationWarning):
        api.get_schedule(a, b_col=8, c_col=8, p=2)


def _messages(run):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            run()
        except TypeError as e:
            return "TypeError", str(e)
    return "warning", [(w.category, str(w.message)) for w in caught
                       if issubclass(w.category, DeprecationWarning)]


@pytest.mark.parametrize("case", ["both", "typo", "not_a_spec", "warning"])
@pytest.mark.parametrize("caller", ["get_schedule", "tile_fused_matmul"])
def test_shim_messages_are_the_reference_s(caller, case):
    ta = random.banded_spd(64, 2, seed=22)
    from repro.core.sparse.random import banded_spd as ref_banded
    ra = ref_banded(64, 2, seed=22)
    kw = {"both": dict(spec="SPEC", ct_size=32),
          "typo": dict(ct_sizee=32),
          "not_a_spec": dict(spec={"p": 2}),
          "warning": dict(ct_size=32, p=2)}[case]

    def call(module, a, ones, spec_cls):
        args = {k: (spec_cls() if v == "SPEC" else v) for k, v in kw.items()}
        if caller == "get_schedule":
            return lambda: module.get_schedule(a, b_col=4, c_col=4, **args)
        return lambda: module.tile_fused_matmul(a, ones((64, 4)),
                                                ones((4, 4)), **args)
    got = _messages(call(api, ta, torch.ones, api.FusionSpec))
    want = _messages(call(ref_api, ra, jnp.ones, ref_api.FusionSpec))
    assert got == want
    assert got[0] == ("warning" if case == "warning" else "TypeError")


def test_legacy_kwargs_on_tile_fused_matmul_and_store_bucket_schedule():
    a = random.powerlaw_graph(128, 6, seed=3)
    rng = np.random.default_rng(3)
    b = torch.tensor(rng.standard_normal((128, 8)), dtype=torch.float32)
    c = torch.tensor(rng.standard_normal((8, 4)), dtype=torch.float32)
    want = api.tile_fused_matmul(a, b, c, spec=api.FusionSpec(p=2,
                                                              ct_size=32))
    with pytest.warns(DeprecationWarning, match="tile_fused_matmul"):
        got = api.tile_fused_matmul(a, b, c, p=2, ct_size=32)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert api.schedule_cache_stats()["misses"] == 1
    entry = dataclasses.replace(
        api.get_schedule(a, b_col=8, c_col=4), content_digest=b"d")
    bucket = (128, 1024, 8)
    published = api.store_bucket_schedule(entry, bucket=bucket,
                                          width_cap=8)
    hit = api.get_schedule(a, b_col=8, c_col=4, spec=api.FusionSpec(
        width_cap=8, bucket=bucket))
    assert published is entry
    assert hit.bucket == bucket
    with pytest.raises(TypeError, match="both spec="):
        api.store_bucket_schedule(entry, bucket=bucket,
                                  spec=api.FusionSpec(), p=2)


def test_store_bucket_schedule_without_a_spec():
    """A bare ``store_bucket_schedule`` takes the default spec, as in the
    reference (the port raised ``AttributeError`` on ``None.dtype_bytes``
    before reading the spec)."""
    a = random.banded_spd(64, 2, seed=4)
    entry = dataclasses.replace(api.get_schedule(a, b_col=4, c_col=4),
                                content_digest=b"d")
    assert api.store_bucket_schedule(entry, bucket=(64, 512, 4)) is entry
    assert entry.bucket == (64, 512, 4)
    assert api.schedule_cache_stats()["bucket_entries"] == 1


# --------------------------------------------------------------------------
# GCN's legacy (fused, impl) pair
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kw,backend", [
    (dict(fused=False), "unfused"), (dict(impl="pallas"), "cuda"),
    (dict(impl="xla"), "torch"), (dict(), "auto"),
    (dict(fused=False, impl="pallas"), "unfused"),
    (dict(fused=False, backend="cuda"), "cuda"),
    (dict(impl="pallas", backend="torch"), "torch")])
def test_gcn_legacy_pair_picks_the_backend(kw, backend, monkeypatch):
    adj = random.powerlaw_graph(REDUCED.n_nodes, 6, seed=0)
    model = GCN(REDUCED, adj, device="cpu", seed=1)
    picked = []
    real = api.tile_fused_matmul

    def record(*args, backend, **rest):
        picked.append(backend)
        return real(*args, backend=backend, **rest)
    monkeypatch.setattr(gcn_mod.api, "tile_fused_matmul", record)
    x = torch.randn(REDUCED.n_nodes, REDUCED.in_dim,
                    generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        out = model(x, **kw)
        want = model(x, backend=backend)
    assert picked == [backend] * (2 * REDUCED.n_layers)
    torch.testing.assert_close(out, want, rtol=0, atol=0)


def test_gcn_legacy_pair_matches_the_reference():
    """``fused=False`` and ``impl="pallas"`` give the reference's logits
    under the same pair (its unfused and Pallas arms)."""
    import jax
    adj = ref_powerlaw(REDUCED.n_nodes, 6, seed=3)
    ref = RefGCN(REDUCED, adj)
    params = ref.init_params(jax.random.PRNGKey(0))
    model = GCN(REDUCED, random.powerlaw_graph(REDUCED.n_nodes, 6, seed=3),
                device="cpu")
    model.params_from_jax(params)
    x = np.random.default_rng(3).standard_normal(
        (REDUCED.n_nodes, REDUCED.in_dim)).astype(np.float32)
    for kw in (dict(fused=False), dict(impl="pallas")):
        want = np.asarray(ref.forward(params, jnp.asarray(x), **kw))
        with torch.inference_mode():
            got = model(torch.tensor(x), **kw).numpy()
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    with pytest.raises(ValueError, match="impl="):
        model(torch.tensor(x), impl="mkl")


def test_baseline_names_match_the_reference():
    for name in ("overlapped_tiles", "overlapped_gemm_spmm",
                 "overlapped_redundancy", "atomic_tiles",
                 "atomic_gemm_spmm"):
        assert callable(getattr(fused_ops, name))
        assert callable(getattr(ref_ops, name))
