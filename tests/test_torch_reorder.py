"""The port's reorder transform against the JAX package's, on the CPU.

A twin of ``tests/test_reorder.py``: ``rcm_order``, ``similarity_order``,
``permute_csr`` and ``bandwidth`` equal to the reference's array for array
(square and rectangular inputs, and their errors); the ``spec.reorder``
schedule transform — ``"auto"`` never raises modeled traffic, a forced
ordering is baked into the entry with the reference's permutation, a
rectangular pattern is rejected — and ``tile_fused_matmul`` with
``reorder`` ∈ {auto, rcm, similarity} × {GeMM-SpMM, SpMM-SpMM} × port
backend {torch, cuda (plain versions on the CPU), auto} against the
reference's output (rtol=atol=2e-3) and pick.  Gradients run against
``jax.grad`` on non-symmetric patterns, where a wrong transpose would show.

``shuffled-banded`` is ``banded_spd(64, 4)`` under a seeded symmetric
permutation: it fuses nothing as given and RCM restores the band, so
``"auto"`` applies an ordering and moves the pick off ``unfused``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cells import KNOBS, as_port, pattern_pair
from test_torch_grad import BACKEND_MAP, _port_grads, _ref_grads
from repro.core.sparse.formats import CSR as RefCSR
from repro.core.sparse.random import banded_spd, powerlaw_graph
from repro.core.tilefusion import api as ref_api
from repro.core.tilefusion import fused_ref as ref_oracle
from repro.core.tilefusion import reorder as ref_reorder
from repro_torch.core.tilefusion import api, reorder

#: reference pick -> port pick on a host without the card
PICK_MAP = {"xla": "torch", "pallas": "cuda", "unfused": "unfused"}
ORDERINGS = ("auto", "rcm", "similarity")


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    jax.clear_caches()


def _shuffled_banded(n: int = 64, seed: int = 0) -> RefCSR:
    a = banded_spd(n, 4, seed=seed)
    return ref_reorder.permute_csr(
        a, np.random.default_rng(seed).permutation(n))


def _every_other_row(a: RefCSR) -> RefCSR:
    """``a`` with its even rows emptied: ``Aᵀ != A``."""
    dense = a.to_dense()
    dense[::2, :] = 0.0
    return RefCSR.from_dense(dense)


SQUARE = {
    "shuffled-banded": lambda: _shuffled_banded(),
    "shuffled-banded-nonsym": lambda: _every_other_row(_shuffled_banded()),
    "powerlaw-300": lambda: powerlaw_graph(300, 6, seed=0),
    "banded-97": lambda: banded_spd(97, 3, seed=1),
    "empty-rows": lambda: pattern_pair("empty-rows")[0],
    "single-hub-row": lambda: pattern_pair("single-hub-row")[0],
    "1x1": lambda: pattern_pair("1x1")[0],
}


def _rect(seed=0, shape=(7, 5)) -> RefCSR:
    rng = np.random.default_rng(seed)
    dense = (rng.random(shape) < 0.4) * rng.standard_normal(shape)
    return RefCSR.from_dense(dense)


def _assert_csr_equal(got, want):
    assert (got.n_rows, got.n_cols) == (want.n_rows, want.n_cols)
    for field in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))


@pytest.mark.parametrize("name", sorted(SQUARE))
def test_orderings_equal_the_reference(name):
    ra = SQUARE[name]()
    ta = as_port(ra)
    perm = reorder.rcm_order(ta)
    np.testing.assert_array_equal(perm, ref_reorder.rcm_order(ra))
    assert sorted(perm.tolist()) == list(range(ra.n_rows))
    for block in (1, 8, 64):
        np.testing.assert_array_equal(
            reorder.similarity_order(ta, block=block),
            ref_reorder.similarity_order(ra, block=block))
    _assert_csr_equal(reorder.permute_csr(ta, perm),
                      ref_reorder.permute_csr(ra, perm))
    assert reorder.bandwidth(ta) == ref_reorder.bandwidth(ra)


def test_rcm_reduces_bandwidth_on_shuffled_banded():
    ta = as_port(_shuffled_banded(512, seed=1))
    assert (reorder.bandwidth(reorder.permute_csr(ta, reorder.rcm_order(ta)))
            < reorder.bandwidth(ta))


@pytest.mark.parametrize("shape", [(7, 5), (9, 6), (40, 23)])
def test_rectangular_permutations_equal_the_reference(shape):
    ra = _rect(seed=shape[0], shape=shape)
    ta = as_port(ra)
    rng = np.random.default_rng(1)
    rp, cp = rng.permutation(ra.n_rows), rng.permutation(ra.n_cols)
    for kw in (dict(row_perm=rp), dict(col_perm=cp),
               dict(row_perm=rp, col_perm=cp)):
        got = reorder.permute_csr(ta, **kw)
        _assert_csr_equal(got, ref_reorder.permute_csr(ra, **kw))
        np.testing.assert_array_equal(
            got.to_dense(), ra.to_dense()[kw.get("row_perm", slice(None))]
            [:, kw.get("col_perm", slice(None))])
    np.testing.assert_array_equal(reorder.similarity_order(ta, block=8),
                                  ref_reorder.similarity_order(ra, block=8))
    assert reorder.permute_csr(ta) is ta


def test_permute_csr_and_rcm_errors():
    ta = as_port(_rect(seed=4, shape=(8, 5)))
    with pytest.raises(ValueError, match="square"):
        reorder.rcm_order(ta)
    with pytest.raises(ValueError, match="row_perm"):
        reorder.permute_csr(ta, np.arange(ta.n_rows))
    with pytest.raises(ValueError, match="row_perm"):
        reorder.permute_csr(ta, row_perm=np.arange(ta.n_cols))
    with pytest.raises(ValueError, match="col_perm"):
        reorder.permute_csr(ta, col_perm=np.arange(ta.n_rows))
    sq = as_port(banded_spd(6, 2, seed=0))
    with pytest.raises(ValueError, match="not both"):
        reorder.permute_csr(sq, np.arange(6), row_perm=np.arange(6))


def test_permute_rows_cached_hits_and_equals_permute_csr():
    ta = as_port(powerlaw_graph(128, 4, seed=2))
    perm = np.random.default_rng(3).permutation(128)
    first = reorder.permute_rows_cached(ta, perm)
    _assert_csr_equal(first, reorder.permute_csr(ta, row_perm=perm))
    assert reorder.permute_rows_cached(ta, perm) is first
    assert reorder.permute_rows_cached(ta, perm.copy()) is first
    other = reorder.permute_rows_cached(ta, perm[::-1].copy())
    assert other is not first
    _assert_csr_equal(other, reorder.permute_csr(ta, row_perm=perm[::-1]))


def test_candidate_orderings_shared_by_content():
    """A candidate ordering is computed once per matrix content: an equal
    CSR (a transpose entry's ``a.transpose()`` of a symmetric matrix is
    one) reuses it, and ``clear_schedule_cache`` drops it."""
    ref = _shuffled_banded()
    api.clear_schedule_cache()
    perm, a_p = api._ordering(as_port(ref), "rcm")
    np.testing.assert_array_equal(perm, ref_reorder.rcm_order(ref))
    assert api._ordering(as_port(ref).transpose(), "rcm")[1] is a_p
    api.clear_schedule_cache()
    assert api._ordering(as_port(ref), "rcm")[1] is not a_p


@pytest.mark.parametrize("b_is_sparse", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reorder_auto_never_raises_modeled_traffic(seed, b_is_sparse):
    """``"auto"``'s fused bytes never exceed the identity ordering's, and
    it makes the reference's choice (applied or not, and which)."""
    for ra in (powerlaw_graph(256, 5, seed=seed), _shuffled_banded(64, seed)):
        ta = as_port(ra)
        kw = dict(b_col=8, c_col=8, b_is_sparse=b_is_sparse)
        base = api.get_schedule(ta, spec=api.FusionSpec(**KNOBS), **kw)
        auto = api.get_schedule(
            ta, spec=api.FusionSpec(**KNOBS, reorder="auto"), **kw)
        want = ref_api.get_schedule(
            ra, spec=ref_api.FusionSpec(**KNOBS, reorder="auto"), **kw)
        assert (auto.traffic_model["fused_bytes"]
                <= base.traffic_model["fused_bytes"] + 1e-9)
        assert auto.reorder == want.reorder
        assert auto.traffic_model == pytest.approx(want.traffic_model)
        if auto.reorder is not None:
            assert auto is not base and auto.reorder_perm is not None


@pytest.mark.parametrize("name", ["rcm", "similarity"])
@pytest.mark.parametrize("transpose", [False, True])
def test_forced_reorder_bakes_the_reference_permutation(name, transpose):
    ra = _every_other_row(powerlaw_graph(128, 4, seed=2))
    ta = as_port(ra)
    kw = dict(b_col=8, c_col=8)
    spec_kw = dict(KNOBS, reorder=name, transpose=transpose)
    entry = api.get_schedule(ta, spec=api.FusionSpec(**spec_kw), **kw)
    want = ref_api.get_schedule(ra, spec=ref_api.FusionSpec(**spec_kw), **kw)
    assert entry.reorder == want.reorder == name
    np.testing.assert_array_equal(entry.reorder_perm, want.reorder_perm)
    np.testing.assert_array_equal(entry.reorder_inv, want.reorder_inv)
    np.testing.assert_array_equal(entry.reorder_perm[entry.reorder_inv],
                                  np.arange(128))
    for field in ("j_rows0", "ell_cols0", "ell_vals0", "j_rows1",
                  "ell_cols1", "ell_vals1", "spill_rows1", "spill_cols1"):
        np.testing.assert_array_equal(getattr(entry.dsched, field),
                                      getattr(want.dsched, field))
    assert (entry.traffic_model["packed_ell_bytes"]
            == want.traffic_model["packed_ell_bytes"])


def test_plain_and_reordered_entries_are_two_entries():
    """``spec.reorder`` is in the key: a plain and a reordered entry of one
    matrix do not collide, and each repeats as a pure hit."""
    api.clear_schedule_cache()
    ta = as_port(_shuffled_banded())
    kw = dict(b_col=8, c_col=8)
    plain = api.get_schedule(ta, spec=api.FusionSpec(**KNOBS), **kw)
    rcm = api.get_schedule(ta, spec=api.FusionSpec(**KNOBS, reorder="rcm"),
                           **kw)
    assert plain is not rcm
    assert plain.reorder is None and rcm.reorder == "rcm"
    stats = api.schedule_cache_stats()
    assert stats["misses"] == 2 and stats["reorder_entries"] == 1
    assert stats["spec_entries"] == 2
    assert api.get_schedule(ta, spec=api.FusionSpec(**KNOBS), **kw) is plain
    assert api.get_schedule(
        ta, spec=api.FusionSpec(**KNOBS, reorder="rcm"), **kw) is rcm
    assert api.schedule_cache_stats()["misses"] == 2


def test_forced_reorder_rejects_rectangular_schedule():
    ta = as_port(_rect(seed=6, shape=(32, 20)))
    with pytest.raises(ValueError, match="square"):
        api.get_schedule(ta, b_col=8, c_col=8,
                         spec=api.FusionSpec(**KNOBS, reorder="rcm"))
    auto = api.get_schedule(ta, b_col=8, c_col=8,
                            spec=api.FusionSpec(**KNOBS, reorder="auto"))
    assert auto.reorder is None and auto.reorder_perm is None


def _matmul_pair(ra, op_pair, backend, ordering, seed=0):
    """(port result, reference result, port entry, reference entry)."""
    rng = np.random.default_rng(seed)
    spec_kw = dict(KNOBS, reorder=ordering)
    ta = as_port(ra)
    if op_pair == "spmm":
        c = rng.standard_normal((ra.n_rows, 8)).astype(np.float32)
        tb, jb = ta, ra
    else:
        b = rng.standard_normal((ra.n_rows, 8)).astype(np.float32)
        c = rng.standard_normal((8, 8)).astype(np.float32)
        tb, jb = torch.from_numpy(b), jnp.asarray(b)
    got = api.tile_fused_matmul(ta, tb, torch.from_numpy(c), backend=backend,
                                spec=api.FusionSpec(**spec_kw))
    rbe = BACKEND_MAP[backend]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PALLAS_INTERPRET", "1")
        want = ref_api.tile_fused_matmul(ra, jb, jnp.asarray(c),
                                         backend=rbe,
                                         spec=ref_api.FusionSpec(**spec_kw))
    kw = dict(b_col=8, c_col=8, b_is_sparse=op_pair == "spmm")
    entry = api.get_schedule(ta, spec=api.FusionSpec(**spec_kw,
                                                     dtype_bytes=4), **kw)
    ref_entry = ref_api.get_schedule(
        ra, spec=ref_api.FusionSpec(**spec_kw, dtype_bytes=4), **kw)
    oracle = (ref_oracle.unfused_spmm_spmm(ra, ra, c) if op_pair == "spmm"
              else ref_oracle.unfused_gemm_spmm(ra, b, c))
    np.testing.assert_allclose(got.numpy(), oracle, rtol=2e-3, atol=2e-3)
    return got.numpy(), np.asarray(want), entry, ref_entry


@pytest.mark.parametrize("backend", ["torch", "cuda", "auto"])
@pytest.mark.parametrize("op_pair", ["gemm", "spmm"])
@pytest.mark.parametrize("ordering", ORDERINGS)
def test_reordered_matmul_matches_reference(ordering, op_pair, backend):
    ra = _shuffled_banded()
    got, want, entry, ref_entry = _matmul_pair(ra, op_pair, backend,
                                               ordering)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    assert entry.reorder == ref_entry.reorder is not None
    pick = api.select_backend(entry, "cpu")
    assert pick == PICK_MAP[ref_api.select_backend(ref_entry)]
    if ordering == "auto":
        # RCM moves the shuffled band from the unfused arm to the fused one
        plain = api.get_schedule(as_port(ra), b_col=8, c_col=8,
                                 b_is_sparse=op_pair == "spmm",
                                 spec=api.FusionSpec(**KNOBS))
        assert api.select_backend(plain, "cpu") == "unfused"
        assert pick == "torch"


@pytest.mark.parametrize("op_pair", ["gemm", "spmm"])
def test_reordered_matmul_on_a_non_symmetric_pattern(op_pair):
    """A non-symmetric pattern under every ordering and the fused arms."""
    ra = _every_other_row(_shuffled_banded())
    for ordering in ORDERINGS:
        for backend in ("torch", "cuda"):
            got, want, entry, ref_entry = _matmul_pair(ra, op_pair, backend,
                                                       ordering, seed=1)
            np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
            assert entry.reorder == ref_entry.reorder


@pytest.mark.parametrize("backend", ["torch", "cuda", "auto"])
@pytest.mark.parametrize("ordering", ["rcm", "auto"])
@pytest.mark.parametrize("op_pair", ["gemm", "spmm"])
def test_reordered_grads_match_jax_grad(op_pair, ordering, backend):
    """Gradients through a reordered forward entry and a reordered
    transpose entry (``Aᵀ`` priced and permuted on its own), against
    ``jax.grad`` of the reference on a non-symmetric pattern."""
    ra = _every_other_row(_shuffled_banded())
    ta = as_port(ra)
    assert not np.array_equal(ra.to_dense(), ra.to_dense().T)
    rng = np.random.default_rng(7)
    n = ra.n_rows
    if op_pair == "spmm":
        b, c, w = None, rng.standard_normal((n, 6)), rng.standard_normal((n,
                                                                          6))
    else:
        b, c, w = (rng.standard_normal((n, 8)), rng.standard_normal((8, 6)),
                   rng.standard_normal((n, 6)))
    spec_kw = dict(reorder=ordering)
    want = _ref_grads(ra, op_pair, b, c, w, BACKEND_MAP[backend],
                      jnp.float32, spec_kw)
    api.clear_schedule_cache()
    got = _port_grads(ta, op_pair, b, c, w, backend, torch.float32, spec_kw)
    for g, r in zip(got, want, strict=True):
        np.testing.assert_allclose(g, r, rtol=2e-3, atol=2e-3)
    if backend != "auto":
        # the backward's transpose entry carries the knob and prices its
        # own ordering of Aᵀ, as the reference's does
        bwd = [e for e in api._schedule_cache.values() if e.transpose]
        assert bwd
        for e in bwd:
            want_e = ref_api.get_schedule(
                ra, b_col=e.b_col, c_col=e.c_col, b_is_sparse=e.b_is_sparse,
                spec=ref_api.FusionSpec(**KNOBS, reorder=ordering,
                                        transpose=True, dtype_bytes=4))
            assert e.reorder == want_e.reorder
            if ordering == "rcm":
                assert e.reorder == "rcm"
                np.testing.assert_array_equal(e.reorder_perm,
                                              want_e.reorder_perm)


def test_gcn_with_reorder_matches_the_reference():
    """``GCN`` built with ``FusionSpec(reorder="auto")`` serves and trains:
    logits and one step's weight gradients against the plain model."""
    from repro_torch.configs.gcn import GCNConfig
    from repro_torch.models.gcn import GCN
    ta = as_port(_shuffled_banded())
    cfg = GCNConfig(n_nodes=64, in_dim=8, hidden_dim=8, out_dim=4,
                    n_layers=2)
    spec = dataclasses.replace(api.FusionSpec(**KNOBS), reorder="auto")
    model = GCN(cfg, ta, spec=spec, device="cpu", seed=0)
    plain = GCN(cfg, ta, spec=api.FusionSpec(**KNOBS), device="cpu", seed=0)
    assert [e.reorder for e in model.entries] == ["rcm", "rcm"]
    assert model.layer_backends() == ["torch", "torch"]
    assert plain.layer_backends() == ["unfused", "unfused"]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (64, 8)).astype(np.float32))
    y = torch.arange(64) % 4
    with torch.inference_mode():
        torch.testing.assert_close(model(x), plain(x), rtol=2e-3, atol=2e-3)
    model.loss(x, y).backward()
    plain.loss(x, y).backward()
    for w, v in zip(model.weights, plain.weights):
        torch.testing.assert_close(w.grad, v.grad, rtol=2e-3, atol=2e-3)
