"""The port's sparse formats and generators against the JAX package's.

``repro_torch.core.sparse`` is a copy of ``repro.core.sparse``: the same
seeds must give array-equal CSRs, packs and content digests (the schedule
caches of both packages key on those digests).
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.sparse import formats as rf
from repro.core.sparse import random as rr
from repro_torch.core.sparse import formats as tf
from repro_torch.core.sparse import random as tr

GENERATORS = {
    "banded_spd": lambda m, seed: m.banded_spd(96, 4, seed=seed),
    "powerlaw_graph": lambda m, seed: m.powerlaw_graph(96, 5, seed=seed),
    "hub_powerlaw": lambda m, seed: m.hub_powerlaw(96, 4, seed=seed),
    "block_diag_noise": lambda m, seed: m.block_diag_noise(96, block=32,
                                                           seed=seed),
}


def _assert_csr_equal(got, want):
    assert (got.n_rows, got.n_cols) == (want.n_rows, want.n_cols)
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.data, want.data)
    assert got.data.dtype == want.data.dtype


def _as_port(a: rf.CSR) -> tf.CSR:
    return tf.CSR(a.n_rows, a.n_cols, a.indptr, a.indices, a.data)


def test_runs_under_jax_on_cpu():
    assert jax.default_backend() == "cpu"


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("gen", sorted(GENERATORS))
def test_generators_and_digests_equal(gen, seed):
    want = GENERATORS[gen](rr, seed)
    got = GENERATORS[gen](tr, seed)
    _assert_csr_equal(got, want)
    assert tf.csr_content_digest(got) == rf.csr_content_digest(want)
    got_ext, want_ext = got.row_extents(), want.row_extents()
    for g, w in zip(got_ext, want_ext):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("cap", [None, 1, 3, "quantile"])
@pytest.mark.parametrize("gen", ["powerlaw_graph", "hub_powerlaw"])
def test_hybrid_ell_equal(gen, cap):
    want_a = GENERATORS[gen](rr, 3)
    got_a = _as_port(want_a)
    counts = np.diff(want_a.indptr)
    if cap == "quantile":
        cap = rf.hybrid_width_cap(counts, rf.DEFAULT_WIDTH_QUANTILE)
        assert cap == tf.hybrid_width_cap(counts, tf.DEFAULT_WIDTH_QUANTILE)
    assert tf.hybrid_width_cap(counts) == rf.hybrid_width_cap(counts)
    rows = np.arange(0, want_a.n_rows, 2)
    want = rf.HybridELL.from_csr_rows(want_a, rows, cap=cap)
    got = tf.HybridELL.from_csr_rows(got_a, rows, cap=cap)
    for name in ("cols", "vals", "spill_rows", "spill_cols", "spill_vals"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    tiles_w = rf.TileELL.from_csr_rows(want_a, rows)
    tiles_g = tf.TileELL.from_csr_rows(got_a, rows)
    np.testing.assert_array_equal(tiles_g.cols, tiles_w.cols)
    np.testing.assert_array_equal(tiles_g.vals, tiles_w.vals)


def test_dense_coo_transpose_and_block_diag_equal():
    rng = np.random.default_rng(0)
    dense = rng.standard_normal((12, 9)) * (rng.random((12, 9)) < 0.3)
    dense[4] = 0.0
    _assert_csr_equal(tf.CSR.from_dense(dense), rf.CSR.from_dense(dense))
    want = rf.CSR.from_dense(dense)
    got = tf.CSR.from_dense(dense)
    _assert_csr_equal(got.transpose(), want.transpose())
    np.testing.assert_array_equal(got.to_dense(), want.to_dense())
    mats_w = [rr.banded_spd(8, 2, seed=1), want]
    mats_g = [tr.banded_spd(8, 2, seed=1), got]
    _assert_csr_equal(tf.block_diag_csr(mats_g, row_sizes=[10, 12]),
                      rf.block_diag_csr(mats_w, row_sizes=[10, 12]))
    # an empty pattern keeps its value dtype (the digest tags it)
    empty = np.zeros((3, 3), np.float32)
    assert tf.CSR.from_dense(empty).data.dtype == np.float32
    assert (tf.csr_content_digest(tf.CSR.from_dense(empty))
            == rf.csr_content_digest(rf.CSR.from_dense(empty)))


def test_to_torch():
    a = tr.hub_powerlaw(64, 4, seed=0)
    sp = a.to_torch("cpu", torch.float64)
    np.testing.assert_array_equal(sp.to_dense().numpy(), a.to_dense())
    hell = tf.HybridELL.from_csr_rows(a, np.arange(a.n_rows), cap=2)
    cols, vals, srows, scols, svals = hell.to_torch("cpu", torch.bfloat16)
    assert cols.dtype == torch.int32 and srows.dtype == torch.int64
    assert scols.dtype == torch.int64
    assert vals.dtype == svals.dtype == torch.bfloat16
    np.testing.assert_array_equal(cols.numpy(), hell.cols)
    np.testing.assert_array_equal(
        vals.float().numpy(),
        torch.as_tensor(hell.vals.astype(np.float32)).bfloat16().float())
    assert srows.shape[0] == hell.n_spill > 0
