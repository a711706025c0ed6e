"""The port's prior-work baselines and host-side helpers against the JAX
package's, on the CPU.

- ``overlapped_tiles`` / ``atomic_tiles`` array for array and
  ``overlapped_redundancy`` the same float (paper §4.1.3's overlapped and
  atomic tilings);
- ``overlapped_gemm_spmm`` / ``atomic_gemm_spmm`` against the reference's
  JAX baselines and ``fused_ref`` (f32, ``rtol=atol=2e-3``, the
  reference's parity bar), through the ``spmm_ell`` wrapper and its plain
  version: one wrapper call per non-empty partition or tile, the atomic
  schedule's barriers, and each partition packed as a width-capped
  hybrid ELL;
- ``fused_compute_ratio``, ``hybrid_packed_elements``, ``tile_cost_bytes``
  and ``block_csr_pattern`` equal to the reference's, with the empty,
  rectangular and block-size-1 cases.

The graphs are ``powerlaw_graph(256, 6, seed=1)`` and ``banded_spd(256,
4)``; B and C come from a seeded numpy generator.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _prop import given, settings, st

from repro.core.sparse import formats as ref_formats
from repro.core.sparse import random as ref_random
from repro.core.tilefusion import cost_model as ref_cost
from repro.core.tilefusion import fused_ops as ref_ops
from repro.core.tilefusion import fused_ref as ref_oracle
from repro.core.tilefusion import scheduler as ref_scheduler
from repro_torch.core import sparse as port_sparse
from repro_torch.core.sparse import formats, random
from repro_torch.core.tilefusion import cost_model, fused_ops, scheduler
from repro_torch.core.tilefusion import fused_ref
from repro_torch.kernels import ops

TOL = 2e-3
GRAPHS = {"powerlaw": (lambda m: m.powerlaw_graph(256, 6, seed=1)),
          "banded": (lambda m: m.banded_spd(256, 4))}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: the products are small, and several test
    workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(name):
    """The reference's and the port's copy of one graph."""
    ra, ta = GRAPHS[name](ref_random), GRAPHS[name](random)
    np.testing.assert_array_equal(ta.indptr, ra.indptr)
    np.testing.assert_array_equal(ta.indices, ra.indices)
    np.testing.assert_array_equal(ta.data, ra.data)
    return ra, ta


def _operands(n, b_col=16, c_col=8, seed=1):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, b_col)), rng.standard_normal((b_col, c_col))


def _random_pair(n_rows, n_cols, nnz, seed):
    rng = np.random.default_rng(seed)
    args = (n_rows, n_cols, rng.integers(0, max(n_rows, 1), nnz),
            rng.integers(0, max(n_cols, 1), nnz), rng.standard_normal(nnz))
    return ref_formats.CSR.from_coo(*args), formats.CSR.from_coo(*args)


# --------------------------------------------------------------------------
# The schedules
# --------------------------------------------------------------------------
@pytest.mark.parametrize("p", [1, 3, 8, 300])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_overlapped_tiles_equal(graph, p):
    ra, ta = _pair(graph)
    got, want = fused_ops.overlapped_tiles(ta, p), \
        ref_ops.overlapped_tiles(ra, p)
    assert len(got) == len(want) == min(p, 256)
    for (gd, gj), (wd, wj) in zip(got, want):
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gj, wj)
        assert (gd.dtype, gj.dtype) == (wd.dtype, wj.dtype)
    assert fused_ops.overlapped_redundancy(ta, p) == \
        ref_ops.overlapped_redundancy(ra, p)


@pytest.mark.parametrize("p,n_waves", [(1, 4), (4, 4), (8, 2), (100, 3)])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_atomic_tiles_equal(graph, p, n_waves):
    ra, ta = _pair(graph)
    got = fused_ops.atomic_tiles(ta, p, n_waves)
    want = ref_ops.atomic_tiles(ra, p, n_waves)
    assert len(got) == len(want) == n_waves
    for gw, ww in zip(got, want):
        assert len(gw) == len(ww)
        for g, w in zip(gw, ww):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype


def test_overlapped_tiles_of_empty_rows():
    """A partition of empty rows has no dependencies, as in the
    reference."""
    ra, ta = _random_pair(12, 12, 0, 0)
    got, want = fused_ops.overlapped_tiles(ta, 4), \
        ref_ops.overlapped_tiles(ra, 4)
    assert [(d.size, j.tolist()) for d, j in got] == \
        [(d.size, j.tolist()) for d, j in want]
    assert fused_ops.overlapped_redundancy(ta, 4) == \
        ref_ops.overlapped_redundancy(ra, 4) == 0.0


# --------------------------------------------------------------------------
# The executors
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kernel", [True, False])
@pytest.mark.parametrize("baseline", ["overlapped", "atomic"])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_baseline_matches_reference(graph, baseline, kernel):
    ra, ta = _pair(graph)
    b, c = _operands(256)
    if baseline == "overlapped":
        want = ref_ops.overlapped_gemm_spmm(
            ra, ref_ops.overlapped_tiles(ra, 4), jnp.asarray(b, jnp.float32),
            jnp.asarray(c, jnp.float32))
        got = fused_ops.overlapped_gemm_spmm(
            ta, fused_ops.overlapped_tiles(ta, 4),
            torch.tensor(b, dtype=torch.float32),
            torch.tensor(c, dtype=torch.float32), kernel=kernel)
    else:
        want = ref_ops.atomic_gemm_spmm(
            ra, ref_ops.atomic_tiles(ra, 4), jnp.asarray(b, jnp.float32),
            jnp.asarray(c, jnp.float32))
        got = fused_ops.atomic_gemm_spmm(
            ta, fused_ops.atomic_tiles(ta, 4),
            torch.tensor(b, dtype=torch.float32),
            torch.tensor(c, dtype=torch.float32), kernel=kernel)
    assert got.dtype == torch.float32 and got.shape == (256, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(got.numpy(), ref_oracle.unfused_gemm_spmm(
        ra, b, c), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), fused_ref.unfused_gemm_spmm(
        ta, b, c), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("baseline", ["overlapped", "atomic"])
def test_baseline_on_a_rectangular_matrix(baseline):
    """``A`` of 96 × 160: D1 has ``n_cols`` rows, D ``n_rows``."""
    ra, ta = _random_pair(96, 160, 700, 3)
    b, c = _operands(160, seed=3)
    run, tiles = ((fused_ops.overlapped_gemm_spmm, fused_ops.overlapped_tiles)
                  if baseline == "overlapped" else
                  (fused_ops.atomic_gemm_spmm, fused_ops.atomic_tiles))
    got = run(ta, tiles(ta, 3), torch.tensor(b, dtype=torch.float32),
              torch.tensor(c, dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), ref_oracle.unfused_gemm_spmm(
        ra, b, c), rtol=TOL, atol=TOL)


def test_baselines_in_bf16_follow_c():
    """Values go through f32 to ``c``'s dtype, and D comes back in it."""
    _, ta = _pair("powerlaw")
    b, c = _operands(256)
    bt = torch.tensor(b, dtype=torch.bfloat16)
    ct = torch.tensor(c, dtype=torch.bfloat16)
    want = fused_ref.unfused_gemm_spmm(ta, b, c)
    scale = float(np.abs(want).max())
    for d in (fused_ops.overlapped_gemm_spmm(
                  ta, fused_ops.overlapped_tiles(ta, 8), bt, ct),
              fused_ops.atomic_gemm_spmm(ta, fused_ops.atomic_tiles(ta, 8),
                                         bt, ct)):
        assert d.dtype == torch.bfloat16
        assert float(np.abs(d.float().numpy() - want).max()) / scale < 2e-2


def _count_calls(monkeypatch):
    """Count the ``spmm_ell`` wrapper's calls (its launch counter counts
    only on the card) and record each call's body width."""
    calls = []
    real = ops.spmm_ell

    def counted(cols, vals, x, **kw):
        calls.append(int(cols.shape[1]))
        return real(cols, vals, x, **kw)
    monkeypatch.setattr(ops, "spmm_ell", counted)
    return calls


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_one_wrapper_call_per_partition_and_tile(graph, monkeypatch):
    _, ta = _pair(graph)
    b, c = _operands(256)
    bt, ct = (torch.tensor(b, dtype=torch.float32),
              torch.tensor(c, dtype=torch.float32))
    calls = _count_calls(monkeypatch)
    barriers = []
    real_barrier = fused_ops._barrier
    monkeypatch.setattr(fused_ops, "_barrier",
                        lambda t: (barriers.append(t.shape),
                                   real_barrier(t)))
    fused_ops.overlapped_gemm_spmm(ta, fused_ops.overlapped_tiles(ta, 8),
                                   bt, ct)
    assert len(calls) == 8 and not barriers
    del calls[:]
    fused_ops.atomic_gemm_spmm(ta, fused_ops.atomic_tiles(ta, 8, 4), bt, ct)
    assert len(calls) == 32
    # D1's producer barrier, then one after each wave
    assert barriers == [(256, 8)] * 5
    del calls[:]
    fused_ops.atomic_gemm_spmm(ta, fused_ops.atomic_tiles(ta, 8, 4), bt, ct,
                               kernel=False)
    assert not calls


def test_empty_partitions_and_tiles_launch_nothing(monkeypatch):
    """Rows 0-63 empty: their partition (all deps empty) and tiles write
    nothing; the others are one call each."""
    rng = np.random.default_rng(5)
    rows = rng.integers(64, 128, 400)
    ta = formats.CSR.from_coo(128, 128, rows, rng.integers(0, 128, 400),
                              rng.standard_normal(400))
    b, c = _operands(128)
    calls = _count_calls(monkeypatch)
    bt, ct = (torch.tensor(b, dtype=torch.float32),
              torch.tensor(c, dtype=torch.float32))
    d = fused_ops.overlapped_gemm_spmm(ta, fused_ops.overlapped_tiles(ta, 2),
                                       bt, ct)
    assert len(calls) == 1 and not d[:64].any()
    np.testing.assert_allclose(d.numpy(), fused_ref.unfused_gemm_spmm(
        ta, b, c), rtol=TOL, atol=TOL)
    del calls[:]
    # atomic tiles of empty rows still gather D1 (they exist): 8 calls
    d = fused_ops.atomic_gemm_spmm(ta, fused_ops.atomic_tiles(ta, 2), bt, ct)
    assert len(calls) == 8
    np.testing.assert_allclose(d.numpy(), fused_ref.unfused_gemm_spmm(
        ta, b, c), rtol=TOL, atol=TOL)


def test_partitions_pack_as_hybrid_ell(monkeypatch):
    """On a graph with a hub row each partition's body is capped at its
    own traffic-optimal width, not padded to the hub: the spill lanes go
    to the kernel's row tails."""
    ta = random.hub_powerlaw(2048, 6, seed=0)
    counts = np.diff(ta.indptr)
    b, c = _operands(2048, 8, 4)
    calls = _count_calls(monkeypatch)
    parts = fused_ops.overlapped_tiles(ta, 4)
    d = fused_ops.overlapped_gemm_spmm(
        ta, parts, torch.tensor(b, dtype=torch.float32),
        torch.tensor(c, dtype=torch.float32))
    caps = [formats.hybrid_width_cap(counts[jr]) for _, jr in parts]
    assert calls == [min(cap, int(counts[jr].max()))
                     for cap, (_, jr) in zip(caps, parts)]
    assert max(calls) < int(counts.max())
    np.testing.assert_allclose(d.numpy(), fused_ref.unfused_gemm_spmm(
        ta, b, c), rtol=TOL, atol=TOL)


# --------------------------------------------------------------------------
# Host-side helpers
# --------------------------------------------------------------------------
@settings(max_examples=12, deadline=None)
@given(n=st.integers(8, 200), density=st.floats(0.001, 0.1),
       seed=st.integers(0, 10), ct=st.sampled_from([1, 8, 16, 64, 2048]))
def test_fused_compute_ratio_equal(n, density, seed, ct):
    ra, ta = _random_pair(n, n, max(int(density * n * n), 1), seed)
    assert scheduler.fused_compute_ratio(ta, ct_size=ct) == \
        ref_scheduler.fused_compute_ratio(ra, ct_size=ct)


@pytest.mark.parametrize("shape,nnz", [((6, 6), 0), ((120, 60), 200),
                                       ((60, 120), 200)])
def test_fused_compute_ratio_on_empty_and_rectangular(shape, nnz):
    ra, ta = _random_pair(*shape, nnz, 0)
    for ct in (1, 16, 2048):
        assert scheduler.fused_compute_ratio(ta, ct_size=ct) == \
            ref_scheduler.fused_compute_ratio(ra, ct_size=ct)


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_fused_compute_ratio_of_the_parity_graphs(graph):
    ra, ta = _pair(graph)
    for ct in (32, 128, 2048):
        assert scheduler.fused_compute_ratio(ta, ct) == \
            ref_scheduler.fused_compute_ratio(ra, ct)


@pytest.mark.parametrize("cap", [None, 1, 2, 5, 1000])
def test_hybrid_packed_elements_equal(cap):
    rng = np.random.default_rng(7)
    for counts in (np.zeros(0, np.int64), np.zeros(9, np.int64),
                   rng.integers(0, 30, 500),
                   np.diff(random.hub_powerlaw(1024, 6).indptr)):
        assert cost_model.hybrid_packed_elements(counts, cap) == \
            ref_cost.hybrid_packed_elements(counts, cap)


@pytest.mark.parametrize("dtype_bytes", [2, 4, 8])
@pytest.mark.parametrize("b_is_sparse", [False, True])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_tile_cost_bytes_equal(graph, b_is_sparse, dtype_bytes):
    ra, ta = _pair(graph)
    rng = np.random.default_rng(3)
    for i0 in range(0, 256, 48):
        jr = np.sort(rng.choice(256, size=int(rng.integers(0, 24)),
                                replace=False)).astype(np.int32)
        args = (i0, min(i0 + 48, 256), jr, 16, 8, b_is_sparse, dtype_bytes)
        assert cost_model.tile_cost_bytes(ta, *args) == \
            ref_cost.tile_cost_bytes(ra, *args)
    assert cost_model.DEFAULT_CPU_CACHE_BYTES == \
        ref_cost.DEFAULT_CPU_CACHE_BYTES


def _assert_csr_equal(got, want):
    assert (got.n_rows, got.n_cols) == (want.n_rows, want.n_cols)
    for f in ("indptr", "indices", "data"):
        g, w = getattr(got, f), getattr(want, f)
        np.testing.assert_array_equal(g, w, err_msg=f)
        assert g.dtype == w.dtype, f


@pytest.mark.parametrize("block", [1, 3, 16, 128, 1000])
@pytest.mark.parametrize("shape,nnz", [((6, 6), 0), ((200, 200), 900),
                                       ((120, 60), 300), ((60, 120), 300)])
def test_block_csr_pattern_equal(shape, nnz, block):
    ra, ta = _random_pair(*shape, nnz, 2)
    got = port_sparse.block_csr_pattern(ta, block)
    _assert_csr_equal(got, ref_formats.block_csr_pattern(ra, block))
    assert isinstance(got, formats.CSR)
    assert int(got.data.sum()) == ta.nnz


@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_block_csr_pattern_of_the_parity_graphs(graph):
    ra, ta = _pair(graph)
    for block in (1, 32):
        _assert_csr_equal(formats.block_csr_pattern(ta, block),
                          ref_formats.block_csr_pattern(ra, block))


def test_exports_match_the_reference():
    """Both ``__init__`` export lists hold the reference's names (the
    tile-fusion one without the TPU VMEM budget)."""
    import repro.core.sparse as ref_sparse_pkg
    import repro.core.tilefusion as ref_tf
    import repro_torch.core.tilefusion as tf
    assert set(ref_sparse_pkg.__all__) <= set(port_sparse.__all__)
    want = set(ref_tf.__all__) - {"DEFAULT_VMEM_BUDGET_BYTES"}
    assert want <= set(tf.__all__)
    for name in tf.__all__:
        assert hasattr(tf, name), name
    assert not hasattr(tf, "DEFAULT_VMEM_BUDGET_BYTES")
    assert dataclasses.is_dataclass(tf.ShardedSchedule)
