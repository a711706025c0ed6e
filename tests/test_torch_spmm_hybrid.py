"""The hybrid-ELL product of ``kernels.spmm`` (body and row tails in one
call) against the JAX package's body-then-scatter-add chain.

``plan_tails`` is checked on its own; then the wrapper's plain version
(what CPU tensors run, and what the CUDA kernel is held to on the card)
walks a plan whose small ``max_chunk`` splits long tails, against
``repro.core.tilefusion.fused_ops.spmm_hybrid`` on full-matrix hybrid ELLs
and against ``repro.core.tilefusion.api._wf1_pallas`` (the Pallas kernel
in interpret mode, then ``.at[].set`` / ``.at[].add``) on wavefront 1 with
its target-row map.  Tolerances: f32 ``rtol=atol=2e-3`` (the reference's
bar).  In bf16 the chain accumulates the body and each tail entry in bf16
(one rounding per term), while the port sums in f32 and rounds once, so
the port is held to the f64 product within one bf16 rounding (2^-8 of the
largest value; on wavefront 1, its rows of A·D1) and to the chain within
the chain's own error, one bf16 rounding per term of the longest row
(terms · 2^-8 of the largest value).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.sparse.formats import hybrid_width_cap
from repro.core.sparse.random import hub_powerlaw, powerlaw_graph
from repro.core.tilefusion import api as ref_api
from repro.core.tilefusion import fused_ops as ref_fused_ops
from repro.core.tilefusion import build_schedule, to_device_schedule
from repro_torch.core.tilefusion import fused_ops
from repro_torch.core.tilefusion import schedule as port_schedule
from repro_torch.core.tilefusion import scheduler as port_scheduler
from repro_torch.kernels import ops, spmm
from test_torch_cells import KNOBS, PATTERNS, as_port, pattern_pair

GRAPHS = {"hub_powerlaw(64, 4)": lambda: hub_powerlaw(64, 4, seed=0),
          "powerlaw_graph(256, 5)": lambda: powerlaw_graph(256, 5, seed=0)}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
BF16_ULP = 2.0 ** -8


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    jax.clear_caches()


# ---- plan_tails ----

def _lanes_of(plan):
    """Every lane a range or chunk holds, as (row, lane) in plan order:
    rows' ranges first, then the chunks."""
    out = [(i, k) for i, (s, e) in enumerate(plan.ranges)
           for k in range(s, e)]
    out += [(r, k) for r, s, e in plan.chunks for k in range(s, e)]
    return out


@pytest.mark.parametrize("max_chunk", [1, 3, 4, 256])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_tails_covers_each_lane_once(seed, max_chunk):
    rng = np.random.default_rng(seed)
    n_rows = 40
    counts = rng.integers(0, 4, n_rows)
    counts[rng.integers(0, n_rows, 3)] = rng.integers(5, 30, 3)   # hubs
    rows = np.repeat(np.arange(n_rows), counts)
    plan = spmm.plan_tails(rows, n_rows, max_chunk)
    lanes = _lanes_of(plan)
    # each lane exactly once, under its own row
    assert sorted(k for _, k in lanes) == list(range(rows.size))
    assert all(rows[k] == r for r, k in lanes)
    # ranges in row order; each split row's chunks in lane order, at most
    # max_chunk long, and listed under split_ptr
    assert np.all(plan.ranges[:, 1] >= plan.ranges[:, 0])
    split = counts > max_chunk
    np.testing.assert_array_equal(plan.split_rows, np.flatnonzero(split))
    assert np.all(plan.ranges[split] == -1)
    sizes = plan.chunks[:, 2] - plan.chunks[:, 1]
    assert np.all((sizes >= 1) & (sizes <= max_chunk))
    for s, row in enumerate(plan.split_rows):
        mine = plan.chunks[plan.split_ptr[s]:plan.split_ptr[s + 1]]
        assert np.all(mine[:, 0] == row)
        np.testing.assert_array_equal(
            np.concatenate([np.arange(a, b) for _, a, b in mine]),
            np.flatnonzero(rows == row))
    assert plan.split_ptr[-1] == len(plan.chunks)
    for a in (plan.ranges, plan.chunks, plan.split_rows, plan.split_ptr):
        assert a.dtype == np.int32


def test_plan_tails_of_no_lanes_is_empty():
    plan = spmm.plan_tails(np.zeros(0, np.int32), 5, 3)
    np.testing.assert_array_equal(plan.ranges, np.zeros((5, 2)))
    assert plan.chunks.shape == (0, 3) and plan.split_rows.size == 0
    np.testing.assert_array_equal(plan.split_ptr, [0])


@pytest.mark.parametrize("rows", [[0, 2, 1], [3, 3, 0], [0, 5], [-1, 0]])
def test_plan_tails_raises_on_unsorted_lanes(rows):
    with pytest.raises(ValueError, match="sorted by row"):
        spmm.plan_tails(np.asarray(rows), 5, 3)


# ---- the plain hybrid product against the JAX chain ----

def _close(got, want, dtype, terms):
    got = got.float().numpy()
    want = np.asarray(want, np.float64)
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
        return
    scale = float(np.abs(want).max())
    assert np.abs(got - want).max() <= terms * BF16_ULP * scale


def _oracle(a, x):
    return a.to_dense() @ np.asarray(x, np.float64)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("cap", [1, 2, "auto"])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_hybrid_matches_the_reference_chain(graph, cap, dtype):
    jdt, tdt = DTYPES[dtype]
    a = GRAPHS[graph]()
    cap = hybrid_width_cap(np.diff(a.indptr)) if cap == "auto" else cap
    x = np.random.default_rng(3).standard_normal((a.n_cols, 24))
    ref_hell = ref_fused_ops.csr_to_ell(a, width_cap=cap)
    want = ref_fused_ops.spmm_hybrid(
        *ref_hell, jnp.asarray(x, jnp.float32).astype(jdt))
    hell = fused_ops.csr_to_ell(as_port(a), width_cap=cap)
    tensors = fused_ops.HybridTensors.upload(hell, "cpu", tdt, max_chunk=3)
    assert tensors.tails.split_rows.numel() > 0     # the split path runs
    tx = torch.as_tensor(x, dtype=torch.float32).to(tdt)
    ops.reset_launch_counts()
    got = fused_ops.spmm_hybrid(tensors, tx)
    assert ops.launch_counts()["spmm_ell"] == 0     # the plain version
    assert got.dtype == tdt and got.shape == (a.n_rows, 24)
    terms = int(np.diff(a.indptr).max())
    _close(got, want, dtype, terms)
    _close(got, _oracle(a, tx.double().numpy()), dtype, 1)


def _wf1_cell(name, dtype, max_chunk=3):
    """Wavefront 1 of the pattern's GeMM-SpMM schedule with width cap 1:
    (reference CSR, port schedule, its tensors, tails planned with
    ``max_chunk``, the Pallas arm's D, the port's D with a NaN pad row,
    D1, what wavefront 0 left in D)."""
    jdt, tdt = DTYPES[dtype]
    ra, ta = pattern_pair(name)
    kw = dict(b_col=8, c_col=6, p=KNOBS["p"], cache_size=KNOBS["cache_size"],
              ct_size=KNOBS["ct_size"])
    ref_ds = to_device_schedule(ra, build_schedule(ra, **kw), width_cap=1)
    ds = port_schedule.to_device_schedule(
        ta, port_scheduler.build_schedule(ta, **kw), width_cap=1)
    rng = np.random.default_rng(7)
    d1 = rng.standard_normal((ds.n_i, 6))
    d0 = rng.standard_normal((ds.n_j, 6))      # what wavefront 0 left
    want = ref_api._wf1_pallas(ref_ds, jnp.asarray(d0, jnp.float32).astype(
        jdt), jnp.asarray(d1, jnp.float32).astype(jdt), jdt)
    st = fused_ops.schedule_tensors(ds, "cpu", tdt)
    tails = spmm.Tails.upload(fused_ops.wf1_tail_plan(ds, max_chunk),
                              ds.spill_cols1, ds.spill_vals1, "cpu", tdt)
    d = torch.cat([torch.as_tensor(d0, dtype=torch.float32).to(tdt),
                   torch.full((1, 6), float("nan"), dtype=tdt)])
    td1 = torch.as_tensor(d1, dtype=torch.float32).to(tdt)
    return ra, ds, st, tails, want, d, td1, d0


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", ["powerlaw", "single-hub-row", "banded"])
def test_wf1_in_place_matches_the_pallas_arm(name, dtype):
    ra, ds, st, tails, want, d, d1, d0 = _wf1_cell(name, dtype)
    got = spmm.spmm_ell(st.cols1, st.vals1, d1, tails=tails,
                        out=d[:ds.n_j], out_rows=st.j_rows1_32)
    assert got.data_ptr() == d.data_ptr()
    assert torch.isnan(d[ds.n_j]).all()         # the pad row is not written
    terms = int(np.diff(ra.indptr).max())
    _close(d[:ds.n_j], want, dtype, terms)
    # wavefront 1's rows are A·D1 of the operands as the kernel reads them
    # (A's values and D1 in the dtype), in f64, within one rounding
    wf1 = np.unique(ds.j_rows1[ds.j_rows1 != ds.n_j])
    a_dt = torch.as_tensor(ra.to_dense()).to(d.dtype).double().numpy()
    exact = a_dt[wf1] @ d1.double().numpy()
    _close(d[wf1], exact, dtype, 1)
    # rows outside wavefront 1 keep what wavefront 0 wrote
    rest = np.setdiff1d(np.arange(ds.n_j), wf1)
    np.testing.assert_array_equal(
        d[rest].float().numpy(),
        torch.as_tensor(d0[rest], dtype=torch.float32).to(d.dtype).float()
        .numpy())
    # the cuda arm's own call (the default max_chunk) writes the same rows
    d_arm = d.clone()
    d_arm[:ds.n_j] = torch.as_tensor(d0, dtype=torch.float32).to(d.dtype)
    fused_ops._wf1(st, d_arm, d1, kernel=True)
    _close(d_arm[:ds.n_j], want, dtype, terms)
    _close(d_arm[wf1], exact, dtype, 1)


def test_wf1_cells_split_a_tail():
    """The wavefront-1 cells above do run the split path."""
    splits = [_wf1_cell(n, "f32")[3].split_rows.numel()
              for n in ("powerlaw", "single-hub-row")]
    assert min(splits) > 0


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_wavefront_rows_are_disjoint(name):
    """Wavefront 1 overwrites D at ``j_rows1``; that keeps wavefront 0's
    rows only because the two row sets are disjoint (the reference's
    ``.set`` then ``.add`` needs the same)."""
    _, ta = pattern_pair(name)
    for b_is_sparse in (False, True):
        sched = port_scheduler.build_schedule(
            ta, b_col=8, c_col=6, p=KNOBS["p"],
            cache_size=KNOBS["cache_size"], ct_size=KNOBS["ct_size"],
            b_is_sparse=b_is_sparse)
        for cap in (None, 1):
            ds = port_schedule.to_device_schedule(ta, sched, width_cap=cap)
            r0 = ds.j_rows0[ds.j_rows0 != ds.n_j]
            r1 = ds.j_rows1[ds.j_rows1 != ds.n_j]
            assert np.intersect1d(r0, r1).size == 0
            assert np.unique(r1).size == r1.size
            assert np.all(np.isin(ds.spill_rows1, r1))


def test_wrapper_checks_its_new_arguments_on_the_cpu():
    x = torch.randn(6, 4)
    cols = torch.zeros(6, 2, dtype=torch.int32)
    vals = torch.ones(6, 2)
    with pytest.raises(ValueError, match="out_rows needs out"):
        ops.spmm_ell(cols, vals, x,
                     out_rows=torch.zeros(6, dtype=torch.int32))
    with pytest.raises(ValueError, match="out"):
        ops.spmm_ell(cols, vals, x, out=torch.empty(5, 4))
    with pytest.raises(ValueError, match="out_rows"):
        ops.spmm_ell(cols, vals, x, out=torch.empty(9, 4),
                     out_rows=torch.zeros(5, dtype=torch.int32))
    plan = spmm.plan_tails(np.array([0, 0, 3]), 5, 2)
    tails = spmm.Tails.upload(plan, [1, 2, 3], [1.0, 1.0, 1.0], "cpu",
                              torch.float32)
    with pytest.raises(ValueError, match="tails"):
        ops.spmm_ell(cols, vals, x, tails=tails)      # 5 rows' plan, 6 rows
    with pytest.raises(ValueError, match="out_rows outside"):
        ops.spmm_ell(cols, vals, x, out=torch.empty(3, 4),
                     out_rows=torch.full((6,), 4, dtype=torch.int32))
