"""The port's serving tier against the JAX package's, on the CPU.

A twin of ``tests/test_serving.py``: ``pad_csr``, ``csr_dirty_rows``,
``row_extents_for``, the subgraph generators, ``serving_bucket_price`` and
``pad_device_schedule`` equal to the reference's array for array;
``incremental_update`` for both op pairs patches to the reference's
``Schedule`` and ``DeviceSchedule`` and bails (None) in the same cases;
one seeded request stream through both tiers is served the same way
(hit / incremental / rebuild), with the same counters and outputs within
2e-3; ``SubgraphFrontEnd`` against the reference's; the bucket knob's
rejections.  The kernel arm's glue (``backend="cuda"`` on CPU tensors runs
the kernels' plain versions) runs on headroom-padded and patched entries,
whose spill lanes are not sorted by row: ``fused_ops.wf1_tail_plan``
puts them in the kernel's order, and the plain hybrid product with that
plan equals the body plus ``_spill_add``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cells import KNOBS, as_port
from repro.core.sparse import random as ref_random
from repro.core.sparse.formats import CSR as RefCSR
from repro.core.tilefusion import api as ref_api
from repro.core.tilefusion import cost_model as ref_cost
from repro.core.tilefusion import fused_ref as ref_oracle
from repro.core.tilefusion import schedule as ref_schedule
from repro.core.tilefusion import scheduler as ref_scheduler
from repro.core.tilefusion import serving as ref_serving
from repro.launch import serve as ref_serve
from repro_torch.core.sparse import random as port_random
from repro_torch.core.sparse.formats import csr_content_digest
from repro_torch.core.tilefusion import (api, cost_model, fused_ops, schedule,
                                         scheduler, serving)
from repro_torch.kernels import ref as kref
from repro_torch.kernels import spmm as kspmm
from repro_torch.launch import serve

#: counters both packages' ``schedule_cache_stats`` report
COUNTERS = ("hits", "misses", "evictions", "incremental_patches", "entries",
            "bucket_entries", "spec_entries")
#: the port's backends on CPU tensors (``cuda``: the kernel arm's glue
#: with the kernels' plain versions)
PORT_BACKENDS = ("auto", "cuda", "torch")


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    # many small JAX executables compile in one process; start clean, as
    # test_serving.py does
    jax.clear_caches()


@pytest.fixture(autouse=True)
def _fresh_cache():
    ref_api.clear_schedule_cache()
    api.clear_schedule_cache()
    yield
    ref_api.clear_schedule_cache()
    api.clear_schedule_cache()


def _graph(n=200, seed=3, avg_deg=6) -> RefCSR:
    base = ref_random.powerlaw_graph(8 * n, avg_deg=avg_deg, seed=seed)
    return ref_random.induced_subgraph(base, n, n)


def _assert_csr_equal(got, want):
    assert (got.n_rows, got.n_cols) == (want.n_rows, want.n_cols)
    for field in ("indptr", "indices", "data"):
        g, w = getattr(got, field), getattr(want, field)
        np.testing.assert_array_equal(g, w, err_msg=field)
        assert g.dtype == w.dtype, field


def _assert_schedule_equal(got, want):
    assert (got.n_i, got.n_j, got.t) == (want.n_i, want.n_j, want.t)
    for wf_g, wf_w in zip(got.wavefronts, want.wavefronts, strict=True):
        assert len(wf_g) == len(wf_w)
        for tg, tw in zip(wf_g, wf_w):
            assert (tg.i_start, tg.i_end) == (tw.i_start, tw.i_end)
            np.testing.assert_array_equal(tg.j_rows, tw.j_rows)


def _assert_dsched_equal(got, want):
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=f.name)
            assert g.dtype == w.dtype, f.name
        else:
            assert g == w, f.name


def _assert_entry_equal(got, want):
    _assert_schedule_equal(got.sched, want.sched)
    _assert_dsched_equal(got.dsched, want.dsched)
    for name in ("b_col", "c_col", "b_is_sparse", "width_cap", "hits",
                 "content_digest", "bucket"):
        assert getattr(got, name) == getattr(want, name), name
    assert got.traffic_model == pytest.approx(want.traffic_model, rel=1e-12)


def _counters(stats) -> dict:
    return {k: stats[k] for k in COUNTERS}


# --------------------------------------------------------------------------
# the numpy pieces, array for array
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(100, 100), (128, 128), (256, 200),
                                   (128, 100)])
def test_pad_csr_equals_the_reference(shape):
    ra = _graph(100)
    _assert_csr_equal(serving.pad_csr(as_port(ra), *shape),
                      ref_serving.pad_csr(ra, *shape))
    ta = as_port(ra)
    assert serving.pad_csr(ta, ta.n_rows, ta.n_cols) is ta
    with pytest.raises(ValueError):
        serving.pad_csr(ta, 50, 128)


@pytest.mark.parametrize("case", ["perturbed", "same", "values", "shape"])
def test_csr_dirty_rows_equals_the_reference(case):
    ra = _graph(150)
    if case == "perturbed":
        rows = np.random.default_rng(0).choice(ra.n_rows, 7, replace=False)
        rb = ref_random.perturb_rows(ra, rows, seed=1)
    elif case == "same":
        rb = ra
    elif case == "values":
        data = ra.data.copy()
        data[ra.indptr[5]] += 1.0
        data[ra.indptr[77]] -= 2.0
        rb = RefCSR(ra.n_rows, ra.n_cols, ra.indptr, ra.indices, data)
    else:
        rb = ref_serving.pad_csr(ra, 256, 256)
    want = ref_serving.csr_dirty_rows(ra, rb)
    got = serving.csr_dirty_rows(as_port(ra), as_port(rb))
    if want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


@pytest.mark.parametrize("rows", [[0, 3, 57, 119], list(range(120)), []])
def test_row_extents_for_equals_the_reference(rows):
    dense = _graph(120).to_dense()
    dense[57] = 0.0                     # an empty row: the (n_cols, -1) sentinel
    ra = RefCSR.from_dense(dense)
    got = scheduler.row_extents_for(as_port(ra), np.asarray(rows, np.int64))
    want = ref_scheduler.row_extents_for(ra, np.asarray(rows, np.int64))
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


@pytest.mark.parametrize("case", ["induced", "induced-tail", "perturb",
                                  "suite"])
def test_subgraph_generators_equal_the_reference(case):
    if case == "suite":
        got = port_random.benchmark_suite(256, seed=4)
        want = ref_random.benchmark_suite(256, seed=4)
        assert list(got) == list(want)
        for name in want:
            _assert_csr_equal(got[name], want[name])
        assert sorted(port_random.SUITES) == sorted(ref_random.SUITES)
        return
    base = ref_random.powerlaw_graph(800, avg_deg=6, seed=2)
    tbase = as_port(base)
    if case == "induced":
        got = port_random.induced_subgraph(tbase, 200, 150)
        want = ref_random.induced_subgraph(base, 200, 150)
    elif case == "induced-tail":
        got = port_random.induced_subgraph(tbase, 700, 150)
        want = ref_random.induced_subgraph(base, 700, 150)
    else:
        sub = ref_random.induced_subgraph(base, 100, 180)
        rows = np.random.default_rng(5).choice(180, 9, replace=False)
        got = port_random.perturb_rows(as_port(sub), rows, seed=7)
        want = ref_random.perturb_rows(sub, rows, seed=7)
    _assert_csr_equal(got, want)


@pytest.mark.parametrize("kw", [
    dict(n_rows=1000, n_pad=1024, nnz=8000, b_col=32, c_col=32,
         expected_reuse=8.0),
    dict(n_rows=10, n_pad=1024, nnz=40, b_col=32, c_col=32,
         expected_reuse=1.0),
    dict(n_rows=30000, n_pad=32768, nnz=413814, b_col=128, c_col=128),
    dict(n_rows=30000, n_pad=32768, nnz=413814, b_col=512, c_col=512),
    dict(n_rows=64, n_pad=64, nnz=0, b_col=8, c_col=8,
         inspect_elements_per_nnz=3.0),
])
def test_serving_bucket_price_equals_the_reference(kw):
    assert cost_model.INSPECT_ELEMENTS_PER_NNZ == \
        ref_cost.INSPECT_ELEMENTS_PER_NNZ
    assert cost_model.serving_bucket_price(**kw) == \
        ref_cost.serving_bucket_price(**kw)


def _entries(ra, *, b_is_sparse=False, spec_kw=None):
    """The port's and the reference's ``get_schedule`` entries of ``ra``
    at the test knobs (b_col = c_col = 8)."""
    kw = dict(KNOBS, uniform_split=True, **(spec_kw or {}))
    want = ref_api.get_schedule(ra, b_col=8, c_col=8,
                                b_is_sparse=b_is_sparse,
                                spec=ref_api.FusionSpec(**kw))
    got = api.get_schedule(as_port(ra), b_col=8, c_col=8,
                           b_is_sparse=b_is_sparse,
                           spec=api.FusionSpec(**kw))
    return got, want


@pytest.mark.parametrize("slots", [(0, 0), (10, 40), (0, 25), (7, 0),
                                   (64, 512)])
@pytest.mark.parametrize("op_pair", ["gemm", "spmm"])
def test_pad_device_schedule_equals_the_reference(op_pair, slots):
    got, want = _entries(_graph(100), b_is_sparse=op_pair == "spmm")
    kw = dict(j1_slots=slots[0], spill_slots=slots[1])
    padded = schedule.pad_device_schedule(got.dsched, **kw)
    _assert_dsched_equal(padded,
                         ref_schedule.pad_device_schedule(want.dsched, **kw))
    if slots == (0, 0):
        assert padded is got.dsched


def test_pad_device_schedule_of_a_fully_fused_schedule():
    """A schedule with no wavefront 1 gets one tile of pure pad slots."""
    ra = RefCSR.from_dense(np.diag(np.arange(1.0, 97.0)))
    got, want = _entries(ra)
    assert want.dsched.j_rows1.shape[0] == 0
    kw = dict(j1_slots=12, spill_slots=30)
    _assert_dsched_equal(schedule.pad_device_schedule(got.dsched, **kw),
                         ref_schedule.pad_device_schedule(want.dsched, **kw))


# --------------------------------------------------------------------------
# incremental inspection
# --------------------------------------------------------------------------
def _padded(entry, module, slack=16):
    ds = module.pad_device_schedule(entry.dsched, j1_slots=slack,
                                    spill_slots=slack * 8)
    return dataclasses.replace(entry, dsched=ds)


@pytest.mark.parametrize("seed", [2, 3, 11])
@pytest.mark.parametrize("op_pair", ["gemm", "spmm"])
def test_incremental_update_equals_the_reference(op_pair, seed):
    ra = _graph(160)
    got, want = _entries(ra, b_is_sparse=op_pair == "spmm")
    got, want = _padded(got, schedule), _padded(want, ref_schedule)
    rng = np.random.default_rng(seed)
    rows = np.sort(rng.choice(ra.n_rows, 6, replace=False))
    rb = ref_random.perturb_rows(ra, rows, seed=seed + 5)
    dirty = ref_serving.csr_dirty_rows(ra, rb)
    want_p = ref_serving.incremental_update(
        ra, want, rb, dirty, cache_size=KNOBS["cache_size"])
    got_p = serving.incremental_update(
        as_port(ra), got, as_port(rb), dirty,
        cache_size=KNOBS["cache_size"])
    assert want_p is not None and got_p is not None
    _assert_entry_equal(got_p, want_p)
    assert got_p.content_digest == csr_content_digest(as_port(rb))
    # the patched schedule computes the new pattern's product
    b = rng.standard_normal((rb.n_cols, 8))
    c = rng.standard_normal((rb.n_cols if op_pair == "spmm" else 8, 8))
    tb, tc = torch.as_tensor(b, dtype=torch.float32), torch.as_tensor(
        c, dtype=torch.float32)
    if op_pair == "spmm":
        oracle = ref_oracle.unfused_spmm_spmm(rb, rb, c)
        d = fused_ops.fused_spmm_spmm(got_p.dsched, as_port(rb), tc)
    else:
        oracle = ref_oracle.unfused_gemm_spmm(rb, b, c)
        d = fused_ops.fused_gemm_spmm(got_p.dsched, tb, tc)
    np.testing.assert_allclose(d.numpy(), oracle, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("case", ["empty-dirty", "headroom", "shape",
                                  "budget", "no-headroom"])
def test_incremental_update_bails_as_the_reference(case):
    ra = _graph(160)
    got, want = _entries(ra)
    if case != "no-headroom":
        got, want = _padded(got, schedule), _padded(want, ref_schedule)
    cache_size = KNOBS["cache_size"]
    if case == "empty-dirty":
        rb, dirty = ra, np.array([], np.int64)
    elif case == "headroom":
        dirty = np.arange(ra.n_rows)
        rb = ref_random.perturb_rows(ra, dirty, seed=1)
    elif case == "shape":
        rb, dirty = ref_serving.pad_csr(ra, 256, 256), np.array([0])
    else:
        # a fused row's re-sample (budget: every patched tile is over a
        # budget of 1; no-headroom: it must enter wavefront 1, which has
        # no free slot without the pad)
        fused = np.concatenate([tl.j_rows for tl in
                                want.sched.wavefronts[0]])
        dirty = np.sort(fused[:4]).astype(np.int64)
        rb = ref_random.perturb_rows(ra, dirty, seed=11)
        dirty = ref_serving.csr_dirty_rows(ra, rb)
        if case == "budget":
            cache_size = 1.0
    want_p = ref_serving.incremental_update(ra, want, rb, dirty,
                                            cache_size=cache_size)
    got_p = serving.incremental_update(as_port(ra), got, as_port(rb), dirty,
                                       cache_size=cache_size)
    if case == "empty-dirty":
        assert want_p is want and got_p is got
    elif case in ("headroom", "shape", "budget"):
        assert want_p is None and got_p is None
    elif want_p is None:
        assert got_p is None
    else:
        _assert_entry_equal(got_p, want_p)


# --------------------------------------------------------------------------
# the kernel arm's wavefront-1 tails on padded and patched schedules
# --------------------------------------------------------------------------
def _old_plan(ds, max_chunk=kspmm.MAX_CHUNK):
    """The tail plan as it was built before headroom and patches existed:
    spill lanes as given, which must already be sorted by slot."""
    j_flat = np.asarray(ds.j_rows1, np.int64).reshape(-1)
    slot_of = np.full(ds.n_j + 1, -1, np.int64)
    real = np.flatnonzero(j_flat != ds.n_j)
    slot_of[j_flat[real]] = real
    return kspmm.plan_tails(slot_of[np.asarray(ds.spill_rows1, np.int64)],
                            j_flat.size, max_chunk)


def _patched_stream_entries(op_pair="gemm"):
    """(CSR, entry) of a tier stream: the rebuild with its headroom, then
    three patched entries (rows re-sampled each time)."""
    tier = serving.ServingTier(b_col=8, c_col=8,
                               b_is_sparse=op_pair == "spmm", width_cap=2,
                               **KNOBS)
    rng = np.random.default_rng(4)
    a = as_port(_graph(180))
    out = []
    for i in range(4):
        if i:
            a = port_random.perturb_rows(
                a, rng.choice(a.n_rows, 3, replace=False), seed=i)
        entry, ap, how = tier.schedule_for(a)
        assert how == ("rebuild" if i == 0 else "incremental")
        out.append((ap, entry))
    return out


@pytest.mark.parametrize("max_chunk", [1, 3, kspmm.MAX_CHUNK])
@pytest.mark.parametrize("name", ["banded", "powerlaw", "single-hub-row"])
def test_wf1_tail_plan_unchanged_on_a_fresh_schedule(name, max_chunk):
    from test_torch_cells import pattern_pair
    _, ta = pattern_pair(name)
    ds = api.get_schedule(ta, b_col=8, c_col=6, spec=api.FusionSpec(
        **KNOBS, width_cap=1)).dsched
    assert ds.spill_rows1.size
    got, want = fused_ops.wf1_tail_plan(ds, max_chunk), _old_plan(ds,
                                                                  max_chunk)
    assert got.order is None
    for f in ("ranges", "chunks", "split_rows", "split_ptr"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("max_chunk", [2, kspmm.MAX_CHUNK])
@pytest.mark.parametrize("op_pair", ["gemm", "spmm"])
def test_wf1_tail_plan_on_padded_and_patched_schedules(op_pair, max_chunk):
    """Headroom and patches leave the spill lanes out of row order: the
    plan drops slot-less zero lanes, sorts the rest by slot, and the
    plain hybrid product with it equals the body plus ``_spill_add``."""
    for ap, entry in _patched_stream_entries(op_pair):
        ds = entry.dsched
        with pytest.raises(ValueError, match="sorted"):
            _old_plan(ds, max_chunk)    # what the kernel's plan refused
        plan = fused_ops.wf1_tail_plan(ds, max_chunk)
        assert plan.order is not None
        st = fused_ops.schedule_tensors(ds, "cpu", torch.float32)
        tails = kspmm.Tails.upload(plan, ds.spill_cols1, ds.spill_vals1,
                                   "cpu", torch.float32)
        rng = np.random.default_rng(1)
        d1 = torch.as_tensor(rng.standard_normal((ds.n_i, 6)),
                             dtype=torch.float32)
        d0 = torch.as_tensor(rng.standard_normal((ds.n_j + 1, 6)),
                             dtype=torch.float32)
        got = kref.spmm_ell(st.cols1, st.vals1, d1, tails=tails,
                            out=d0.clone()[: ds.n_j],
                            out_rows=st.j_rows1_32)
        want = fused_ops._wf1(st, d0.clone(), d1)[: ds.n_j]
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        # the schedule tensors' own tails carry the lanes in plan order
        order = fused_ops.wf1_tail_plan(ds).order
        torch.testing.assert_close(st.tails1.vals,
                                   torch.as_tensor(ds.spill_vals1[order]))


def test_wf1_tail_plan_raises_on_a_live_lane_without_a_slot():
    (_, entry), = _patched_stream_entries()[:1]
    ds = entry.dsched
    on_slot = set(ds.j_rows1[ds.j_rows1 != ds.n_j].tolist())
    orphan = next(r for r in range(ds.n_j) if r not in on_slot)
    sr, sv = ds.spill_rows1.copy(), ds.spill_vals1.copy()
    sr[-1], sv[-1] = orphan, 0.5
    bad = dataclasses.replace(ds, spill_rows1=sr, spill_vals1=sv)
    with pytest.raises(ValueError, match="without a wavefront-1 slot"):
        fused_ops.wf1_tail_plan(bad)
    sv[-1] = 0.0                         # a zero lane there is dropped
    fused_ops.wf1_tail_plan(dataclasses.replace(ds, spill_rows1=sr,
                                                spill_vals1=sv))


@pytest.mark.parametrize("op_pair", ["gemm", "spmm"])
def test_cuda_arm_glue_on_padded_and_patched_entries(op_pair):
    """``backend="cuda"`` on CPU tensors runs the kernel arm's glue (the
    kernels' plain versions, wavefront 1 through the tail plan) on the
    headroom-padded entry and the patched ones; each equals the plain
    executor on the same entry and the host oracle."""
    rng = np.random.default_rng(6)
    for ap, entry in _patched_stream_entries(op_pair):
        c = torch.as_tensor(rng.standard_normal(
            (ap.n_cols if op_pair == "spmm" else 8, 8)), dtype=torch.float32)
        if op_pair == "spmm":
            got = api._spmm_spmm_cuda(entry, ap, c)
            plain = fused_ops.fused_spmm_spmm(entry.dsched, ap, c)
            oracle = ref_oracle.unfused_spmm_spmm(ap, ap, c.double().numpy())
        else:
            b = torch.as_tensor(rng.standard_normal((ap.n_cols, 8)),
                                dtype=torch.float32)
            got = api._gemm_spmm_cuda(entry, b, c)
            plain = fused_ops.fused_gemm_spmm(entry.dsched, b, c)
            oracle = ref_oracle.unfused_gemm_spmm(
                ap, b.double().numpy(), c.double().numpy())
        torch.testing.assert_close(got, plain, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got.numpy(), oracle, rtol=2e-3, atol=2e-3)


# --------------------------------------------------------------------------
# the tier and the front end against the reference's
# --------------------------------------------------------------------------
def _stream(n_requests=16, seed=4):
    """A drifting request stream (the reference CLI's drift): jumps among
    three windows of one base graph and re-sampled rows."""
    rng = np.random.default_rng(seed)
    base = ref_random.powerlaw_graph(1600, avg_deg=6, seed=3)
    windows = [ref_random.induced_subgraph(base, s, n)
               for s, n in ((0, 180), (200, 170), (600, 150))]
    current = windows[0]
    for i in range(n_requests):
        r = rng.random()
        if r < 0.15 and i:
            current = windows[int(rng.integers(len(windows)))]
        elif r < 0.6:
            k = max(1, current.n_rows // 50)
            current = ref_random.perturb_rows(
                current, rng.choice(current.n_rows, k, replace=False),
                seed=int(rng.integers(1 << 31)))
        yield current, rng.standard_normal((current.n_cols, 8)), \
            rng.standard_normal((current.n_cols, 8)), \
            rng.standard_normal((8, 8))


def _served(tier, call) -> str:
    before = dict(tier.stats)
    out = call()
    for how, key in (("hit", "exact_hits"), ("incremental", "incremental"),
                     ("rebuild", "rebuilds")):
        if tier.stats[key] != before[key]:
            return how, out
    raise AssertionError("the request was not counted")


@pytest.fixture(scope="module")
def reference_streams():
    """Each op pair's stream through the reference tier (``"xla"``): the
    way each request was served, its output, the tier's stats and the
    cache counters."""
    out = {}
    for op_pair in ("gemm", "spmm"):
        ref_api.clear_schedule_cache()
        tier = ref_serving.ServingTier(b_col=8, c_col=8,
                                       b_is_sparse=op_pair == "spmm",
                                       backend="xla", **KNOBS)
        hows, outs = [], []
        for a, b, cs, c in _stream():
            if op_pair == "spmm":
                how, d = _served(tier, lambda: tier.matmul(
                    a, a, jnp.asarray(cs, jnp.float32)))
            else:
                how, d = _served(tier, lambda: tier.matmul(
                    a, jnp.asarray(b, jnp.float32),
                    jnp.asarray(c, jnp.float32)))
            hows.append(how)
            outs.append(np.asarray(d))
        out[op_pair] = (hows, outs, dict(tier.stats),
                        _counters(ref_api.schedule_cache_stats()),
                        tier.hit_rate())
        ref_api.clear_schedule_cache()
    return out


@pytest.mark.parametrize("backend", PORT_BACKENDS)
@pytest.mark.parametrize("op_pair", ["gemm", "spmm"])
def test_tier_stream_equals_the_reference(reference_streams, op_pair,
                                          backend):
    want_hows, want_outs, want_stats, want_counters, want_rate = \
        reference_streams[op_pair]
    tier = serving.ServingTier(b_col=8, c_col=8,
                               b_is_sparse=op_pair == "spmm",
                               backend=backend, **KNOBS)
    hows = []
    for i, (a, b, cs, c) in enumerate(_stream()):
        ta = as_port(a)
        if op_pair == "spmm":
            how, d = _served(tier, lambda: tier.matmul(
                ta, ta, torch.as_tensor(cs, dtype=torch.float32)))
        else:
            how, d = _served(tier, lambda: tier.matmul(
                ta, torch.as_tensor(b, dtype=torch.float32),
                torch.as_tensor(c, dtype=torch.float32)))
        hows.append(how)
        assert d.shape == (a.n_rows, 8)
        np.testing.assert_allclose(d.numpy(), want_outs[i], rtol=2e-3,
                                   atol=2e-3, err_msg=f"request {i}")
    assert hows == want_hows
    assert {"hit", "incremental", "rebuild"} <= set(hows)
    assert tier.stats == want_stats
    assert tier.hit_rate() == want_rate
    assert _counters(api.schedule_cache_stats()) == want_counters


def test_bucket_lru_never_thrashes():
    """N distinct patterns in K buckets hold K cache entries and evict
    nothing, as in the reference."""
    kw = dict(b_col=8, c_col=8, width_cap=8, backend="torch", **KNOBS)
    tier = serving.ServingTier(**kw)
    ref_tier = ref_serving.ServingTier(**dict(kw, backend="xla"))
    rng = np.random.default_rng(0)
    base = ref_random.powerlaw_graph(2048, avg_deg=5, seed=9)
    sizes = (100, 200, 400)            # three pow2 buckets (128/256/512)
    for i in range(9):
        a = ref_random.induced_subgraph(base, (i * 37) % 1024,
                                        sizes[i % len(sizes)])
        b = rng.standard_normal((a.n_cols, 8)).astype(np.float32)
        c = rng.standard_normal((8, 8)).astype(np.float32)
        d = tier.matmul(as_port(a), torch.as_tensor(b), torch.as_tensor(c))
        want = ref_tier.matmul(a, jnp.asarray(b), jnp.asarray(c))
        np.testing.assert_allclose(d.numpy(), np.asarray(want), rtol=2e-3,
                                   atol=2e-3)
    st = api.schedule_cache_stats()
    assert st["bucket_entries"] == st["entries"] == len(sizes)
    assert st["evictions"] == 0
    assert sorted(tier._residents) == sorted(ref_tier._residents)
    assert _counters(st) == _counters(ref_api.schedule_cache_stats())


def test_stats_counters_and_clear():
    tier = serving.ServingTier(b_col=8, c_col=8, backend="torch", **KNOBS)
    a = as_port(_graph(150))
    b, c = torch.randn(a.n_cols, 8), torch.randn(8, 8)
    tier.matmul(a, b, c)               # rebuild (miss)
    tier.matmul(a, b, c)               # exact hit
    tier.matmul(port_random.perturb_rows(a, np.array([3, 9]), seed=2), b, c)
    st = api.schedule_cache_stats()
    assert (st["misses"], st["hits"], st["incremental_patches"],
            st["bucket_entries"]) == (1, 4, 1, 1)
    assert tier.stats == {"requests": 3, "exact_hits": 1, "incremental": 1,
                          "rebuilds": 1}
    assert tier.hit_rate() == pytest.approx(2 / 3)
    api.clear_schedule_cache()
    st = api.schedule_cache_stats()
    assert st["hits"] == st["misses"] == st["incremental_patches"] == 0
    assert st["bucket_entries"] == st["entries"] == 0


@pytest.mark.parametrize("feats_as", ["numpy", "tensor"])
def test_front_end_equals_the_reference(feats_as):
    fe = serve.SubgraphFrontEnd(feat_dim=4, out_dim=3, max_batch=3,
                                device="cpu", **KNOBS)
    ref_fe = ref_serve.SubgraphFrontEnd(feat_dim=4, out_dim=3, max_batch=3,
                                        **KNOBS)
    rng = np.random.default_rng(5)
    a = _graph(96)
    a2 = ref_random.perturb_rows(a, np.array([1, 2]), seed=6)
    for pat in (a, a, a2, a, a2):       # two patterns, interleaved
        feats = rng.standard_normal((pat.n_cols, 4))
        w = rng.standard_normal((4, 3))
        ref_fe.submit(pat, feats, w)
        if feats_as == "tensor":
            feats = torch.as_tensor(feats, dtype=torch.float32)
            fe.submit(as_port(pat), feats, w)
            assert fe._queue[-1][1] is feats      # not copied
        else:
            fe.submit(as_port(pat), feats, w)
    outs, want = fe.flush(), ref_fe.flush()
    assert len(outs) == len(want) == 5
    for got, w in zip(outs, want):
        assert got.device.type == "cpu"
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=2e-3,
                                   atol=2e-3)
    assert fe.batches == ref_fe.batches < 5
    assert fe.tier.stats == ref_fe.tier.stats


def test_subgraph_cli_equals_the_reference(capsys):
    argv = ["--subgraphs", "12", "--subgraph-nodes", "128", "--feat-dim",
            "8", "--out-dim", "4", "--max-batch", "3"]
    ref_serve.main(argv)
    want = capsys.readouterr().out.splitlines()[-1]
    fe = serve.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()[-1]
    assert got == want
    assert isinstance(fe, serve.SubgraphFrontEnd)


@pytest.mark.parametrize("knob", ["autotune", "transpose", "reorder",
                                  "mesh"])
def test_bucket_knob_rejects_bad_compositions(knob):
    """Each knob raises ``ValueError`` with a bucket, in both packages.  A
    non-trivial mesh: a port ``Mesh`` of two cpu entries, and for the
    reference a stand-in with the two attributes its ``mesh_key`` reads
    (the test process has one JAX device)."""
    import types
    from repro_torch.models.sharding import Mesh
    ra = _graph(100)
    value = {"autotune": True, "transpose": True, "reorder": "rcm",
             "mesh": Mesh(["cpu", "cpu"], ("x",))}[knob]
    ref_value = value if knob != "mesh" else types.SimpleNamespace(
        devices=np.empty((2,)), axis_names=("x",))
    bucket = (128, 128, None)
    with pytest.raises(ValueError):
        api.get_schedule(as_port(ra), b_col=8, c_col=8, spec=api.FusionSpec(
            **KNOBS, bucket=bucket, **{knob: value}))
    with pytest.raises(ValueError):
        ref_api.get_schedule(ra, b_col=8, c_col=8,
                             spec=ref_api.FusionSpec(
                                 **KNOBS, bucket=bucket,
                                 **{knob: ref_value}))


def test_bucket_hit_needs_the_same_content():
    """A bucket entry serves a second pattern only after re-inspection,
    which replaces it under the same key (one entry for the bucket)."""
    ta = as_port(_graph(100))
    tb = port_random.perturb_rows(ta, np.array([4, 50]), seed=3)
    spec = api.FusionSpec(**KNOBS, bucket=(128, 128, None))
    e1 = api.get_schedule(ta, b_col=8, c_col=8, spec=spec)
    assert api.get_schedule(ta, b_col=8, c_col=8, spec=spec) is e1
    e2 = api.get_schedule(tb, b_col=8, c_col=8, spec=spec)
    assert e2 is not e1 and e2.content_digest == csr_content_digest(tb)
    st = api.schedule_cache_stats()
    assert (st["hits"], st["misses"], st["bucket_entries"],
            st["entries"]) == (1, 2, 1, 1)
    with pytest.raises(ValueError, match="content_digest"):
        api.store_bucket_schedule(dataclasses.replace(e1,
                                                      content_digest=None),
                                  bucket=(128, 128, None))
