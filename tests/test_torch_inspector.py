"""The port's inspector (Algorithm 1 → DeviceSchedule → Eq-3 traffic) and
its schedule cache against the JAX package's.

The port's cost model, scheduler and schedule are copies, so every host
structure must be array-equal on the six parity patterns × {GeMM-SpMM,
SpMM-SpMM} × c_col ∈ {4, 8}, and the two schedule caches must count the
same hits and misses for the same call sequence.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from test_torch_cells import KNOBS, PATTERNS, pattern_pair
from repro.core.tilefusion import api as ref_api
from repro.core.tilefusion import fused_ref as ref_oracle
from repro.core.tilefusion.schedule import to_device_schedule as ref_to_ds
from repro.core.tilefusion.scheduler import build_schedule as ref_build
from repro_torch.core.tilefusion import api, fused_ref
from repro_torch.core.tilefusion.schedule import to_device_schedule
from repro_torch.core.tilefusion.scheduler import build_schedule


@pytest.fixture(scope="module", autouse=True)
def _fresh_jit_cache():
    # many small JAX executables compile in one process; start clean, as
    # test_serving.py does
    jax.clear_caches()


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


@pytest.mark.parametrize("uniform", [True, False])
@pytest.mark.parametrize("c_col", [4, 8])
@pytest.mark.parametrize("op_pair", ["gemm", "spmm"])
@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_inspector_equal(pattern, op_pair, c_col, uniform):
    ra, ta = pattern_pair(pattern)
    sparse = op_pair == "spmm"
    b_col = c_col if sparse else 8
    cap = ref_api._resolve_width_cap(ra, "auto")
    assert api._resolve_width_cap(ta, "auto") == cap
    kw = dict(b_col=b_col, c_col=c_col, b_is_sparse=sparse,
              uniform_split=uniform, width_cap=cap, **KNOBS)
    want = ref_build(ra, **kw)
    got = build_schedule(ta, **kw)
    _assert_schedule_equal(got, want)
    assert got.fused_ratio == want.fused_ratio
    want_ds = ref_to_ds(ra, want, width_cap=cap)
    got_ds = to_device_schedule(ta, got, width_cap=cap)
    _assert_dsched_equal(got_ds, want_ds)
    for dtype_bytes in (2, 4):
        assert (got_ds.hbm_traffic_model(b_col, c_col, dtype_bytes)
                == want_ds.hbm_traffic_model(b_col, c_col, dtype_bytes))


@pytest.mark.parametrize("op_pair", ["gemm", "spmm"])
@pytest.mark.parametrize("pattern", sorted(PATTERNS))
def test_schedule_walk_and_host_oracles_equal(pattern, op_pair):
    """The numpy schedule walk (with its wavefront invariants) and the
    port's CSR-product unfused oracle against the reference's dense one."""
    ra, ta = pattern_pair(pattern)
    rng = np.random.default_rng(7)
    n = ra.n_rows
    entry = api.get_schedule(ta, b_col=8, c_col=4,
                             b_is_sparse=(op_pair == "spmm"),
                             spec=api.FusionSpec(**KNOBS))
    if op_pair == "spmm":
        c = rng.standard_normal((n, 4))
        got = fused_ref.run_spmm_spmm(ta, ta, c, entry.sched, check=True)
        want = ref_oracle.unfused_spmm_spmm(ra, ra, c)
        unfused = fused_ref.unfused_spmm_spmm(ta, ta, c)
    else:
        b = rng.standard_normal((n, 8))
        c = rng.standard_normal((8, 4))
        got = fused_ref.run_gemm_spmm(ta, b, c, entry.sched, check=True)
        want = ref_oracle.unfused_gemm_spmm(ra, b, c)
        unfused = fused_ref.unfused_gemm_spmm(ta, b, c)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(unfused, want, rtol=1e-10, atol=1e-10)


def test_schedule_cache_counts_equal():
    """The same call sequence gives the same hits and misses in both
    caches: content keys, shape keys and the resolved-spec tail agree."""
    calls = []
    for name in ("banded", "powerlaw"):
        ra, ta = pattern_pair(name)
        for b_col, c_col, sparse in ((8, 4, False), (8, 4, False),
                                     (4, 4, True), (8, 8, False)):
            calls.append((ra, ta, b_col, c_col, sparse))
    ref_api.clear_schedule_cache()
    api.clear_schedule_cache()
    for ra, ta, b_col, c_col, sparse in calls + calls[:3]:
        for spec_kw in (dict(KNOBS), dict(KNOBS, dtype_bytes=2),
                        dict(KNOBS, width_cap=None)):
            ref_api.get_schedule(ra, b_col=b_col, c_col=c_col,
                                 b_is_sparse=sparse,
                                 spec=ref_api.FusionSpec(**spec_kw))
            api.get_schedule(ta, b_col=b_col, c_col=c_col,
                             b_is_sparse=sparse,
                             spec=api.FusionSpec(**spec_kw))
    want = ref_api.schedule_cache_stats()
    got = api.schedule_cache_stats()
    for k in ("hits", "misses", "evictions", "entries", "spec_entries"):
        assert got[k] == want[k], k
    assert got["misses"] > 0 and got["hits"] > 0


def test_operand_dtype_bytes_reads_torch_dtypes():
    from repro_torch.core.tilefusion.cost_model import operand_dtype_bytes
    assert operand_dtype_bytes(torch.zeros(1, dtype=torch.bfloat16)) == 2
    assert operand_dtype_bytes(torch.zeros(1)) == 4
    assert operand_dtype_bytes(np.zeros(1)) == 8
    assert operand_dtype_bytes(object()) == 4
