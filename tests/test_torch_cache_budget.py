"""The schedule cache's size knob: the port's ``REPRO_SCHEDULE_CACHE_ENTRIES``
against the reference's.

Each cell runs one sequence of ``tile_fused_matmul`` / ``get_schedule``
calls on both packages under the same cap (set with
``monkeypatch.setenv``), on the same 128- and 256-node banded patterns
(built by the reference's generator and carried into the port's ``CSR``),
and holds the port's cache counters and live entry counts to the
reference's after every call.  The sequences are those of
``tests/test_api.py``'s eviction tests; the caps are 1 and 2.
"""
import jax.numpy as jnp
import pytest
import torch

from test_torch_cells import as_port
from repro.core.sparse.random import banded_spd
from repro.core.tilefusion import api as ref_api
from repro_torch.core.tilefusion import api

#: the counters both packages keep
KEYS = ("hits", "misses", "evictions", "ell_evictions", "entries",
        "ell_entries")


@pytest.fixture(autouse=True)
def _fresh_caches():
    api.clear_schedule_cache()
    ref_api.clear_schedule_cache()
    yield
    api.clear_schedule_cache()
    ref_api.clear_schedule_cache()


def _stats(mod) -> dict:
    stats = mod.schedule_cache_stats()
    return {k: stats[k] for k in KEYS}


def _lru(mod, to_csr, dense):
    """``test_cache_lru_eviction``: three tile sizes of one pattern, then
    the newest and the oldest again."""
    a = to_csr(banded_spd(256, 4, seed=0))
    for ct in (32, 64, 128, 128, 32):
        mod.get_schedule(a, b_col=8, c_col=8, spec=mod.FusionSpec(ct_size=ct))
        yield _stats(mod)


def _monotonic(mod, to_csr, dense):
    """``test_eviction_counters_monotonic``: inspections and unfused
    products of new patterns, both caches filling."""
    a = to_csr(banded_spd(128, 4, seed=8))
    b, c = dense((128, 8)), dense((8, 8))
    for ct in (16, 32, 64, 128):
        mod.get_schedule(a, b_col=8, c_col=8, spec=mod.FusionSpec(ct_size=ct))
        yield _stats(mod)
        mod.tile_fused_matmul(to_csr(banded_spd(128, 4, seed=ct)), b, c,
                              backend="unfused",
                              spec=mod.FusionSpec(width_cap=ct % 3 or None))
        yield _stats(mod)


def _ell(mod, to_csr, dense):
    """``test_ell_cache_reported_and_bounded``: unfused products of new
    patterns (three, so cap 2 evicts too)."""
    b, c = dense((128, 8)), dense((8, 8))
    for seed in (0, 1, 2):
        mod.tile_fused_matmul(to_csr(banded_spd(128, 4, seed=seed)), b, c,
                              backend="unfused")
        yield _stats(mod)


SEQUENCES = {"lru": _lru, "monotonic": _monotonic, "ell": _ell}


@pytest.mark.parametrize("cap", [1, 2])
@pytest.mark.parametrize("sequence", sorted(SEQUENCES))
def test_evictions_match_the_reference(monkeypatch, sequence, cap):
    monkeypatch.setenv(api.CACHE_ENTRIES_ENV, str(cap))
    run = SEQUENCES[sequence]
    want = list(run(ref_api, lambda a: a,
                    lambda s: jnp.ones(s, jnp.float32)))
    got = list(run(api, as_port, lambda s: torch.ones(s)))
    assert got == want
    assert max(s["entries"] for s in got) <= cap
    assert max(s["ell_entries"] for s in got) <= cap
    # the cap really evicted
    assert got[-1]["evictions"] + got[-1]["ell_evictions"] >= 1


@pytest.mark.parametrize("raw", ["", "0", "-3", "1", "7", "many"])
def test_cache_budget_reads_the_env_as_the_reference(monkeypatch, raw):
    monkeypatch.setenv(api.CACHE_ENTRIES_ENV, raw)
    assert api.CACHE_ENTRIES_ENV == ref_api.CACHE_ENTRIES_ENV
    assert api.DEFAULT_CACHE_ENTRIES == ref_api.DEFAULT_CACHE_ENTRIES
    assert api._cache_budget() == ref_api._cache_budget()


def test_ordering_cache_shares_the_cap(monkeypatch):
    """The port's ordering cache (orderings of ``reorder=`` candidates)
    keeps no more entries than the cap either."""
    monkeypatch.setenv(api.CACHE_ENTRIES_ENV, "1")
    for seed in (0, 1, 2):
        a = as_port(banded_spd(128, 4, seed=seed))
        api._ordering(a, "rcm")
    assert len(api._ordering_cache) == 1
    assert api.schedule_cache_stats()["ordering_evictions"] == 2
