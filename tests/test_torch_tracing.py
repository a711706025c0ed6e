"""The port's spans (``repro_torch.tracing``) on a small banded GCN on the
CPU: nothing recorded and no profiler scope entered while tracing is off;
one training step's span tree under ``collect()``; the same names in a
profiler's trace; the schedule cache's ``inspect_s`` counter; span names
clear of the benchmark's substring scopes."""
import importlib.util
import json
import re
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.configs.gcn import GCNConfig
from repro_torch.core.sparse.random import banded_spd
from repro_torch.core.tilefusion import api
from repro_torch.launch.steps import make_gcn_train_step
from repro_torch.models.gcn import GCN

ROOT = Path(__file__).resolve().parents[1]
API = ROOT / "src" / "repro_torch" / "core" / "tilefusion" / "api.py"
CFG = GCNConfig(n_nodes=96, in_dim=16, hidden_dim=16, out_dim=8, n_layers=3)
SPEC = api.FusionSpec(p=2, cache_size=30_000.0, ct_size=32)
#: the kernel arm's spans inside each call, in order
ARM = ["tile_fusion.pad", "tile_fusion.wf0", "tile_fusion.scatter",
       "tile_fusion.wf1"]


@pytest.fixture(autouse=True)
def _fresh_cache():
    api.clear_schedule_cache()
    yield
    api.clear_schedule_cache()


def _step(backend: str = "cuda"):
    """A 3-layer GCN's SGD step on a banded graph, and its inputs."""
    model = GCN(CFG, banded_spd(CFG.n_nodes, 4, seed=1), spec=SPEC,
                device="cpu")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(
        (CFG.n_nodes, CFG.in_dim)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, CFG.out_dim, CFG.n_nodes))
    return make_gcn_train_step(model, lr=0.1, backend=backend), x, y


@pytest.fixture
def kernel_arm(monkeypatch):
    """Eq 3's pick forced to the kernel arm (its glue over the kernels'
    plain versions on the CPU), so ``backend="auto"`` runs
    ``select_backend`` and the arm's spans both."""
    monkeypatch.setattr(api, "_single_device_backend",
                        lambda entry, device: "cuda")


def _children(rec, k):
    return [s for s in rec.spans if s.parent == k]


def _names(rec, k):
    return [s.name for s in _children(rec, k)]


def test_off_records_nothing_and_enters_no_profiler_scope(monkeypatch):
    step, x, y = _step("cuda")
    step(x, y)                                  # inspections out of the way

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")
    monkeypatch.setattr(tracing, "record_function", refuse)
    assert tracing.span("tile_fusion.call") is tracing.span("x")
    loss = step(x, y)
    assert torch.isfinite(loss)
    assert tracing._record is None and not tracing._stack()
    with tracing.collect() as rec:
        pass
    assert rec.spans == [] and rec.steps == 0


def test_collect_gives_the_step_tree(kernel_arm):
    step, x, y = _step("auto")
    step(x, y)
    with tracing.collect() as rec:
        step(x, y)
    assert rec.steps == 1
    spans = rec.spans
    top = [k for k, s in enumerate(spans) if s.parent is None]
    roots = [spans[k] for k in top]
    assert [s.name for s in roots if s.name == tracing.STEP] == ["train_step"]
    k_step = next(k for k in top if spans[k].name == tracing.STEP)
    assert _names(rec, k_step) == ["train_step.forward",
                                   "train_step.backward", "train_step.update"]
    assert {s.step for s in spans} == {1}
    assert all(rec.self_s(s.name) >= 0 for s in spans)

    # the forward: one call per layer, each with its pieces in order
    k_fwd = next(k for k, s in enumerate(spans)
                 if s.name == "train_step.forward")
    calls = [k for k, s in enumerate(spans) if s.name == "tile_fusion.call"
             and _ancestor(spans, k, "train_step.forward")]
    assert len(calls) == CFG.n_layers
    for k in calls:
        assert spans[k].parent == k_fwd
        assert _names(rec, k) == ["tile_fusion.get_schedule",
                                  "tile_fusion.select_backend", *ARM]

    # the backward: one node per layer; dB (a nested call) past layer 1,
    # dC in backward.dc
    bwd = [k for k, s in enumerate(spans) if s.name == "tile_fusion.backward"]
    assert len(bwd) == CFG.n_layers
    with_db = 0
    for k in bwd:
        names = _names(rec, k)
        assert names[-1] == "tile_fusion.backward.dc"
        if names[0] == "tile_fusion.call":
            with_db += 1
            nested = next(c for c, s in enumerate(spans)
                          if s.parent == k and s.name == "tile_fusion.call")
            assert _names(rec, nested) == ["tile_fusion.get_schedule",
                                           "tile_fusion.select_backend",
                                           *ARM]
    assert with_db == CFG.n_layers - 1
    # outermost tile-fusion spans: the forward calls and the backward
    # nodes, on whichever thread autograd ran them
    assert sorted(s.name for s in rec.roots("tile_fusion.")) == \
        ["tile_fusion.backward"] * 3 + ["tile_fusion.call"] * 3
    assert rec.self_s("train_step") >= 0
    assert rec.self_s("tile_fusion.call") < sum(
        s.seconds for s in spans if s.name == "tile_fusion.call")


def _ancestor(spans, k, name):
    p = spans[k].parent
    while p is not None:
        if spans[p].name == name:
            return True
        p = spans[p].parent
    return False


def test_a_span_on_another_thread_is_a_root_of_the_same_step():
    """A CUDA backward runs on autograd's device thread: there its spans
    have no parent, and carry the step they ran in."""
    def worker():
        with tracing.span("tile_fusion.backward"):
            with tracing.span("tile_fusion.backward.dc"):
                pass
    with tracing.collect() as rec:
        with tracing.step():
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=30)
        assert not t.is_alive()
    by = {s.name: s for s in rec.spans}
    assert by["tile_fusion.backward"].parent is None
    assert by["tile_fusion.backward"].thread != by["train_step"].thread
    assert rec.spans[by["tile_fusion.backward.dc"].parent].name == \
        "tile_fusion.backward"
    assert {s.step for s in rec.spans} == {1}
    assert [s.name for s in rec.roots("tile_fusion.")] == \
        ["tile_fusion.backward"]


def test_collect_is_one_at_a_time():
    with tracing.collect():
        with pytest.raises(RuntimeError):
            with tracing.collect():
                pass


def test_profiler_trace_holds_the_spans(kernel_arm, tmp_path):
    from torch.profiler import ProfilerActivity, profile
    step, x, y = _step("auto")
    step(x, y)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(x, y)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    names = [e["name"] for e in events]
    assert names.count("train_step") == 1
    for name in ("train_step.forward", "train_step.backward",
                 "train_step.update", "tile_fusion.get_schedule",
                 "tile_fusion.select_backend", "tile_fusion.backward",
                 "tile_fusion.backward.dc", *ARM):
        assert name in names, name
    assert names.count("tile_fusion.call") == 2 * CFG.n_layers - 1
    root = next(e for e in events if e["name"] == "train_step")
    t0, t1 = root["ts"], root["ts"] + root["dur"]
    for e in events:
        assert t0 <= e["ts"] and e["ts"] + e["dur"] <= t1, e["name"]


def test_inspect_s_sums_the_entries_built():
    step, x, y = _step("cuda")
    step(x, y)
    stats = api.schedule_cache_stats()
    entries = list(api._schedule_cache.values())
    assert stats["misses"] == len(entries) == 4     # 2 shapes, 2 transposes
    assert stats["inspect_s"] == pytest.approx(
        sum(e.inspector_s for e in entries), rel=1e-12)
    assert stats["inspect_s"] > 0
    step(x, y)                                  # hits only
    assert api.schedule_cache_stats()["inspect_s"] == stats["inspect_s"]
    api.clear_schedule_cache()
    assert api.schedule_cache_stats()["inspect_s"] == 0


def test_inspect_spans_are_the_timed_builds():
    step, x, y = _step("cuda")          # the model inspects its forward
    before = api.schedule_cache_stats()
    with tracing.collect() as rec:
        step(x, y)                      # the backward's transpose entries
    after = api.schedule_cache_stats()
    inspects = [s for s in rec.spans if s.name == "tile_fusion.inspect"]
    assert len(inspects) == after["misses"] - before["misses"] == 2
    assert all(rec.spans[s.parent].name == "tile_fusion.get_schedule"
               for s in inspects)
    # each span encloses the build its entry timed
    assert sum(s.seconds for s in inspects) >= \
        after["inspect_s"] - before["inspect_s"] > 0


def _bench_scopes():
    spec = importlib.util.spec_from_file_location("bench_trace",
                                                  ROOT / "bench" / "trace.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.TILE_FUSION_SCOPES


SPAN_NAMES = sorted(set(re.findall(r'tracing\.span\("([^"]+)"\)',
                                   API.read_text())))


@pytest.mark.parametrize("name", SPAN_NAMES)
def test_span_names_stay_clear_of_the_benchmark_scopes(name):
    assert name.startswith("tile_fusion.")
    assert not any(scope in name for scope in _bench_scopes())


def test_every_span_of_the_step_is_named_in_the_source(kernel_arm):
    step, x, y = _step("auto")
    with tracing.collect() as rec:
        step(x, y)
    seen = {s.name for s in rec.spans if s.name.startswith("tile_fusion.")}
    assert seen == set(SPAN_NAMES) - {"tile_fusion.unfused"}
