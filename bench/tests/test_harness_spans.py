"""The readings of the program's spans (``bench.spans``): the trace
reductions on a hand-made trace, the in-memory record of a tiny GCN
session's steps on the CPU, and nothing from a program without them."""
import sys

import pytest

from bench import generate, harness, spans, trace
from bench.families import gcn


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    ev("user_annotation", trace.WINDOW, 0, 100),
    ev("user_annotation", "tile_fusion.call", 10, 30),           # 10-40
    ev("user_annotation", "tile_fusion.scatter", 20, 5),         # 20-25
    ev("cuda_runtime", "cudaLaunchKernel", 21, 1, corr=1),
    ev("cuda_runtime", "cudaLaunchKernel", 30, 1, corr=2),
    # the backward on a second thread, a gap under its nested span
    ev("user_annotation", "tile_fusion.backward", 44, 36, tid=2),  # 44-80
    ev("user_annotation", "tile_fusion.backward.dc", 45, 15, tid=2),
    ev("cuda_driver", "cuLaunchKernel", 62, 1, tid=2, corr=3),
    ev("cuda_runtime", "cudaLaunchKernel", 94, 1, corr=4),        # no span
    ev("kernel", "zero_fill_and_index_copy", 22, 5, tid=7, corr=1),  # 22-27
    ev("kernel", "wf0", 31, 10, tid=7, corr=2),                   # 31-41
    ev("kernel", "spmm_hybrid", 63, 10, tid=7, corr=3),           # 63-73
    ev("kernel", "sgemm", 95, 4, tid=7, corr=4),                  # 95-99
]


def test_idle_under_the_op_spans_on_any_thread():
    tr = trace.Trace(EVENTS, n_steps=1)
    # idle gaps 0-22 (mid 11, in the call), 27-31 (mid 29, in the call),
    # 41-63 (mid 52, in backward.dc on thread 2), 73-95 (mid 84, none),
    # 99-100 (none): 48 of 71 us under a span
    assert spans.idle_share(tr) == pytest.approx(100 * 48 / 71)
    assert spans.idle_share(tr, "tile_fusion.backward") == \
        pytest.approx(100 * 22 / 71)


def test_device_time_launched_under_the_scatter():
    tr = trace.Trace(EVENTS, n_steps=1)
    share = spans.device_share(tr, ("tile_fusion.scatter",),
                               ("tile_fusion.call", "tile_fusion.backward"))
    assert share == pytest.approx(100 * 5 / 25)


def test_a_trace_without_the_spans_gives_nothing():
    events = [e for e in EVENTS if not e["name"].startswith("tile_fusion.")]
    tr = trace.Trace(events, n_steps=1)
    assert spans.idle_share(tr) is None
    assert spans.device_share(tr, ("tile_fusion.scatter",),
                              ("tile_fusion.call",)) is None


def test_the_new_spans_leave_the_op_scopes_alone():
    """``gcn_tilefusion_roofline`` reads kernels under the benchmark's
    substring scopes: the program's span names match none of them."""
    tr = trace.Trace(EVENTS, n_steps=1)
    assert tr.device_s_in_scopes(trace.TILE_FUSION_SCOPES) == 0


def _run(sess):
    return harness.Run(sess, setup_s=0.0, steps=1, units=1.0, window_s=1.0,
                       step_s=[1.0])


def test_host_spans_of_a_tiny_gcn_session():
    from repro_torch.core.tilefusion import api
    api.clear_schedule_cache()
    cfg = dict(generate.load("configs", "gcn-ogbn-arxiv"), n_nodes=300,
               in_dim=8, hidden_dim=16, out_dim=4)
    sess = gcn.Session(cfg, generate.load("traffic", "fullbatch.band"),
                       3000000123, "cpu")
    sess.trace_steps = 3
    sess.setup()
    run = _run(sess)
    rec = spans.host_spans(run)
    assert rec.steps == 3 and spans.host_spans(run) is rec
    roots = rec.roots(spans.OP)
    # each step: one call a layer forward, one backward node a layer
    assert sorted({s.name for s in roots}) == ["tile_fusion.backward",
                                               "tile_fusion.call"]
    assert len(roots) == 3 * 2 * cfg["n_layers"]
    assert {s.step for s in rec.spans} == {1, 2, 3}
    host_ms = harness.reader("gcn_op_host_ms").read(run)
    step_ms = sum(s.seconds for s in rec.spans
                  if s.name == "train_step") / 3 * 1e3
    assert 0 < host_ms < step_ms
    assert harness.reader("gcn_op_idle").read(run) is None      # no trace
    assert harness.reader("gcn_scatter_share").read(run) is None
    counted = harness.reader("gcn_inspect_counter_s").read(run)
    assert 0 < counted <= sess.inspect_s
    api.clear_schedule_cache()


class _Stub:
    trace_steps, device = 2, "cpu"

    def step(self):
        raise AssertionError("no steps without the program's spans")


def test_a_program_without_spans_gives_nothing(monkeypatch):
    import repro_torch
    monkeypatch.delattr(repro_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    run = _run(_Stub())
    assert spans.host_spans(run) is None
    assert spans.op_host_ms(run) is None
