"""The trace reduction on a hand-made trace, and one short run of a cell
on the card."""
import json
import subprocess
import sys

import pytest

from bench import harness, trace


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    ev("user_annotation", trace.WINDOW, 0, 100),
    ev("user_annotation", "tile_fused_matmul", 10, 20),
    ev("cpu_op", "aten::mm", 12, 5),
    ev("cuda_runtime", "cudaLaunchKernel", 13, 1, corr=1),
    ev("cuda_runtime", "cudaLaunchKernel", 40, 1, corr=2),
    ev("cpu_op", "autograd::engine::evaluate_function: _GemmSpmmFnBackward",
       50, 30, tid=2),
    ev("cuda_driver", "cuLaunchKernel", 55, 1, tid=2, corr=3),
    ev("cpu_op", "select_backend", 82, 10),
    ev("kernel", "k_scoped", 20, 10, corr=1),        # 20-30, in scope
    ev("kernel", "k_free", 42, 8, corr=2),           # 42-50, no scope
    ev("kernel", "k_bwd", 60, 15, tid=7, corr=3),    # 60-75, backward
    ev("gpu_memcpy", "Memcpy DtoD", 70, 10, tid=7, corr=99),  # 70-80
    ev("kernel", "k_outside", 150, 10, corr=4),      # after the window
]


def test_busy_scopes_and_breakdown():
    tr = trace.Trace(EVENTS, n_steps=1)
    assert tr.window_s == pytest.approx(100e-6)
    # device intervals 20-30, 42-50, 60-80 (copy merged): 38 us
    assert tr.busy_s == pytest.approx(38e-6)
    assert tr.unlaunched == 1
    assert tr.device_s_in_scopes(trace.TILE_FUSION_SCOPES) == \
        pytest.approx(25e-6)
    assert tr.top_device_ops(2) == [["k_bwd", pytest.approx(15e-6)],
                                    ["k_scoped", pytest.approx(10e-6)]]
    gaps = dict(tr.idle_gaps())
    # 0-20 under the window scope only until tile_fused_matmul opens at 10
    assert gaps["tile_fused_matmul"] == pytest.approx(20e-6 + 0)
    assert gaps["select_backend"] == pytest.approx(20e-6)
    assert sum(gaps.values()) == pytest.approx(62e-6)


def test_a_trace_needs_its_window():
    with pytest.raises(RuntimeError):
        trace.Trace(EVENTS[1:], n_steps=1)


@pytest.mark.gpu
@pytest.mark.parametrize("traced", [0, 1])
def test_a_cell_runs_on_the_card(card, traced):
    proc = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload",
         "gcn-arxiv.train.band", "--seed", "3000000123", "--seconds", "2",
         "--trace", str(traced)], capture_output=True, text=True,
        cwd=str(harness.ROOT), timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "compared"
    if traced:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        assert result["breakdown"]["device_ops"]
