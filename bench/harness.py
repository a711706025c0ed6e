"""One run of one cell: set-up, the measured window, the traced steps
(``--trace 1``), the comparison with the plain reference, and the result.

The cell, its configuration, traffic and limits are found by name: the
cell in ``BENCHMARK.json``, the rest in this folder's ``configs/``,
``traffic/`` and ``limits/``.  The configuration's ``family`` names the
module under ``families/`` that drives the program, and each metric the
manifest gives the cell has its reader in ``metrics/<name>.py``.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import math
import sys
import time
from pathlib import Path

import torch

from . import compare, generate

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level modules that may not be loaded in a run's process
FOREIGN = ("jax", "jaxlib", "flax", "repro")


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def find_cell(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric``: named in its ``workloads``; an
    end-to-end metric without that key is reported in every cell (a
    per-layer metric always carries the key)."""
    return cell in metric.get("workloads", (cell,))


def cell_metrics(man: dict, cell: str, traced: bool) -> list:
    key = "per_layer" if traced else "end_to_end"
    return [m for m in man[key] if reports(m, cell)]


def reader(name: str):
    return generate.module("metrics", name)


def foreign_modules() -> list:
    return sorted({m for m in sys.modules if m.split(".")[0] in FOREIGN})


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""
    session: object
    setup_s: float
    steps: int
    units: float
    window_s: float
    step_s: list
    trace: object = None


def kernel_library(log) -> None:
    """Build (a checkout's first run) or find the program's kernel library
    and load it, on a clock of its own.  Its time stays inside
    ``setup_s``, which counts compilation in a run that compiles; the line
    tells a cold run's set-up from a warm one's."""
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    build = _build.build()
    _build.library()
    log(f"[setup] kernel library {'found' if build.reused else 'built'} "
        f"and loaded in {time.perf_counter() - t0:.6f} s: {build.path}")


def card(device) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1}


def run(workload: str, seed: int, seconds: float, traced: bool, *,
        device, t_start: float, man: dict | None = None,
        config: dict | None = None, traffic: dict | None = None,
        limits: dict | None = None, log=print) -> dict:
    """One run; returns the result object (the last key, ``compared``,
    holds each compared number beside its limit)."""
    man = manifest() if man is None else man
    cell = find_cell(man, workload)
    config = generate.load("configs", cell["config"]) if config is None \
        else config
    traffic = generate.load("traffic", cell["traffic"]) if traffic is None \
        else traffic
    limits = generate.load("limits", workload) if limits is None else limits
    family = importlib.import_module(f"bench.families.{config['family']}")
    sess = family.Session(config, traffic, seed, device)
    if torch.device(device).type == "cuda":
        kernel_library(log)
    sess.setup()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start

    from repro_torch.kernels import ops as kops
    kops.reset_launch_counts()
    step_s, units, failed = [], 0, 0
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        units += sess.step()
        te = time.perf_counter()
        step_s.append(te - ts)
        failed += not math.isfinite(sess.last_loss)
        if te - t0 >= seconds:
            break
    window_s = te - t0
    launches = {k: v / len(step_s) for k, v in kops.launch_counts().items()
                if v}
    tr = None
    if traced:
        from . import trace
        tr = trace.capture(sess.step, sess.trace_steps)
        log(f"[trace] {tr.n_steps} steps traced: busy {tr.busy_s:.6f} s of "
            f"{tr.window_s:.6f} s; {len(tr.device)} device ops, "
            f"{tr.unlaunched} without a launch record; read in "
            f"{tr.read_s:.1f} s")
    dev = card(device)
    dev["memory_peak_bytes"] = (
        torch.cuda.max_memory_allocated(device) if dev["platform"] == "gpu"
        else 0)
    q = len(step_s) // 4
    quarters = [sorted(step_s[i * q:(i + 1) * q])[q // 2] * 1e3
                for i in range(4)] if q else []
    log(f"[run] {workload} seed {seed}: {len(step_s)} steps in "
        f"{window_s:.6f} s, setup {setup_s:.6f} s; median step ms by "
        f"quarter of the window {quarters}; launches per step "
        f"{launches}; {json.dumps(sess.info())}")

    ctx = Run(sess, setup_s, len(step_s), units, window_s, step_s, tr)
    metrics = {}
    for m in cell_metrics(man, workload, traced):
        value = reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    program = sess.readings
    sess.close()
    gc.collect()
    if dev["platform"] == "gpu":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = sess.reference()
    values = compare.gaps(program, ref)
    log(f"[check] reference in {time.perf_counter() - t_ref:.1f} s; losses "
        f"program {program['losses']} reference {ref['losses']}")
    result = {"correct": compare.judge(values, limits),
              "attempted": len(step_s), "failed": failed,
              "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        result["breakdown"] = {"device_ops": tr.top_device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    result["compared"] = {k: {"value": values[k], "limit": limits[k]}
                          for k in limits}
    return result
