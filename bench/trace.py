"""The device trace of a few steps, and its reduction.

``capture`` runs the steps under ``torch.profiler`` (after one traced
warm-up step, which the profiler discards: a session can drop its first
launch through ``ctypes``), with the tile-fusion op's host calls wrapped
in ``record_function`` scopes, and reads the exported trace back.
``Trace`` reduces it: the device's busy time (the union of kernel, copy
and set intervals) in the traced window, the device time of the kernels
launched inside given host scopes, the kernels that took the most time,
and the idle gaps by the host op that was open during each.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "user_annotation")
WINDOW = "bench.window"
STEP = "bench.step"
#: the tile-fusion op: the forward's scope around ``api.tile_fused_matmul``
#: and the backward's autograd nodes of its Functions
TILE_FUSION_SCOPES = ("tile_fused_matmul", "_GemmSpmmFnBackward",
                      "_SpmmSpmmFnBackward")


def tilefusion_targets() -> list:
    """The host calls a traced run wraps in scopes: the tile-fusion entry
    (the module attribute the models call; the backward's ``dB`` calls it
    too), and the Eq-3 pick and the schedule lookup inside it."""
    from repro_torch.core.tilefusion import api
    return [(api, "tile_fused_matmul"), (api, "select_backend"),
            (api, "get_schedule")]


@contextlib.contextmanager
def scoped(targets):
    """Wrap each ``(module, attribute)`` callable in a profiler scope of the
    attribute's name for the duration of the block."""
    from torch.profiler import record_function
    saved = []
    for mod, attr in targets:
        fn = getattr(mod, attr)

        def wrapper(*args, _fn=fn, _name=attr, **kwargs):
            with record_function(_name):
                return _fn(*args, **kwargs)
        setattr(mod, attr, wrapper)
        saved.append((mod, attr, fn))
    try:
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


def capture(step, n_steps: int) -> "Trace":
    import torch
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)
    with scoped(tilefusion_targets()), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        step()
        torch.cuda.synchronize()
        prof.step()
        with record_function(WINDOW):
            for _ in range(n_steps):
                with record_function(STEP):
                    step()
            torch.cuda.synchronize()
        prof.step()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    tr = Trace(events, n_steps)
    tr.read_s = time.perf_counter() - t0
    return tr


def union(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """Times in the trace's microseconds; the public readings in
    seconds."""

    def __init__(self, events: list, n_steps: int):
        self.n_steps = n_steps
        self.device, launches, self.host = [], {}, []
        window = None
        for e in events:
            if e.get("ph") != "X":
                continue
            cat, ts, dur = e.get("cat"), float(e["ts"]), float(e["dur"])
            args = e.get("args") or {}
            if cat in DEVICE_CATS:
                self.device.append((ts, ts + dur, e["name"],
                                    args.get("correlation")))
            elif cat in LAUNCH_CATS:
                launches[args.get("correlation")] = (e["tid"], ts)
            elif cat in HOST_CATS:
                self.host.append((ts, ts + dur, e["name"], e["tid"]))
                if e["name"] == WINDOW:
                    window = (ts, ts + dur)
        if window is None:
            raise RuntimeError("the trace has no window scope")
        self.window = window
        self.device = [d for d in self.device
                       if d[1] > window[0] and d[0] < window[1]]
        self.launch = [launches.get(d[3]) for d in self.device]
        self.unlaunched = sum(x is None for x in self.launch)

    # ----------------------------------------------------- readings ----
    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_intervals(self) -> list:
        w0, w1 = self.window
        return union((max(a, w0), min(b, w1)) for a, b, _, _ in self.device)

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def device_s_in_scopes(self, names) -> float:
        """Device seconds of the kernels and copies launched while a host
        op whose name contains one of ``names`` was open on the launching
        thread."""
        spans = collections.defaultdict(list)
        for a, b, name, tid in self.host:
            if any(n in name for n in names):
                spans[tid].append((a, b))
        merged = {tid: union(v) for tid, v in spans.items()}
        starts = {tid: [a for a, _ in v] for tid, v in merged.items()}
        total = 0.0
        for (a, b, _, _), launch in zip(self.device, self.launch):
            if launch is None or launch[0] not in merged:
                continue
            tid, ts = launch
            k = bisect.bisect_right(starts[tid], ts) - 1
            if k >= 0 and merged[tid][k][1] >= ts:
                total += b - a
        return total / 1e6

    def top_device_ops(self, n: int = 10) -> list:
        by = collections.Counter()
        for a, b, name, _ in self.device:
            by[name] += (b - a) / 1e6
        return [[k[:200], v] for k, v in by.most_common(n)]

    def _host_segments(self) -> dict:
        """Per host thread, ``(start, end, innermost op, its start)``
        segments covering the thread's traced time."""
        by_tid = collections.defaultdict(list)
        for a, b, name, tid in self.host:
            by_tid[tid].append((a, -b, name))
        out = {}
        for tid, ops in by_tid.items():
            ops.sort()
            segs, stack, cur = [], [], ops[0][0]

            def emit(until):
                nonlocal cur
                if until > cur:
                    top = stack[-1] if stack else None
                    segs.append((cur, until, top[2] if top else None,
                                 top[0] if top else None))
                    cur = until
            for a, nb, name in ops:
                while stack and stack[-1][1] <= a:
                    emit(stack[-1][1])
                    stack.pop()
                emit(a)
                stack.append((a, -nb, name))
            while stack:
                emit(stack[-1][1])
                stack.pop()
            out[tid] = ([s[0] for s in segs], segs)
        return out

    def idle_gaps(self, n: int = 10) -> list:
        """The device's idle time in the window, by the innermost host op
        open at each gap's middle (of the thread whose op began last)."""
        busy = self.busy_intervals()
        w0, w1 = self.window
        edges = [w0] + [x for ab in busy for x in ab] + [w1]
        segs = self._host_segments()
        by = collections.Counter()
        for a, b in zip(edges[::2], edges[1::2]):
            if b <= a:
                continue
            mid, best = (a + b) / 2, None
            for starts, ss in segs.values():
                k = bisect.bisect_right(starts, mid) - 1
                if k >= 0 and ss[k][1] >= mid and ss[k][2] is not None:
                    if best is None or ss[k][3] > best[3]:
                        best = ss[k]
            by[best[2][:200] if best else "(no host op)"] += (b - a) / 1e6
        return [[k, v] for k, v in by.most_common(n)]
