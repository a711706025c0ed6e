"""The program's own spans (``repro_torch.tracing``), read two ways.

In memory: ``host_spans`` runs a few more steps, unprofiled, under
``tracing.collect()``, the first time a reader asks, after the window and
the trace, so no other reading changes.  In the traced run's Kineto
trace, where each span is a ``user_annotation`` on the clock of the
device's kernels: the device's idle time under a span (``idle_share``)
and the device time of the kernels launched under one (``Trace``'s
``device_s_in_scopes``).  A program without the spans gives nothing: the
readers then return None.
"""
from __future__ import annotations

import bisect

import torch

from .trace import union

#: the tile-fusion op's spans all start so
OP = "tile_fusion."


def host_spans(run):
    """The ``Spans`` of ``run.session.trace_steps`` more steps, unprofiled,
    the card drained before and after; made once and kept on the run.
    None where the program has no ``tracing`` module."""
    if "host_spans" not in vars(run):
        run.host_spans = _collect(run.session)
    return run.host_spans


def _collect(sess):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    device = torch.device(sess.device)

    def drain():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    drain()
    with tracing.collect() as rec:
        for _ in range(sess.trace_steps):
            sess.step()
        drain()
    return rec


def op_host_ms(run) -> float | None:
    """Host milliseconds a step inside the outermost tile-fusion spans (the
    forward's calls and the backward's nodes, on whichever thread)."""
    rec = host_spans(run)
    if rec is None or not rec.steps:
        return None
    return sum(s.seconds for s in rec.roots(OP)) / rec.steps * 1e3


def idle_share(trace, prefix: str = OP) -> float | None:
    """The share of the traced window's device-idle time, in percent,
    whose gaps have their midpoint inside a span named ``prefix...`` open
    on any thread; None without such a span or idle time."""
    spans = union((a, b) for a, b, name, _ in trace.host
                  if name.startswith(prefix))
    if not spans:
        return None
    starts = [a for a, _ in spans]
    w0, w1 = trace.window
    edges = [w0] + [x for ab in trace.busy_intervals() for x in ab] + [w1]
    idle = under = 0.0
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        idle += b - a
        mid = (a + b) / 2
        k = bisect.bisect_right(starts, mid) - 1
        if k >= 0 and spans[k][1] >= mid:
            under += b - a
    return 100.0 * under / idle if idle > 0 else None


def device_share(trace, part: tuple, whole: tuple) -> float | None:
    """Device time of the kernels launched under the ``part`` spans over
    that under the ``whole`` spans, in percent; None where ``whole``
    launched nothing."""
    total = trace.device_s_in_scopes(whole)
    if total <= 0:
        return None
    return 100.0 * trace.device_s_in_scopes(part) / total
