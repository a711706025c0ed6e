"""Shares that several per-layer metrics read, each from the run's own
counts and times: a step's share of a peak rate, an op's share of its
roofline, and the device's idle share of a step."""
from __future__ import annotations

from . import trace, work


def step_mfu(run, peak: str) -> float:
    """The step's counted FLOPs over the mean step time of the window's
    (unprofiled) steps times ``PEAKS[peak]``, in percent."""
    step_s = run.window_s / run.steps
    return 100.0 * run.session.step_flops() / (step_s * work.PEAKS[peak])


def tilefusion_roofline(run) -> float | None:
    """For each tile-fusion call of a step (the family's ``scoped_work``,
    counted once whatever arm or recompute runs), the least time at the
    TF32 peak and the HBM bandwidth, summed over the traced steps, over
    the device time of the kernels launched inside the op's scopes, in
    percent; nothing without a trace or a scoped kernel."""
    if run.trace is None:
        return None
    device_s = run.trace.device_s_in_scopes(trace.TILE_FUSION_SCOPES)
    if device_s <= 0:
        return None
    least = sum(w.least_s(work.PEAKS["tf32_flops"])
                for w in run.session.scoped_work())
    return 100.0 * least * run.trace.n_steps / device_s


def device_idle(run) -> float | None:
    """One less the device's busy time a traced step (the union of
    kernel, copy and set intervals in the traced window, over its steps)
    over the mean step time of the window's unprofiled steps, in percent.
    The profiler's own host work lengthens the traced steps, so their
    wall is not the step's."""
    if run.trace is None:
        return None
    busy = run.trace.busy_s / run.trace.n_steps
    return 100.0 * (1.0 - busy * run.steps / run.window_s)
