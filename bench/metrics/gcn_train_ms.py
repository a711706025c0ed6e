"""Milliseconds a full-batch training step: the whole window over the
steps it completed, each step ending with its loss read on the host."""


def read(run):
    return run.window_s / run.steps * 1e3
