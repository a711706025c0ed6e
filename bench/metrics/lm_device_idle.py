"""The device's idle share of a step, in percent
(``bench.shares.device_idle``: the traced steps' busy time against the
unprofiled steps' mean time)."""
from bench import shares


def read(run):
    return shares.device_idle(run)
