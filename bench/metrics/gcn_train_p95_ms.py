"""The 95th percentile of every step of the window, milliseconds on the
host clock around the step and its loss read: the slow epochs a training
user waits on."""
import numpy as np


def read(run):
    return float(np.percentile(run.step_s, 95)) * 1e3
