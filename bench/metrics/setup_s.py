"""Set-up seconds: from the start of the run's process to the first
timed step (imports, the kernel library, inputs and weights from the
seed, the schedule inspections, the checked and warm-up steps)."""


def read(run):
    return run.setup_s
