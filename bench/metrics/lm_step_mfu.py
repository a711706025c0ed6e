"""The LM step's share of the card's bf16 peak (989 TFLOP/s), in percent:
the model's FLOPs a step (every matmul and the band product, forward and
backward, recompute not counted), counted by ``bench.work`` from
shapes."""
from bench import shares


def read(run):
    return shares.step_mfu(run, "bf16_flops")
