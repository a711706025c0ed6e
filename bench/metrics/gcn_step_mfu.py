"""The GCN step's share of the card's TF32 peak (495 TFLOP/s, the fastest
rate of any path that takes f32 inputs), in percent: the model's FLOPs a
step (every layer's two products forward, their gradient products
backward), counted by ``bench.work`` from shapes and nonzeros."""
from bench import shares


def read(run):
    return shares.step_mfu(run, "tf32_flops")
