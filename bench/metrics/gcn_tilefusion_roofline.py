"""The tile-fusion op's share of its roofline in the GCN step, in
percent: every layer's ``Â·(H·W)`` forward and its backward node, f32
operands at the TF32 peak (``bench.shares.tilefusion_roofline``)."""
from bench import shares


def read(run):
    return shares.tilefusion_roofline(run)
