"""The band mixer's tile-fusion op's share of its roofline in the LM
step, in percent: each layer's and batch row's ``A·(X·Wv)`` forward and
its backward node, f32 operands at the TF32 peak
(``bench.shares.tilefusion_roofline``)."""
from bench import shares


def read(run):
    return shares.tilefusion_roofline(run)
