"""Host milliseconds an LM step spends inside the tile-fusion op: the
outermost ``tile_fusion.*`` spans of the program (the band mixer's calls,
their recompute under remat and their backward nodes), over a few
unprofiled steps run under ``repro_torch.tracing.collect()`` after the
window."""
from bench import spans


def read(run):
    return spans.op_host_ms(run)
