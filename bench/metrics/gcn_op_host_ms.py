"""Host milliseconds a GCN step spends inside the tile-fusion op: the
outermost ``tile_fusion.*`` spans of the program (each layer's forward
call and backward node), summed over a few unprofiled steps run under
``repro_torch.tracing.collect()`` after the window, over the steps."""
from bench import spans


def read(run):
    return spans.op_host_ms(run)
