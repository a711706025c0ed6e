"""The share of the traced LM steps' device-idle time that falls under
the tile-fusion op, in percent: idle gaps whose midpoint lies inside an
open ``tile_fusion.*`` span of the program on any host thread."""
from bench import spans


def read(run):
    return None if run.trace is None else spans.idle_share(run.trace)
