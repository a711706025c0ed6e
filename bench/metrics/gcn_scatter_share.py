"""The fused rows' scatter's share of the tile-fusion op's device time in
the traced GCN steps, in percent: the kernels launched under the
program's ``tile_fusion.scatter`` spans (the zero fill and the
``index_copy_``) over those launched under ``tile_fusion.call`` and
``tile_fusion.backward``."""
from bench import spans


def read(run):
    if run.trace is None:
        return None
    return spans.device_share(run.trace, ("tile_fusion.scatter",),
                              ("tile_fusion.call", "tile_fusion.backward"))
