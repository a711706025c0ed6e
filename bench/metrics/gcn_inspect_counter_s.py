"""Seconds of schedule inspection by the program's own count: the
schedule cache's ``inspect_s`` (each entry's build, ``inspector_s``,
summed where the cache counts a miss) at the end of the run.  It leaves
out the lookup, the CSR digest and the transpose that ``gcn_inspect_s``'s
clock around ``get_schedule`` also holds."""


def read(run):
    from repro_torch.core.tilefusion import api
    return api.schedule_cache_stats().get("inspect_s")
