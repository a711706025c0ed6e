"""Host seconds of the set-up's schedule inspections (each layer's
forward entry and the backward's transpose entries): a host clock around
every ``api.get_schedule`` call that the port's schedule-cache counters
show to be a miss."""


def read(run):
    return run.session.inspect_s
