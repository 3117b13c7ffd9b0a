"""The device's idle share over the traced chunk: 1 - (the union of its
kernel, copy and set intervals) / the chunk's wall time, taken between
two device synchronisations inside the profiled stretch (the profiler's
start and the collection of its trace left out)."""


def read(run):
    t = run.trace
    if not t.device:
        return None
    return 1.0 - t.busy_s / t.wall_s
