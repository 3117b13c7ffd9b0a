"""The sharing strategy's step alone on the engine's state after the
window, for the round after the last one run (its key, its overlay), on
a host clock between device synchronisations: the median of three."""

import statistics

from portbench import common


def read(run):
    step = getattr(run.cell, "share_step", None)
    if step is None:
        return None
    return statistics.median(common.wall_ms(step(), run.device, reps=3))
