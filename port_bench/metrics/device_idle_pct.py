"""Share of a call's wall in which no device event ran: 1 - (mean union of
the device events' intervals per profiled call) / (median wall of the
same run's unprofiled calls). The profiler's host overhead lengthens the
profiled calls' own walls by half or more, so they are not the base."""

import numpy as np


def read(rec):
    s = rec.summary
    walls = [b - a for a, b in zip(rec.starts, rec.ends)]
    if s is None or not s.device_events or not walls:
        return None
    return 100.0 * (1.0 - s.busy_s / len(s.walls) / float(np.median(walls)))
