"""90th percentile of the walls of all calls of the window (host clock;
numpy's linear interpolation)."""

import numpy as np


def read(rec):
    walls = [b - a for a, b in zip(rec.starts, rec.ends)]
    return float(np.percentile(walls, 90)) if walls else None
