"""MOLUSC companion-posterior ingestion (host numpy).

Counterpart of the JAX package's ``populations/molusc.py``. An external
binary-population posterior replaces the analytic ``sample_q_companion``
draw in the P*/S* scenarios (reference marginal_likelihoods.py:455-464):
keep rows with periastron a(1-e) > 10 AU, floor mass ratios at 0.1/M_s,
zero-pad to N. The padded entries are masked out later (qs_comp != 0)
but still count in the Monte-Carlo denominator, so kept/N carries the
companion-frequency weight.
"""

from __future__ import annotations

import numpy as np
from pandas import read_csv

from ..utils import profiling


def load_molusc_kept(molusc_file: str, M_s: float) -> np.ndarray:
    """Surviving companion mass ratios (un-padded), with the reference's
    periastron cut and mass-ratio floor (ml.py:455-464). Counts
    ``io.molusc_read``."""
    profiling.count("io.molusc_read")
    df = read_csv(molusc_file)
    a = df["semi-major axis(AU)"].values
    e = df["eccentricity"].values
    q = df[a * (1 - e) > 10]["mass ratio"].values.copy()
    q[q < 0.1 / M_s] = 0.1 / M_s
    return q


def load_molusc_qs(molusc_file: str, M_s: float, N: int) -> np.ndarray:
    """The kept mass ratios zero-padded to N draws."""
    q = load_molusc_kept(molusc_file, M_s)
    if len(q) > N:
        raise ValueError(
            f"MOLUSC file keeps {len(q)} rows > N={N} draws; increase N "
            "(the reference zero-pads the kept rows to N)")
    return np.pad(q, (0, N - len(q)))
