"""Limb-darkening coefficient lookup for the target star (host numpy).

Counterpart of the JAX package's ``populations/ldc.py::lookup_target``: the
quadratic LDC grids (Claret 2017 TESS / Claret & Bloemen 2011 Kepler) are
read from the JAX package's ``data/ldc_grids.npz`` by path.
"""

from __future__ import annotations

import numpy as np

from ..tables import ldc_grids


def lookup_target(Z: float, Teff: float, logg: float, mission: str = "TESS"):
    """Target-star (u1, u2): independent nearest Z, Teff and logg, then the
    unique row matching all three (reference
    marginal_likelihoods.py:90-98)."""
    g = ldc_grids(mission)
    this_Z = g["Z"][np.argmin(np.abs(g["Z"] - Z))]
    this_Teff = g["Teff"][np.argmin(np.abs(g["Teff"] - Teff))]
    this_logg = g["logg"][np.argmin(np.abs(g["logg"] - logg))]
    mask = (g["Z"] == this_Z) & (g["Teff"] == this_Teff) & (g["logg"] == this_logg)
    idx = np.flatnonzero(mask)
    if idx.size != 1:
        raise ValueError(
            f"LDC lookup for Z={Z}, Teff={Teff}, logg={logg} matched "
            f"{idx.size} rows (expected 1)."
        )
    return float(g["u1"][idx[0]]), float(g["u2"][idx[0]])
