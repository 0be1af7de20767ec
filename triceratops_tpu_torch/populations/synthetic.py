"""Physically consistent synthetic TRILEGAL-style populations (numpy).

Counterpart of the JAX package's ``populations/synthetic.py``: an offline
stand-in for the TRILEGAL galactic-population service, for tests,
``chip_smoke.py`` and examples. The stars lie on the mass -> (radius,
Teff, flux) relations the scenario models assume (evaluated on the host
with the reference's scipy splines), so the background-host scenarios
(BTP/BEB) see no unphysical hosts. Columns mirror a saved TRILEGAL csv so
``funcs.trilegal_results`` parses it unchanged.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from ..constants import G, MSUN, RSUN
from ..tables import spline

# Sun's apparent TESS magnitude at 10 pc ~ absolute magnitude anchor
_M_SUN_T = 4.63


def _relations(mass):
    """Unclamped-above radii and Teffs (reference funcs.py:54-79 with
    infinite caps)."""
    hot = mass > 0.63
    radius = np.where(hot, spline("torres_rad")(mass),
                      spline("cdwrf_rad")(mass))
    teff = np.where(hot, spline("torres_teff")(mass),
                    spline("cdwrf_teff")(mass))
    return np.maximum(radius, 0.1), np.maximum(teff, 2800.0)


def _flux(mass, filt="TESS"):
    """Flux ratio vs a ~1 Msun star (reference funcs.py:121-140)."""
    return 10.0 ** spline(filt)(np.asarray(mass, dtype=float))


def make_synthetic_trilegal(path, Tmag_target: float = 10.0,
                            n_stars: int = 3000, seed: int = 0,
                            mag_limit: float = 21.0) -> str:
    """Write a synthetic background population csv; returns the path.

    Masses follow a rough log-uniform IMF over [0.1, 1.6] Msun; radii and
    Teffs come from the stellar relations; loggs are derived (log g =
    log10 GM/R^2); apparent magnitudes combine the mass-flux relation with
    a volume-weighted distance modulus, keeping stars fainter than the
    target. The same seed gives the same file as the JAX package's
    ``make_synthetic_trilegal``."""
    rng = np.random.default_rng(seed)
    n = int(n_stars * 2.5)
    mass = 10 ** rng.uniform(np.log10(0.1), np.log10(1.6), n)
    radius, teff = _relations(mass)
    logg = np.log10(G * mass * MSUN / (radius * RSUN) ** 2)
    mh = np.clip(rng.normal(-0.1, 0.25, n), -1.0, 0.4)

    def absmag(filt):
        return _M_SUN_T - 2.5 * np.log10(_flux(mass, filt))

    M_T, M_J, M_H, M_K = (absmag(f) for f in ("TESS", "J", "H", "K"))
    # volume-weighted distance modulus in [6, 16]
    u = rng.uniform(0, 1, n)
    mu = (6 ** 3 + u * (16 ** 3 - 6 ** 3)) ** (1 / 3)
    tmag = M_T + mu
    keep = (tmag >= Tmag_target) & (tmag <= mag_limit)
    idx = np.flatnonzero(keep)[:n_stars]
    if idx.size < n_stars:  # top up with faint stars if the cut was harsh
        extra = np.flatnonzero(~keep)[: n_stars - idx.size]
        idx = np.concatenate([idx, extra])
    m = len(idx) + 2  # +2 rows dropped by the parser (termination banner)
    sel = np.concatenate([idx, idx[:2]])
    df = pd.DataFrame({
        "Gc": np.ones(m, int),
        "logAge": np.full(m, 9.3),
        "[M/H]": mh[sel],
        "m_ini": mass[sel],
        "Mact": mass[sel],
        "logL": np.log10(np.maximum(_flux(mass[sel]), 1e-6)),
        "logTe": np.log10(teff[sel]),
        "logg": logg[sel],
        "m-M0": mu[sel],
        "Av": np.zeros(m),
        "TESS": (M_T + mu)[sel],
        "J": (M_J + mu)[sel],
        "H": (M_H + mu)[sel],
        "Ks": (M_K + mu)[sel],
    })
    df.to_csv(path)
    return str(path)
