"""Host-side helpers shared with the frontend and the scenario API
(numpy): flux renormalization, contrast-curve I/O and TRILEGAL parsing.

Counterpart of the JAX package's ``funcs.py`` (reference
triceratops/funcs.py), offline parts only.
"""

import numpy as np
from pandas import read_csv


def renorm_flux(flux, flux_err, star_fluxratio: float):
    """Renormalize a light curve for nearby-star flux contamination
    (reference funcs.py:164-177)."""
    renormed_flux = (flux - (1 - star_fluxratio)) / star_fluxratio
    renormed_flux_err = flux_err / star_fluxratio
    return renormed_flux, renormed_flux_err


def file_to_contrast_curve(contrast_curve_file: str):
    """(separations [arcsec], |Delta_mag|) from a 2-column csv
    (reference funcs.py:203-219)."""
    data = np.loadtxt(contrast_curve_file, delimiter=",")
    return data.T[0], np.abs(data.T[1])


def separation_at_contrast(delta_mags, separations, contrasts):
    """Limiting separation at contrast via np.interp (reference
    funcs.py:222-238)."""
    return np.interp(delta_mags, contrasts, separations)


def trilegal_results(trilegal_fname: str, Tmag: float):
    """Parse a saved TRILEGAL csv (reference funcs.py:335-403): drop its
    last two lines (the service's termination banner), compute Tmag from
    J - Ks (Stassun et al. 2018) when the TESS column is absent, and keep
    the stars no brighter than the target (Tmags >= Tmag)."""
    df = read_csv(trilegal_fname)[:-2]
    Masses = df["Mact"].values.astype(float)
    loggs = df["logg"].values.astype(float)
    Teffs = 10 ** df["logTe"].values.astype(float)
    Zs = np.array(df["[M/H]"], dtype=float)
    Jmags = df["J"].values.astype(float)
    Hmags = df["H"].values.astype(float)
    Kmags = df["Ks"].values.astype(float)
    if "TESS" in df.columns:
        Tmags = df["TESS"].values.astype(float)
    else:
        jk = Jmags - Kmags
        Tmags = np.where(
            (jk >= -0.1) & (jk <= 0.7),
            Jmags + 1.22163 * jk**3 - 1.74299 * jk**2 + 1.89115 * jk + 0.0563,
            np.where((jk > 0.7) & (jk <= 1.0),
                     Jmags - 269.372 * jk**3 + 668.453 * jk**2
                     - 545.64 * jk + 147.811,
                     np.where(jk < -0.1, Jmags + 0.5, Jmags + 1.75)))
    mask = Tmags >= Tmag
    return (Tmags[mask], Masses[mask], loggs[mask], Teffs[mask], Zs[mask],
            Jmags[mask], Hmags[mask], Kmags[mask])
