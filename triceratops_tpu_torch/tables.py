"""The numeric tables the computation is parametrized by.

This system has no learned weights; its parameters are tables derived
from the repository's packaged data and from scipy:

* the k-tabulated Chebyshev basis (``cheb_k_tables.npz``: breaks, kinds,
  degrees and the C matrix), read from the JAX package's data directory by
  path, never copied;
* the Chebyshev-Gauss DCT matrix and sqrt-map S-nodes of the deficit
  proxy;
* the Beta(0.867, 3.030) PPF Chebyshev coefficients;
* the stellar-relation PPoly breaks and coefficients;
* the limb-darkening grids (``ldc_grids.npz``).

The numpy builders here follow the JAX package's own construction
operation for operation, so the float64 arrays are bit-equal to it.
``load_tables(device, dtype)`` turns them into tensors.
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path

import numpy as np
import torch

DATA_DIR = Path(__file__).resolve().parent.parent / "triceratops_tpu" / "data"
CHEB_K_TABLES = DATA_DIR / "cheb_k_tables.npz"
LDC_GRIDS = DATA_DIR / "ldc_grids.npz"

M_CHEB = 18

# Beta(0.867, 3.030) PPF: two Chebyshev segments in the cusp-absorbing
# variables v = u^{1/a} (u <= split) and w = (1-u)^{1/b} (u > split)
BETA_A, BETA_B = 0.867, 3.030
BETA_USPLIT = 0.9
BETA_M = 16

# Stellar relation node tables (reference funcs.py:19-51, 81-119)
MASS_NODES_TORRES = np.array([
    0.26, 0.47, 0.59, 0.69, 0.87, 0.98, 1.085,
    1.4, 1.65, 2.0, 2.5, 3.0, 4.4, 15.0, 40.0])
TEFF_NODES_TORRES = np.array([
    3170, 3520, 3840, 4410, 5150, 5560, 5940, 6650,
    7300, 8180, 9790, 11400, 15200, 30000, 42000])
RAD_NODES_TORRES = np.array([
    0.28, 0.47, 0.60, 0.72, 0.9, 1.05, 1.2, 1.55,
    1.8, 2.1, 2.4, 2.6, 3.0, 6.2, 11.0])
MASS_NODES_CDWRF = np.array([0.1, 0.135, 0.2, 0.35, 0.48, 0.58, 0.63])
TEFF_NODES_CDWRF = np.array([2800, 3000, 3200, 3400, 3600, 3800, 4000])
RAD_NODES_CDWRF = np.array([0.12, 0.165, 0.23, 0.36, 0.48, 0.585, 0.6])

FLUX_NODES = {
    "TESS": (np.array([0.1, 0.15, 0.23, 0.4, 0.58, 0.7, 0.9, 1.15, 1.45, 2.2, 2.8]),
             np.array([-3, -2.5, -2, -1.5, -1, -0.5, 0, 0.5, 1, 1.5, 2], dtype=float)),
    "J": (np.array([0.1, 0.2, 0.5, 0.75, 1.0, 1.5, 2.0, 2.5, 3]),
          np.array([-5.7, -3.8, -1.6, 0, 1.2, 2.9, 3.3, 4, 6]) / 2.5),
    "H": (np.array([0.1, 0.23, 0.5, 0.75, 1.0, 1.5, 2.0, 2.5, 3]),
          np.array([-4.9, -2.8, -0.9, 0.6, 1.5, 3, 3.3, 4, 6]) / 2.5),
    "K": (np.array([0.1, 0.2, 0.35, 0.5, 0.75, 1.0, 1.5, 2.0, 2.5, 3]),
          np.array([-4.7, -2.9, -1.7, -0.7, 0.6, 1.6, 3, 3.3, 4, 6]) / 2.5),
}
SPLINE_NAMES = ("torres_teff", "torres_rad", "cdwrf_teff", "cdwrf_rad",
                "TESS", "J", "H", "K")


@lru_cache(maxsize=None)
def cheb_k_tables():
    """(breaks (9,), kinds (8,), degs (8,), C (sum_degs, 162)) float64."""
    with np.load(CHEB_K_TABLES) as z:
        return z["breaks"], z["kinds"], z["degs"], z["C"]


@lru_cache(maxsize=None)
def dct_nodes():
    """(DCT^T (M, M), S-nodes (M,)): Chebyshev-Gauss DCT-II rows (c_0
    halved) and the node positions in the segment coordinate s, the
    inverse of the sqrt map x = sqrt(s) - sqrt(1-s)."""
    theta = (np.arange(M_CHEB) + 0.5) * np.pi / M_CHEB
    cheb_x = np.cos(theta)
    dct = (2.0 / M_CHEB) * np.cos(np.outer(np.arange(M_CHEB), theta))
    dct[0] *= 0.5
    dct_t = np.ascontiguousarray(dct.T)
    s_nodes = (((cheb_x + np.sqrt(2.0 - cheb_x**2)) / 2.0) ** 2)
    return dct_t, s_nodes


@lru_cache(maxsize=None)
def beta_ppf_cheb():
    """(cL, cH, vmax, wmax): Chebyshev series of the Beta PPF's two
    segments and their variable ranges."""
    from scipy.stats import beta as _beta

    theta = (np.arange(BETA_M) + 0.5) * np.pi / BETA_M
    xn = np.cos(theta)
    dct = (2.0 / BETA_M) * np.cos(np.outer(np.arange(BETA_M), theta))
    dct[0] *= 0.5
    vmax = BETA_USPLIT ** (1.0 / BETA_A)
    v = 0.5 * vmax * (xn + 1.0)
    cL = dct @ (_beta.ppf(v**BETA_A, BETA_A, BETA_B) / v)
    wmax = (1.0 - BETA_USPLIT) ** (1.0 / BETA_B)
    w = 0.5 * wmax * (xn + 1.0)
    cH = dct @ ((1.0 - _beta.ppf(1.0 - w**BETA_B, BETA_A, BETA_B)) / w)
    return cL, cH, vmax, wmax


@lru_cache(maxsize=None)
def spline(name: str):
    """The scipy cubic interpolating spline of one named relation (the
    host evaluation of the reference, funcs.py:54-140)."""
    from scipy.interpolate import InterpolatedUnivariateSpline

    nodes = {
        "torres_teff": (MASS_NODES_TORRES, TEFF_NODES_TORRES),
        "torres_rad": (MASS_NODES_TORRES, RAD_NODES_TORRES),
        "cdwrf_teff": (MASS_NODES_CDWRF, TEFF_NODES_CDWRF),
        "cdwrf_rad": (MASS_NODES_CDWRF, RAD_NODES_CDWRF),
    }
    x, y = nodes[name] if name in nodes else FLUX_NODES[name]
    return InterpolatedUnivariateSpline(x, y)


@lru_cache(maxsize=None)
def ppoly_arrays(name: str):
    """(breaks (n,), coefs (4, n-1)) float64 of the cubic interpolating
    spline of one named relation."""
    from scipy.interpolate import PPoly

    pp = PPoly.from_spline(spline(name)._eval_args, extrapolate=True)
    return (np.asarray(pp.x, dtype=np.float64),
            np.asarray(pp.c, dtype=np.float64))


@lru_cache(maxsize=None)
def ldc_grids(mission: str):
    """Quadratic limb-darkening grid columns (Z, Teff, logg, u1, u2)."""
    mission = "tess" if mission.upper() == "TESS" else "kepler"
    with np.load(LDC_GRIDS) as z:
        return {name: z[f"{mission}_{name}"]
                for name in ("Z", "Teff", "logg", "u1", "u2")}


@lru_cache(maxsize=None)
def load_tables(device="cuda", dtype=torch.float32):
    """Every device-side table as tensors of ``dtype`` on ``device``.

    Keys: ``tab_C`` (sum_degs, 162); ``dct_T`` (18, 18); ``s_nodes``
    (18,); ``beta_cL`` / ``beta_cH`` (16,); ``ppoly/<name>`` (breaks,
    coefs) per spline name. A cast of the float64 arrays, so float64
    tables equal the JAX package's bit for bit."""
    device = torch.device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                               device=device)

    dct_t, s_nodes = dct_nodes()
    cL, cH, _, _ = beta_ppf_cheb()
    out = {"tab_C": t(cheb_k_tables()[3]), "dct_T": t(dct_t),
           "s_nodes": t(s_nodes), "beta_cL": t(cL), "beta_cH": t(cH)}
    for name in SPLINE_NAMES:
        breaks, coefs = ppoly_arrays(name)
        out[f"ppoly/{name}"] = (t(breaks), t(coefs))
    return out
