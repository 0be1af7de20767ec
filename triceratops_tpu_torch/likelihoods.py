"""Photometric forward models and chi^2 likelihoods (public API).

Counterpart of the JAX package's ``likelihoods.py`` (reference
triceratops/likelihoods.py:27-587): scalar and batch ("_p")
transiting-planet and eclipsing-binary light-curve simulators and their
log-likelihoods. The light curves are computed on ``device`` (default
"cuda") in float64, through the exact Kepler solve and occultation kernel
(``core/kepler.projected_z``, ``ops/occult.occult_quad_deficit``); inputs
and outputs are numpy arrays. Conventions kept from the reference:

* w = (90 - argp) deg, t0 = 0 at mid-transit;
* the EB secondary-eclipse depth from the fixed 25-point grid
  linspace(-0.05, 0.05, 25) with argp - 180 deg and k -> 1/k;
* the near-unity radius-ratio adjustment: every k < 1 + 1e-6 is scaled
  by 0.999 (likelihoods.py:405-406);
* ``lnL_*`` return +0.5 chi^2 (positive; callers negate it);
* the EB secondary veto: lnL = +inf when the diluted secondary depth is
  at least 1.5 sigma.
"""

from __future__ import annotations

import numpy as np
import torch

from .constants import RSUN, REARTH
from .core.kepler import projected_z
from .ops.occult import occult_quad_deficit
from .ops.lightcurve import (
    SEC_GRID, supersample_times, tp_dilution, eb_dilution)

# rows x supersampled points per device step: bounds the (rows, n_ss, 16)
# float64 quadrature tensors of the occultation kernel to ~0.5 GiB each
_POINTS_PER_STEP = 1 << 22


def _deficit_curve(t_ss, k, P_orb, a_R, inc_rad, e, w_rad, u1, u2, n_t, ns):
    """Mean-over-supersamples deficit (rows, n_t) of a batch of parameter
    rows, all float64 tensors on one device."""
    z, front = projected_z(t_ss[None, :], 0.0, P_orb[:, None], a_R[:, None],
                           inc_rad[:, None], e[:, None], w_rad[:, None])
    D = occult_quad_deficit(k[:, None], z, u1[:, None], u2[:, None])
    D = torch.where(front, D, torch.zeros_like(D))
    if ns > 1:
        D = D.reshape(D.shape[0], n_t, ns).mean(dim=2)
    return D


def _atleast1(*xs):
    return [np.atleast_1d(np.asarray(x, dtype=np.float64)) for x in xs]


def _host_deficit(time, k, P_orb, a_R, inc_deg, ecc, argp_deg, u1, u2,
                  exptime, nsamples, device):
    """(rows, n_t) numpy deficit of the broadcast parameter rows, computed
    on ``device`` in row blocks of ``_POINTS_PER_STEP`` points."""
    k, P_orb, a_R, inc_deg, ecc, argp_deg, u1, u2 = _atleast1(
        k, P_orb, a_R, inc_deg, ecc, argp_deg, u1, u2)
    n = max(map(len, (k, P_orb, a_R, inc_deg, ecc, argp_deg, u1, u2)))
    rows = np.stack([np.broadcast_to(a, (n,)) for a in (
        k, P_orb, a_R, np.deg2rad(inc_deg), ecc, np.deg2rad(90.0 - argp_deg),
        u1, u2)])
    t_ss = supersample_times(np.asarray(time, float), exptime, nsamples)
    n_t = len(np.atleast_1d(time))
    t_dev = torch.as_tensor(t_ss, dtype=torch.float64, device=device)
    rows_dev = torch.as_tensor(rows, dtype=torch.float64, device=device)
    step = max(1, _POINTS_PER_STEP // len(t_ss))
    out = [_deficit_curve(t_dev, *rows_dev[:, i:i + step], n_t, nsamples)
           for i in range(0, n, step)]
    return torch.cat(out).cpu().numpy()


def simulate_TP_transit(time, R_p, P_orb, inc, a, R_s, u1, u2, ecc, argp,
                        companion_fluxratio: float = 0.0,
                        companion_is_host: bool = False,
                        exptime: float = 0.00139, nsamples: int = 20,
                        device="cuda"):
    """Transiting-planet light curve (reference likelihoods.py:27-80).
    ``a`` in cm, ``R_s`` in Rsun, ``R_p`` in Rearth, angles in degrees."""
    F_comp = companion_fluxratio / (1 - companion_fluxratio)
    D = _host_deficit(time, R_p * REARTH / (R_s * RSUN), P_orb,
                      a / (R_s * RSUN), inc, ecc, argp, u1, u2,
                      exptime, nsamples, device)[0]
    return 1.0 - D * tp_dilution(F_comp, companion_is_host)


def _eb_k(k):
    """Radius ratios with the near-unity adjustment (k - 1 < 1e-6 is
    scaled by 0.999)."""
    k = np.atleast_1d(np.asarray(k, float)).copy()
    k[(k - 1.0) < 1e-6] *= 0.999
    return k


def simulate_EB_transit(time, R_EB, EB_fluxratio, P_orb, inc, a, R_s, u1,
                        u2, ecc, argp, companion_fluxratio: float = 0.0,
                        companion_is_host: bool = False,
                        exptime: float = 0.00139, nsamples: int = 20,
                        device="cuda"):
    """Eclipsing-binary light curve and secondary-eclipse depth
    (reference likelihoods.py:83-160)."""
    F_comp = companion_fluxratio / (1 - companion_fluxratio)
    F_EB = EB_fluxratio / (1 - EB_fluxratio)
    k = _eb_k(np.asarray(R_EB, float) / np.asarray(R_s, float))[0]
    a_R = a / (R_s * RSUN)
    D = _host_deficit(time, k, P_orb, a_R, inc, ecc, argp, u1, u2,
                      exptime, nsamples, device)[0]
    D_sec = _host_deficit(SEC_GRID, 1.0 / k, P_orb, a_R, inc, ecc,
                          argp - 180.0, u1, u2, 0.0, 1, device)[0]
    g_pri, g_sec = eb_dilution(F_EB, F_comp, companion_is_host)
    return 1.0 - D * g_pri, np.max(D_sec) * g_sec


def _chi2_half(flux, model, sigma, axis=None):
    return 0.5 * np.sum((np.asarray(flux) - model) ** 2 / sigma**2,
                        axis=axis)


def lnL_TP(time, flux, sigma, R_p, P_orb, inc, a, R_s, u1, u2, ecc, argp,
           companion_fluxratio: float = 0.0, companion_is_host: bool = False,
           exptime: float = 0.00139, nsamples: int = 20, device="cuda"):
    """+0.5 chi^2 of the TP model (reference likelihoods.py:164-204)."""
    model = simulate_TP_transit(time, R_p, P_orb, inc, a, R_s, u1, u2, ecc,
                                argp, companion_fluxratio, companion_is_host,
                                exptime, nsamples, device)
    return _chi2_half(flux, model, sigma)


def lnL_EB(time, flux, sigma, R_EB, EB_fluxratio, P_orb, inc, a, R_s, u1,
           u2, ecc, argp, companion_fluxratio: float = 0.0,
           companion_is_host: bool = False, exptime: float = 0.00139,
           nsamples: int = 20, device="cuda"):
    """+0.5 chi^2 with the secondary veto (reference
    likelihoods.py:207-253)."""
    model, secdepth = simulate_EB_transit(
        time, R_EB, EB_fluxratio, P_orb, inc, a, R_s, u1, u2, ecc, argp,
        companion_fluxratio, companion_is_host, exptime, nsamples, device)
    if secdepth < 1.5 * sigma:
        return _chi2_half(flux, model, sigma)
    return np.inf


def lnL_EB_twin(time, flux, sigma, R_EB, EB_fluxratio, P_orb, inc, a, R_s,
                u1, u2, ecc, argp, companion_fluxratio: float = 0.0,
                companion_is_host: bool = False, exptime: float = 0.00139,
                nsamples: int = 20, device="cuda"):
    """Twin variant: no secondary veto (reference likelihoods.py:256-299)."""
    model, _ = simulate_EB_transit(
        time, R_EB, EB_fluxratio, P_orb, inc, a, R_s, u1, u2, ecc, argp,
        companion_fluxratio, companion_is_host, exptime, nsamples, device)
    return _chi2_half(flux, model, sigma)


# ---------------------------------------------------------------------------
# Batch variants (reference likelihoods.py:302-587): one row per draw
# ---------------------------------------------------------------------------

def _F(fluxratio):
    fr = np.asarray(fluxratio, float)
    return (fr / (1 - fr))[:, None]


def simulate_TP_transit_p(time, R_p, P_orb, inc, a, R_s, u1, u2, ecc, argp,
                          companion_fluxratio, companion_is_host=False,
                          exptime: float = 0.00139, nsamples: int = 20,
                          device="cuda"):
    """Batched TP light curves, (rows, n_t) (reference
    likelihoods.py:302-358)."""
    F_comp = _F(companion_fluxratio)
    R_s = np.asarray(R_s)
    D = _host_deficit(time, np.asarray(R_p) * REARTH / (R_s * RSUN), P_orb,
                      np.asarray(a) / (R_s * RSUN), inc, ecc, argp, u1, u2,
                      exptime, nsamples, device)
    return 1.0 - D * tp_dilution(F_comp, companion_is_host)


def simulate_EB_transit_p(time, R_EB, EB_fluxratio, P_orb, inc, a, R_s, u1,
                          u2, ecc, argp, companion_fluxratio,
                          companion_is_host=False, exptime: float = 0.00139,
                          nsamples: int = 20, device="cuda"):
    """Batched EB light curves (rows, n_t) and secondary depths (rows, 1)
    (reference likelihoods.py:361-439)."""
    F_comp = _F(companion_fluxratio)
    F_EB = _F(EB_fluxratio)
    k = _eb_k(np.asarray(R_EB, float) / np.asarray(R_s, float))
    ksec = _eb_k(np.asarray(R_s, float) / np.asarray(R_EB, float))
    a_R = np.asarray(a) / (np.asarray(R_s) * RSUN)
    D = _host_deficit(time, k, P_orb, a_R, inc, ecc, argp, u1, u2,
                      exptime, nsamples, device)
    D_sec = _host_deficit(SEC_GRID, ksec, P_orb, a_R, inc, ecc,
                          np.asarray(argp, float) - 180.0, u1, u2, 0.0, 1,
                          device)
    g_pri, g_sec = eb_dilution(F_EB, F_comp, companion_is_host)
    return 1.0 - D * g_pri, np.max(D_sec, axis=1)[:, None] * g_sec


def lnL_TP_p(time, flux, sigma, R_p, P_orb, inc, a, R_s, u1, u2, ecc, argp,
             companion_fluxratio, companion_is_host=False,
             exptime: float = 0.00139, nsamples: int = 20, device="cuda"):
    """Batched +0.5 chi^2 (reference likelihoods.py:443-487)."""
    model = simulate_TP_transit_p(time, R_p, P_orb, inc, a, R_s, u1, u2,
                                  ecc, argp, companion_fluxratio,
                                  companion_is_host, exptime, nsamples,
                                  device)
    return _chi2_half(flux, model, sigma, axis=1)


def lnL_EB_p(time, flux, sigma, R_EB, EB_fluxratio, P_orb, inc, a, R_s, u1,
             u2, ecc, argp, companion_fluxratio, companion_is_host=False,
             exptime: float = 0.00139, nsamples: int = 20, device="cuda"):
    """Batched EB +0.5 chi^2 with the veto (reference
    likelihoods.py:490-539)."""
    model, secdepth = simulate_EB_transit_p(
        time, R_EB, EB_fluxratio, P_orb, inc, a, R_s, u1, u2, ecc, argp,
        companion_fluxratio, companion_is_host, exptime, nsamples, device)
    lnL = np.zeros(model.shape[0])
    mask = (secdepth < 1.5 * sigma)[:, 0]
    lnL[mask] = _chi2_half(flux, model[mask], sigma, axis=1)
    lnL[~mask] = np.inf
    return lnL


def lnL_EB_twin_p(time, flux, sigma, R_EB, EB_fluxratio, P_orb, inc, a, R_s,
                  u1, u2, ecc, argp, companion_fluxratio,
                  companion_is_host=False, exptime: float = 0.00139,
                  nsamples: int = 20, device="cuda"):
    """Batched twin +0.5 chi^2, no veto (reference likelihoods.py:542-587)."""
    model, _ = simulate_EB_transit_p(
        time, R_EB, EB_fluxratio, P_orb, inc, a, R_s, u1, u2, ecc, argp,
        companion_fluxratio, companion_is_host, exptime, nsamples, device)
    return _chi2_half(flux, model, sigma, axis=1)
