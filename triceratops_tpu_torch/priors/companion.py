"""Bound-companion and background occurrence priors (torch, per draw).

Counterpart of the JAX package's ``priors/companion.py``: the Moe & Di
Stefano (2017) companion-rate integrals over log-period, truncated by the
contrast-curve-limited maximum separation, exactly as the reference
computes them, including its deliberately zeroed low-period segments (the
TP variant assumes a companion period > 2500 d, so log10 P < 3.4 terms
are dropped; the EB variant assumes a tertiary period > 10 d, so only the
t1 term is dropped). Reference priors.py:580-1005; the M_s and P_orb
priors (priors.py:386-577) are host numpy.

One deliberate departure from the JAX package, toward the reference's
float64: the bound-companion priors evaluate in float64 and return the
draws' dtype (``_upstream_f64``), and log10 of the largest companion
period is computed in logs (``_log10_max_porb``). The JAX package forms
(separation [cm])^3 in float32, which overflows beyond about 0.47 AU, so
its log10 Pmax reads inf and every bound-companion draw takes the
saturated t4 + t5 term. In float32, even in logs, the rounding of log10
Pmax would move ln f_comp by up to ~1e-5 nats where the rate vanishes
(log10 Pmax just above 3.4 for TP, 1 for EB); in float64 the prior is the
reference's to the output's rounding.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..constants import G, MSUN, AU, PI

_INTERP_EPS = float(np.spacing(np.finfo(np.float32).eps))
# log10 Pmax [d] = _LP0 + 1.5 log10(sep [AU]) - 0.5 log10(M [Msun]):
# Kepler's third law in logs, its constant folded once in float64
_LP0 = (0.5 * (math.log10(4 * PI**2 / (G * MSUN)) + 3 * math.log10(AU))
        - math.log10(86400.0))


def separation_at_contrast(delta_mags, separations, contrasts):
    """Limiting separation [arcsec] at the given contrasts: linear
    interpolation of separations over contrasts, constant beyond the ends
    (np.interp / jnp.interp semantics, op for op)."""
    xp, fp = contrasts, separations
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, delta_mags.contiguous(),
                                       right=True), 1, n - 1)
    im1 = torch.remainder(i - 1, n)
    df = fp[i] - fp[im1]
    dx = xp[i] - xp[im1]
    delta = delta_mags - xp[im1]
    dx0 = torch.abs(dx) <= _INTERP_EPS
    f = torch.where(dx0, fp[im1],
                    fp[im1] + (delta / torch.where(dx0, torch.ones_like(dx),
                                                   dx)) * df)
    f = torch.where(delta_mags < xp[0], fp[0], f)
    return torch.where(delta_mags > xp[-1], fp[-1], f)


def _f123(logM):
    f1 = 0.020 + 0.04 * logM + 0.07 * logM**2
    f2 = 0.039 + 0.07 * logM + 0.01 * logM**2
    f3 = 0.078 - 0.05 * logM + 0.04 * logM**2
    return f1, f2, f3


def _fcomp_terms(lp, f1, f2, f3):
    """Per-draw Moe-Di Stefano piecewise terms of lp = log10 Pmax [d]."""
    alpha, dlogP = 0.018, 0.7
    t2_partial = 0.5 * (lp - 1.0) * (2.0 * f1 + (f2 - f1 - alpha * dlogP) * (lp - 1.0))
    t2 = 0.5 * (2.0 - 1.0) * (2.0 * f1 + (f2 - f1 - alpha * dlogP) * (2.0 - 1.0))
    t3_partial = 0.5 * alpha * (lp**2 - 5.4 * lp + 6.8) + f2 * (lp - 2.0)
    t3 = 0.5 * alpha * (3.4**2 - 5.4 * 3.4 + 6.8) + f2 * (3.4 - 2.0)
    t4_partial = (alpha * dlogP * (lp - 3.4) + f2 * (lp - 3.4)
                  + (f3 - f2 - alpha * dlogP)
                  * (0.238095 * lp**2 - 0.952381 * lp + 0.485714))
    t4 = (alpha * dlogP * (5.5 - 3.4) + f2 * (5.5 - 3.4)
          + (f3 - f2 - alpha * dlogP)
          * (0.238095 * 5.5**2 - 0.952381 * 5.5 + 0.485714))
    t5_partial = f3 * (3.33333 - 17.3566 * torch.exp(-0.3 * lp))
    t5 = f3 * (3.33333 - 17.3566 * math.exp(-0.3 * 8.0))
    return t2_partial, t2, t3_partial, t3, t4_partial, t4, t5_partial, t5


def _log10_max_porb(M_eval, plx, delta_mags, separations, contrasts):
    """log10 of the period [d] of a companion at the contrast-limited
    separation, with no intermediate beyond float32's range; a NaN
    parallax reads 0.1 mas."""
    plx = torch.where(torch.isnan(plx), torch.full_like(plx, 0.1), plx)
    seps = (1000.0 / plx) * separation_at_contrast(delta_mags, separations,
                                                   contrasts)
    return _LP0 + 1.5 * torch.log10(seps) - 0.5 * torch.log10(M_eval)


def _upstream_f64(prior):
    """Evaluate a bound-companion prior in float64 and return it in the
    draws' (``delta_mags``') dtype."""
    @functools.wraps(prior)
    def wrapper(M_s, plx, delta_mags, separations, contrasts):
        f64 = functools.partial(torch.as_tensor, dtype=torch.float64,
                                device=delta_mags.device)
        return prior(f64(M_s), f64(plx), f64(delta_mags), f64(separations),
                     f64(contrasts)).to(delta_mags.dtype)
    return wrapper


def _mass_scaled(f_comp, M_s):
    """Hosts below 1 Msun scale the companion rate (priors.py:684-689)."""
    f_small = torch.clamp_min(0.65 * f_comp + 0.35 * f_comp * M_s, 0.0)
    return torch.log(torch.where(M_s >= 1.0, f_comp, f_small))


@_upstream_f64
def lnprior_bound_TP(M_s, plx, delta_mags, separations, contrasts):
    """Bound-companion log-prior, planet variant: segments with
    log10(Pmax) < 3.4 are zeroed and the 3.4-5.5 segment enters without
    the t2 + t3 offset (reference priors.py:659-689). M_s, plx: 0-d
    tensors."""
    M_eval = torch.where(M_s >= 1.0, M_s, torch.ones_like(M_s))
    f1, f2, f3 = _f123(torch.log10(M_eval))
    lp = _log10_max_porb(M_eval, plx, delta_mags, separations, contrasts)
    (_t2p, _t2, _t3p, _t3, t4_partial, t4, t5_partial, t5) = _fcomp_terms(
        lp, f1, f2, f3)
    zero = torch.zeros_like(lp)
    f_comp = torch.where(lp < 3.4, zero,
                         torch.where(lp < 5.5, t4_partial,
                                     torch.where(lp < 8.0, t4 + t5_partial,
                                                 t4 + t5)))
    return _mass_scaled(f_comp, M_s)


@_upstream_f64
def lnprior_bound_EB(M_s, plx, delta_mags, separations, contrasts):
    """Bound-companion log-prior, EB variant: only the t1 term is dropped
    (reference priors.py:861-891)."""
    M_eval = torch.where(M_s >= 1.0, M_s, torch.ones_like(M_s))
    f1, f2, f3 = _f123(torch.log10(M_eval))
    lp = _log10_max_porb(M_eval, plx, delta_mags, separations, contrasts)
    (t2_partial, t2, t3_partial, t3, t4_partial, t4, t5_partial, t5) = (
        _fcomp_terms(lp, f1, f2, f3))
    f_comp = torch.where(
        lp < 1.0, torch.zeros_like(lp),
        torch.where(lp < 2.0, t2_partial,
                    torch.where(lp < 3.4, t2 + t3_partial,
                                torch.where(lp < 5.5, t2 + t3 + t4_partial,
                                            torch.where(lp < 8.0,
                                                        t2 + t3 + t4 + t5_partial,
                                                        t2 + t3 + t4 + t5)))))
    return _mass_scaled(f_comp, M_s)


def lnprior_background(N_comp, delta_mags, separations, contrasts):
    """Background-star log-prior: density of the 0.1 deg^2 TRILEGAL field
    inside the contrast-limited circle (reference priors.py:986-1005)."""
    seps = separation_at_contrast(delta_mags, separations, contrasts)
    return torch.log((N_comp / 0.1) * (1.0 / 3600.0) ** 2 * seps**2)


def clamp_companion_prior(lnprior, delta_mags):
    """The shared clamps: positive log-priors -> 0; companions brighter
    than the host (delta_mag > 0) -> -inf (reference ml.py:488-489)."""
    lnprior = torch.clamp_max(lnprior, 0.0)
    return torch.where(delta_mags > 0.0,
                       torch.full_like(lnprior, -math.inf), lnprior)


def lnprior_Mstar_planet(M_s):
    """Returns 0.0: left out of the evidence for its bias (reference
    priors.py:386-405)."""
    return 0.0


def lnprior_Mstar_binary(M_s):
    """Returns 0.0 (reference priors.py:408-479)."""
    return 0.0


def _piecewise_P_prior(P_orb, P_break, P_min, P_max, p1, p2):
    A = P_break**p1 / P_break**p2
    I1 = (P_break ** (p1 + 1) - P_min ** (p1 + 1)) / (p1 + 1)
    I2 = A * (P_max ** (p2 + 1) - P_break ** (p2 + 1)) / (p2 + 1)
    Norm = 1.0 / (I1 + I2)
    P_orb = min(max(P_orb, P_min + 0.1), P_max - 0.1)
    if P_orb <= P_break - 0.1:
        prob = Norm * ((P_orb + 0.1) ** (p1 + 1) - (P_orb - 0.1) ** (p1 + 1)) / (p1 + 1)
    elif P_orb >= P_break + 0.1:
        prob = Norm * A * ((P_orb + 0.1) ** (p2 + 1) - (P_orb - 0.1) ** (p2 + 1)) / (p2 + 1)
    else:
        i1 = (P_break ** (p1 + 1) - (P_orb - 0.1) ** (p1 + 1)) / (p1 + 1)
        i2 = A * ((P_orb + 0.1) ** (p2 + 1) - P_break ** (p2 + 1)) / (p2 + 1)
        prob = Norm * (i1 + i2)
    return np.log(prob)


def lnprior_Porb_planet(P_orb, flatpriors=False):
    """Planet period prior (reference priors.py:482-536; no call site in
    the evidence path)."""
    if flatpriors:
        P_min, P_max = 0.1, 50.0
        Norm = 1.0 / (P_max - P_min)
        P_orb = min(max(P_orb, P_min + 0.1), P_max - 0.1)
        return np.log(Norm * ((P_orb + 0.1) - (P_orb - 0.1)))
    return _piecewise_P_prior(P_orb, 10.0, 0.1, 50.0, 1.5, 0.0)


def lnprior_Porb_binary(P_orb):
    """Binary period prior (reference priors.py:539-577)."""
    return _piecewise_P_prior(P_orb, 0.3, 0.1, 50.0, 5.0, 0.5)
