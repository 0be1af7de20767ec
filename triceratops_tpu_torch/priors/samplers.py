"""Inverse-CDF prior samplers: pure functions of uniform draws (torch).

Counterpart of the JAX package's ``priors/samplers.py`` for the planet and
short-period-binary priors (reference priors.py:16-383):

* ``sample_rp``: broken power law in Rp with host-mass-dependent slopes;
* ``sample_inc``: cos-uniform inclination;
* ``sample_ecc``: Beta(0.867, 3.030) for planets through a gather-free
  Chebyshev PPF, Moe & Di Stefano power law for binaries;
* ``sample_w``: uniform argument of periastron in degrees;
* ``sample_q`` / ``q_below_twin_cdf``: Moe & Di Stefano short-period mass
  ratios with twin excess, and P(q < 0.95) under that law;
* ``sample_q_companion``: the long-period companion law of the same
  family (weaker twin excess, steeper slope).
"""

from __future__ import annotations

import math

import torch

from ..tables import BETA_A, BETA_B, BETA_M, BETA_USPLIT, beta_ppf_cheb, load_tables


def _broken3_constants(p1, p2, p3, r_min, r_b1, r_b2, r_max):
    A1 = r_b1**p1 / r_b1**p2
    A2 = r_b2**p2 / r_b2**p3
    I1 = (r_b1 ** (p1 + 1) - r_min ** (p1 + 1)) / (p1 + 1)
    I2 = A1 * (r_b2 ** (p2 + 1) - r_b1 ** (p2 + 1)) / (p2 + 1)
    I3 = A2 * A1 * (r_max ** (p3 + 1) - r_b2 ** (p3 + 1)) / (p3 + 1)
    return A1, A2, I1, I2, I3, 1.0 / (I1 + I2 + I3)


def _broken3_invcdf(x, p1, p2, p3, r_min, r_b1, r_b2, r_max):
    A1, A2, I1, I2, I3, Norm = _broken3_constants(p1, p2, p3, r_min, r_b1,
                                                  r_b2, r_max)
    seg1 = (x / Norm * (p1 + 1) + r_min ** (p1 + 1)) ** (1.0 / (p1 + 1))
    seg2 = ((x / Norm - I1) * (p2 + 1) / A1 + r_b1 ** (p2 + 1)) ** (1.0 / (p2 + 1))
    seg3 = ((x / Norm - I1 - I2) * (p3 + 1) / (A1 * A2)
            + r_b2 ** (p3 + 1)) ** (1.0 / (p3 + 1))
    return torch.where(x <= Norm * I1, seg1,
                       torch.where(x <= Norm * (I1 + I2), seg2, seg3))


def sample_rp(x, M_s, flatpriors: bool = False):
    """Planet radii [Rearth] from uniforms; M_s is a tensor broadcastable
    against x."""
    if flatpriors:
        return x / (1.0 / 19.5) + 0.5
    hot = _broken3_invcdf(x, 0.0, -4.0, -0.5, 0.5, 3.0, 6.0, 20.0)
    cool = _broken3_invcdf(x, 0.0, -7.0, -0.5, 0.5, 3.0, 6.0, 20.0)
    return torch.where(M_s > 0.45, hot, cool)


def sample_inc(x, lower: float = 0.0, upper: float = 90.0):
    """Inclinations [deg], density ~ sin (cos-uniform)."""
    norm = 1.0 / (math.cos(lower * math.pi / 180) - math.cos(upper * math.pi / 180))
    return torch.arccos(math.cos(lower * math.pi / 180) - x / norm) \
        * (180.0 / math.pi)


def sample_w(x):
    """Argument of periastron [deg]."""
    return x * 360.0


def _beta_ppf(u):
    """Beta(0.867, 3.030) quantile, branch-free: a 16-step Clenshaw on the
    cusp-absorbing variable of the active segment."""
    _, _, vmax, wmax = beta_ppf_cheb()
    tabs = load_tables(u.device, u.dtype)
    cL, cH = tabs["beta_cL"], tabs["beta_cH"]
    hi = u > BETA_USPLIT
    u_safe = torch.clamp(u, 0.0, 1.0)
    v = u_safe ** (1.0 / BETA_A)
    w = (1.0 - u_safe) ** (1.0 / BETA_B)
    t = torch.where(hi, w, v)
    xx = torch.where(hi, 2.0 * w / wmax, 2.0 * v / vmax) - 1.0
    b1 = torch.zeros_like(u)
    b2 = torch.zeros_like(u)
    two_x = 2.0 * xx
    for m in range(BETA_M - 1, 0, -1):
        cm = torch.where(hi, cH[m], cL[m])
        b1, b2 = cm + two_x * b1 - b2, b1
    c0 = torch.where(hi, cH[0], cL[0])
    series = c0 + xx * b1 - b2
    return torch.clamp(torch.where(hi, 1.0 - t * series, t * series), 0.0, 1.0)


def sample_ecc(x, planet: bool, P_orb):
    """Eccentricities. planet: Beta(0.867, 3.030) inverse CDF; binary:
    power law with exponent 0.2 if P_orb <= 10 else 0.6. P_orb is a 0-d
    tensor (the mean period)."""
    if planet:
        return _beta_ppf(x)
    exponent = torch.where(P_orb <= 10.0, 1.0 / 0.2, 1.0 / 0.6)
    return x ** exponent


def _q_invcdf_3seg(x, q_min, p1, p2, F_twin):
    """Three-segment broken power law on [q_min, 1] with twin excess
    (reference priors.py:177-244, 286-353)."""
    A1 = (0.3**p1) / (0.3**p2)
    A2 = (1 + F_twin / (1 - F_twin)
          * ((1.0 ** (p2 + 1) - 0.3 ** (p2 + 1)) / (p2 + 1))
          / ((1.0 ** (p2 + 1) - 0.95 ** (p2 + 1)) / (p2 + 1)))
    I1 = (0.3 ** (p1 + 1) - q_min ** (p1 + 1)) / (p1 + 1)
    I2 = A1 * (0.95 ** (p2 + 1) - 0.3 ** (p2 + 1)) / (p2 + 1)
    I3 = A2 * A1 * (1.0 ** (p2 + 1) - 0.95 ** (p2 + 1)) / (p2 + 1)
    Norm = 1.0 / (I1 + I2 + I3)
    seg1 = (x / Norm * (p1 + 1) + q_min ** (p1 + 1)) ** (1.0 / (p1 + 1))
    seg2 = ((x / Norm - I1) * (p2 + 1) / A1 + 0.3 ** (p2 + 1)) ** (1.0 / (p2 + 1))
    seg3 = ((x / Norm - I1 - I2) * (p2 + 1) / (A1 * A2)
            + 0.95 ** (p2 + 1)) ** (1.0 / (p2 + 1))
    return torch.where(x <= Norm * I1, seg1,
                       torch.where(x <= Norm * (I1 + I2), seg2, seg3))


def _q_invcdf_2seg(x, q_min, p2, F_twin):
    """Two-segment variant for 0.1 < M_s < 0.3 (reference
    priors.py:245-271, 354-380)."""
    A2 = (1 + F_twin / (1 - F_twin)
          * ((1.0 ** (p2 + 1) - q_min ** (p2 + 1)) / (p2 + 1))
          / ((1.0 ** (p2 + 1) - 0.95 ** (p2 + 1)) / (p2 + 1)))
    I2 = (0.95 ** (p2 + 1) - q_min ** (p2 + 1)) / (p2 + 1)
    I3 = A2 * (1.0 ** (p2 + 1) - 0.95 ** (p2 + 1)) / (p2 + 1)
    Norm = 1.0 / (I2 + I3)
    seg2 = (x / Norm * (p2 + 1) + q_min ** (p2 + 1)) ** (1.0 / (p2 + 1))
    seg3 = ((x / Norm - I2) * (p2 + 1) / A2 + 0.95 ** (p2 + 1)) ** (1.0 / (p2 + 1))
    return torch.where(x <= Norm * I2, seg2, seg3)


def _sample_q_generic(x, M_s, p1, p2, F_twin):
    q_min = 0.1 / torch.clamp_min(M_s, 1e-6)
    big = _q_invcdf_3seg(x, 0.1, p1, p2, F_twin)
    # 0.3 <= M_s < 1: q_min = 0.1/M_s unclipped, as the reference keeps the
    # 3-segment formula; the clamp only avoids NaN on inactive lanes
    mid = _q_invcdf_3seg(x, torch.clamp_max(q_min, 0.999), p1, p2, F_twin)
    small = _q_invcdf_2seg(x, torch.clamp_max(q_min, 0.999), p2, F_twin)
    out = torch.where(M_s >= 1.0, big, torch.where(M_s >= 0.3, mid, small))
    return torch.where(M_s <= 0.1, torch.ones_like(x), out)


def _q_cdf95_3seg(q_min, p1, p2, F_twin):
    """P(q < 0.95) for the 3-segment law."""
    A1 = (0.3**p1) / (0.3**p2)
    A2 = (1 + F_twin / (1 - F_twin)
          * ((1.0 ** (p2 + 1) - 0.3 ** (p2 + 1)) / (p2 + 1))
          / ((1.0 ** (p2 + 1) - 0.95 ** (p2 + 1)) / (p2 + 1)))
    I1 = (0.3 ** (p1 + 1) - q_min ** (p1 + 1)) / (p1 + 1)
    I2 = A1 * (0.95 ** (p2 + 1) - 0.3 ** (p2 + 1)) / (p2 + 1)
    I3 = A2 * A1 * (1.0 ** (p2 + 1) - 0.95 ** (p2 + 1)) / (p2 + 1)
    return (I1 + I2) / (I1 + I2 + I3)


def _q_cdf95_2seg(q_min, p2, F_twin):
    A2 = (1 + F_twin / (1 - F_twin)
          * ((1.0 ** (p2 + 1) - q_min ** (p2 + 1)) / (p2 + 1))
          / ((1.0 ** (p2 + 1) - 0.95 ** (p2 + 1)) / (p2 + 1)))
    I2 = (0.95 ** (p2 + 1) - q_min ** (p2 + 1)) / (p2 + 1)
    I3 = A2 * (1.0 ** (p2 + 1) - 0.95 ** (p2 + 1)) / (p2 + 1)
    return I2 / (I2 + I3)


def q_below_twin_cdf(M_s, p1=0.3, p2=-0.5, F_twin=0.30):
    """P(q < 0.95) under ``sample_q``'s law: the twin band's complement
    mass, for the conditioned EBx2P draws. M_s is a float tensor."""
    q_min = 0.1 / torch.clamp_min(M_s, 1e-6)
    big = torch.full_like(M_s, _q_cdf95_3seg(0.1, p1, p2, F_twin))
    mid = _q_cdf95_3seg(torch.clamp_max(q_min, 0.999), p1, p2, F_twin)
    small = _q_cdf95_2seg(torch.clamp_max(q_min, 0.999), p2, F_twin)
    out = torch.where(M_s >= 1.0, big, torch.where(M_s >= 0.3, mid, small))
    return torch.where(M_s <= 0.1, torch.zeros_like(out), out)


def sample_q(x, M_s):
    """Short-period binary mass ratios (F_twin = 0.30, p2 = -0.5)."""
    return _sample_q_generic(x, M_s, 0.3, -0.5, 0.30)


def sample_q_companion(x, M_s):
    """Long-period companion mass ratios (F_twin = 0.05, p2 = -0.95)."""
    return _sample_q_generic(x, M_s, 0.3, -0.95, 0.05)
