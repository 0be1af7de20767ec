"""Kepler-equation solver and sky-projected separation (torch,
branch-free). Counterpart of the JAX package's ``core/kepler.py``, with the
same conventions: t0 is the transit epoch (true anomaly pi/2 - w), w the
argument of periastron in radians, and the body is in front when
sin(w + nu) > 0.

Per dtype:

* float32 (device hot path): Markley (1995) cubic starter on the wrapped
  |M| plus ONE staged Householder-4 correction, then a third-order Taylor
  rotation of (sinE, cosE) by the final step.
* float64 (reference accuracy): 8 Newton iterations from the classical
  starter with the cube-root pericenter override.

Callers must use the returned (sinE, cosE) pair, never re-derive it from
the unwrapped E (see the JAX module's consistency caveat).
"""

from __future__ import annotations

import math

import torch

NEWTON_ITERS = 8
E_MAX = 0.995


def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def solve_kepler_sc(M, e):
    """Solve E - e sin E = M; returns (E, sinE, cosE). M is range-reduced
    to [-pi, pi) with a compensated 2pi wrap first."""
    e = torch.clamp(e, 0.0, E_MAX)
    two_pi = 2.0 * math.pi
    k = torch.round(M / two_pi)
    # compensated wrap: 2pi split into a few-mantissa-bit head (k * head is
    # exact in f32) and a tail; kept as two separate subtractions
    Mw = (M - k * 6.28125) - k * 0.001935307179586232
    if torch.result_type(M, e) == torch.float64:
        sinM = torch.sin(Mw)
        cosM = torch.cos(Mw)
        E = Mw + e * sinM + e * e * sinM * cosM
        Ecb = _cbrt(6.0 * Mw / torch.clamp_min(e, 1e-6))
        E = torch.where((torch.abs(Mw) < 0.25) & (e > 0.9), Ecb, E)
        sinE = cosE = dE = None
        for _ in range(NEWTON_ITERS):
            sinE = torch.sin(E)
            cosE = torch.cos(E)
            f = E - e * sinE - Mw
            fp = 1.0 - e * cosE
            dE = -f / fp
            E = E + dE
        sinEf = sinE + dE * (cosE - 0.5 * dE * sinE)
        cosEf = cosE - dE * (sinE + 0.5 * dE * cosE)
        return E + two_pi * k, sinEf, cosEf
    s = torch.sign(Mw)
    Ma = torch.abs(Mw)
    pi = math.pi
    alpha = (3.0 * pi * pi + 1.6 * pi * (pi - Ma) / (1.0 + e)) \
        / (pi * pi - 6.0)
    d = 3.0 * (1.0 - e) + alpha * e
    q = 2.0 * alpha * d * (1.0 - e) - Ma * Ma
    r = 3.0 * alpha * d * (d - 1.0 + e) * Ma + Ma * Ma * Ma
    w_ = _cbrt(torch.abs(r) + torch.sqrt(torch.clamp_min(
        q * q * q + r * r, 0.0))) ** 2
    E = (2.0 * r * w_ / (w_ * w_ + w_ * q + q * q) + Ma) / d
    sinE = torch.sin(E)
    cosE = torch.cos(E)
    f = E - e * sinE - Ma
    fp = 1.0 - e * cosE
    fpp = e * sinE
    fppp = e * cosE
    d1 = -f / fp
    d2 = -f / (fp + 0.5 * d1 * fpp)
    dE = -f / (fp + 0.5 * d2 * fpp + d2 * d2 * fppp * (1.0 / 6.0))
    E = E + dE
    sinEf = sinE + dE * (cosE - 0.5 * dE * (sinE + dE * cosE * (1.0 / 3.0)))
    cosEf = cosE - dE * (sinE + 0.5 * dE * (cosE - dE * sinE * (1.0 / 3.0)))
    return s * E + two_pi * k, s * sinEf, cosEf


def solve_kepler(M, e):
    """Solve E - e sin E = M for E (see solve_kepler_sc)."""
    return solve_kepler_sc(M, e)[0]


def true_anomaly_from_E(E, e):
    """True anomaly of eccentric anomaly E (e clipped to [0, E_MAX])."""
    e = torch.clamp(e, 0.0, E_MAX)
    sq = torch.sqrt((1.0 + e) / (1.0 - e))
    return 2.0 * torch.atan2(sq * torch.sin(E / 2.0), torch.cos(E / 2.0))


def mean_anomaly_at_transit(e, w):
    """Mean anomaly at inferior conjunction (nu = pi/2 - w)."""
    e = torch.clamp(e, 0.0, E_MAX)
    nu_tc = math.pi / 2.0 - w
    E_tc = 2.0 * torch.atan2(
        torch.sqrt(1.0 - e) * torch.sin(nu_tc / 2.0),
        torch.sqrt(1.0 + e) * torch.cos(nu_tc / 2.0),
    )
    return E_tc - e * torch.sin(E_tc)


def z2_taylor(t, t0, P, a_R, inc, e, w):
    """z^2 and its first two time derivatives from ONE Kepler solve, with
    closed-form orbital kinematics. Returns (z2, dz2/dt, d2z2/dt2,
    front)."""
    e = torch.clamp(e, 0.0, E_MAX)
    n = 2.0 * math.pi / P
    M_tc = mean_anomaly_at_transit(e, w)
    M = M_tc + n * (t - t0)
    _, sinE, cosE = solve_kepler_sc(M, e)
    beta = 1.0 - e * cosE
    ome2 = torch.sqrt((1.0 - e) * (1.0 + e))
    r = a_R * beta
    rdot = a_R * e * n * sinE / beta
    rdd = a_R * e * n * n * (cosE * beta - e * sinE * sinE) / (beta * beta * beta)
    nudot = n * ome2 / (beta * beta)
    nudd = -2.0 * e * n * n * ome2 * sinE / (beta * beta * beta * beta)
    inv_beta = 1.0 / beta
    cnu = (cosE - e) * inv_beta
    snu = ome2 * sinE * inv_beta
    sw = torch.sin(w)
    cw = torch.cos(w)
    su = sw * cnu + cw * snu
    cu = cw * cnu - sw * snu
    S = torch.sin(inc) ** 2
    C = torch.cos(inc) ** 2
    s2u = 2.0 * su * cu
    c2u = 1.0 - 2.0 * su * su
    # 1 - S su^2 as the sum of squares cu^2 + C su^2: the subtraction
    # cancels catastrophically in f32 near mid-transit
    A = cu * cu + C * (su * su)
    z2 = r * r * A
    dz2 = 2.0 * r * rdot * A - r * r * S * s2u * nudot
    d2z2 = (2.0 * (rdot * rdot + r * rdd) * A
            - 4.0 * r * rdot * S * s2u * nudot
            - r * r * S * (2.0 * c2u * nudot * nudot + s2u * nudd))
    return z2, dz2, d2z2, su > 0.0


def projected_z(t, t0, P, a_R, inc, e, w):
    """Sky-projected separation in stellar radii and the in-front mask.
    All orbital arguments are tensors broadcastable against t."""
    e = torch.clamp(e, 0.0, E_MAX)
    M_tc = mean_anomaly_at_transit(e, w)
    M = M_tc + 2.0 * math.pi * (t - t0) / P
    _, sinE, cosE = solve_kepler_sc(M, e)
    beta = 1.0 - e * cosE
    inv_beta = 1.0 / beta
    cnu = (cosE - e) * inv_beta
    snu = torch.sqrt((1.0 - e) * (1.0 + e)) * sinE * inv_beta
    sw = torch.sin(w)
    cw = torch.cos(w)
    swnu = sw * cnu + cw * snu
    cwnu = cw * cnu - sw * snu
    z = a_R * beta * torch.sqrt(
        cwnu * cwnu + torch.cos(inc) ** 2 * (swnu * swnu))
    return z, swnu > 0.0
