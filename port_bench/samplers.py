"""Plain reference of the scenario samplers and their priors, from the
uniforms the program drew: what each scenario's draws and log weights
must be, in plain torch (float64 for the reference, bfloat16 for the
control), importing nothing of the program.

The Monte-Carlo state the reference starts from is the program's random
numbers: each sampler's uniform streams and drawn star indices, taken at
the seam they pass through. Everything drawn from them is worked out
again here, following upstream TRICERATOPS (Giacalone et al. 2021;
marginal_likelihoods.py, priors.py, funcs.py) and the program's
documented importance sampling:

* period P in [P_lo, P_hi]; planet radii from the broken power law
  (slopes by host mass); eccentricities Beta(0.867, 3.03) for planets and
  u^(1/0.2) or u^(1/0.6) (P <= 10 d or not) for binaries; argument of
  periastron 360 u; binary and companion mass ratios from Moe & Di
  Stefano's broken power laws with a twin excess;
* the stars drawn: radii and Teff on the Torres / cool-dwarf relations,
  TESS-band flux ratios from the flux relation, background stars read
  from the TRILEGAL file the benchmark wrote;
* geometry: the transit probability Ptra, cos i ~ U[0, min(Ptra, 1)] with
  log weight ln min(Ptra, 1); the twin (2P) branches on their own
  conditioned draws: q restricted to q >= 0.95 (log weight ln P(q >=
  0.95)) and cos i from the grazing-edge mixture (log weight -ln q(c));
  Latin-hypercube stratification of the streams a scenario names;
* the priors: the bound-companion rate (Moe & Di Stefano 2017 integrals,
  TP and EB variants), the background-star density of the TRILEGAL
  field, both without a contrast curve (separation 2.2", contrast 1), with
  the clamps (positive log-priors to 0, companions brighter than the host
  to -inf);
* the inputs of the likelihood cores: k, a/R, inclination, w, the
  dilutions g / g_pri / g_sec and ksec.

Limb darkening of drawn stars (a table lookup) is not worked out here.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import pandas as pd
import torch
from scipy.interpolate import InterpolatedUnivariateSpline
from scipy.special import betaincinv

from .traffic import (FLUX_NODES, G, MASS_CDWRF, MASS_TORRES, MSUN,
                      RAD_CDWRF, RAD_TORRES, REARTH, RSUN, TEFF_CDWRF,
                      TEFF_TORRES)

AU = 1.49597870700e13
BETA_A, BETA_B = 0.867, 3.030
# no contrast curve: upstream's default separation [arcsec] at contrast 1
SEP_DEFAULT, CON_DEFAULT = 2.2, 1.0
# the grazing-edge mixture of the twin branches: (mass, edge width)
TWIN_EDGE = ((0.5, 1.0), (0.5, 0.05), (0.0, 0.005))
# streams each kind's sampler Latin-hypercube stratifies: (normal, twin)
LATTICE = {"TP": (None, None), "PTP": (None, None), "STP": (None, None),
           "DTP": (None, None), "BTP": (None, None),
           "EB": (None, (1, 2, 4, 3)), "DEB": (None, (1, 2, 4, 3)),
           "BEB": (None, (1, 2, 4, 3)),
           "PEB": ((1, 2, 4, 3, 5), (1, 2, 4, 3, 5)),
           "SEB": ((1, 2, 4, 3, 5), (1, 2, 4, 3, 5))}
PLANETS = ("TP", "PTP", "STP", "DTP", "BTP")
BACKGROUND = ("DTP", "BTP", "DEB", "BEB")
# a draw this close (relative) to a threshold where the result jumps is
# left out: float32 and float64 may fall on either side
AMBIGUOUS = 1e-5


def _spl(x, y):
    return InterpolatedUnivariateSpline(np.asarray(x, float),
                                        np.asarray(y, float))


@lru_cache(maxsize=None)
def _splines():
    return dict(trad=_spl(MASS_TORRES, RAD_TORRES),
                tteff=_spl(MASS_TORRES, TEFF_TORRES),
                crad=_spl(MASS_CDWRF, RAD_CDWRF),
                cteff=_spl(MASS_CDWRF, TEFF_CDWRF),
                flux=_spl(*FLUX_NODES["TESS"]))


class Ops:
    """Elementwise math in one dtype; the table functions (splines, the
    Beta quantile) in float64, rounded to the dtype."""

    def __init__(self, dtype):
        self.dt = dtype

    def t(self, x):
        return torch.as_tensor(x, dtype=torch.float64).to(self.dt)

    def host(self, fn, x):
        return self.t(fn(x.double().numpy()))

    def stellar(self, m, max_r, max_t):
        s = _splines()
        hot = m > 0.63
        r = torch.where(hot, self.host(s["trad"], m), self.host(s["crad"], m))
        te = torch.where(hot, self.host(s["tteff"], m),
                         self.host(s["cteff"], m))
        return (torch.clamp_min(torch.minimum(r, self.t(max_r)), 0.1),
                torch.clamp_min(torch.minimum(te, self.t(max_t)), 2800.0))

    def flux(self, m):
        return 10.0 ** self.host(_splines()["flux"], m)

    def fr_vs(self, m, M_s):
        f = self.flux(m)
        return f / (f + self.flux(self.t(M_s).reshape(1)))

    def beta_ppf(self, u):
        return self.host(lambda v: betaincinv(BETA_A, BETA_B, v), u)


def broken3_inv(x, p1, p2, p3, r0, r1, r2, r3):
    A1 = r1**p1 / r1**p2
    A2 = r2**p2 / r2**p3
    I1 = (r1 ** (p1 + 1) - r0 ** (p1 + 1)) / (p1 + 1)
    I2 = A1 * (r2 ** (p2 + 1) - r1 ** (p2 + 1)) / (p2 + 1)
    I3 = A2 * A1 * (r3 ** (p3 + 1) - r2 ** (p3 + 1)) / (p3 + 1)
    nrm = 1.0 / (I1 + I2 + I3)
    s1 = (x / nrm * (p1 + 1) + r0 ** (p1 + 1)) ** (1.0 / (p1 + 1))
    s2 = ((x / nrm - I1) * (p2 + 1) / A1 + r1 ** (p2 + 1)) ** (1 / (p2 + 1))
    s3 = ((x / nrm - I1 - I2) * (p3 + 1) / (A1 * A2)
          + r2 ** (p3 + 1)) ** (1.0 / (p3 + 1))
    return torch.where(x <= nrm * I1, s1,
                       torch.where(x <= nrm * (I1 + I2), s2, s3))


def radius_planet(u, M):
    """Planet radius [Re]: upstream's broken power law, p2 = -4 above
    0.45 Msun, -7 below."""
    hot = broken3_inv(u, 0.0, -4.0, -0.5, 0.5, 3.0, 6.0, 20.0)
    cool = broken3_inv(u, 0.0, -7.0, -0.5, 0.5, 3.0, 6.0, 20.0)
    return torch.where(M > 0.45, hot, cool)


def _q_consts(q_min, p1, p2, F):
    A2_top = (1.0 ** (p2 + 1) - 0.3 ** (p2 + 1)) / (p2 + 1)
    band = (1.0 ** (p2 + 1) - 0.95 ** (p2 + 1)) / (p2 + 1)
    A1 = 0.3**p1 / 0.3**p2
    A2 = 1 + F / (1 - F) * A2_top / band
    I1 = (0.3 ** (p1 + 1) - q_min ** (p1 + 1)) / (p1 + 1)
    I2 = A1 * (0.95 ** (p2 + 1) - 0.3 ** (p2 + 1)) / (p2 + 1)
    I3 = A2 * A1 * band
    return A1, A2, I1, I2, I3


def _q_consts2(q_min, p2, F):
    band = (1.0 ** (p2 + 1) - 0.95 ** (p2 + 1)) / (p2 + 1)
    A2 = 1 + F / (1 - F) * ((1.0 ** (p2 + 1) - q_min ** (p2 + 1))
                            / (p2 + 1)) / band
    I2 = (0.95 ** (p2 + 1) - q_min ** (p2 + 1)) / (p2 + 1)
    return A2, I2, A2 * band


def mass_ratio(x, M, p1, p2, F):
    """Moe & Di Stefano mass ratio on [q_min, 1] with a twin excess F
    above 0.95 (three segments for M >= 0.3, two below; q = 1 at M <=
    0.1); M a float."""
    if M <= 0.1:
        return torch.ones_like(x)
    if M >= 0.3:
        q_min = 0.1 if M >= 1.0 else 0.1 / M
        A1, A2, I1, I2, I3 = _q_consts(q_min, p1, p2, F)
        nrm = 1.0 / (I1 + I2 + I3)
        s1 = (x / nrm * (p1 + 1) + q_min ** (p1 + 1)) ** (1 / (p1 + 1))
        s2 = ((x / nrm - I1) * (p2 + 1) / A1 + 0.3 ** (p2 + 1)) ** (
            1 / (p2 + 1))
        s3 = ((x / nrm - I1 - I2) * (p2 + 1) / (A1 * A2)
              + 0.95 ** (p2 + 1)) ** (1 / (p2 + 1))
        return torch.where(x <= nrm * I1, s1,
                           torch.where(x <= nrm * (I1 + I2), s2, s3))
    q_min = min(0.1 / M, 0.999)
    A2, I2, I3 = _q_consts2(q_min, p2, F)
    nrm = 1.0 / (I2 + I3)
    s2 = (x / nrm * (p2 + 1) + q_min ** (p2 + 1)) ** (1 / (p2 + 1))
    s3 = ((x / nrm - I2) * (p2 + 1) / A2 + 0.95 ** (p2 + 1)) ** (1 / (p2 + 1))
    return torch.where(x <= nrm * I2, s2, s3)


def below_twin(M, p1=0.3, p2=-0.5, F=0.30):
    """P(q < 0.95) under the binary law."""
    if M <= 0.1:
        return 0.0
    if M >= 0.3:
        A1, A2, I1, I2, I3 = _q_consts(0.1 if M >= 1.0 else 0.1 / M, p1, p2,
                                       F)
        return (I1 + I2) / (I1 + I2 + I3)
    A2, I2, I3 = _q_consts2(min(0.1 / M, 0.999), p2, F)
    return I2 / (I2 + I3)


def binary_q(x, M):
    return mass_ratio(x, M, 0.3, -0.5, 0.30)


def companion_q(x, M):
    return mass_ratio(x, M, 0.3, -0.95, 0.05)


def semimajor(P, M):
    """Kepler III semimajor axis [cm] of period P [d] about mass M
    [Msun]."""
    return ((G * M * MSUN) / (4 * math.pi**2) * (P * 86400.0) ** 2) ** (
        1.0 / 3.0)


def e_corr(e, argp):
    return (1.0 + e * torch.sin(argp * math.pi / 180.0)) / (1.0 - e**2)


def _ptra(P, M_tot, R_host_cm, R_occ_cm, e, argp):
    a = semimajor(P, M_tot)
    return a, (R_occ_cm + R_host_cm) / a * e_corr(e, argp)


def inc_strat(u, Ptra):
    """(inc [deg], transits, ln weight): cos i ~ U[0, min(Ptra, 1)]."""
    w = torch.clamp_max(Ptra, 1.0)
    return torch.arccos(u * w) * (180.0 / math.pi), Ptra <= 1.0, torch.log(w)


def inc_twin(u, Ptra):
    """The grazing-edge mixture over [0, min(Ptra, 1)]: (inc [deg],
    transits, ln weight = -ln q(c), the mixture's piece boundaries)."""
    (a1, _), (a2, d1), (a3, d2) = TWIN_EDGE
    w = torch.clamp_max(Ptra, 1.0)
    t1, t2 = 1.0 - d1, 1.0 - d2
    d_1, d_2, d_3 = a1, a1 + a2 / d1, a1 + a2 / d1 + a3 / d2
    m1 = d_1 * t1
    m2 = m1 + d_2 * (t2 - t1)
    t = torch.where(u < m1, u / d_1, torch.where(u < m2, t1 + (u - m1) / d_2,
                                                  t2 + (u - m2) / d_3))
    dens = torch.where(u < m1, d_1 + 0 * u,
                       torch.where(u < m2, d_2 + 0 * u, d_3 + 0 * u)) / w
    inc = torch.arccos(torch.clamp(w * t, 0.0, 1.0)) * (180.0 / math.pi)
    return inc, Ptra <= 1.0, -torch.log(dens), (m1, m2)


def lnprior_bound(kind, M_s, plx, dm):
    """Bound-companion log prior (priors.py: TP variant drops log10
    Pmax < 3.4, EB variant only the first term), no contrast curve."""
    M_eval = max(M_s, 1.0)
    lm = math.log10(M_eval)
    f1 = 0.020 + 0.04 * lm + 0.07 * lm**2
    f2 = 0.039 + 0.07 * lm + 0.01 * lm**2
    f3 = 0.078 - 0.05 * lm + 0.04 * lm**2
    alpha, dlp = 0.018, 0.7
    plx = 0.1 if math.isnan(plx) else plx
    sep = (1000.0 / plx) * SEP_DEFAULT
    P_max = ((4 * math.pi**2) / (G * M_eval * MSUN) * (sep * AU) ** 3) ** 0.5
    lp = math.log10(P_max / 86400.0)
    t2p = 0.5 * (lp - 1.0) * (2 * f1 + (f2 - f1 - alpha * dlp) * (lp - 1.0))
    t2 = 0.5 * (2 * f1 + (f2 - f1 - alpha * dlp))
    t3p = 0.5 * alpha * (lp**2 - 5.4 * lp + 6.8) + f2 * (lp - 2.0)
    t3 = 0.5 * alpha * (3.4**2 - 5.4 * 3.4 + 6.8) + f2 * 1.4
    quad = lambda x: 0.238095 * x**2 - 0.952381 * x + 0.485714  # noqa: E731
    t4p = (alpha * dlp * (lp - 3.4) + f2 * (lp - 3.4)
           + (f3 - f2 - alpha * dlp) * quad(lp))
    t4 = (alpha * dlp * 2.1 + f2 * 2.1 + (f3 - f2 - alpha * dlp) * quad(5.5))
    t5p = f3 * (3.33333 - 17.3566 * math.exp(-0.3 * lp))
    t5 = f3 * (3.33333 - 17.3566 * math.exp(-0.3 * 8.0))
    if kind == "TP":
        f = (0.0 if lp < 3.4 else t4p if lp < 5.5 else t4 + t5p if lp < 8.0
             else t4 + t5)
    else:
        f = (0.0 if lp < 1.0 else t2p if lp < 2.0 else t2 + t3p if lp < 3.4
             else t2 + t3 + t4p if lp < 5.5 else t2 + t3 + t4 + t5p
             if lp < 8.0 else t2 + t3 + t4 + t5)
    if M_s < 1.0:
        f = max(0.65 * f + 0.35 * f * M_s, 0.0)
    lnp = math.log(f) if f > 0 else -math.inf
    return clamp(torch.full_like(dm, lnp), dm)


def lnprior_background(N_comp, dm):
    """Background-star log prior: the TRILEGAL field's 0.1 deg^2 density
    inside the 2.2" circle."""
    lnp = math.log((N_comp / 0.1) * (1.0 / 3600.0) ** 2 * SEP_DEFAULT**2)
    return clamp(torch.full_like(dm, lnp), dm)


def clamp(lnp, dm):
    lnp = torch.clamp_max(lnp, 0.0)
    return torch.where(dm > 0.0, torch.full_like(lnp, -math.inf), lnp)


def delta_mag(*frs):
    """2.5 log10 of the summed flux ratios F / (1 - F)."""
    return 2.5 * torch.log10(sum(f / (1.0 - f) for f in frs))


def radius_ratios(r, R_host):
    k = r / R_host
    k = torch.where(k - 1.0 < 1e-6, k * 0.999, k)
    ks = R_host / r
    ks = torch.where(ks - 1.0 < 1e-6, ks * 0.999, ks)
    return k, ks


def eb_dilution(F_EB, F_comp, on_companion):
    if on_companion:
        x1, x2, y1 = F_EB / F_comp, 1.0 / (F_comp + F_EB), F_comp / F_EB
    else:
        x1, x2, y1 = F_EB, F_comp / (1.0 + F_EB), 1.0 / F_EB
    return (1.0 / ((1.0 + x1) * (1.0 + x2)),
            1.0 / ((1.0 + y1) * (1.0 + x2)))


@lru_cache(maxsize=8)
def background_table(path, Tmag):
    """The TRILEGAL file's stars no brighter than the target, as upstream
    reads them (its last two lines dropped): (columns, N_comp)."""
    df = pd.read_csv(path)[:-2]
    keep = df["TESS"].to_numpy(float) >= Tmag
    df = df[keep]
    d_T = Tmag - df["TESS"].to_numpy(float)
    m = df["Mact"].to_numpy(float)
    logg = df["logg"].to_numpy(float)
    cols = dict(fr=10 ** (d_T / 2.5) / (1 + 10 ** (d_T / 2.5)), mass=m,
                rad=np.sqrt(G * m * MSUN / 10**logg) / RSUN, logg=logg,
                teff=10 ** df["logTe"].to_numpy(float))
    return cols, int(keep.sum())


def molusc_kept(path, M_s):
    """The companions a MOLUSC posterior keeps, as upstream reads it:
    periastron a (1 - e) > 10 AU, mass ratios floored at 0.1 / M_s."""
    df = pd.read_csv(path)
    a = df["semi-major axis(AU)"].to_numpy(float)
    e = df["eccentricity"].to_numpy(float)
    q = df["mass ratio"].to_numpy(float)[a * (1 - e) > 10]
    return np.maximum(q, 0.1 / M_s)


def lattice(u, r, axes, n):
    """The streams ``axes`` Latin-hypercube stratified: (i + u_i) / n on
    the first, (pi_j(i) + u_i) / n on the others with pi_j the stable
    argsort of the j-th extra stream; all streams float64, full length."""
    out = list(u)
    base = torch.arange(n, dtype=torch.float64, device=u[0].device)
    out[axes[0]] = (base + u[axes[0]]) / n
    for j, ax in enumerate(axes[1:]):
        perm = torch.argsort(r[j], stable=True).double()
        out[ax] = (perm + u[ax]) / n
    return out


def branch(kind, twin, star, u, idx_rows, bg, ops, molusc=None):
    """The reference's draws of one sampler branch at the sampled draws.

    kind: the scenario family ("TP", "EB", "PTP", "PEB", "STP", "SEB",
    "DTP", "DEB", "BTP", "BEB"); twin: the conditioned 2P branch of an EB
    family. star: the host star as the benchmark's inputs give it (P, M_s,
    R_s, Teff, plx). u: the branch's uniform streams at the draws, already
    stratified (``lattice``). idx_rows: the drawn TRILEGAL rows (background
    kinds). bg: ``background_table``. molusc: (kept mass ratios, the
    position each draw takes among the posterior's rows, zero beyond the
    kept ones) where a MOLUSC posterior replaces the companion law and
    its prior. Returns the fields by the program's
    names, ``mask`` (draws that count), ``weight`` (ln prior + ln weight)
    and ``ambiguous`` (draws left out)."""
    t = ops.t
    u = [t(x) for x in u]
    P = t(star["P"]) + 0 * u[0]
    M_s, R_s, Teff, plx = (float(star[k]) for k in ("M_s", "R_s", "Teff",
                                                      "plx"))
    amb = torch.zeros_like(P, dtype=torch.bool)

    def near(x, thr):
        return torch.abs(x.double() - thr) <= AMBIGUOUS * max(abs(thr), 1e-3)

    out, lnprior = {"P": P}, torch.zeros_like(P)

    def companion(u5, variant, dm_extra=()):
        """(q, flux ratio, ln prior) of the bound companion."""
        if molusc is None:
            qc = companion_q(u5, M_s)
        else:
            kept, pos = molusc
            qc = t(np.where(pos.numpy() < len(kept),
                            kept[np.minimum(pos.numpy(), len(kept) - 1)],
                            0.0))
        frc = ops.fr_vs(qc * M_s, M_s)
        if molusc is not None:
            return qc, frc, torch.zeros_like(qc)
        return qc, frc, lnprior_bound(variant, M_s, plx,
                                      delta_mag(frc, *dm_extra))
    argps = 360.0 * u[4]
    if kind in BACKGROUND:
        cols, N_comp = bg
        rows = {k: t(v[idx_rows.numpy()]) for k, v in cols.items()}
        fr_d = rows["fr"]
        out["fluxratios_comp"] = fr_d
    if kind in PLANETS:
        host_m, host_r, mask_extra = t(M_s) + 0 * P, t(R_s) + 0 * P, None
        g = torch.ones_like(P)
        if kind in ("PTP", "STP"):
            qc, frc, lnprior = companion(u[5], "TP")
            mc = qc * M_s
            out["fluxratios_comp"] = frc
            mask_extra = qc != 0.0
            Fc = frc / (1.0 - frc)
            g = 1.0 / (1.0 + Fc)
            if kind == "STP":
                rc, _ = ops.stellar(mc, R_s, Teff)
                amb |= near(mc, 0.63)
                host_m, host_r = mc, rc
                out.update(masses_comp=mc, radii_comp=rc)
                g = 1.0 / (1.0 + 1.0 / Fc)
        elif kind in ("DTP", "BTP"):
            lnprior = lnprior_background(N_comp, delta_mag(fr_d))
            F = fr_d / (1.0 - fr_d)
            if kind == "BTP":
                host_m, host_r = rows["mass"], rows["rad"]
                mask_extra = (rows["logg"] >= 3.5) & (rows["teff"] <= 1e4)
                out.update(host_mass=host_m, host_rad=host_r)
                g = 1.0 / (1.0 + 1.0 / F)
            else:
                g = 1.0 / (1.0 + F)
        amb |= near(host_m, 0.45)
        rps = radius_planet(u[1], host_m)
        eccs = ops.beta_ppf(u[3])
        R_occ = rps * REARTH
        a, Ptra = _ptra(P, host_m, host_r * RSUN, R_occ, eccs, argps)
        coll = R_occ + host_r * RSUN > a * (1.0 - eccs)
        incs, tra, lnw = inc_strat(u[2], Ptra)
        mask = tra & ~coll
        amb |= near(Ptra, 1.0) | near((R_occ + host_r * RSUN)
                                      / (a * (1.0 - eccs)), 1.0)
        out.update(rps=rps, k=rps * REARTH / (host_r * RSUN),
                   a_R=a / (host_r * RSUN), g=g)
    else:
        if twin:
            u095 = below_twin(M_s)
            qs = binary_q(u095 + u[2] * (1.0 - u095), M_s)
            lnq = math.log1p(-u095)
        else:
            qs, lnq = binary_q(u[2], M_s), 0.0
        eccs = u[3] ** (1.0 / 0.2 if star["P"] <= 10.0 else 1.0 / 0.6)
        mask_extra = None
        if kind in ("EB", "PEB", "DEB"):
            m = qs * M_s
            r, _ = ops.stellar(m, R_s, Teff)
            amb |= near(m, 0.63)
            fr = ops.fr_vs(m, M_s)
            host_m, host_r = t(M_s) + 0 * P, t(R_s) + 0 * P
            F_comp = torch.zeros_like(P)
            if kind == "PEB":
                qc, frc, lnprior = companion(u[5], "EB")
                out["fluxratios_comp"] = frc
                F_comp = frc / (1.0 - frc)
                mask_extra = qc != 0.0
            elif kind == "DEB":
                lnprior = lnprior_background(N_comp, delta_mag(fr_d))
                F_comp = fr_d / (1.0 - fr_d)
            gp, gs = eb_dilution(fr / (1.0 - fr), F_comp, False)
        elif kind == "SEB":
            qc, frc, _ = companion(u[5], "EB")
            mc = qc * M_s
            rc, tc = ops.stellar(mc, R_s, Teff)
            m = qs * mc
            r, _ = ops.stellar(m, rc, tc)
            amb |= near(mc, 0.63) | near(m, 0.63)
            fr = ops.fr_vs(m, M_s)
            lnprior = (torch.zeros_like(qc) if molusc is not None else
                       lnprior_bound("EB", M_s, plx, delta_mag(frc, fr)))
            host_m, host_r = mc, rc
            out.update(fluxratios_comp=frc, masses_comp=mc, radii_comp=rc)
            gp, gs = eb_dilution(fr / (1.0 - fr), frc / (1.0 - frc), True)
            mask_extra = qc != 0.0
        else:  # BEB
            host_m, host_r = rows["mass"], rows["rad"]
            m = qs * host_m
            r, _ = ops.stellar(m, host_r, rows["teff"])
            amb |= near(m, 0.63) | near(host_m, 0.63)
            fr = ops.fr_vs(m, M_s) * (fr_d / ops.fr_vs(host_m, M_s))
            F_comp = fr_d / (1.0 - fr_d)
            lnprior = lnprior_background(N_comp, delta_mag(fr_d, fr))
            gp, gs = eb_dilution(fr / (1.0 - fr), F_comp, True)
            mask_extra = (rows["logg"] >= 3.5) & (rows["teff"] <= 1e4)
            out.update(host_mass=host_m, host_rad=host_r)
        k, ks = radius_ratios(r, host_r)
        amb |= near(k, 1.0) | near(ks, 1.0)
        Pg = 2.0 * P if twin else P
        a, Ptra = _ptra(Pg, host_m + m, host_r * RSUN, r * RSUN, eccs, argps)
        R_coll = 2.0 * host_r * RSUN if twin else (r + host_r) * RSUN
        coll = R_coll > a * (1.0 - eccs)
        amb |= near(Ptra, 1.0) | near(R_coll / (a * (1.0 - eccs)), 1.0)
        if twin:
            incs, tra, lnw, (m1, m2) = inc_twin(u[1], Ptra)
            amb |= near(u[1], m1) | near(u[1], m2)
            lnw = lnw + lnq
            mask = tra & ~coll
        else:
            incs, tra, lnw = inc_strat(u[1], Ptra)
            mask = tra & ~coll & (qs < 0.95)
            amb |= near(qs, 0.95)
        out.update(qs=qs, masses=m, radii=r, fluxratios=fr, k=k, ksec=ks,
                   a_R=a / (host_r * RSUN), g_pri=gp, g_sec=gs)
    if mask_extra is not None:
        mask = mask & mask_extra
    dm_like = out.get("fluxratios_comp")
    if dm_like is not None:
        amb |= torch.abs(dm_like.double() - 0.5) <= AMBIGUOUS
    out.update(eccs=eccs, argps=argps, incs=incs,
               inc_rad=incs * (math.pi / 180.0),
               w_rad=(90.0 - argps) * (math.pi / 180.0))
    return out, mask, lnprior + lnw, amb
