"""Scenario Monte-Carlo marginalization engine (device side).

Counterpart of the JAX package's ``scenarios/engine.py`` for the target and
nearby-star planet (TP/NTP) and eclipsing-binary (EB/NEB + EBx2P twin)
scenarios. Per scenario: a sampler turns uniform draws into priors,
Kepler-III geometry and transit/collision masks (masking, never
compaction, so shapes stay static); the chunked likelihood core
(``ops/lightcurve.py``) scores the draws; ``finalize`` reduces to the
evidence and the top-100 best fits.

Geometric importance sampling (``stratified=True``): cos(inc) is drawn
from U[0, min(Ptra, 1)] with ln-weight ln min(Ptra, 1), an exact
reweighting of the reference's rejection scheme (``stratified=False``).

Every uniform comes through one seam, ``_uniforms(gen, n_streams, N)``,
including the Latin-hypercube permutation uniforms of ``_lattice_strat``,
so tests can hand the port and the JAX package the same numbers.
"""

from __future__ import annotations

import torch

from ..constants import G, MSUN, RSUN, REARTH, PI
from ..core.numerics import log_mean_exp_torch
from ..priors.samplers import (
    sample_rp, sample_inc, sample_ecc, sample_w, sample_q, q_below_twin_cdf,
)
from ..populations.stellar import stellar_relations, flux_relation
from ..ops.lightcurve import eb_radius_ratios, eb_dilution

F32 = torch.float32
N_SAMPLES = 100  # top-k best-fit draws kept (reference ml.py:152)
TWIN_DIV = 4     # twin-branch conditioned draw count = N // TWIN_DIV


# ---------------------------------------------------------------------------
# Shared draw/geometry helpers
# ---------------------------------------------------------------------------

def _uniforms(gen, n_streams, N):
    """n_streams float32 U[0, 1) tensors of length N from ``gen``, on the
    generator's device."""
    return [torch.rand(N, generator=gen, dtype=F32, device=gen.device)
            for _ in range(n_streams)]


def _scalars(device, *xs):
    """Float32 0-d tensors on ``device``: host scalars enter the device
    math as float32, as the JAX samplers' traced scalars do."""
    return tuple(torch.as_tensor(x, dtype=F32, device=device) for x in xs)


def _draw_P(u, P_lo, P_hi):
    return P_lo + u * (P_hi - P_lo)


def _semimajor(P_days, M_tot_msun):
    """Kepler III semimajor axis [cm] (reference ml.py:75)."""
    return ((G * M_tot_msun * MSUN) / (4 * PI**2) * (P_days * 86400.0) ** 2) ** (1.0 / 3.0)


def _geom_base(P, M_tot, R_host_rsun, R_occ_cm, eccs, argps_deg):
    """a [cm], Ptra, coll, r [cm] (reference ml.py:107-115)."""
    a = _semimajor(P, M_tot)
    sin_argp = torch.sin(argps_deg * PI / 180.0)
    e_corr = (1.0 + eccs * sin_argp) / (1.0 - eccs**2)
    R_host_cm = R_host_rsun * RSUN
    Ptra = (R_occ_cm + R_host_cm) / a * e_corr
    r = a * (1.0 - eccs**2) / (1.0 + eccs * sin_argp)
    coll = (R_occ_cm + R_host_cm) > a * (1.0 - eccs)
    return a, Ptra, coll, r


def _inc_weighted(u_inc, Ptra, stratified: bool):
    """Inclination draw + geometric transit handling; returns
    (incs_deg, tra_ok, lnw). stratified: cos(inc) ~ U[0, min(Ptra, 1)],
    ln-weight ln min(Ptra, 1); plain: the reference's rejection mask
    (ml.py:120-123)."""
    if stratified:
        w = torch.clamp_max(Ptra, 1.0)
        cosi = u_inc * w
        incs_deg = torch.arccos(cosi) * (180.0 / PI)
        return incs_deg, Ptra <= 1.0, torch.log(w)
    incs_deg = sample_inc(u_inc)
    cosi = torch.cos(incs_deg * PI / 180.0)
    tra_ok = (Ptra <= 1.0) & (cosi <= Ptra)
    return incs_deg, tra_ok, torch.zeros_like(Ptra)


def _impact_param(r_cm, incs_deg, R_host_rsun):
    return r_cm * torch.cos(incs_deg * PI / 180.0) / (R_host_rsun * RSUN)


def _kernel_angles(incs_deg, argps_deg):
    """(inc_rad, w_rad) with the reference's w = (90 - argp) deg
    convention (reference likelihoods.py:70, :345)."""
    return incs_deg * (PI / 180.0), (90.0 - argps_deg) * (PI / 180.0)


def _fluxratio_vs_target(masses, M_s, filt="TESS"):
    """F_star / (F_star + F_target) in the given band (ref ml.py:248-251)."""
    f = flux_relation(masses, filt)
    ft = flux_relation(M_s.reshape(1).to(masses.dtype), filt)
    return f / (f + ft)


# ---------------------------------------------------------------------------
# Finalize: evidence + top-k best fits
# ---------------------------------------------------------------------------

def finalize(lnL, lnprior, gather_arrays, *, N: int):
    """lnZ = log_mean_exp(lnL + lnprior) over all N draws; the top-100
    draws ranked by lnL alone (reference ml.py:152-154). Ties among equal
    lnL may come back in any order."""
    lnZ = log_mean_exp_torch(lnL + lnprior, N)
    _, idx = torch.topk(lnL, min(N_SAMPLES, N))
    return lnZ, tuple(a[idx] for a in gather_arrays)


def run_finalize(lnL, lnprior, gather: dict):
    """finalize on a dict of gather arrays; values stay on the device."""
    names = list(gather.keys())
    lnZ, vals = finalize(lnL, lnprior, tuple(gather[n] for n in names),
                         N=lnL.shape[0])
    return lnZ, dict(zip(names, vals))


# ---------------------------------------------------------------------------
# Planet-family sampler
# ---------------------------------------------------------------------------

def sample_planet_target(gen, P_lo, P_hi, M_s, R_s, *, N, flatpriors,
                         stratified=True):
    """Draws for TTP / NTP: a planet around a star with fixed properties
    (reference ml.py:100-123)."""
    u = _uniforms(gen, 5, N)
    P_lo, P_hi, M_s, R_s = _scalars(gen.device, P_lo, P_hi, M_s, R_s)
    P = _draw_P(u[0], P_lo, P_hi)
    rps = sample_rp(u[1], M_s.expand(N), flatpriors)
    eccs = sample_ecc(u[3], True, P.mean())
    argps = sample_w(u[4])
    a, Ptra, coll, r = _geom_base(P, M_s, R_s, rps * REARTH, eccs, argps)
    incs, tra_ok, lnw = _inc_weighted(u[2], Ptra, stratified)
    b = _impact_param(r, incs, R_s)
    mask = tra_ok & ~coll
    inc_rad, w_rad = _kernel_angles(incs, argps)
    return dict(P=P, rps=rps, incs=incs, eccs=eccs, argps=argps, a=a, b=b,
                mask=mask, lnw=lnw, inc_rad=inc_rad, w_rad=w_rad,
                k=rps * REARTH / (R_s * RSUN), a_R=a / (R_s * RSUN))


# ---------------------------------------------------------------------------
# EB-family samplers and the EBx2P twin machinery
#
# With stratified=True and twin_n > 0, sample_teb returns d["twin"]: an
# independent conditioned draw set of size twin_n (q | q >= 0.95 with
# ln-weight log P(q >= 0.95), a grazing-edge cos(inc) mixture, and
# Latin-hypercube strata over (inc, q, w, ecc)). With twin_n = 0 or
# stratified=False the legacy shared-draw twin branch is kept and
# d["twin"] is an aliased view of it (see the JAX engine's module notes).
# ---------------------------------------------------------------------------

# Grazing-edge mixture components (mass, edge-width fraction of the
# cos(inc) range)
_TWIN_EDGE = ((0.5, 1.0), (0.5, 0.05), (0.0, 0.005))


def _lattice_strat(u, axes, n, gen):
    """Latin-hypercube stratification of the streams ``axes``: stream
    axes[j] becomes (pi_j(i) + u_i) / n with the identity on the first
    axis and, on the others, uniform random permutations from ONE batched
    argsort of iid uniforms. Never an affine or modular permutation: a
    lattice without a shared random shift is biased on needle integrands
    (see the JAX engine's notes)."""
    out = list(u)
    dt = out[axes[0]].dtype
    base = torch.arange(n, dtype=dt, device=out[axes[0]].device)
    out[axes[0]] = (base + out[axes[0]]) / n
    rest = axes[1:]
    if rest:
        r = torch.stack(_uniforms(gen, len(rest), n))
        perms = torch.argsort(r, dim=1)
        for j, ax in enumerate(rest):
            out[ax] = (perms[j].to(dt) + out[ax]) / n
    return out


def _inc_twin_mixture(u_inc, Ptra):
    """cos(inc) from the grazing-edge mixture over [0, min(Ptra, 1)] by
    its exact piecewise-linear inverse CDF, with ln-weight -ln q(c)."""
    (a1, _), (a2, d1), (a3, d2) = _TWIN_EDGE
    w = torch.clamp_max(Ptra, 1.0)
    t1, t2 = 1.0 - d1, 1.0 - d2
    dens1 = a1
    dens2 = a1 + a2 / d1
    dens3 = a1 + a2 / d1 + a3 / d2
    m1 = dens1 * t1
    m2 = m1 + dens2 * (t2 - t1)
    t = torch.where(
        u_inc < m1, u_inc / dens1,
        torch.where(u_inc < m2, t1 + (u_inc - m1) / dens2,
                    t2 + (u_inc - m2) / dens3))
    dens = torch.where(u_inc < m1, dens1,
                       torch.where(u_inc < m2, dens2, dens3)) / w
    cosi = w * t
    incs_deg = torch.arccos(torch.clamp(cosi, 0.0, 1.0)) * (180.0 / PI)
    return incs_deg, Ptra <= 1.0, -torch.log(dens)


def _twin_q(u, M_q):
    """(qs, ln-mass): q | q >= 0.95 by inverse-CDF restriction."""
    u095 = q_below_twin_cdf(M_q)
    qs = sample_q(u095 + u * (1.0 - u095), M_q)
    return qs, torch.log1p(-u095)


def _twin_geom(P, M_tot, R_host_rsun, radii_rsun, eccs, argps_deg, u_inc,
               coll_R_occ_cm):
    """Twin-branch geometry at 2P on a conditioned draw set with the
    grazing-edge inclination mixture."""
    a_twin = _semimajor(2.0 * P, M_tot)
    sin_argp = torch.sin(argps_deg * PI / 180.0)
    e_corr = (1.0 + eccs * sin_argp) / (1.0 - eccs**2)
    Ptra = (radii_rsun * RSUN + R_host_rsun * RSUN) / a_twin * e_corr
    r_twin = a_twin * (1.0 - eccs**2) / (1.0 + eccs * sin_argp)
    coll = coll_R_occ_cm > a_twin * (1.0 - eccs)
    incs, tra_ok, lnw = _inc_twin_mixture(u_inc, Ptra)
    b = _impact_param(r_twin, incs, R_host_rsun)
    return dict(a=a_twin, incs=incs, b=b, geo_ok=tra_ok & ~coll, lnw=lnw)


def _twin_pack(P, qs, eccs, argps, masses, radii, fluxratios, tb,
               R_host_rsun, kk, ksec, g_pri, g_sec, lnqmass):
    """Assemble a conditioned twin dict with the normal branch's field
    names, so consumers are uniform."""
    inc_rad, w_rad = _kernel_angles(tb["incs"], argps)
    return dict(P=P, qs=qs, eccs=eccs, argps=argps, masses=masses,
                radii=radii, fluxratios=fluxratios, a=tb["a"],
                incs=tb["incs"], b=tb["b"], mask=tb["geo_ok"],
                lnw=tb["lnw"] + lnqmass, inc_rad=inc_rad, w_rad=w_rad,
                k=kk, ksec=ksec, g_pri=g_pri, g_sec=g_sec,
                a_R=tb["a"] / (R_host_rsun * RSUN),
                lnprior=torch.zeros_like(P))


def _twin_alias(d):
    """Twin-branch view of a legacy shared-draw EB sampler output."""
    return dict(P=d["P"], qs=d["qs"], eccs=d["eccs"], argps=d["argps"],
                masses=d["masses"], radii=d["radii"],
                fluxratios=d["fluxratios"], a=d["a_twin"],
                incs=d["incs_twin"], b=d["b_twin"], mask=d["mask_twin"],
                lnw=d["lnw_twin"], inc_rad=d["inc_rad_twin"],
                w_rad=d["w_rad"], k=d["k"], ksec=d["ksec"],
                g_pri=d["g_pri"], g_sec=d["g_sec"], a_R=d["a_R_twin"],
                lnprior=torch.zeros_like(d["P"]))


def _eb_normal_branch(P, M_tot, R_host_rsun, radii_rsun, eccs, argps_deg,
                      u_inc, stratified):
    """Normal-branch geometry only (the twin has its own draw set)."""
    a, Ptra, coll, r = _geom_base(P, M_tot, R_host_rsun, radii_rsun * RSUN,
                                  eccs, argps_deg)
    incs, tra_ok, lnw = _inc_weighted(u_inc, Ptra, stratified)
    b = _impact_param(r, incs, R_host_rsun)
    return dict(a=a, incs=incs, b=b, geo_ok=tra_ok & ~coll, lnw=lnw)


def _eb_pack_normal(d, P, qs, eccs, argps, masses, radii, fluxratios,
                    nb, R_host_rsun, kk, ksec, g_pri, g_sec):
    """Normal-branch fields of an EB sampler output (twin in d['twin'])."""
    inc_rad, w_rad = _kernel_angles(nb["incs"], argps)
    d.update(
        P=P, incs=nb["incs"], qs=qs, eccs=eccs, argps=argps, masses=masses,
        radii=radii, fluxratios=fluxratios, a=nb["a"], b=nb["b"],
        mask=nb["geo_ok"] & (qs < 0.95), lnw=nb["lnw"],
        inc_rad=inc_rad, w_rad=w_rad, k=kk, ksec=ksec, g_pri=g_pri,
        g_sec=g_sec, a_R=nb["a"] / (R_host_rsun * RSUN))
    return d


def _eb_branches(P, M_tot, R_host_rsun, radii_rsun, eccs, argps_deg, u_inc,
                 twin_R_occ_cm, stratified):
    """Normal + twin-branch geometry on shared draws; the twin uses 2P and
    the caller's collision radius (reference ml.py:253-268)."""
    nb = _eb_normal_branch(P, M_tot, R_host_rsun, radii_rsun, eccs,
                           argps_deg, u_inc, stratified)
    a_twin = _semimajor(2.0 * P, M_tot)
    sin_argp = torch.sin(argps_deg * PI / 180.0)
    e_corr = (1.0 + eccs * sin_argp) / (1.0 - eccs**2)
    R_host_cm = R_host_rsun * RSUN
    Ptra_twin = (radii_rsun * RSUN + R_host_cm) / a_twin * e_corr
    r_twin = a_twin * (1.0 - eccs**2) / (1.0 + eccs * sin_argp)
    coll_twin = twin_R_occ_cm > a_twin * (1.0 - eccs)
    incs_t, tra_ok_t, lnw_t = _inc_weighted(u_inc, Ptra_twin, stratified)
    b_twin = _impact_param(r_twin, incs_t, R_host_rsun)
    tb = dict(a=a_twin, incs=incs_t, b=b_twin, geo_ok=tra_ok_t & ~coll_twin,
              lnw=lnw_t)
    return nb, tb


def _eb_pack(d, P, qs, eccs, argps, masses, radii, fluxratios,
             nb, tb, R_host_rsun, kk, ksec, g_pri, g_sec):
    inc_rad, w_rad = _kernel_angles(nb["incs"], argps)
    inc_rad_t, _ = _kernel_angles(tb["incs"], argps)
    d.update(
        P=P, incs=nb["incs"], incs_twin=tb["incs"], qs=qs, eccs=eccs,
        argps=argps, masses=masses, radii=radii, fluxratios=fluxratios,
        a=nb["a"], b=nb["b"], a_twin=tb["a"], b_twin=tb["b"],
        mask=nb["geo_ok"] & (qs < 0.95),
        mask_twin=tb["geo_ok"] & (qs >= 0.95),
        lnw=nb["lnw"], lnw_twin=tb["lnw"],
        inc_rad=inc_rad, inc_rad_twin=inc_rad_t, w_rad=w_rad,
        k=kk, ksec=ksec, g_pri=g_pri, g_sec=g_sec,
        a_R=nb["a"] / (R_host_rsun * RSUN),
        a_R_twin=tb["a"] / (R_host_rsun * RSUN))
    return d


def _teb_fields(gen, P_lo, P_hi, M_s, R_s, Teff, n, twin):
    """Shared TEB field block; twin=True conditions q on the twin band and
    stratifies the (inc, q, w, ecc) streams."""
    u = _uniforms(gen, 5, n)
    if twin:
        u = _lattice_strat(u, (1, 2, 4, 3), n, gen)
    P = _draw_P(u[0], P_lo, P_hi)
    if twin:
        qs, lnqmass = _twin_q(u[2], M_s)
    else:
        qs, lnqmass = sample_q(u[2], M_s), 0.0
    eccs = sample_ecc(u[3], False, P.mean())
    argps = sample_w(u[4])
    masses = qs * M_s
    radii, _ = stellar_relations(masses, R_s.expand(n), Teff.expand(n))
    fluxratios = _fluxratio_vs_target(masses, M_s)
    kk, ksec = eb_radius_ratios(radii, R_s)
    F_EB = fluxratios / (1.0 - fluxratios)
    g_pri, g_sec = eb_dilution(F_EB, torch.zeros_like(F_EB), False)
    return u, P, qs, lnqmass, eccs, argps, masses, radii, fluxratios, \
        kk, ksec, g_pri, g_sec


def sample_teb(gen, P_lo, P_hi, M_s, R_s, Teff, *, N, stratified=True,
               twin_n=0):
    """TEB / NEB: the target (or a nearby star) is an eclipsing binary
    (reference ml.py:175-383). twin_n > 0 (stratified only): the EBx2P
    branch runs on its own conditioned draw set."""
    P_lo, P_hi, M_s, R_s, Teff = _scalars(gen.device, P_lo, P_hi, M_s, R_s,
                                          Teff)
    (u, P, qs, _, eccs, argps, masses, radii, fluxratios,
     kk, ksec, g_pri, g_sec) = _teb_fields(gen, P_lo, P_hi, M_s, R_s, Teff,
                                           N, twin=False)
    if stratified and twin_n:
        nb = _eb_normal_branch(P, M_s + masses, R_s, radii, eccs, argps,
                               u[1], stratified)
        d = _eb_pack_normal({}, P, qs, eccs, argps, masses, radii,
                            fluxratios, nb, R_s, kk, ksec, g_pri, g_sec)
        (ut, Pt, qst, lnqm, eccst, argpst, massest, radiit, frt,
         kkt, ksect, g_prit, g_sect) = _teb_fields(
            gen, P_lo, P_hi, M_s, R_s, Teff, twin_n, twin=True)
        tbt = _twin_geom(Pt, M_s + massest, R_s, radiit, eccst, argpst,
                         ut[1], 2.0 * R_s * RSUN)
        d["twin"] = _twin_pack(Pt, qst, eccst, argpst, massest, radiit, frt,
                               tbt, R_s, kkt, ksect, g_prit, g_sect, lnqm)
        return d
    nb, tb = _eb_branches(P, M_s + masses, R_s, radii, eccs, argps, u[1],
                          2.0 * R_s * RSUN, stratified)
    d = _eb_pack({}, P, qs, eccs, argps, masses, radii, fluxratios,
                 nb, tb, R_s, kk, ksec, g_pri, g_sec)
    d["twin"] = _twin_alias(d)
    return d

