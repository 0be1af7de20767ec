"""Scenario Monte-Carlo marginalization engine (device side).

Counterpart of the JAX package's ``scenarios/engine.py`` for the 15
target-star rows, the nearby-star NTP / NEB / NEBx2P rows and the four
dormant nearby-star scenarios of unknown or evolved hosts: planets
(TP, PTP, STP, DTP, BTP, NTP_unknown) and eclipsing binaries with their
twin branches (EB, PEB, SEB, DEB, BEB, NEB_unknown, NEB_evolved and the
x2P rows), around the target, a bound companion, a TRILEGAL background
star or a TRILEGAL lookalike. Per scenario: a sampler turns
uniform draws into priors,
Kepler-III geometry and transit/collision masks (masking, never
compaction, so shapes stay static); the chunked likelihood core
(``ops/lightcurve.py``) scores the draws; ``finalize`` reduces to the
evidence and the top-100 best fits.

Geometric importance sampling (``stratified=True``): cos(inc) is drawn
from U[0, min(Ptra, 1)] with ln-weight ln min(Ptra, 1), an exact
reweighting of the reference's rejection scheme (``stratified=False``).

Every uniform comes through one seam, ``_uniforms(gen, n_streams, N)``,
including the Latin-hypercube permutation uniforms of ``_lattice_strat``,
and every drawn star or MOLUSC-row index through another,
``_randint(gen, n, hi)``, so tests can hand the port and the JAX package
the same numbers.

Each sampler runs in the span ``tri.sample.<name>`` (``sample_ptp`` in
``tri.sample.ptp``), each bound-companion prior block of the P* and S*
samplers (companion law, no MOLUSC file) in ``tri.prior.companion`` with
its draws counted under ``prior.companion``, and ``run_finalize`` in
``tri.reduce``, of ``utils/profiling.py``.
"""

from __future__ import annotations

import math

import torch

from ..constants import G, MSUN, RSUN, REARTH, PI
from ..core.numerics import log_mean_exp_torch
from ..priors.samplers import (
    sample_rp, sample_inc, sample_ecc, sample_w, sample_q, sample_q_companion,
    q_below_twin_cdf,
)
from ..priors.companion import (
    lnprior_bound_TP, lnprior_bound_EB, lnprior_background,
    clamp_companion_prior,
)
from ..populations.ldc import round_index_comp
from ..populations.stellar import stellar_relations, flux_relation
from ..ops.lightcurve import eb_radius_ratios, eb_dilution, tp_dilution
from ..utils import profiling

F32 = torch.float32
N_SAMPLES = 100  # top-k best-fit draws kept (reference ml.py:152)
TWIN_DIV = 4     # twin-branch conditioned draw count = N // TWIN_DIV
TWIN_DIV_SEB = 2  # SEB only: its twin needle is bimodal (grazing or heavy
                  # companion dilution) and noisier, so it gets 2x the
                  # twin draws (the JAX engine's notes)


# ---------------------------------------------------------------------------
# Shared draw/geometry helpers
# ---------------------------------------------------------------------------

def _uniforms(gen, n_streams, N):
    """n_streams float32 U[0, 1) tensors of length N from ``gen``, on the
    generator's device."""
    return [torch.rand(N, generator=gen, dtype=F32, device=gen.device)
            for _ in range(n_streams)]


def _randint(gen, n, hi):
    """n int64 indices uniform on [0, hi) from ``gen``, on its device: the
    one place that draws star or MOLUSC-row indices (the JAX package's
    ``jax.random.randint`` on ``fold_in(key, 555 | 777)``)."""
    return torch.randint(0, int(hi), (n,), generator=gen, device=gen.device)


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


def _companion_prior_bound(kind, M_s, plx, masses_comp, fluxratios_comp,
                           cc_filt, seps, cons):
    """Bound-companion prior block of the P*/S* scenarios (reference
    ml.py:478-509, :695-727). kind: 'TP' or 'EB'. Without a contrast curve
    (cc_filt None) the TESS-band flux ratios set delta_mag; with one, the
    curve's band does. Runs in the span ``tri.prior.companion`` and counts
    its draws under ``prior.companion``."""
    with profiling.span("tri.prior.companion"):
        profiling.count("prior.companion", masses_comp.shape[0])
        if cc_filt is None:
            fr = fluxratios_comp
        else:
            fr = _fluxratio_vs_target(masses_comp, M_s, cc_filt)
        delta_mags = 2.5 * torch.log10(fr / (1.0 - fr))
        fn = lnprior_bound_TP if kind == "TP" else lnprior_bound_EB
        lnp = fn(M_s, plx, torch.abs(delta_mags), seps, cons)
        return clamp_companion_prior(lnp, delta_mags)


def _background_prior(has_cc, N_comp, fluxratios_draw, delta_band_draw,
                      seps, cons):
    """Background-star prior block of DTP / DEB / BTP (reference
    ml.py:1466-1492, :1929-1955)."""
    if not has_cc:
        delta_mags = 2.5 * torch.log10(
            fluxratios_draw / (1.0 - fluxratios_draw))
        lnp = (torch.zeros_like(delta_mags)
               + math.log((N_comp / 0.1) * (1.0 / 3600.0) ** 2 * 2.2**2))
    else:
        delta_mags = delta_band_draw
        lnp = lnprior_background(N_comp, torch.abs(delta_mags), seps, cons)
    return clamp_companion_prior(lnp, delta_mags)


# field order of the packed background table: one (N_rows, F) float32
# matrix, gathered once per draw batch
BG_PACK_FIELDS = ("fluxratios", "delta_band", "masses", "radii", "loggs",
                  "teffs", "u1s", "u2s", "fluxratios_cc")
# field order of the packed Tmag +/- 1 lookalike table
POP_PACK_FIELDS = ("masses", "radii", "loggs", "teffs", "u1s", "u2s")


def _drawn_rows(tab, idxs, fields):
    """Per-draw star properties: one gather of the packed rows."""
    rows = tab["pack"][idxs]
    return {f: rows[:, i] for i, f in enumerate(fields)}


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


@profiling.span("tri.reduce")
def run_finalize(lnL, lnprior, gather: dict):
    """finalize on a dict of gather arrays; values stay on the device."""
    names = list(gather.keys())
    lnZ, vals = finalize(lnL, lnprior, tuple(gather[n] for n in names),
                         N=lnL.shape[0])
    return lnZ, dict(zip(names, vals))


# ---------------------------------------------------------------------------
# Planet-family sampler
# ---------------------------------------------------------------------------

@profiling.span("tri.sample.planet_target")
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


def _companion_qs(gen, u, M_s, qs_comp_in, n, use_molusc, twin=False):
    """Companion mass ratios: the MOLUSC rows (zero-padded to N; a twin
    draw set resamples them by random rows, which keeps the share of zero
    padding) or the long-period companion law."""
    if not use_molusc:
        return sample_q_companion(u, M_s)
    if twin:
        return qs_comp_in[_randint(gen, n, qs_comp_in.shape[0])]
    return qs_comp_in


@profiling.span("tri.sample.ptp")
def sample_ptp(gen, P_lo, P_hi, M_s, R_s, Teff, plx, qs_comp_in, seps, cons,
               *, N, flatpriors, use_molusc, cc_filt, stratified=True):
    """PTP: a planet around the target plus an unresolved bound companion
    (reference ml.py:386-586)."""
    u = _uniforms(gen, 6, N)
    P_lo, P_hi, M_s, R_s, plx = _scalars(gen.device, P_lo, P_hi, M_s, R_s,
                                         plx)
    qs_comp = _companion_qs(gen, u[5], M_s, qs_comp_in, N, use_molusc)
    masses_comp = qs_comp * M_s
    fluxratios_comp = _fluxratio_vs_target(masses_comp, M_s)
    if use_molusc:
        lnprior = torch.zeros_like(qs_comp)
    else:
        lnprior = _companion_prior_bound("TP", M_s, plx, masses_comp,
                                         fluxratios_comp, cc_filt, seps, cons)
    P = _draw_P(u[0], P_lo, P_hi)
    rps = sample_rp(u[1], M_s.expand(N), flatpriors)
    eccs = sample_ecc(u[3], True, P.mean())
    argps = sample_w(u[4])
    a, Ptra, coll, r = _geom_base(P, M_s, R_s, rps * REARTH, eccs, argps)
    incs, tra_ok, lnw = _inc_weighted(u[2], Ptra, stratified)
    b = _impact_param(r, incs, R_s)
    mask = tra_ok & ~coll & (qs_comp != 0.0)
    inc_rad, w_rad = _kernel_angles(incs, argps)
    g = tp_dilution(fluxratios_comp / (1.0 - fluxratios_comp), False)
    return dict(P=P, rps=rps, incs=incs, eccs=eccs, argps=argps, a=a, b=b,
                mask=mask, lnw=lnw, inc_rad=inc_rad, w_rad=w_rad,
                k=rps * REARTH / (R_s * RSUN), a_R=a / (R_s * RSUN),
                g=g, lnprior=lnprior, fluxratios_comp=fluxratios_comp)


def _companion_ldc(masses_comp, radii_comp, teffs_comp, u1_tab, u2_tab):
    """Per-draw companion LDC by clamped rounding on the nearest-Z grid
    (reference ml.py:961-972)."""
    loggs_comp = torch.log10(G * (masses_comp * MSUN)
                             / torch.clamp_min(radii_comp * RSUN, 1.0) ** 2)
    i_logg, i_teff = round_index_comp(loggs_comp, teffs_comp, u1_tab.shape[1])
    return u1_tab[i_logg, i_teff], u2_tab[i_logg, i_teff]


@profiling.span("tri.sample.stp")
def sample_stp(gen, P_lo, P_hi, M_s, R_s, Teff, plx, qs_comp_in,
               u1_tab, u2_tab, seps, cons, *, N, flatpriors, use_molusc,
               cc_filt, stratified=True):
    """STP: a planet around the unresolved bound companion, with per-draw
    LDC from the nearest-Z grid (reference ml.py:869-1077)."""
    u = _uniforms(gen, 6, N)
    P_lo, P_hi, M_s, R_s, Teff, plx = _scalars(gen.device, P_lo, P_hi, M_s,
                                               R_s, Teff, plx)
    qs_comp = _companion_qs(gen, u[5], M_s, qs_comp_in, N, use_molusc)
    masses_comp = qs_comp * M_s
    radii_comp, teffs_comp = stellar_relations(masses_comp, R_s.expand(N),
                                               Teff.expand(N))
    fluxratios_comp = _fluxratio_vs_target(masses_comp, M_s)
    u1s, u2s = _companion_ldc(masses_comp, radii_comp, teffs_comp, u1_tab,
                              u2_tab)
    if use_molusc:
        lnprior = torch.zeros_like(qs_comp)
    else:
        lnprior = _companion_prior_bound("TP", M_s, plx, masses_comp,
                                         fluxratios_comp, cc_filt, seps, cons)
    P = _draw_P(u[0], P_lo, P_hi)
    rps = sample_rp(u[1], masses_comp, flatpriors)
    eccs = sample_ecc(u[3], True, P.mean())
    argps = sample_w(u[4])
    a, Ptra, coll, r = _geom_base(P, masses_comp, radii_comp, rps * REARTH,
                                  eccs, argps)
    incs, tra_ok, lnw = _inc_weighted(u[2], Ptra, stratified)
    b = _impact_param(r, incs, radii_comp)
    mask = tra_ok & ~coll & (qs_comp != 0.0)
    inc_rad, w_rad = _kernel_angles(incs, argps)
    g = tp_dilution(fluxratios_comp / (1.0 - fluxratios_comp), True)
    return dict(P=P, rps=rps, incs=incs, eccs=eccs, argps=argps, a=a, b=b,
                mask=mask, lnw=lnw, inc_rad=inc_rad, w_rad=w_rad,
                k=rps * REARTH / (radii_comp * RSUN),
                a_R=a / (radii_comp * RSUN), g=g, lnprior=lnprior,
                fluxratios_comp=fluxratios_comp, masses_comp=masses_comp,
                radii_comp=radii_comp, u1s=u1s, u2s=u2s)


def _draw_background(gen, bg, n, host_is_bg):
    """(idxs, rows, N_comp): n TRILEGAL rows drawn per draw. The index
    quirk is the reference's: DTP / DEB draw from [0, N_comp - 1) (the
    last star is never drawn, ml.py:1463), BTP / BEB from [0, N_comp)
    (ml.py:1926)."""
    N_comp = bg["pack"].shape[0]
    hi = N_comp if host_is_bg else max(N_comp - 1, 1)
    idxs = _randint(gen, n, hi)
    return idxs, _drawn_rows(bg, idxs, BG_PACK_FIELDS), N_comp


def _host_is_bg_ok(row):
    """The background host must be a dwarf (logg >= 3.5) no hotter than
    10000 K (reference ml.py:1947-1949)."""
    return (row["loggs"] >= 3.5) & (row["teffs"] <= 10000.0)


@profiling.span("tri.sample.background_planet")
def sample_background_planet(gen, P_lo, P_hi, M_s, R_s, bg, seps, cons,
                             *, N, flatpriors, has_cc, host_is_bg,
                             stratified=True):
    """DTP (host_is_bg=False): a planet around the target diluted by a
    TRILEGAL background star; BTP (host_is_bg=True): a planet around the
    background star (reference ml.py:1379-1568, :1840-2035)."""
    u = _uniforms(gen, 5, N)
    P_lo, P_hi, M_s, R_s = _scalars(gen.device, P_lo, P_hi, M_s, R_s)
    idxs, row, N_comp = _draw_background(gen, bg, N, host_is_bg)
    fluxratios_draw = row["fluxratios"]
    lnprior = _background_prior(has_cc, N_comp, fluxratios_draw,
                                row["delta_band"], seps, cons)
    P = _draw_P(u[0], P_lo, P_hi)
    F_draw = fluxratios_draw / (1.0 - fluxratios_draw)
    out = {}
    if host_is_bg:
        host_mass, host_rad = row["masses"], row["radii"]
        out["u1s"], out["u2s"] = row["u1s"], row["u2s"]
        pop_ok = _host_is_bg_ok(row)
    else:
        host_mass, host_rad = M_s.expand(N), R_s.expand(N)
        pop_ok = torch.ones_like(fluxratios_draw, dtype=torch.bool)
    g = tp_dilution(F_draw, host_is_bg)
    rps = sample_rp(u[1], host_mass, flatpriors)
    eccs = sample_ecc(u[3], True, P.mean())
    argps = sample_w(u[4])
    a, Ptra, coll, r = _geom_base(P, host_mass, host_rad, rps * REARTH,
                                  eccs, argps)
    incs, tra_ok, lnw = _inc_weighted(u[2], Ptra, stratified)
    b = _impact_param(r, incs, host_rad)
    inc_rad, w_rad = _kernel_angles(incs, argps)
    out.update(P=P, rps=rps, incs=incs, eccs=eccs, argps=argps, a=a, b=b,
               mask=tra_ok & ~coll & pop_ok, lnw=lnw, inc_rad=inc_rad,
               w_rad=w_rad, k=rps * REARTH / (host_rad * RSUN),
               a_R=a / (host_rad * RSUN), g=g, lnprior=lnprior,
               fluxratios_comp=fluxratios_draw, idxs=idxs,
               host_mass=host_mass, host_rad=host_rad)
    return out


def _draw_lookalike(gen, pop, n):
    """(idxs, rows, pop_ok): n lookalike rows drawn uniformly from
    [0, N_pos) (the JAX package's randint on ``fold_in(key, 777)``); the
    host must pass ``_host_is_bg_ok``."""
    idxs = _randint(gen, n, pop["pack"].shape[0])
    row = _drawn_rows(pop, idxs, POP_PACK_FIELDS)
    return idxs, row, _host_is_bg_ok(row)


@profiling.span("tri.sample.ntp_unknown")
def sample_ntp_unknown(gen, P_lo, P_hi, pop, *, N, flatpriors,
                       stratified=True):
    """NTP for a star of unknown properties: the host is drawn from the
    TRILEGAL Tmag +/- 1 lookalike population, no dilution (reference
    ml.py:2365-2551)."""
    u = _uniforms(gen, 5, N)
    P_lo, P_hi = _scalars(gen.device, P_lo, P_hi)
    idxs, row, pop_ok = _draw_lookalike(gen, pop, N)
    host_mass, host_rad = row["masses"], row["radii"]
    P = _draw_P(u[0], P_lo, P_hi)
    rps = sample_rp(u[1], host_mass, flatpriors)
    eccs = sample_ecc(u[3], True, P.mean())
    argps = sample_w(u[4])
    a, Ptra, coll, r = _geom_base(P, host_mass, host_rad, rps * REARTH,
                                  eccs, argps)
    incs, tra_ok, lnw = _inc_weighted(u[2], Ptra, stratified)
    b = _impact_param(r, incs, host_rad)
    inc_rad, w_rad = _kernel_angles(incs, argps)
    return dict(P=P, rps=rps, incs=incs, eccs=eccs, argps=argps, a=a, b=b,
                mask=tra_ok & ~coll & pop_ok, lnw=lnw, inc_rad=inc_rad,
                w_rad=w_rad, k=rps * REARTH / (host_rad * RSUN),
                a_R=a / (host_rad * RSUN), idxs=idxs, host_mass=host_mass,
                host_rad=host_rad, u1s=row["u1s"], u2s=row["u2s"],
                g=torch.ones_like(P), lnprior=torch.zeros_like(P))


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
        # stable, as jnp.argsort: float32 uniforms tie a few times per 1e4
        perms = torch.argsort(r, dim=1, stable=True)
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
               coll_R_occ_cm, Ptra_R_occ_cm=None):
    """Twin-branch geometry at 2P on a conditioned draw set with the
    grazing-edge inclination mixture. Ptra_R_occ_cm overrides the
    transit-probability radius (NEB_evolved's 2 R_s, reference
    ml.py:3052)."""
    a_twin = _semimajor(2.0 * P, M_tot)
    sin_argp = torch.sin(argps_deg * PI / 180.0)
    e_corr = (1.0 + eccs * sin_argp) / (1.0 - eccs**2)
    R_occ = (radii_rsun * RSUN + R_host_rsun * RSUN
             if Ptra_R_occ_cm is None else Ptra_R_occ_cm)
    Ptra = R_occ / a_twin * e_corr
    r_twin = a_twin * (1.0 - eccs**2) / (1.0 + eccs * sin_argp)
    coll = coll_R_occ_cm > a_twin * (1.0 - eccs)
    incs, tra_ok, lnw = _inc_twin_mixture(u_inc, Ptra)
    b = _impact_param(r_twin, incs, R_host_rsun)
    return dict(a=a_twin, incs=incs, b=b, geo_ok=tra_ok & ~coll, lnw=lnw)


def _and(mask, extra_ok):
    return mask if extra_ok is None else mask & extra_ok


def _twin_pack(P, qs, eccs, argps, masses, radii, fluxratios, tb,
               R_host_rsun, kk, ksec, g_pri, g_sec, lnqmass, extra_ok=None,
               lnprior=None, **extra):
    """Assemble a conditioned twin dict with the normal branch's field
    names, so consumers are uniform."""
    inc_rad, w_rad = _kernel_angles(tb["incs"], argps)
    d = dict(P=P, qs=qs, eccs=eccs, argps=argps, masses=masses, radii=radii,
             fluxratios=fluxratios, a=tb["a"], incs=tb["incs"], b=tb["b"],
             mask=_and(tb["geo_ok"], extra_ok), lnw=tb["lnw"] + lnqmass,
             inc_rad=inc_rad, w_rad=w_rad, k=kk, ksec=ksec, g_pri=g_pri,
             g_sec=g_sec, a_R=tb["a"] / (R_host_rsun * RSUN),
             lnprior=torch.zeros_like(P) if lnprior is None else lnprior)
    d.update(extra)
    return d


# per-draw companion / background fields a twin view shares with the
# normal branch
_TWIN_SHARED = ("fluxratios_comp", "masses_comp", "radii_comp", "u1s", "u2s",
                "idxs", "host_mass", "host_rad")


def _twin_alias(d):
    """Twin-branch view of a legacy shared-draw EB sampler output."""
    t = dict(P=d["P"], qs=d["qs"], eccs=d["eccs"], argps=d["argps"],
             masses=d["masses"], radii=d["radii"],
             fluxratios=d["fluxratios"], a=d["a_twin"], incs=d["incs_twin"],
             b=d["b_twin"], mask=d["mask_twin"], lnw=d["lnw_twin"],
             inc_rad=d["inc_rad_twin"], w_rad=d["w_rad"],
             k=d.get("k_twin", d["k"]), ksec=d.get("ksec_twin", d["ksec"]),
             g_pri=d["g_pri"], g_sec=d["g_sec"],
             a_R=d["a_R_twin"],
             lnprior=d.get("lnprior", torch.zeros_like(d["P"])))
    t.update((n, d[n]) for n in _TWIN_SHARED if n in d)
    return t


def _eb_normal_branch(P, M_tot, R_host_rsun, radii_rsun, eccs, argps_deg,
                      u_inc, stratified):
    """Normal-branch geometry only (the twin has its own draw set)."""
    a, Ptra, coll, r = _geom_base(P, M_tot, R_host_rsun, radii_rsun * RSUN,
                                  eccs, argps_deg)
    incs, tra_ok, lnw = _inc_weighted(u_inc, Ptra, stratified)
    b = _impact_param(r, incs, R_host_rsun)
    return dict(a=a, incs=incs, b=b, geo_ok=tra_ok & ~coll, lnw=lnw)


def _eb_pack_normal(d, P, qs, eccs, argps, masses, radii, fluxratios,
                    nb, R_host_rsun, kk, ksec, g_pri, g_sec, extra_ok=None):
    """Normal-branch fields of an EB sampler output (twin in d['twin'])."""
    inc_rad, w_rad = _kernel_angles(nb["incs"], argps)
    d.update(
        P=P, incs=nb["incs"], qs=qs, eccs=eccs, argps=argps, masses=masses,
        radii=radii, fluxratios=fluxratios, a=nb["a"], b=nb["b"],
        mask=_and(nb["geo_ok"] & (qs < 0.95), extra_ok), lnw=nb["lnw"],
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
             nb, tb, R_host_rsun, kk, ksec, g_pri, g_sec, extra_ok=None):
    inc_rad, w_rad = _kernel_angles(nb["incs"], argps)
    inc_rad_t, _ = _kernel_angles(tb["incs"], argps)
    d.update(
        P=P, incs=nb["incs"], incs_twin=tb["incs"], qs=qs, eccs=eccs,
        argps=argps, masses=masses, radii=radii, fluxratios=fluxratios,
        a=nb["a"], b=nb["b"], a_twin=tb["a"], b_twin=tb["b"],
        mask=_and(nb["geo_ok"] & (qs < 0.95), extra_ok),
        mask_twin=_and(tb["geo_ok"] & (qs >= 0.95), extra_ok),
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


@profiling.span("tri.sample.teb")
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



def _peb_fields(gen, P_lo, P_hi, M_s, R_s, Teff, plx, qs_comp_in, seps,
                cons, n, use_molusc, cc_filt, twin, lattice=True):
    """Shared PEB field block. twin=True conditions q on the twin band;
    lattice=True Latin-hypercube-stratifies the (inc, q, w, ecc, q_comp)
    streams (the companion axis is the needle dimension of PEB)."""
    u = _uniforms(gen, 6, n)
    if lattice:
        u = _lattice_strat(u, (1, 2, 4, 3, 5), n, gen)
    P = _draw_P(u[0], P_lo, P_hi)
    if twin:
        qs, lnqmass = _twin_q(u[2], M_s)
    else:
        qs, lnqmass = sample_q(u[2], M_s), 0.0
    eccs = sample_ecc(u[3], False, P.mean())
    argps = sample_w(u[4])
    qs_comp = _companion_qs(gen, u[5], M_s, qs_comp_in, n, use_molusc, twin)
    masses = qs * M_s
    radii, _ = stellar_relations(masses, R_s.expand(n), Teff.expand(n))
    fluxratios = _fluxratio_vs_target(masses, M_s)
    masses_comp = qs_comp * M_s
    fluxratios_comp = _fluxratio_vs_target(masses_comp, M_s)
    if use_molusc:
        lnprior = torch.zeros_like(qs_comp)
    else:
        lnprior = _companion_prior_bound("EB", M_s, plx, masses_comp,
                                         fluxratios_comp, cc_filt, seps, cons)
    kk, ksec = eb_radius_ratios(radii, R_s)
    F_EB = fluxratios / (1.0 - fluxratios)
    F_comp = fluxratios_comp / (1.0 - fluxratios_comp)
    g_pri, g_sec = eb_dilution(F_EB, F_comp, False)
    return (u, P, qs, lnqmass, eccs, argps, masses, radii, fluxratios,
            qs_comp, fluxratios_comp, lnprior, kk, ksec, g_pri, g_sec)


@profiling.span("tri.sample.peb")
def sample_peb(gen, P_lo, P_hi, M_s, R_s, Teff, plx, qs_comp_in, seps, cons,
               *, N, use_molusc, cc_filt, stratified=True, twin_n=0):
    """PEB: the target is an EB with an unresolved bound companion
    (reference ml.py:589-866)."""
    P_lo, P_hi, M_s, R_s, Teff, plx = _scalars(gen.device, P_lo, P_hi, M_s,
                                               R_s, Teff, plx)
    (u, P, qs, _, eccs, argps, masses, radii, fluxratios, qs_comp,
     fluxratios_comp, lnprior, kk, ksec, g_pri, g_sec) = _peb_fields(
        gen, P_lo, P_hi, M_s, R_s, Teff, plx, qs_comp_in, seps, cons, N,
        use_molusc, cc_filt, twin=False, lattice=stratified)
    extra = dict(fluxratios_comp=fluxratios_comp, lnprior=lnprior)
    if stratified and twin_n:
        nb = _eb_normal_branch(P, M_s + masses, R_s, radii, eccs, argps,
                               u[1], stratified)
        d = _eb_pack_normal(extra, P, qs, eccs, argps, masses, radii,
                            fluxratios, nb, R_s, kk, ksec, g_pri, g_sec,
                            qs_comp != 0.0)
        (ut, Pt, qst, lnqm, eccst, argpst, massest, radiit, frt, qs_compt,
         fr_compt, lnpriort, kkt, ksect, g_prit, g_sect) = _peb_fields(
            gen, P_lo, P_hi, M_s, R_s, Teff, plx, qs_comp_in, seps, cons,
            twin_n, use_molusc, cc_filt, twin=True)
        tbt = _twin_geom(Pt, M_s + massest, R_s, radiit, eccst, argpst,
                         ut[1], 2.0 * R_s * RSUN)
        d["twin"] = _twin_pack(Pt, qst, eccst, argpst, massest, radiit, frt,
                               tbt, R_s, kkt, ksect, g_prit, g_sect, lnqm,
                               extra_ok=qs_compt != 0.0, lnprior=lnpriort,
                               fluxratios_comp=fr_compt)
        return d
    nb, tb = _eb_branches(P, M_s + masses, R_s, radii, eccs, argps, u[1],
                          2.0 * R_s * RSUN, stratified)
    d = _eb_pack(extra, P, qs, eccs, argps, masses, radii, fluxratios,
                 nb, tb, R_s, kk, ksec, g_pri, g_sec, qs_comp != 0.0)
    d["twin"] = _twin_alias(d)
    return d


def _seb_fields(gen, P_lo, P_hi, M_s, R_s, Teff, plx, qs_comp_in, u1_tab,
                u2_tab, seps, cons, n, use_molusc, cc_filt, twin,
                lattice=True):
    """Shared SEB field block: the companion chain, its per-draw LDC and
    the EB around it. The companion-host stream (axis 5) sets the whole
    dilution / LDC chain, so it joins the lattice."""
    u = _uniforms(gen, 6, n)
    if lattice:
        u = _lattice_strat(u, (1, 2, 4, 3, 5), n, gen)
    P = _draw_P(u[0], P_lo, P_hi)
    if twin:
        qs, lnqmass = _twin_q(u[2], M_s)
    else:
        qs, lnqmass = sample_q(u[2], M_s), 0.0
    eccs = sample_ecc(u[3], False, P.mean())
    argps = sample_w(u[4])
    qs_comp = _companion_qs(gen, u[5], M_s, qs_comp_in, n, use_molusc, twin)
    masses_comp = qs_comp * M_s
    radii_comp, teffs_comp = stellar_relations(masses_comp, R_s.expand(n),
                                               Teff.expand(n))
    fluxratios_comp = _fluxratio_vs_target(masses_comp, M_s)
    u1s, u2s = _companion_ldc(masses_comp, radii_comp, teffs_comp, u1_tab,
                              u2_tab)
    masses = qs * masses_comp
    radii, _ = stellar_relations(masses, radii_comp, teffs_comp)
    fluxratios = _fluxratio_vs_target(masses, M_s)
    if use_molusc:
        lnprior = torch.zeros_like(qs_comp)
    else:
        # the prior's delta-mag combines the companion and its EB
        # (ml.py:1200-1235); the span and counter of _companion_prior_bound
        with profiling.span("tri.prior.companion"):
            profiling.count("prior.companion", n)
            if cc_filt is None:
                fr_c, fr_e = fluxratios_comp, fluxratios
            else:
                fr_c = _fluxratio_vs_target(masses_comp, M_s, cc_filt)
                fr_e = _fluxratio_vs_target(masses, M_s, cc_filt)
            delta_mags = 2.5 * torch.log10(fr_c / (1.0 - fr_c)
                                           + fr_e / (1.0 - fr_e))
            lnp = lnprior_bound_EB(M_s, plx, torch.abs(delta_mags), seps,
                                   cons)
            lnprior = clamp_companion_prior(lnp, delta_mags)
    kk, ksec = eb_radius_ratios(radii, radii_comp)
    F_EB = fluxratios / (1.0 - fluxratios)
    F_comp = fluxratios_comp / (1.0 - fluxratios_comp)
    g_pri, g_sec = eb_dilution(F_EB, F_comp, True)
    return (u, P, qs, lnqmass, eccs, argps, masses, radii, fluxratios,
            qs_comp, masses_comp, radii_comp, fluxratios_comp, u1s, u2s,
            lnprior, kk, ksec, g_pri, g_sec)


@profiling.span("tri.sample.seb")
def sample_seb(gen, P_lo, P_hi, M_s, R_s, Teff, plx, qs_comp_in,
               u1_tab, u2_tab, seps, cons, *, N, use_molusc, cc_filt,
               stratified=True, twin_n=0):
    """SEB: the unresolved bound companion is itself an EB (reference
    ml.py:1080-1376). The EB flux ratio's denominator uses the target's
    mass (ml.py:1193-1196)."""
    P_lo, P_hi, M_s, R_s, Teff, plx = _scalars(gen.device, P_lo, P_hi, M_s,
                                               R_s, Teff, plx)
    (u, P, qs, _, eccs, argps, masses, radii, fluxratios, qs_comp,
     masses_comp, radii_comp, fluxratios_comp, u1s, u2s, lnprior,
     kk, ksec, g_pri, g_sec) = _seb_fields(
        gen, P_lo, P_hi, M_s, R_s, Teff, plx, qs_comp_in, u1_tab, u2_tab,
        seps, cons, N, use_molusc, cc_filt, twin=False, lattice=stratified)
    extra = dict(fluxratios_comp=fluxratios_comp, lnprior=lnprior,
                 masses_comp=masses_comp, radii_comp=radii_comp,
                 u1s=u1s, u2s=u2s)
    if stratified and twin_n:
        nb = _eb_normal_branch(P, masses_comp + masses, radii_comp, radii,
                               eccs, argps, u[1], stratified)
        d = _eb_pack_normal(extra, P, qs, eccs, argps, masses, radii,
                            fluxratios, nb, radii_comp, kk, ksec, g_pri,
                            g_sec, qs_comp != 0.0)
        (ut, Pt, qst, lnqm, eccst, argpst, massest, radiit, frt, qs_compt,
         m_compt, r_compt, fr_compt, u1st, u2st, lnpriort, kkt, ksect,
         g_prit, g_sect) = _seb_fields(
            gen, P_lo, P_hi, M_s, R_s, Teff, plx, qs_comp_in, u1_tab,
            u2_tab, seps, cons, twin_n, use_molusc, cc_filt, twin=True)
        tbt = _twin_geom(Pt, m_compt + massest, r_compt, radiit, eccst,
                         argpst, ut[1], 2.0 * r_compt * RSUN)
        d["twin"] = _twin_pack(Pt, qst, eccst, argpst, massest, radiit, frt,
                               tbt, r_compt, kkt, ksect, g_prit, g_sect,
                               lnqm, extra_ok=qs_compt != 0.0,
                               lnprior=lnpriort, fluxratios_comp=fr_compt,
                               masses_comp=m_compt, radii_comp=r_compt,
                               u1s=u1st, u2s=u2st)
        return d
    nb, tb = _eb_branches(P, masses_comp + masses, radii_comp, radii, eccs,
                          argps, u[1], 2.0 * radii_comp * RSUN, stratified)
    d = _eb_pack(extra, P, qs, eccs, argps, masses, radii, fluxratios,
                 nb, tb, radii_comp, kk, ksec, g_pri, g_sec, qs_comp != 0.0)
    d["twin"] = _twin_alias(d)
    return d


def _bg_eb_fields(gen, P_lo, P_hi, M_s, R_s, Teff, bg, seps, cons, n,
                  has_cc, host_is_bg, cc_filt, twin):
    """Shared DEB / BEB field block, with its own background-row draws."""
    u = _uniforms(gen, 5, n)
    if twin:
        u = _lattice_strat(u, (1, 2, 4, 3), n, gen)
    idxs, row, N_comp = _draw_background(gen, bg, n, host_is_bg)
    fluxratios_draw = row["fluxratios"]
    P = _draw_P(u[0], P_lo, P_hi)
    if twin:
        qs, lnqmass = _twin_q(u[2], M_s)
    else:
        qs, lnqmass = sample_q(u[2], M_s), 0.0
    eccs = sample_ecc(u[3], False, P.mean())
    argps = sample_w(u[4])
    F_comp = fluxratios_draw / (1.0 - fluxratios_draw)
    if host_is_bg:
        host_mass, host_rad = row["masses"], row["radii"]
        pop_ok = _host_is_bg_ok(row)
        masses = qs * host_mass
        radii, _ = stellar_relations(masses, host_rad, row["teffs"])
        # distance correction of the EB's flux ratio (ml.py:2146-2159)
        dist_corr = fluxratios_draw / _fluxratio_vs_target(host_mass, M_s)
        fluxratios = _fluxratio_vs_target(masses, M_s) * dist_corr
        g_pri, g_sec = eb_dilution(fluxratios / (1.0 - fluxratios), F_comp,
                                   True)
        # BEB's prior combines the background star and its EB; with a
        # contrast curve both take the curve band's distance correction
        # (ml.py:2160-2209)
        if has_cc:
            fr_c_cc = row["fluxratios_cc"]
            fr_bound_cc = _fluxratio_vs_target(host_mass, M_s, cc_filt)
            fr_eb_cc = (_fluxratio_vs_target(masses, M_s, cc_filt)
                        * (fr_c_cc / fr_bound_cc))
            delta_mags = 2.5 * torch.log10(fr_c_cc / (1.0 - fr_c_cc)
                                           + fr_eb_cc / (1.0 - fr_eb_cc))
            lnp = lnprior_background(N_comp, torch.abs(delta_mags), seps,
                                     cons)
        else:
            delta_mags = 2.5 * torch.log10(F_comp
                                           + fluxratios / (1.0 - fluxratios))
            lnp = (torch.zeros_like(delta_mags)
                   + math.log((N_comp / 0.1) * (1.0 / 3600.0) ** 2 * 2.2**2))
        lnprior = clamp_companion_prior(lnp, delta_mags)
        u1s, u2s = row["u1s"], row["u2s"]
    else:
        host_mass, host_rad = M_s.expand(n), R_s.expand(n)
        pop_ok = torch.ones_like(fluxratios_draw, dtype=torch.bool)
        masses = qs * M_s
        radii, _ = stellar_relations(masses, R_s.expand(n), Teff.expand(n))
        fluxratios = _fluxratio_vs_target(masses, M_s)
        g_pri, g_sec = eb_dilution(fluxratios / (1.0 - fluxratios), F_comp,
                                   False)
        # DEB uses the DTP prior block (ml.py:1674-1701)
        lnprior = _background_prior(has_cc, N_comp, fluxratios_draw,
                                    row["delta_band"], seps, cons)
        u1s = u2s = None
    kk, ksec = eb_radius_ratios(radii, host_rad)
    return (u, P, qs, lnqmass, eccs, argps, masses, radii, fluxratios,
            fluxratios_draw, idxs, host_mass, host_rad, u1s, u2s, pop_ok,
            lnprior, kk, ksec, g_pri, g_sec)


@profiling.span("tri.sample.background_eb")
def sample_background_eb(gen, P_lo, P_hi, M_s, R_s, Teff, bg, seps, cons,
                         *, N, has_cc, host_is_bg, cc_filt="TESS",
                         stratified=True, twin_n=0):
    """DEB (host_is_bg=False): the target is an EB diluted by a TRILEGAL
    background star; BEB (host_is_bg=True): the background star is the EB
    (reference ml.py:1571-1837, :2038-2362)."""
    P_lo, P_hi, M_s, R_s, Teff = _scalars(gen.device, P_lo, P_hi, M_s, R_s,
                                          Teff)
    (u, P, qs, _, eccs, argps, masses, radii, fluxratios, fluxratios_draw,
     idxs, host_mass, host_rad, u1s, u2s, pop_ok, lnprior,
     kk, ksec, g_pri, g_sec) = _bg_eb_fields(
        gen, P_lo, P_hi, M_s, R_s, Teff, bg, seps, cons, N, has_cc,
        host_is_bg, cc_filt, twin=False)
    extra = dict(fluxratios_comp=fluxratios_draw, lnprior=lnprior, idxs=idxs,
                 host_mass=host_mass, host_rad=host_rad)
    if u1s is not None:
        extra["u1s"], extra["u2s"] = u1s, u2s
    if stratified and twin_n:
        nb = _eb_normal_branch(P, host_mass + masses, host_rad, radii, eccs,
                               argps, u[1], stratified)
        d = _eb_pack_normal(extra, P, qs, eccs, argps, masses, radii,
                            fluxratios, nb, host_rad, kk, ksec, g_pri,
                            g_sec, pop_ok)
        (ut, Pt, qst, lnqm, eccst, argpst, massest, radiit, frt, fr_drawt,
         idxst, h_mt, h_rt, u1st, u2st, pop_okt, lnpriort,
         kkt, ksect, g_prit, g_sect) = _bg_eb_fields(
            gen, P_lo, P_hi, M_s, R_s, Teff, bg, seps, cons, twin_n, has_cc,
            host_is_bg, cc_filt, twin=True)
        tbt = _twin_geom(Pt, h_mt + massest, h_rt, radiit, eccst, argpst,
                         ut[1], 2.0 * h_rt * RSUN)
        textra = dict(fluxratios_comp=fr_drawt, idxs=idxst, host_mass=h_mt,
                      host_rad=h_rt)
        if u1st is not None:
            textra["u1s"], textra["u2s"] = u1st, u2st
        d["twin"] = _twin_pack(Pt, qst, eccst, argpst, massest, radiit, frt,
                               tbt, h_rt, kkt, ksect, g_prit, g_sect, lnqm,
                               extra_ok=pop_okt, lnprior=lnpriort, **textra)
        return d
    nb, tb = _eb_branches(P, host_mass + masses, host_rad, radii, eccs,
                          argps, u[1], 2.0 * host_rad * RSUN, stratified)
    d = _eb_pack(extra, P, qs, eccs, argps, masses, radii, fluxratios,
                 nb, tb, host_rad, kk, ksec, g_pri, g_sec, pop_ok)
    d["twin"] = _twin_alias(d)
    return d


def _neb_evolved_fields(gen, P_lo, P_hi, M_s, R_s, Teff, n, twin):
    """NEB_evolved field block: q is drawn as for a one-solar-mass primary,
    the EB's flux ratio against the host."""
    u = _uniforms(gen, 5, n)
    if twin:
        u = _lattice_strat(u, (1, 2, 4, 3), n, gen)
    one = torch.ones((), dtype=F32, device=gen.device)
    P = _draw_P(u[0], P_lo, P_hi)
    if twin:
        qs, lnqmass = _twin_q(u[2], one)
    else:
        qs, lnqmass = sample_q(u[2], one), 0.0
    eccs = sample_ecc(u[3], False, P.mean())
    argps = sample_w(u[4])
    masses = qs * M_s
    radii, _ = stellar_relations(masses, R_s.expand(n), Teff.expand(n))
    fluxratios = _fluxratio_vs_target(masses, M_s)
    F_EB = fluxratios / (1.0 - fluxratios)
    g_pri, g_sec = eb_dilution(F_EB, torch.zeros_like(F_EB), False)
    return (u, P, qs, lnqmass, eccs, argps, masses, radii, fluxratios,
            g_pri, g_sec)


@profiling.span("tri.sample.neb_evolved")
def sample_neb_evolved(gen, P_lo, P_hi, M_s, R_s, Teff, *, N,
                       stratified=True, twin_n=0):
    """NEB for a subgiant (logg = 3.0 sets M_s on the host; reference
    ml.py:2969-3178). The twin branch keeps two quirks: its transit
    probability and collision radius are 2 R_s (not radii + R_s,
    ml.py:3052), and its lnL takes R_EB = R_s, so k = ksec = 1 before the
    0.999 adjustment (ml.py:3100)."""
    P_lo, P_hi, M_s, R_s, Teff = _scalars(gen.device, P_lo, P_hi, M_s, R_s,
                                          Teff)
    (u, P, qs, _, eccs, argps, masses, radii, fluxratios,
     g_pri, g_sec) = _neb_evolved_fields(gen, P_lo, P_hi, M_s, R_s, Teff, N,
                                         twin=False)
    kk, ksec = eb_radius_ratios(radii, R_s)
    R_occ2 = 2.0 * R_s * RSUN
    if stratified and twin_n:
        nb = _eb_normal_branch(P, M_s + masses, R_s, radii, eccs, argps,
                               u[1], stratified)
        d = _eb_pack_normal({}, P, qs, eccs, argps, masses, radii,
                            fluxratios, nb, R_s, kk, ksec, g_pri, g_sec)
        (ut, Pt, qst, lnqm, eccst, argpst, massest, radiit, frt,
         g_prit, g_sect) = _neb_evolved_fields(gen, P_lo, P_hi, M_s, R_s,
                                               Teff, twin_n, twin=True)
        tbt = _twin_geom(Pt, M_s + massest, R_s, radiit, eccst, argpst,
                         ut[1], R_occ2, Ptra_R_occ_cm=R_occ2)
        k_t, ksec_t = eb_radius_ratios(R_s.expand(twin_n), R_s)
        d["twin"] = _twin_pack(Pt, qst, eccst, argpst, massest, radiit, frt,
                               tbt, R_s, k_t, ksec_t, g_prit, g_sect, lnqm)
        return d
    nb = _eb_normal_branch(P, M_s + masses, R_s, radii, eccs, argps, u[1],
                           stratified)
    # the legacy shared-draw twin branch with the 2 R_s quirks
    a_twin = _semimajor(2.0 * P, M_s + masses)
    sin_argp = torch.sin(argps * PI / 180.0)
    e_corr = (1.0 + eccs * sin_argp) / (1.0 - eccs**2)
    r_twin = a_twin * (1.0 - eccs**2) / (1.0 + eccs * sin_argp)
    incs_t, tra_ok_t, lnw_t = _inc_weighted(u[1], R_occ2 / a_twin * e_corr,
                                            stratified)
    tb = dict(a=a_twin, incs=incs_t, b=_impact_param(r_twin, incs_t, R_s),
              geo_ok=tra_ok_t & ~(R_occ2 > a_twin * (1.0 - eccs)),
              lnw=lnw_t)
    d = _eb_pack({}, P, qs, eccs, argps, masses, radii, fluxratios, nb, tb,
                 R_s, kk, ksec, g_pri, g_sec)
    d["k_twin"], d["ksec_twin"] = eb_radius_ratios(R_s.expand(N), R_s)
    d["twin"] = _twin_alias(d)
    return d


def _neb_unknown_fields(gen, P_lo, P_hi, pop, n, twin):
    """NEB_unknown field block, with its own lookalike-row draws: q is
    drawn as for a one-solar-mass primary and the EB's flux ratio is taken
    against the drawn host in the TESS band, whatever the mission
    (reference ml.py:2672-2676)."""
    u = _uniforms(gen, 5, n)
    if twin:
        u = _lattice_strat(u, (1, 2, 4, 3), n, gen)
    idxs, row, pop_ok = _draw_lookalike(gen, pop, n)
    host_mass, host_rad = row["masses"], row["radii"]
    one = torch.ones((), dtype=F32, device=gen.device)
    P = _draw_P(u[0], P_lo, P_hi)
    if twin:
        qs, lnqmass = _twin_q(u[2], one)
    else:
        qs, lnqmass = sample_q(u[2], one), 0.0
    eccs = sample_ecc(u[3], False, P.mean())
    argps = sample_w(u[4])
    masses = qs * host_mass
    radii, _ = stellar_relations(masses, host_rad, row["teffs"])
    f_eb = flux_relation(masses, "TESS")
    fluxratios = f_eb / (f_eb + flux_relation(host_mass, "TESS"))
    kk, ksec = eb_radius_ratios(radii, host_rad)
    F_EB = fluxratios / (1.0 - fluxratios)
    g_pri, g_sec = eb_dilution(F_EB, torch.zeros_like(F_EB), False)
    return (u, P, qs, lnqmass, eccs, argps, masses, radii, fluxratios,
            idxs, host_mass, host_rad, row["u1s"], row["u2s"], pop_ok, kk,
            ksec, g_pri, g_sec)


@profiling.span("tri.sample.neb_unknown")
def sample_neb_unknown(gen, P_lo, P_hi, pop, *, N, stratified=True,
                       twin_n=0):
    """NEB for a star of unknown properties, its host drawn from the
    lookalike population (reference ml.py:2554-2829). The twin draw set
    has its own lookalike rows and limb darkening."""
    P_lo, P_hi = _scalars(gen.device, P_lo, P_hi)
    (u, P, qs, _, eccs, argps, masses, radii, fluxratios, idxs,
     host_mass, host_rad, u1s, u2s, pop_ok, kk, ksec,
     g_pri, g_sec) = _neb_unknown_fields(gen, P_lo, P_hi, pop, N,
                                         twin=False)
    extra = dict(idxs=idxs, host_mass=host_mass, host_rad=host_rad,
                 u1s=u1s, u2s=u2s, g=torch.ones_like(P),
                 lnprior=torch.zeros_like(P))
    if stratified and twin_n:
        nb = _eb_normal_branch(P, host_mass + masses, host_rad, radii, eccs,
                               argps, u[1], stratified)
        d = _eb_pack_normal(extra, P, qs, eccs, argps, masses, radii,
                            fluxratios, nb, host_rad, kk, ksec, g_pri,
                            g_sec, pop_ok)
        (ut, Pt, qst, lnqm, eccst, argpst, massest, radiit, frt, idxst,
         h_mt, h_rt, u1st, u2st, pop_okt, kkt, ksect,
         g_prit, g_sect) = _neb_unknown_fields(gen, P_lo, P_hi, pop, twin_n,
                                               twin=True)
        tbt = _twin_geom(Pt, h_mt + massest, h_rt, radiit, eccst, argpst,
                         ut[1], 2.0 * h_rt * RSUN)
        d["twin"] = _twin_pack(Pt, qst, eccst, argpst, massest, radiit, frt,
                               tbt, h_rt, kkt, ksect, g_prit, g_sect, lnqm,
                               extra_ok=pop_okt, idxs=idxst, host_mass=h_mt,
                               host_rad=h_rt, u1s=u1st, u2s=u2st)
        return d
    nb, tb = _eb_branches(P, host_mass + masses, host_rad, radii, eccs,
                          argps, u[1], 2.0 * host_rad * RSUN, stratified)
    d = _eb_pack(extra, P, qs, eccs, argps, masses, radii, fluxratios,
                 nb, tb, host_rad, kk, ksec, g_pri, g_sec, pop_ok)
    d["twin"] = _twin_alias(d)
    return d
