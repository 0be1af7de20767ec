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

Each sampler of a target-star or nearby-star row routes by its
generator's device (``_routed``): a CUDA generator runs its card path,
which keeps the same uniform and index draws, in the same order, and the
periods, their mean, the lattice's argsort and the priors in torch, and
hands the rest of each branch to one launch of ``ops/sampler_kernels.py``
(``csrc/samplers.cu``), whose fields equal the plain chain's bit for bit;
a CPU generator runs the plain torch chain, reachable on any device as
``<sampler>.plain``. The dormant samplers (``sample_ntp_unknown``,
``sample_neb_unknown``, ``sample_neb_evolved``) run their plain chain
everywhere.

Each sampler runs in the span ``tri.sample.<name>`` (``sample_ptp`` in
``tri.sample.ptp``), each bound-companion prior block of the P* and S*
samplers (companion law, no MOLUSC file) in ``tri.prior.companion`` with
its draws counted under ``prior.companion``, and ``run_finalize`` in
``tri.reduce``, of ``utils/profiling.py``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
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
from ..populations.packs import BG_PACK_FIELDS, POP_PACK_FIELDS
from ..populations.stellar import stellar_relations, flux_relation
from ..ops.lightcurve import eb_radius_ratios, eb_dilution, tp_dilution
from ..ops import sampler_kernels as sk
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


def _draw_P_card(u, P_lo, P_hi):
    """``_draw_P`` on the float32 P_lo and P_hi of ``_scalars`` without
    uploading them: P_hi - P_lo is the float32 difference, and a Python
    float that is a float32 value enters the tensor ops exactly."""
    lo, hi = sk.by_value(P_lo, P_hi)
    return lo + u * float(np.float32(hi) - np.float32(lo))


def _routed(card):
    """A sampler whose CUDA generator runs ``card`` (module docstring) and
    whose CPU generator runs the plain chain it decorates; the plain chain
    stays reachable as ``.plain``."""
    def deco(plain):
        @functools.wraps(plain)
        def sampler(gen, *args, **kwargs):
            if gen.device.type == "cuda":
                return card(gen, *args, **kwargs)
            return plain(gen, *args, **kwargs)
        sampler.plain = plain
        return sampler
    return deco


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


def _companion_prior_bound(kind, M_s, plx, cc_filt, seps, cons, *bodies):
    """Bound-companion prior block of the P*/S* scenarios (reference
    ml.py:478-509, :695-727, :1200-1235). kind: 'TP' or 'EB'. bodies:
    (masses, TESS-band flux ratios) of the companion and, for SEB, of its
    EB; delta_mag is that of their summed flux. Without a contrast curve
    (cc_filt None) the TESS-band flux ratios set it; with one, the curve's
    band does. Runs in the span ``tri.prior.companion`` and counts its
    draws under ``prior.companion``."""
    with profiling.span("tri.prior.companion"):
        profiling.count("prior.companion", bodies[0][0].shape[0])
        F = []
        for masses, fr in bodies:
            if cc_filt is not None:
                fr = _fluxratio_vs_target(masses, M_s, cc_filt)
            F.append(fr / (1.0 - fr))
        delta_mags = 2.5 * torch.log10(sum(F[1:], F[0]))
        fn = lnprior_bound_TP if kind == "TP" else lnprior_bound_EB
        lnp = fn(M_s, plx, torch.abs(delta_mags), seps, cons)
        return clamp_companion_prior(lnp, delta_mags)


def _companion_lnprior(use_molusc, kind, M_s, plx, cc_filt, seps, cons,
                       *bodies):
    """A PTP / STP / PEB / SEB branch's log-prior: zero with MOLUSC rows,
    else ``_companion_prior_bound``."""
    if use_molusc:
        return torch.zeros_like(bodies[0][1])
    return _companion_prior_bound(kind, M_s, plx, cc_filt, seps, cons,
                                  *bodies)


def _bound_eb_lnprior(star, use_molusc, M_s, plx, f, cc_filt, seps, cons):
    """The log-prior of a PEB (star 'P') or SEB (star 'S') branch's fields
    f, on either path: SEB's delta-mag adds its EB to the companion
    (ml.py:1200-1235)."""
    bodies = [(f["masses_comp"], f["fluxratios_comp"])]
    if star == "S":
        bodies.append((f["masses"], f["fluxratios"]))
    return _companion_lnprior(use_molusc, "EB", M_s, plx, cc_filt, seps,
                              cons, *bodies)


def _beb_prior(has_cc, N_comp, M_s, host_mass, masses, fluxratios,
               fluxratios_draw, fluxratios_cc, cc_filt, seps, cons):
    """BEB's prior: it combines the background star and its EB; with a
    contrast curve both take the curve band's distance correction
    (ml.py:2160-2209)."""
    if has_cc:
        fr_bound_cc = _fluxratio_vs_target(host_mass, M_s, cc_filt)
        fr_eb_cc = (_fluxratio_vs_target(masses, M_s, cc_filt)
                    * (fluxratios_cc / fr_bound_cc))
        delta_mags = 2.5 * torch.log10(fluxratios_cc / (1.0 - fluxratios_cc)
                                       + fr_eb_cc / (1.0 - fr_eb_cc))
        lnp = lnprior_background(N_comp, torch.abs(delta_mags), seps, cons)
    else:
        F_comp = fluxratios_draw / (1.0 - fluxratios_draw)
        delta_mags = 2.5 * torch.log10(F_comp
                                       + fluxratios / (1.0 - fluxratios))
        lnp = (torch.zeros_like(delta_mags)
               + math.log((N_comp / 0.1) * (1.0 / 3600.0) ** 2 * 2.2**2))
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


def _bg_eb_lnprior(host_is_bg, has_cc, N_comp, M_s, f, band, cc_filt, seps,
                   cons):
    """The log-prior of a BEB (host_is_bg) or DEB branch's fields f, on
    either path; band: the drawn rows' contrast-curve flux ratios (BEB) or
    delta-mags (DEB), read only with a contrast curve. DEB takes the DTP
    prior block (ml.py:1674-1701)."""
    if host_is_bg:
        return _beb_prior(has_cc, N_comp, M_s, f["host_mass"], f["masses"],
                          f["fluxratios"], f["fluxratios_comp"], band,
                          cc_filt, seps, cons)
    return _background_prior(has_cc, N_comp, f["fluxratios_comp"], band,
                             seps, cons)


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
# Card paths: one sampler-kernel launch a branch (ops/sampler_kernels.py)
# ---------------------------------------------------------------------------

# the fields each branch returns, as the plain chain names them
_PLANET_KEYS = ("P", "rps", "incs", "eccs", "argps", "a", "b", "mask", "lnw",
                "inc_rad", "w_rad", "k", "a_R")
_EB_KEYS = ("incs", "qs", "eccs", "argps", "masses", "radii", "fluxratios",
            "a", "b", "mask", "lnw", "inc_rad", "w_rad", "k", "ksec", "g_pri",
            "g_sec", "a_R")
_SHARED_TWIN_KEYS = ("incs_twin", "a_twin", "b_twin", "mask_twin",
                     "lnw_twin", "inc_rad_twin", "a_R_twin")
# where M_s and plx sit in the scalars a launch writes back: their 0-d
# views are the float32 tensors _scalars would upload, for the priors
_M_S, _PLX = sk.SCALARS.index("M_s"), sk.SCALARS.index("plx")


def _eb_branch_card(gen, mode, star, scalars, n, names, *, lattice,
                    draw_rows=None, **kw):
    """One EB branch on the card (mode as ``_eb_split``'s): (fields with P,
    scal, drawn rows). Its uniform streams (6 for stars P and S, else 5),
    lattice permutations and drawn rows (``draw_rows(gen, n)``) come in
    the plain chain's order; its periods and their mean are torch's; the
    kernel does the rest and returns ``_EB_KEYS``, the shared-draw twin
    fields in mode "shared", and ``names``."""
    u = _uniforms(gen, 6 if star in "PS" else 5, n)
    perm = _lattice_perms(gen, len(u) - 2, n) if lattice else None
    idx = None if draw_rows is None else draw_rows(gen, n)
    P = _draw_P_card(u[0], scalars[0], scalars[1])
    names = _EB_KEYS + (_SHARED_TWIN_KEYS if mode == "shared" else ()) + names
    f, scal = sk.launch("twin" if mode == "twin" else "eb", star, n, u,
                        scalars, names, P=P, P_mean=P.mean(), perm=perm,
                        idx=idx, shared_twin=mode == "shared", **kw)
    return {"P": P, **f}, scal, idx


def _planet_target_card(gen, P_lo, P_hi, M_s, R_s, *, N, flatpriors,
                        stratified=True):
    f, _ = sk.launch("planet", "T", N, _uniforms(gen, 5, N),
                     (P_lo, P_hi, M_s, R_s), _PLANET_KEYS,
                     flatpriors=flatpriors, stratified=stratified)
    return f


def _ptp_card(gen, P_lo, P_hi, M_s, R_s, Teff, plx, qs_comp_in, seps, cons,
              *, N, flatpriors, use_molusc, cc_filt, stratified=True):
    names = (_PLANET_KEYS + ("g", "fluxratios_comp")
             + (() if use_molusc else ("masses_comp",)))
    f, scal = sk.launch("planet", "P", N, _uniforms(gen, 6, N),
                        (P_lo, P_hi, M_s, R_s, Teff, plx), names,
                        qs_in=qs_comp_in if use_molusc else None,
                        flatpriors=flatpriors, stratified=stratified,
                        use_molusc=use_molusc)
    f["lnprior"] = _companion_lnprior(
        use_molusc, "TP", scal[_M_S], scal[_PLX], cc_filt, seps, cons,
        (f.pop("masses_comp", None), f["fluxratios_comp"]))
    return f


def _stp_card(gen, P_lo, P_hi, M_s, R_s, Teff, plx, qs_comp_in, u1_tab,
              u2_tab, seps, cons, *, N, flatpriors, use_molusc, cc_filt,
              stratified=True):
    names = _PLANET_KEYS + ("g", "fluxratios_comp", "masses_comp",
                            "radii_comp", "u1s", "u2s")
    f, scal = sk.launch("planet", "S", N, _uniforms(gen, 6, N),
                        (P_lo, P_hi, M_s, R_s, Teff, plx), names,
                        qs_in=qs_comp_in if use_molusc else None,
                        ldc=(u1_tab, u2_tab), flatpriors=flatpriors,
                        stratified=stratified, use_molusc=use_molusc)
    f["lnprior"] = _companion_lnprior(
        use_molusc, "TP", scal[_M_S], scal[_PLX], cc_filt, seps, cons,
        (f["masses_comp"], f["fluxratios_comp"]))
    return f


def _background_planet_card(gen, P_lo, P_hi, M_s, R_s, bg, seps, cons, *, N,
                            flatpriors, has_cc, host_is_bg, stratified=True):
    u = _uniforms(gen, 5, N)
    idxs, N_comp = _background_idxs(gen, bg, N, host_is_bg)
    names = (_PLANET_KEYS + ("g", "fluxratios_comp", "host_mass", "host_rad")
             + (("u1s", "u2s") if host_is_bg else ())
             + (("delta_band",) if has_cc else ()))
    f, _ = sk.launch("planet", "B" if host_is_bg else "D", N, u,
                     (P_lo, P_hi, M_s, R_s), names, idx=idxs,
                     pack=bg["pack"], flatpriors=flatpriors,
                     stratified=stratified)
    f["lnprior"] = _background_prior(has_cc, N_comp, f["fluxratios_comp"],
                                     f.pop("delta_band", None), seps, cons)
    f["idxs"] = idxs
    return f


def _teb_card(gen, P_lo, P_hi, M_s, R_s, Teff, *, N, stratified=True,
              twin_n=0):
    def branch(n, mode):
        return _eb_branch_card(gen, mode, "T", (P_lo, P_hi, M_s, R_s, Teff),
                               n, (), lattice=mode == "twin",
                               stratified=stratified)[0]
    return _eb_split(branch, N, stratified, twin_n)


def _bound_eb_card(star, gen, P_lo, P_hi, M_s, R_s, Teff, plx, qs_comp_in,
                   ldc, seps, cons, N, use_molusc, cc_filt, stratified,
                   twin_n):
    """PEB (star P) and SEB (star S) on the card."""
    comp = ("fluxratios_comp", "masses_comp") + (
        ("radii_comp", "u1s", "u2s") if star == "S" else ())

    def rows(g, n):
        return _randint(g, n, qs_comp_in.shape[0])

    def branch(n, mode):
        f, scal, _ = _eb_branch_card(
            gen, mode, star, (P_lo, P_hi, M_s, R_s, Teff, plx), n, comp,
            lattice=stratified,
            draw_rows=rows if use_molusc and mode == "twin" else None,
            qs_in=qs_comp_in if use_molusc else None, ldc=ldc,
            use_molusc=use_molusc, stratified=stratified)
        f["lnprior"] = _bound_eb_lnprior(star, use_molusc, scal[_M_S],
                                         scal[_PLX], f, cc_filt, seps, cons)
        if star == "P":
            del f["masses_comp"]  # PEB returns no companion masses
        return f
    return _eb_split(branch, N, stratified, twin_n)


def _peb_card(gen, P_lo, P_hi, M_s, R_s, Teff, plx, qs_comp_in, seps, cons,
              *, N, use_molusc, cc_filt, stratified=True, twin_n=0):
    return _bound_eb_card("P", gen, P_lo, P_hi, M_s, R_s, Teff, plx,
                          qs_comp_in, None, seps, cons, N, use_molusc,
                          cc_filt, stratified, twin_n)


def _seb_card(gen, P_lo, P_hi, M_s, R_s, Teff, plx, qs_comp_in, u1_tab,
              u2_tab, seps, cons, *, N, use_molusc, cc_filt, stratified=True,
              twin_n=0):
    return _bound_eb_card("S", gen, P_lo, P_hi, M_s, R_s, Teff, plx,
                          qs_comp_in, (u1_tab, u2_tab), seps, cons, N,
                          use_molusc, cc_filt, stratified, twin_n)


def _background_eb_card(gen, P_lo, P_hi, M_s, R_s, Teff, bg, seps, cons, *,
                        N, has_cc, host_is_bg, cc_filt="TESS",
                        stratified=True, twin_n=0):
    N_comp = bg["pack"].shape[0]
    band = "fluxratios_cc" if host_is_bg else "delta_band"
    extra = (("fluxratios_comp", "host_mass", "host_rad")
             + (("u1s", "u2s") if host_is_bg else ())
             + ((band,) if has_cc else ()))

    def rows(g, n):
        return _background_idxs(g, bg, n, host_is_bg)[0]

    def branch(n, mode):
        f, scal, idxs = _eb_branch_card(
            gen, mode, "B" if host_is_bg else "D",
            (P_lo, P_hi, M_s, R_s, Teff), n, extra, lattice=mode == "twin",
            draw_rows=rows, pack=bg["pack"], stratified=stratified)
        f["lnprior"] = _bg_eb_lnprior(host_is_bg, has_cc, N_comp,
                                      scal[_M_S], f, f.pop(band, None),
                                      cc_filt, seps, cons)
        f["idxs"] = idxs
        return f
    return _eb_split(branch, N, stratified, twin_n)


# ---------------------------------------------------------------------------
# Planet-family sampler
# ---------------------------------------------------------------------------

@profiling.span("tri.sample.planet_target")
@_routed(_planet_target_card)
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
@_routed(_ptp_card)
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
    lnprior = _companion_lnprior(use_molusc, "TP", M_s, plx, cc_filt, seps,
                                 cons, (masses_comp, fluxratios_comp))
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
@_routed(_stp_card)
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
    lnprior = _companion_lnprior(use_molusc, "TP", M_s, plx, cc_filt, seps,
                                 cons, (masses_comp, fluxratios_comp))
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


def _background_idxs(gen, bg, n, host_is_bg):
    """(idxs, N_comp): n TRILEGAL row indices drawn per draw. The index
    quirk is the reference's: DTP / DEB draw from [0, N_comp - 1) (the
    last star is never drawn, ml.py:1463), BTP / BEB from [0, N_comp)
    (ml.py:1926)."""
    N_comp = bg["pack"].shape[0]
    hi = N_comp if host_is_bg else max(N_comp - 1, 1)
    return _randint(gen, n, hi), N_comp


def _draw_background(gen, bg, n, host_is_bg):
    """(idxs, rows, N_comp): ``_background_idxs`` and the drawn rows."""
    idxs, N_comp = _background_idxs(gen, bg, n, host_is_bg)
    return idxs, _drawn_rows(bg, idxs, BG_PACK_FIELDS), N_comp


def _host_is_bg_ok(row):
    """The background host must be a dwarf (logg >= 3.5) no hotter than
    10000 K (reference ml.py:1947-1949)."""
    return (row["loggs"] >= 3.5) & (row["teffs"] <= 10000.0)


@profiling.span("tri.sample.background_planet")
@_routed(_background_planet_card)
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
# With stratified=True and twin_n > 0, every EB sampler returns d["twin"]:
# an independent conditioned draw set of size twin_n (q | q >= 0.95 with
# ln-weight log P(q >= 0.95), a grazing-edge cos(inc) mixture, and
# Latin-hypercube strata over (inc, q, w, ecc)). With twin_n = 0 or
# stratified=False the legacy shared-draw twin branch is kept and
# d["twin"] is an aliased view of it (see the JAX engine's module notes).
# One rule, _eb_split, forms the twin branch on both paths: the plain
# chain's branches come from _eb_plain over a sampler's field block, the
# card's from _eb_branch_card.
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
        perms = _lattice_perms(gen, len(rest), n)
        for j, ax in enumerate(rest):
            out[ax] = (perms[j].to(dt) + out[ax]) / n
    return out


def _lattice_perms(gen, k, n):
    """k uniform random permutations of range(n): ONE batched argsort of
    k streams of iid uniforms (``_lattice_strat``'s)."""
    r = torch.stack(_uniforms(gen, k, n))
    # stable, as jnp.argsort: float32 uniforms tie a few times per 1e4
    return torch.argsort(r, dim=1, stable=True)


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
               *, conditioned, stratified=True, R_tra_cm=None):
    """Twin-branch geometry at 2P with collision radius 2 R_host: on a
    conditioned draw set the grazing-edge inclination mixture, on shared
    draws ``_inc_weighted``'s (reference ml.py:253-268). R_tra_cm
    overrides the transit-probability radius (NEB_evolved's 2 R_s,
    reference ml.py:3052)."""
    a_twin = _semimajor(2.0 * P, M_tot)
    sin_argp = torch.sin(argps_deg * PI / 180.0)
    e_corr = (1.0 + eccs * sin_argp) / (1.0 - eccs**2)
    R_occ = (radii_rsun * RSUN + R_host_rsun * RSUN
             if R_tra_cm is None else R_tra_cm)
    Ptra = R_occ / a_twin * e_corr
    r_twin = a_twin * (1.0 - eccs**2) / (1.0 + eccs * sin_argp)
    coll = 2.0 * R_host_rsun * RSUN > a_twin * (1.0 - eccs)
    if conditioned:
        incs, tra_ok, lnw = _inc_twin_mixture(u_inc, Ptra)
    else:
        incs, tra_ok, lnw = _inc_weighted(u_inc, Ptra, stratified)
    b = _impact_param(r_twin, incs, R_host_rsun)
    return dict(a=a_twin, incs=incs, b=b, geo_ok=tra_ok & ~coll, lnw=lnw)


def _eb_normal_branch(P, M_tot, R_host_rsun, radii_rsun, eccs, argps_deg,
                      u_inc, stratified):
    """Normal-branch geometry."""
    a, Ptra, coll, r = _geom_base(P, M_tot, R_host_rsun, radii_rsun * RSUN,
                                  eccs, argps_deg)
    incs, tra_ok, lnw = _inc_weighted(u_inc, Ptra, stratified)
    b = _impact_param(r, incs, R_host_rsun)
    return dict(a=a, incs=incs, b=b, geo_ok=tra_ok & ~coll, lnw=lnw)


def _and(mask, extra_ok):
    return mask if extra_ok is None else mask & extra_ok


def _geom_fields(g, argps, R_host_rsun, mask, suffix=""):
    """A branch's geometry fields as the samplers name them; suffix
    "_twin" names a shared-draw twin's, which shares w_rad."""
    inc_rad, w_rad = _kernel_angles(g["incs"], argps)
    out = dict(incs=g["incs"], a=g["a"], b=g["b"], mask=mask, lnw=g["lnw"],
               inc_rad=inc_rad, a_R=g["a"] / (R_host_rsun * RSUN))
    if suffix:
        return {k + suffix: v for k, v in out.items()}
    out["w_rad"] = w_rad
    return out


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
             inc_rad=d["inc_rad_twin"], w_rad=d["w_rad"], k=d["k"],
             ksec=d["ksec"], g_pri=d["g_pri"], g_sec=d["g_sec"],
             a_R=d["a_R_twin"],
             lnprior=d.get("lnprior", torch.zeros_like(d["P"])))
    t.update((n, d[n]) for n in _TWIN_SHARED if n in d)
    return t


def _eb_split(branch, N, stratified, twin_n):
    """The twin-branch rule of every EB sampler, plain chain and card.
    branch(n, mode) draws one branch of n draws: "normal", "twin" (a
    conditioned twin draw set) or "shared" (the normal branch with the
    legacy shared-draw twin fields). With stratified and twin_n > 0, the
    normal branch of N draws and d["twin"] its own twin draw set of twin_n,
    whose ln-prior is zero where the family has none; else the shared
    branch, with d["twin"] a view of its twin fields."""
    if not (stratified and twin_n):
        d = branch(N, "shared")
        d["twin"] = _twin_alias(d)
        return d
    d = branch(N, "normal")
    t = branch(twin_n, "twin")
    if "lnprior" not in t:
        t["lnprior"] = torch.zeros_like(t["P"])
    d["twin"] = t
    return d


# the keys of a field block that only _eb_plain reads
_BLOCK_ONLY = ("u_inc", "lnqmass", "ok", "M_host", "R_host")


def _eb_plain(block, N, stratified, twin_n, R_tra_twin=None):
    """An EB sampler's plain chain: ``_eb_split`` over block(n, twin), a
    field block (``_eb_block``), and the branch's geometry around the
    block's host. R_tra_twin: ``_twin_geom``'s R_tra_cm."""
    def branch(n, mode):
        f = block(n, mode == "twin")
        u_inc, lnqmass, ok, M_host, R_host = (f.pop(k) for k in _BLOCK_ONLY)
        P, qs, argps = f["P"], f["qs"], f["argps"]
        geom = (P, M_host + f["masses"], R_host, f["radii"], f["eccs"], argps,
                u_inc)
        if mode == "twin":
            tb = _twin_geom(*geom, conditioned=True, R_tra_cm=R_tra_twin)
            tb["lnw"] = tb["lnw"] + lnqmass
            f.update(_geom_fields(tb, argps, R_host, _and(tb["geo_ok"], ok)))
            return f
        nb = _eb_normal_branch(*geom, stratified)
        f.update(_geom_fields(nb, argps, R_host,
                              _and(nb["geo_ok"] & (qs < 0.95), ok)))
        if mode == "shared":
            tb = _twin_geom(*geom, conditioned=False, stratified=stratified,
                            R_tra_cm=R_tra_twin)
            f.update(_geom_fields(tb, argps, R_host,
                                  _and(tb["geo_ok"] & (qs >= 0.95), ok),
                                  "_twin"))
        return f
    return _eb_split(branch, N, stratified, twin_n)


def _eb_draws(gen, n_streams, lattice, P_lo, P_hi, M_q, n, twin):
    """(u, f): a branch's uniform streams, Latin-hypercube-stratified over
    (inc, q, w, ecc[, q_comp]) if lattice, and f its periods, mass ratios
    for a primary of mass M_q (q | q >= 0.95 on a twin set, with their
    ln-mass), eccentricities, arguments of periastron, inclination stream
    and ln-mass."""
    u = _uniforms(gen, n_streams, n)
    if lattice:
        u = _lattice_strat(u, (1, 2, 4, 3, 5)[:n_streams - 1], n, gen)
    P = _draw_P(u[0], P_lo, P_hi)
    if twin:
        qs, lnqmass = _twin_q(u[2], M_q)
    else:
        qs, lnqmass = sample_q(u[2], M_q), 0.0
    return u, dict(P=P, qs=qs, eccs=sample_ecc(u[3], False, P.mean()),
                   argps=sample_w(u[4]), u_inc=u[1], lnqmass=lnqmass)


def _eb_block(f, masses, radii, fluxratios, M_host, R_host, F_comp,
              on_companion, ok=None, **extra):
    """A field block of ``_eb_plain``: ``_eb_draws``' f with the EB's
    masses, radii and flux ratios, its radius ratios and dilutions around
    the host (M_host, R_host) under a diluting flux F_comp (None: none),
    the draws' extra mask ok and the branch's extra output fields."""
    kk, ksec = eb_radius_ratios(radii, R_host)
    F_EB = fluxratios / (1.0 - fluxratios)
    g_pri, g_sec = eb_dilution(
        F_EB, torch.zeros_like(F_EB) if F_comp is None else F_comp,
        on_companion)
    f.update(masses=masses, radii=radii, fluxratios=fluxratios, k=kk,
             ksec=ksec, g_pri=g_pri, g_sec=g_sec, ok=ok, M_host=M_host,
             R_host=R_host, **extra)
    return f


def _teb_fields(gen, P_lo, P_hi, M_s, R_s, Teff, M_q, n, twin):
    """TEB's (and NEB_evolved's, M_q = 1) field block: the EB around the
    target, q drawn for a primary of mass M_q."""
    _, f = _eb_draws(gen, 5, twin, P_lo, P_hi, M_q, n, twin)
    masses = f["qs"] * M_s
    radii, _ = stellar_relations(masses, R_s.expand(n), Teff.expand(n))
    return _eb_block(f, masses, radii, _fluxratio_vs_target(masses, M_s),
                     M_s, R_s, None, False)


@profiling.span("tri.sample.teb")
@_routed(_teb_card)
def sample_teb(gen, P_lo, P_hi, M_s, R_s, Teff, *, N, stratified=True,
               twin_n=0):
    """TEB / NEB: the target (or a nearby star) is an eclipsing binary
    (reference ml.py:175-383). twin_n > 0 (stratified only): the EBx2P
    branch runs on its own conditioned draw set."""
    P_lo, P_hi, M_s, R_s, Teff = _scalars(gen.device, P_lo, P_hi, M_s, R_s,
                                          Teff)
    return _eb_plain(functools.partial(_teb_fields, gen, P_lo, P_hi, M_s,
                                       R_s, Teff, M_s), N, stratified, twin_n)


def _peb_fields(gen, P_lo, P_hi, M_s, R_s, Teff, plx, qs_comp_in, seps,
                cons, use_molusc, cc_filt, stratified, n, twin):
    """PEB's field block; stratified Latin-hypercube-stratifies the
    companion stream too (the needle dimension of PEB)."""
    u, f = _eb_draws(gen, 6, stratified, P_lo, P_hi, M_s, n, twin)
    qs_comp = _companion_qs(gen, u[5], M_s, qs_comp_in, n, use_molusc, twin)
    masses = f["qs"] * M_s
    radii, _ = stellar_relations(masses, R_s.expand(n), Teff.expand(n))
    masses_comp = qs_comp * M_s
    fr_comp = _fluxratio_vs_target(masses_comp, M_s)
    f = _eb_block(f, masses, radii, _fluxratio_vs_target(masses, M_s), M_s,
                  R_s, fr_comp / (1.0 - fr_comp), False, qs_comp != 0.0,
                  fluxratios_comp=fr_comp, masses_comp=masses_comp)
    f["lnprior"] = _bound_eb_lnprior("P", use_molusc, M_s, plx, f, cc_filt,
                                     seps, cons)
    del f["masses_comp"]  # PEB returns no companion masses
    return f


@profiling.span("tri.sample.peb")
@_routed(_peb_card)
def sample_peb(gen, P_lo, P_hi, M_s, R_s, Teff, plx, qs_comp_in, seps, cons,
               *, N, use_molusc, cc_filt, stratified=True, twin_n=0):
    """PEB: the target is an EB with an unresolved bound companion
    (reference ml.py:589-866)."""
    P_lo, P_hi, M_s, R_s, Teff, plx = _scalars(gen.device, P_lo, P_hi, M_s,
                                               R_s, Teff, plx)
    return _eb_plain(functools.partial(
        _peb_fields, gen, P_lo, P_hi, M_s, R_s, Teff, plx, qs_comp_in, seps,
        cons, use_molusc, cc_filt, stratified), N, stratified, twin_n)


def _seb_fields(gen, P_lo, P_hi, M_s, R_s, Teff, plx, qs_comp_in, u1_tab,
                u2_tab, seps, cons, use_molusc, cc_filt, stratified, n, twin):
    """SEB's field block: the companion chain, its per-draw LDC and the EB
    around it. The companion-host stream (axis 5) sets the whole
    dilution / LDC chain, so it joins the lattice."""
    u, f = _eb_draws(gen, 6, stratified, P_lo, P_hi, M_s, n, twin)
    qs_comp = _companion_qs(gen, u[5], M_s, qs_comp_in, n, use_molusc, twin)
    masses_comp = qs_comp * M_s
    radii_comp, teffs_comp = stellar_relations(masses_comp, R_s.expand(n),
                                               Teff.expand(n))
    fr_comp = _fluxratio_vs_target(masses_comp, M_s)
    u1s, u2s = _companion_ldc(masses_comp, radii_comp, teffs_comp, u1_tab,
                              u2_tab)
    masses = f["qs"] * masses_comp
    radii, _ = stellar_relations(masses, radii_comp, teffs_comp)
    f = _eb_block(f, masses, radii, _fluxratio_vs_target(masses, M_s),
                  masses_comp, radii_comp, fr_comp / (1.0 - fr_comp), True,
                  qs_comp != 0.0, fluxratios_comp=fr_comp,
                  masses_comp=masses_comp, radii_comp=radii_comp, u1s=u1s,
                  u2s=u2s)
    f["lnprior"] = _bound_eb_lnprior("S", use_molusc, M_s, plx, f, cc_filt,
                                     seps, cons)
    return f


@profiling.span("tri.sample.seb")
@_routed(_seb_card)
def sample_seb(gen, P_lo, P_hi, M_s, R_s, Teff, plx, qs_comp_in,
               u1_tab, u2_tab, seps, cons, *, N, use_molusc, cc_filt,
               stratified=True, twin_n=0):
    """SEB: the unresolved bound companion is itself an EB (reference
    ml.py:1080-1376). The EB flux ratio's denominator uses the target's
    mass (ml.py:1193-1196)."""
    P_lo, P_hi, M_s, R_s, Teff, plx = _scalars(gen.device, P_lo, P_hi, M_s,
                                               R_s, Teff, plx)
    return _eb_plain(functools.partial(
        _seb_fields, gen, P_lo, P_hi, M_s, R_s, Teff, plx, qs_comp_in, u1_tab,
        u2_tab, seps, cons, use_molusc, cc_filt, stratified), N, stratified,
        twin_n)


def _bg_eb_fields(gen, P_lo, P_hi, M_s, R_s, Teff, bg, seps, cons, has_cc,
                  host_is_bg, cc_filt, n, twin):
    """DEB's / BEB's field block, with its own background-row draws."""
    _, f = _eb_draws(gen, 5, twin, P_lo, P_hi, M_s, n, twin)
    idxs, row, N_comp = _draw_background(gen, bg, n, host_is_bg)
    fr_draw = row["fluxratios"]
    extra = {}
    if host_is_bg:
        host_mass, host_rad = row["masses"], row["radii"]
        ok = _host_is_bg_ok(row)
        masses = f["qs"] * host_mass
        radii, _ = stellar_relations(masses, host_rad, row["teffs"])
        # distance correction of the EB's flux ratio (ml.py:2146-2159)
        fluxratios = _fluxratio_vs_target(masses, M_s) * (
            fr_draw / _fluxratio_vs_target(host_mass, M_s))
        extra = dict(u1s=row["u1s"], u2s=row["u2s"])
    else:
        host_mass, host_rad = M_s.expand(n), R_s.expand(n)
        ok = torch.ones_like(fr_draw, dtype=torch.bool)
        masses = f["qs"] * M_s
        radii, _ = stellar_relations(masses, R_s.expand(n), Teff.expand(n))
        fluxratios = _fluxratio_vs_target(masses, M_s)
    f = _eb_block(f, masses, radii, fluxratios, host_mass, host_rad,
                  fr_draw / (1.0 - fr_draw), host_is_bg, ok,
                  fluxratios_comp=fr_draw, idxs=idxs, host_mass=host_mass,
                  host_rad=host_rad, **extra)
    f["lnprior"] = _bg_eb_lnprior(
        host_is_bg, has_cc, N_comp, M_s, f,
        row["fluxratios_cc" if host_is_bg else "delta_band"], cc_filt, seps,
        cons)
    return f


@profiling.span("tri.sample.background_eb")
@_routed(_background_eb_card)
def sample_background_eb(gen, P_lo, P_hi, M_s, R_s, Teff, bg, seps, cons,
                         *, N, has_cc, host_is_bg, cc_filt="TESS",
                         stratified=True, twin_n=0):
    """DEB (host_is_bg=False): the target is an EB diluted by a TRILEGAL
    background star; BEB (host_is_bg=True): the background star is the EB
    (reference ml.py:1571-1837, :2038-2362)."""
    P_lo, P_hi, M_s, R_s, Teff = _scalars(gen.device, P_lo, P_hi, M_s, R_s,
                                          Teff)
    return _eb_plain(functools.partial(
        _bg_eb_fields, gen, P_lo, P_hi, M_s, R_s, Teff, bg, seps, cons,
        has_cc, host_is_bg, cc_filt), N, stratified, twin_n)


@profiling.span("tri.sample.neb_evolved")
def sample_neb_evolved(gen, P_lo, P_hi, M_s, R_s, Teff, *, N,
                       stratified=True, twin_n=0):
    """NEB for a subgiant (logg = 3.0 sets M_s on the host; reference
    ml.py:2969-3178). q is drawn as for a one-solar-mass primary, the EB's
    flux ratio against the host. The twin branch keeps two quirks: its
    transit probability and collision radius are 2 R_s (not radii + R_s,
    ml.py:3052), and its lnL takes R_EB = R_s, so k = ksec = 1 before the
    0.999 adjustment (ml.py:3100)."""
    P_lo, P_hi, M_s, R_s, Teff = _scalars(gen.device, P_lo, P_hi, M_s, R_s,
                                          Teff)
    one = torch.ones((), dtype=F32, device=gen.device)
    d = _eb_plain(functools.partial(_teb_fields, gen, P_lo, P_hi, M_s, R_s,
                                    Teff, one), N, stratified, twin_n,
                  R_tra_twin=2.0 * R_s * RSUN)
    t = d["twin"]
    t["k"], t["ksec"] = eb_radius_ratios(R_s.expand(t["P"].shape[0]), R_s)
    if not (stratified and twin_n):
        d["k_twin"], d["ksec_twin"] = t["k"], t["ksec"]
    return d


def _neb_unknown_fields(gen, P_lo, P_hi, pop, n, twin):
    """NEB_unknown's field block, with its own lookalike-row draws: q is
    drawn as for a one-solar-mass primary and the EB's flux ratio is taken
    against the drawn host in the TESS band, whatever the mission
    (reference ml.py:2672-2676)."""
    one = torch.ones((), dtype=F32, device=gen.device)
    _, f = _eb_draws(gen, 5, twin, P_lo, P_hi, one, n, twin)
    idxs, row, pop_ok = _draw_lookalike(gen, pop, n)
    host_mass, host_rad = row["masses"], row["radii"]
    masses = f["qs"] * host_mass
    radii, _ = stellar_relations(masses, host_rad, row["teffs"])
    f_eb = flux_relation(masses, "TESS")
    fluxratios = f_eb / (f_eb + flux_relation(host_mass, "TESS"))
    return _eb_block(f, masses, radii, fluxratios, host_mass, host_rad, None,
                     False, pop_ok, idxs=idxs, host_mass=host_mass,
                     host_rad=host_rad, u1s=row["u1s"], u2s=row["u2s"],
                     lnprior=torch.zeros_like(masses))


@profiling.span("tri.sample.neb_unknown")
def sample_neb_unknown(gen, P_lo, P_hi, pop, *, N, stratified=True,
                       twin_n=0):
    """NEB for a star of unknown properties, its host drawn from the
    lookalike population (reference ml.py:2554-2829). The twin draw set
    has its own lookalike rows and limb darkening."""
    P_lo, P_hi = _scalars(gen.device, P_lo, P_hi)
    d = _eb_plain(functools.partial(_neb_unknown_fields, gen, P_lo, P_hi,
                                    pop), N, stratified, twin_n)
    d["g"] = torch.ones_like(d["P"])
    return d
