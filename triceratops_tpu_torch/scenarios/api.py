"""Public scenario-evidence API, the 14 ``lnZ_*`` functions: ``lnZ_TTP``,
``lnZ_TEB`` (also the nearby-star NTP / NEB rows), the bound-companion
``lnZ_PTP``, ``lnZ_PEB``, ``lnZ_STP``, ``lnZ_SEB``, the TRILEGAL background
``lnZ_DTP``, ``lnZ_DEB``, ``lnZ_BTP``, ``lnZ_BEB`` and the nearby-star
scenarios for hosts of unknown or evolved properties,
``lnZ_NTP_unknown``, ``lnZ_NEB_unknown``, ``lnZ_NTP_evolved``,
``lnZ_NEB_evolved`` (which ``calc_probs`` does not call, as in the
reference).

Counterpart of the same functions in the JAX package's ``scenarios/api.py``
(reference marginal_likelihoods.py:39-3178): sample on the device, score the
draws with the chunked likelihood core, reduce to lnZ and the top-100
best fits. Results hold device tensors until the caller pulls them.

Each function takes an explicit ``device`` (default ``"cuda"``) and an
optional ``torch.Generator`` on that device; without one, a generator is
seeded from numpy's global RNG, so ``np.random.seed`` gives
reproducibility as in the reference. ``backend`` selects the likelihood
path (``ops/lightcurve.py``).
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch

from ..constants import G, MSUN, RSUN
from ..funcs import file_to_contrast_curve, trilegal_results
from ..populations.ldc import lookup_target, grid_at_Z, lookup_stars
from ..populations.molusc import load_molusc_qs
from ..ops.lightcurve import lnL_planet, lnL_eb
from ..utils import profiling
from . import engine as eng

F32 = np.float32
N_SAMPLES = eng.N_SAMPLES

__all__ = [
    "lnZ_TTP", "lnZ_TEB", "lnZ_PTP", "lnZ_PEB", "lnZ_STP", "lnZ_SEB",
    "lnZ_DTP", "lnZ_DEB", "lnZ_BTP", "lnZ_BEB",
    "lnZ_NTP_unknown", "lnZ_NEB_unknown", "lnZ_NTP_evolved",
    "lnZ_NEB_evolved",
]


def _generator(gen, device):
    if gen is not None:
        if gen.device.type != torch.device(device).type:
            raise ValueError(f"generator is on {gen.device}, work on {device}")
        return gen
    out = torch.Generator(device=device)
    out.manual_seed(int(np.random.randint(0, 2**31 - 1)))
    return out


def _p_bounds(P_orb):
    """Scalar P -> (P, P); [P_min, P_max] -> bounds (reference ml.py:67-72)."""
    if isinstance(P_orb, (float, int)):
        return F32(P_orb), F32(P_orb)
    arr = np.asarray(P_orb, dtype=float)
    return F32(arr[0]), F32(arr[-1])


def _lc(time, flux, device):
    """(time, obs_dev, n_t): float32 device tensors of the curve,
    with obs_dev = flux - 1 formed in float64 on the host."""
    time = np.asarray(time, dtype=np.float64)
    obs_dev = (np.asarray(flux, dtype=np.float64) - 1.0).astype(F32)
    n_t = len(time)
    return (torch.as_tensor(time.astype(F32), device=device),
            torch.as_tensor(obs_dev, device=device), n_t)


def _logg(M_s, R_s):
    return float(np.log10(G * (M_s * MSUN) / (R_s * RSUN) ** 2))


def _full(v):
    return np.full(N_SAMPLES, v)


def _zeros():
    return np.zeros(N_SAMPLES)


def _gd(d, *names):
    """Pick gather arrays from a sampler output dict."""
    return {n: d[n] for n in names}


def _res(lnZ, gathered, **fields):
    """Assemble a best-fit result dict (device tensors stay on the
    device; the frontend pulls them all in one transfer)."""
    out = dict(fields)
    out.update(gathered)
    out["lnZ"] = lnZ
    return out


def _u_arrays(u1, u2, N, device):
    """Per-draw limb-darkening tensors of one star, filled on the device."""
    return (torch.full((N,), float(F32(u1)), device=device),
            torch.full((N,), float(F32(u2)), device=device))


def _cc(contrast_curve_file, filt, device):
    """(separations, contrasts, cc_filt): the defaults ([2.2], [1.0], None)
    without a contrast curve (reference ml.py:484-487)."""
    if contrast_curve_file is None:
        seps, cons, cc_filt = np.array([2.2]), np.array([1.0]), None
    else:
        seps, cons = file_to_contrast_curve(contrast_curve_file)
        cc_filt = str(filt)
    return (torch.as_tensor(seps.astype(F32), device=device),
            torch.as_tensor(cons.astype(F32), device=device), cc_filt)


def _molusc(molusc_file, M_s, N, device):
    """(qs_comp_in, use_molusc): the MOLUSC mass ratios zero-padded to N,
    or zeros and False without a MOLUSC file; the read and the upload run
    in the span ``tri.io.molusc``."""
    if molusc_file is None:
        return torch.zeros((N,), device=device), False
    with profiling.span("tri.io.molusc"):
        qs = load_molusc_qs(molusc_file, M_s, N).astype(F32)
        return torch.as_tensor(qs, device=device), True


def _file_sig(path):
    """(path, mtime_ns, size): a cache key that changes when the file is
    rewritten, so a same-path rewrite is never served stale."""
    st = os.stat(path)
    return (path, st.st_mtime_ns, st.st_size)


def _prep_background(trilegal_fname, Tmag, Jmag, Hmag, Kmag, mission, filt,
                     need_ldc, device, need_cc_ratio=False):
    return _prep_background_cached(_file_sig(trilegal_fname), Tmag, Jmag,
                                   Hmag, Kmag, mission, filt, need_ldc,
                                   str(torch.device(device)), need_cc_ratio)


@lru_cache(maxsize=16)
def _prep_background_cached(file_sig, Tmag, Jmag, Hmag, Kmag, mission, filt,
                            need_ldc, device, need_cc_ratio):
    """Per-background-star device table from a TRILEGAL csv (reference
    ml.py:1451-1463 and analogues), packed in ``eng.BG_PACK_FIELDS``
    order. Cached per file and target, so the four D*/B* scenarios share
    one parse and one LDC lookup."""
    (Tmags, Masses, loggs, Teffs, Zs, Jmags, Hmags, Kmags) = trilegal_results(
        file_sig[0], Tmag)
    d_T = Tmag - Tmags
    delta_band = {"J": Jmag - Jmags, "H": Hmag - Hmags,
                  "K": Kmag - Kmags}.get(filt, d_T)
    n = len(Tmags)
    bg = {
        "fluxratios": 10 ** (d_T / 2.5) / (1 + 10 ** (d_T / 2.5)),
        "delta_band": delta_band,
        "masses": Masses,
        "radii": np.sqrt(G * Masses * MSUN / 10**loggs) / RSUN,
        "loggs": loggs,
        "teffs": Teffs,
    }
    if need_ldc:
        bg["u1s"], bg["u2s"] = lookup_stars(Teffs, loggs, Zs, mission)
    else:
        bg["u1s"] = bg["u2s"] = np.zeros(n)
    if need_cc_ratio:
        bg["fluxratios_cc"] = (10 ** (delta_band / 2.5)
                               / (1 + 10 ** (delta_band / 2.5)))
    else:
        bg["fluxratios_cc"] = bg["fluxratios"]
    pack = np.stack([np.asarray(bg[f]).astype(F32)
                     for f in eng.BG_PACK_FIELDS], axis=1)
    return {"pack": torch.as_tensor(pack, device=device)}, n


def _prep_lookalikes(trilegal_fname, Tmag, mission, device):
    return _prep_lookalikes_cached(_file_sig(trilegal_fname), Tmag, mission,
                                   str(torch.device(device)))


@lru_cache(maxsize=16)
def _prep_lookalikes_cached(file_sig, Tmag, mission, device):
    """(table, N_pos): the TRILEGAL stars with Tmag - 1 < Tmag_i < Tmag + 1
    (reference ml.py:2402-2446), packed in ``eng.POP_PACK_FIELDS`` order,
    or (None, 0) when there are none."""
    (Tmags, Masses, loggs, Teffs, Zs, _J, _H, _K) = trilegal_results(
        file_sig[0], Tmag)
    m = (Tmag - 1 < Tmags) & (Tmags < Tmag + 1)
    if m.sum() == 0:
        return None, 0
    Masses, loggs, Teffs, Zs = Masses[m], loggs[m], Teffs[m], Zs[m]
    u1s, u2s = lookup_stars(Teffs, loggs, Zs, mission)
    pop = {"masses": Masses,
           "radii": np.sqrt(G * Masses * MSUN / 10**loggs) / RSUN,
           "loggs": loggs, "teffs": Teffs, "u1s": u1s, "u2s": u2s}
    pack = np.stack([np.asarray(pop[f]).astype(F32)
                     for f in eng.POP_PACK_FIELDS], axis=1)
    return {"pack": torch.as_tensor(pack, device=device)}, int(m.sum())


def lnZ_TTP(time, flux, sigma, P_orb, M_s, R_s, Teff, Z,
            N: int = 1000000, parallel: bool = False, mission: str = "TESS",
            flatpriors: bool = False, exptime: float = 0.00139,
            nsamples: int = 20, gen: torch.Generator = None,
            importance_sampling: bool = True, device="cuda",
            backend: str = "auto"):
    """Marginal likelihood of the TTP scenario (reference ml.py:39-172);
    also NTP for nearby stars. ``parallel`` is accepted for signature
    parity and ignored."""
    gen = _generator(gen, device)
    P_lo, P_hi = _p_bounds(P_orb)
    u1, u2 = lookup_target(Z, Teff, _logg(M_s, R_s), mission)
    t, obs_dev, n_t = _lc(time, flux, device)
    d = eng.sample_planet_target(gen, P_lo, P_hi, F32(M_s), F32(R_s), N=N,
                                 flatpriors=flatpriors,
                                 stratified=importance_sampling)
    u1a, u2a = _u_arrays(u1, u2, N, device)
    lnL = lnL_planet(t, obs_dev, F32(sigma), d["k"], d["P"], d["a_R"],
                     d["inc_rad"], d["eccs"], d["w_rad"], u1a, u2a,
                     torch.ones((N,), device=device), d["mask"],
                     exptime=exptime, n_t=n_t, ns=nsamples, backend=backend)
    lnZ, g = eng.run_finalize(lnL, d["lnw"],
                              _gd(d, "P", "incs", "b", "rps", "eccs", "argps"))
    return _res(lnZ, {"P_orb": g["P"], "inc": g["incs"], "b": g["b"],
                      "R_p": g["rps"], "ecc": g["eccs"], "argp": g["argps"]},
                M_s=_full(M_s), R_s=_full(R_s), u1=_full(u1), u2=_full(u2),
                M_EB=_zeros(), R_EB=_zeros(), fluxratio_EB=_zeros(),
                fluxratio_comp=_zeros())


def _twin_n(N, importance_sampling, div=eng.TWIN_DIV):
    """Twin-branch conditioned draw count: N // div under importance
    sampling (TWIN_DIV, or TWIN_DIV_SEB for SEB), 0 (legacy shared draws)
    otherwise."""
    return max(N // div, 1) if importance_sampling else 0


def _eb_lnZ_pair(d, t, obs_dev, sigma, u1a, u2a, exptime, n_t, ns,
                 backend):
    """Normal (veto on) and twin (veto off, 2P) EB log-likelihoods; the
    twin branch is read from d['twin']."""
    lnL = lnL_eb(t, obs_dev, sigma, d["k"], d["ksec"], d["P"], d["a_R"],
                 d["inc_rad"], d["eccs"], d["w_rad"], u1a, u2a,
                 d["g_pri"], d["g_sec"], d["mask"],
                 exptime=exptime, n_t=n_t, ns=ns,
                 apply_veto=True, backend=backend)
    tw = d["twin"]
    nt = tw["P"].shape[0]
    lnL_twin = lnL_eb(t, obs_dev, sigma, tw["k"], tw["ksec"], 2.0 * tw["P"],
                      tw["a_R"], tw["inc_rad"], tw["eccs"], tw["w_rad"],
                      tw.get("u1s", u1a[:nt]), tw.get("u2s", u2a[:nt]),
                      tw["g_pri"], tw["g_sec"],
                      tw["mask"], exptime=exptime, n_t=n_t, ns=ns,
                      apply_veto=False, backend=backend)
    return lnL, lnL_twin


def lnZ_TEB(time, flux, sigma, P_orb, M_s, R_s, Teff, Z,
            N: int = 1000000, parallel: bool = False, mission: str = "TESS",
            flatpriors: bool = False, exptime: float = 0.00139,
            nsamples: int = 20, gen: torch.Generator = None,
            importance_sampling: bool = True, device="cuda",
            backend: str = "auto"):
    """TEB and its EBx2P twin (reference ml.py:175-383); also NEB.
    Returns (res, res_twin)."""
    gen = _generator(gen, device)
    P_lo, P_hi = _p_bounds(P_orb)
    u1, u2 = lookup_target(Z, Teff, _logg(M_s, R_s), mission)
    t, obs_dev, n_t = _lc(time, flux, device)
    d = eng.sample_teb(gen, P_lo, P_hi, F32(M_s), F32(R_s), F32(Teff),
                       N=N, stratified=importance_sampling,
                       twin_n=_twin_n(N, importance_sampling))
    tw = d["twin"]
    u1a, u2a = _u_arrays(u1, u2, N, device)
    lnL, lnL_twin = _eb_lnZ_pair(d, t, obs_dev, F32(sigma), u1a, u2a,
                                 exptime, n_t, nsamples, backend)
    gnames = ("P", "incs", "b", "eccs", "argps", "masses", "radii",
              "fluxratios")
    lnZ, g = eng.run_finalize(lnL, d["lnw"], _gd(d, *gnames))
    lnZt, gt = eng.run_finalize(lnL_twin, tw["lnw"], _gd(tw, *gnames))
    const = dict(M_s=_full(M_s), R_s=_full(R_s), u1=_full(u1), u2=_full(u2),
                 R_p=_zeros(), fluxratio_comp=_zeros())
    res = _res(lnZ, {"P_orb": g["P"], "inc": g["incs"], "b": g["b"],
                     "ecc": g["eccs"], "argp": g["argps"],
                     "M_EB": g["masses"], "R_EB": g["radii"],
                     "fluxratio_EB": g["fluxratios"]}, **const)
    res_twin = _res(lnZt, {"P_orb": 2 * gt["P"], "inc": gt["incs"],
                           "b": gt["b"], "ecc": gt["eccs"],
                           "argp": gt["argps"], "M_EB": gt["masses"],
                           "R_EB": gt["radii"],
                           "fluxratio_EB": gt["fluxratios"]}, **const)
    return res, res_twin


def _eb_results(d, lnL, lnL_twin, host_fields, **const):
    """Finalize the normal and twin EB branches into best-fit dicts.
    host_fields: (mass, radius, u1, u2) gather names of a per-draw host
    (companion or background star), or None for a fixed host in
    ``const``."""
    gnames = ("P", "incs", "b", "eccs", "argps", "masses", "radii",
              "fluxratios", "fluxratios_comp") + (host_fields or ())
    tw = d["twin"]
    out = []
    for br, lnLb, twin in ((d, lnL, False), (tw, lnL_twin, True)):
        lnZ, g = eng.run_finalize(lnLb, br["lnprior"] + br["lnw"],
                                  _gd(br, *gnames))
        fields = {"P_orb": 2 * g["P"] if twin else g["P"], "inc": g["incs"],
                  "b": g["b"], "ecc": g["eccs"], "argp": g["argps"],
                  "M_EB": g["masses"], "R_EB": g["radii"],
                  "fluxratio_EB": g["fluxratios"],
                  "fluxratio_comp": g["fluxratios_comp"]}
        if host_fields:
            for name, key in zip(("M_s", "R_s", "u1", "u2"), host_fields):
                fields[name] = g[key]
        out.append(_res(lnZ, fields, **const))
    return tuple(out)


def _planet_result(d, lnL, host_fields, **const):
    """Finalize a planet-family row with a prior into its best-fit dict
    (host_fields as in ``_eb_results``)."""
    gnames = ("P", "incs", "b", "rps", "eccs", "argps",
              "fluxratios_comp") + (host_fields or ())
    lnZ, g = eng.run_finalize(lnL, d["lnprior"] + d["lnw"], _gd(d, *gnames))
    fields = {"P_orb": g["P"], "inc": g["incs"], "b": g["b"],
              "R_p": g["rps"], "ecc": g["eccs"], "argp": g["argps"],
              "fluxratio_comp": g["fluxratios_comp"]}
    if host_fields:
        for name, key in zip(("M_s", "R_s", "u1", "u2"), host_fields):
            fields[name] = g[key]
    return _res(lnZ, fields, **const)


def _planet_lnL(d, t, obs_dev, sigma, u1a, u2a, exptime, n_t, ns,
                backend):
    return lnL_planet(t, obs_dev, F32(sigma), d["k"], d["P"], d["a_R"],
                      d["inc_rad"], d["eccs"], d["w_rad"], u1a, u2a, d["g"],
                      d["mask"], exptime=exptime, n_t=n_t, ns=ns,
                      backend=backend)


_COMP_HOST = ("masses_comp", "radii_comp", "u1s", "u2s")
_BG_HOST = ("host_mass", "host_rad", "u1s", "u2s")


def lnZ_PTP(time, flux, sigma, P_orb, M_s, R_s, Teff, Z, plx,
            contrast_curve_file: str = None, filt: str = "TESS",
            N: int = 1000000, parallel: bool = False, mission: str = "TESS",
            flatpriors: bool = False, exptime: float = 0.00139,
            nsamples: int = 20, molusc_file: str = None,
            gen: torch.Generator = None, importance_sampling: bool = True,
            device="cuda", backend: str = "auto"):
    """PTP: a planet around the target plus a bound companion (reference
    ml.py:386-586)."""
    gen = _generator(gen, device)
    P_lo, P_hi = _p_bounds(P_orb)
    u1, u2 = lookup_target(Z, Teff, _logg(M_s, R_s), mission)
    t, obs_dev, n_t = _lc(time, flux, device)
    seps, cons, cc_filt = _cc(contrast_curve_file, filt, device)
    qs_in, use_molusc = _molusc(molusc_file, M_s, N, device)
    d = eng.sample_ptp(gen, P_lo, P_hi, F32(M_s), F32(R_s), F32(Teff),
                       F32(plx), qs_in, seps, cons, N=N,
                       flatpriors=flatpriors, use_molusc=use_molusc,
                       cc_filt=cc_filt, stratified=importance_sampling)
    u1a, u2a = _u_arrays(u1, u2, N, device)
    lnL = _planet_lnL(d, t, obs_dev, sigma, u1a, u2a, exptime, n_t,
                      nsamples, backend)
    return _planet_result(d, lnL, None, M_s=_full(M_s), R_s=_full(R_s),
                          u1=_full(u1), u2=_full(u2), M_EB=_zeros(),
                          R_EB=_zeros(), fluxratio_EB=_zeros())


def lnZ_PEB(time, flux, sigma, P_orb, M_s, R_s, Teff, Z, plx,
            contrast_curve_file: str = None, filt: str = "TESS",
            N: int = 1000000, parallel: bool = False, mission: str = "TESS",
            flatpriors: bool = False, exptime: float = 0.00139,
            nsamples: int = 20, molusc_file: str = None,
            gen: torch.Generator = None, importance_sampling: bool = True,
            device="cuda", backend: str = "auto"):
    """PEB and its PEBx2P twin (reference ml.py:589-866). Returns
    (res, res_twin)."""
    gen = _generator(gen, device)
    P_lo, P_hi = _p_bounds(P_orb)
    u1, u2 = lookup_target(Z, Teff, _logg(M_s, R_s), mission)
    t, obs_dev, n_t = _lc(time, flux, device)
    seps, cons, cc_filt = _cc(contrast_curve_file, filt, device)
    qs_in, use_molusc = _molusc(molusc_file, M_s, N, device)
    d = eng.sample_peb(gen, P_lo, P_hi, F32(M_s), F32(R_s), F32(Teff),
                       F32(plx), qs_in, seps, cons, N=N,
                       use_molusc=use_molusc, cc_filt=cc_filt,
                       stratified=importance_sampling,
                       twin_n=_twin_n(N, importance_sampling))
    u1a, u2a = _u_arrays(u1, u2, N, device)
    lnL, lnL_twin = _eb_lnZ_pair(d, t, obs_dev, F32(sigma), u1a, u2a,
                                 exptime, n_t, nsamples, backend)
    return _eb_results(d, lnL, lnL_twin, None, M_s=_full(M_s),
                       R_s=_full(R_s), u1=_full(u1), u2=_full(u2),
                       R_p=_zeros())


def lnZ_STP(time, flux, sigma, P_orb, M_s, R_s, Teff, Z, plx,
            contrast_curve_file: str = None, filt: str = "TESS",
            N: int = 1000000, parallel: bool = False, mission: str = "TESS",
            flatpriors: bool = False, exptime: float = 0.00139,
            nsamples: int = 20, molusc_file: str = None,
            gen: torch.Generator = None, importance_sampling: bool = True,
            device="cuda", backend: str = "auto"):
    """STP: a planet around the unresolved bound companion (reference
    ml.py:869-1077)."""
    gen = _generator(gen, device)
    P_lo, P_hi = _p_bounds(P_orb)
    t, obs_dev, n_t = _lc(time, flux, device)
    seps, cons, cc_filt = _cc(contrast_curve_file, filt, device)
    qs_in, use_molusc = _molusc(molusc_file, M_s, N, device)
    u1_tab, u2_tab = (torch.as_tensor(x.astype(F32), device=device)
                      for x in grid_at_Z(Z, mission, teff_max=10000))
    d = eng.sample_stp(gen, P_lo, P_hi, F32(M_s), F32(R_s), F32(Teff),
                       F32(plx), qs_in, u1_tab, u2_tab, seps, cons, N=N,
                       flatpriors=flatpriors, use_molusc=use_molusc,
                       cc_filt=cc_filt, stratified=importance_sampling)
    lnL = _planet_lnL(d, t, obs_dev, sigma, d["u1s"], d["u2s"], exptime,
                      n_t, nsamples, backend)
    return _planet_result(d, lnL, _COMP_HOST, M_EB=_zeros(), R_EB=_zeros(),
                          fluxratio_EB=_zeros())


def lnZ_SEB(time, flux, sigma, P_orb, M_s, R_s, Teff, Z, plx,
            contrast_curve_file: str = None, filt: str = "TESS",
            N: int = 1000000, parallel: bool = False, mission: str = "TESS",
            flatpriors: bool = False, exptime: float = 0.00139,
            nsamples: int = 20, molusc_file: str = None,
            gen: torch.Generator = None, importance_sampling: bool = True,
            device="cuda", backend: str = "auto"):
    """SEB and its SEBx2P twin (reference ml.py:1080-1376; the Teff clamp
    of 13000 is bounded by the LDC table's maximum, ml.py:1181)."""
    gen = _generator(gen, device)
    P_lo, P_hi = _p_bounds(P_orb)
    t, obs_dev, n_t = _lc(time, flux, device)
    seps, cons, cc_filt = _cc(contrast_curve_file, filt, device)
    qs_in, use_molusc = _molusc(molusc_file, M_s, N, device)
    u1_tab, u2_tab = (torch.as_tensor(x.astype(F32), device=device)
                      for x in grid_at_Z(Z, mission, teff_max=13000))
    d = eng.sample_seb(gen, P_lo, P_hi, F32(M_s), F32(R_s), F32(Teff),
                       F32(plx), qs_in, u1_tab, u2_tab, seps, cons, N=N,
                       use_molusc=use_molusc, cc_filt=cc_filt,
                       stratified=importance_sampling,
                       twin_n=_twin_n(N, importance_sampling,
                                      eng.TWIN_DIV_SEB))
    lnL, lnL_twin = _eb_lnZ_pair(d, t, obs_dev, F32(sigma), d["u1s"],
                                 d["u2s"], exptime, n_t, nsamples,
                                 backend)
    return _eb_results(d, lnL, lnL_twin, _COMP_HOST, R_p=_zeros())


def lnZ_DTP(time, flux, sigma, P_orb, M_s, R_s, Teff, Z, Tmag, Jmag, Hmag,
            Kmag, trilegal_fname, contrast_curve_file: str = None,
            filt: str = "TESS", N: int = 1000000, parallel: bool = False,
            mission: str = "TESS", flatpriors: bool = False,
            exptime: float = 0.00139, nsamples: int = 20,
            gen: torch.Generator = None, importance_sampling: bool = True,
            device="cuda", backend: str = "auto"):
    """DTP: a planet around the target diluted by a background star
    (reference ml.py:1379-1568)."""
    gen = _generator(gen, device)
    P_lo, P_hi = _p_bounds(P_orb)
    u1, u2 = lookup_target(Z, Teff, _logg(M_s, R_s), mission)
    t, obs_dev, n_t = _lc(time, flux, device)
    seps, cons, cc_filt = _cc(contrast_curve_file, filt, device)
    bg, _ = _prep_background(trilegal_fname, Tmag, Jmag, Hmag, Kmag,
                             mission, filt, False, device)
    d = eng.sample_background_planet(
        gen, P_lo, P_hi, F32(M_s), F32(R_s), bg, seps, cons, N=N,
        flatpriors=flatpriors, has_cc=cc_filt is not None, host_is_bg=False,
        stratified=importance_sampling)
    u1a, u2a = _u_arrays(u1, u2, N, device)
    lnL = _planet_lnL(d, t, obs_dev, sigma, u1a, u2a, exptime, n_t,
                      nsamples, backend)
    return _planet_result(d, lnL, None, M_s=_full(M_s), R_s=_full(R_s),
                          u1=_full(u1), u2=_full(u2), M_EB=_zeros(),
                          R_EB=_zeros(), fluxratio_EB=_zeros())


def lnZ_DEB(time, flux, sigma, P_orb, M_s, R_s, Teff, Z, Tmag, Jmag, Hmag,
            Kmag, trilegal_fname, contrast_curve_file: str = None,
            filt: str = "TESS", N: int = 1000000, parallel: bool = False,
            mission: str = "TESS", flatpriors: bool = False,
            exptime: float = 0.00139, nsamples: int = 20,
            gen: torch.Generator = None, importance_sampling: bool = True,
            device="cuda", backend: str = "auto"):
    """DEB and its DEBx2P twin (reference ml.py:1571-1837)."""
    gen = _generator(gen, device)
    P_lo, P_hi = _p_bounds(P_orb)
    u1, u2 = lookup_target(Z, Teff, _logg(M_s, R_s), mission)
    t, obs_dev, n_t = _lc(time, flux, device)
    seps, cons, cc_filt = _cc(contrast_curve_file, filt, device)
    bg, _ = _prep_background(trilegal_fname, Tmag, Jmag, Hmag, Kmag,
                             mission, filt, False, device)
    d = eng.sample_background_eb(
        gen, P_lo, P_hi, F32(M_s), F32(R_s), F32(Teff), bg, seps, cons, N=N,
        has_cc=cc_filt is not None, host_is_bg=False,
        cc_filt=cc_filt or "TESS", stratified=importance_sampling,
        twin_n=_twin_n(N, importance_sampling))
    u1a, u2a = _u_arrays(u1, u2, N, device)
    lnL, lnL_twin = _eb_lnZ_pair(d, t, obs_dev, F32(sigma), u1a, u2a,
                                 exptime, n_t, nsamples, backend)
    return _eb_results(d, lnL, lnL_twin, None, M_s=_full(M_s),
                       R_s=_full(R_s), u1=_full(u1), u2=_full(u2),
                       R_p=_zeros())


def lnZ_BTP(time, flux, sigma, P_orb, M_s, R_s, Teff, Tmag, Jmag, Hmag,
            Kmag, trilegal_fname, contrast_curve_file: str = None,
            filt: str = "TESS", N: int = 1000000, parallel: bool = False,
            mission: str = "TESS", flatpriors: bool = False,
            exptime: float = 0.00139, nsamples: int = 20,
            gen: torch.Generator = None, importance_sampling: bool = True,
            device="cuda", backend: str = "auto"):
    """BTP: a planet around the background star, with per-star LDC
    (reference ml.py:1840-2035)."""
    gen = _generator(gen, device)
    P_lo, P_hi = _p_bounds(P_orb)
    t, obs_dev, n_t = _lc(time, flux, device)
    seps, cons, cc_filt = _cc(contrast_curve_file, filt, device)
    bg, _ = _prep_background(trilegal_fname, Tmag, Jmag, Hmag, Kmag,
                             mission, filt, True, device)
    d = eng.sample_background_planet(
        gen, P_lo, P_hi, F32(M_s), F32(R_s), bg, seps, cons, N=N,
        flatpriors=flatpriors, has_cc=cc_filt is not None, host_is_bg=True,
        stratified=importance_sampling)
    lnL = _planet_lnL(d, t, obs_dev, sigma, d["u1s"], d["u2s"], exptime,
                      n_t, nsamples, backend)
    return _planet_result(d, lnL, _BG_HOST, M_EB=_zeros(), R_EB=_zeros(),
                          fluxratio_EB=_zeros())


def lnZ_BEB(time, flux, sigma, P_orb, M_s, R_s, Teff, Tmag, Jmag, Hmag,
            Kmag, trilegal_fname, contrast_curve_file: str = None,
            filt: str = "TESS", N: int = 1000000, parallel: bool = False,
            mission: str = "TESS", flatpriors: bool = False,
            exptime: float = 0.00139, nsamples: int = 20,
            gen: torch.Generator = None, importance_sampling: bool = True,
            device="cuda", backend: str = "auto"):
    """BEB and its BEBx2P twin (reference ml.py:2038-2362)."""
    gen = _generator(gen, device)
    P_lo, P_hi = _p_bounds(P_orb)
    t, obs_dev, n_t = _lc(time, flux, device)
    seps, cons, cc_filt = _cc(contrast_curve_file, filt, device)
    bg, _ = _prep_background(trilegal_fname, Tmag, Jmag, Hmag, Kmag,
                             mission, filt, True, device, need_cc_ratio=True)
    d = eng.sample_background_eb(
        gen, P_lo, P_hi, F32(M_s), F32(R_s), F32(Teff), bg, seps, cons, N=N,
        has_cc=cc_filt is not None, host_is_bg=True,
        cc_filt=cc_filt or "TESS", stratified=importance_sampling,
        twin_n=_twin_n(N, importance_sampling))
    lnL, lnL_twin = _eb_lnZ_pair(d, t, obs_dev, F32(sigma), d["u1s"],
                                 d["u2s"], exptime, n_t, nsamples,
                                 backend)
    return _eb_results(d, lnL, lnL_twin, _BG_HOST, R_p=_zeros())


# ---------------------------------------------------------------------------
# Nearby-star scenarios for hosts of unknown or evolved properties
# ---------------------------------------------------------------------------

# the reference's results for an empty lookalike population; the NTP one
# has no "b" key, a quirk kept as the JAX package keeps it
_EMPTY_NTP = {"M_s": 0, "R_s": 0, "u1": 0, "u2": 0, "P_orb": 0, "inc": 0,
              "R_p": 0, "ecc": 0, "argp": 0, "M_EB": 0, "R_EB": 0,
              "fluxratio_EB": 0, "fluxratio_comp": 0, "lnZ": -np.inf}
_EMPTY_NEB = {"M_s": 0, "R_s": 0, "u1": 0, "u2": 0, "P_orb": 0, "inc": 0,
              "b": 0, "R_p": 0, "ecc": 0, "argp": 0, "M_EB": 0, "R_EB": 0,
              "fluxratio_EB": 0, "fluxratio_comp": 0, "lnZ": -np.inf}


def _evolved_mass(R_s):
    """The host mass [Msun] that a logg of 3.0 gives at radius R_s."""
    return (10**3.0) * (R_s * RSUN) ** 2 / G / MSUN


def lnZ_NTP_unknown(time, flux, sigma, P_orb, Tmag, trilegal_fname,
                    N: int = 1000000, parallel: bool = False,
                    mission: str = "TESS", flatpriors: bool = False,
                    exptime: float = 0.00139, nsamples: int = 20,
                    gen: torch.Generator = None,
                    importance_sampling: bool = True, device="cuda",
                    backend: str = "auto"):
    """NTP for a star of unknown properties, its host drawn from the
    TRILEGAL Tmag +/- 1 lookalikes (reference ml.py:2365-2551). With no
    lookalike it returns the reference's empty result (lnZ = -inf) and
    runs nothing on the device."""
    pop, N_pos = _prep_lookalikes(trilegal_fname, Tmag, mission, device)
    if N_pos == 0:
        return dict(_EMPTY_NTP)
    gen = _generator(gen, device)
    P_lo, P_hi = _p_bounds(P_orb)
    t, obs_dev, n_t = _lc(time, flux, device)
    d = eng.sample_ntp_unknown(gen, P_lo, P_hi, pop, N=N,
                               flatpriors=flatpriors,
                               stratified=importance_sampling)
    lnL = _planet_lnL(d, t, obs_dev, sigma, d["u1s"], d["u2s"], exptime,
                      n_t, nsamples, backend)
    lnZ, g = eng.run_finalize(lnL, d["lnprior"] + d["lnw"],
                              _gd(d, "P", "incs", "b", "rps", "eccs", "argps",
                                  *_BG_HOST))
    return _res(lnZ, {"M_s": g["host_mass"], "R_s": g["host_rad"],
                      "u1": g["u1s"], "u2": g["u2s"], "P_orb": g["P"],
                      "inc": g["incs"], "b": g["b"], "R_p": g["rps"],
                      "ecc": g["eccs"], "argp": g["argps"]},
                M_EB=_zeros(), R_EB=_zeros(), fluxratio_EB=_zeros(),
                fluxratio_comp=_zeros())


def _eb_results_noprior(d, lnL, lnL_twin, host_fields, **const):
    """Normal and twin best-fit dicts of an EB row without a prior term
    (NEB_unknown / NEB_evolved) and without fluxratio_comp draws;
    host_fields as in ``_eb_results``."""
    gnames = ("P", "incs", "b", "eccs", "argps", "masses", "radii",
              "fluxratios") + (host_fields or ())
    out = []
    for br, lnLb, twin in ((d, lnL, False), (d["twin"], lnL_twin, True)):
        lnZ, g = eng.run_finalize(lnLb, br["lnw"], _gd(br, *gnames))
        fields = {"P_orb": 2 * g["P"] if twin else g["P"], "inc": g["incs"],
                  "b": g["b"], "ecc": g["eccs"], "argp": g["argps"],
                  "M_EB": g["masses"], "R_EB": g["radii"],
                  "fluxratio_EB": g["fluxratios"]}
        if host_fields:
            for name, key in zip(("M_s", "R_s", "u1", "u2"), host_fields):
                fields[name] = g[key]
        out.append(_res(lnZ, fields, **const))
    return tuple(out)


def lnZ_NEB_unknown(time, flux, sigma, P_orb, Tmag, trilegal_fname,
                    N: int = 1000000, parallel: bool = False,
                    mission: str = "TESS", flatpriors: bool = False,
                    exptime: float = 0.00139, nsamples: int = 20,
                    gen: torch.Generator = None,
                    importance_sampling: bool = True, device="cuda",
                    backend: str = "auto"):
    """NEB and its twin for a star of unknown properties (reference
    ml.py:2554-2829). Returns (res, res_twin), or the reference's single
    empty result (lnZ = -inf) when there is no lookalike."""
    pop, N_pos = _prep_lookalikes(trilegal_fname, Tmag, mission, device)
    if N_pos == 0:
        return dict(_EMPTY_NEB)
    gen = _generator(gen, device)
    P_lo, P_hi = _p_bounds(P_orb)
    t, obs_dev, n_t = _lc(time, flux, device)
    d = eng.sample_neb_unknown(gen, P_lo, P_hi, pop, N=N,
                               stratified=importance_sampling,
                               twin_n=_twin_n(N, importance_sampling))
    lnL, lnL_twin = _eb_lnZ_pair(d, t, obs_dev, F32(sigma), d["u1s"],
                                 d["u2s"], exptime, n_t, nsamples, backend)
    return _eb_results_noprior(d, lnL, lnL_twin, _BG_HOST, R_p=_zeros(),
                               fluxratio_comp=_zeros())


def lnZ_NTP_evolved(time, flux, sigma, P_orb, R_s, Teff, Z,
                    N: int = 1000000, parallel: bool = False,
                    mission: str = "TESS", flatpriors: bool = False,
                    exptime: float = 0.00139, nsamples: int = 20,
                    gen: torch.Generator = None,
                    importance_sampling: bool = True, device="cuda",
                    backend: str = "auto"):
    """NTP for a subgiant: a logg of 3.0 sets the host mass (reference
    ml.py:2832-2966)."""
    M_s = _evolved_mass(R_s)
    gen = _generator(gen, device)
    P_lo, P_hi = _p_bounds(P_orb)
    u1, u2 = lookup_target(Z, Teff, 3.0, mission)
    t, obs_dev, n_t = _lc(time, flux, device)
    d = eng.sample_planet_target(gen, P_lo, P_hi, F32(M_s), F32(R_s), N=N,
                                 flatpriors=flatpriors,
                                 stratified=importance_sampling)
    u1a, u2a = _u_arrays(u1, u2, N, device)
    lnL = lnL_planet(t, obs_dev, F32(sigma), d["k"], d["P"], d["a_R"],
                     d["inc_rad"], d["eccs"], d["w_rad"], u1a, u2a,
                     torch.ones((N,), device=device), d["mask"],
                     exptime=exptime, n_t=n_t, ns=nsamples, backend=backend)
    lnZ, g = eng.run_finalize(lnL, d["lnw"],
                              _gd(d, "P", "incs", "b", "rps", "eccs", "argps"))
    return _res(lnZ, {"P_orb": g["P"], "inc": g["incs"], "b": g["b"],
                      "R_p": g["rps"], "ecc": g["eccs"], "argp": g["argps"]},
                M_s=_full(M_s), R_s=_full(R_s), u1=_full(u1), u2=_full(u2),
                M_EB=_zeros(), R_EB=_zeros(), fluxratio_EB=_zeros(),
                fluxratio_comp=_zeros())


def lnZ_NEB_evolved(time, flux, sigma, P_orb, R_s, Teff, Z,
                    N: int = 1000000, parallel: bool = False,
                    mission: str = "TESS", flatpriors: bool = False,
                    exptime: float = 0.00139, nsamples: int = 20,
                    gen: torch.Generator = None,
                    importance_sampling: bool = True, device="cuda",
                    backend: str = "auto"):
    """NEB and its twin for a subgiant (reference ml.py:2969-3178; the twin
    quirks are the sampler's). The twin's best fits report R_EB = R_s, as
    the reference's twin lnL call takes it. Returns (res, res_twin)."""
    M_s = _evolved_mass(R_s)
    gen = _generator(gen, device)
    P_lo, P_hi = _p_bounds(P_orb)
    u1, u2 = lookup_target(Z, Teff, 3.0, mission)
    t, obs_dev, n_t = _lc(time, flux, device)
    d = eng.sample_neb_evolved(gen, P_lo, P_hi, F32(M_s), F32(R_s),
                               F32(Teff), N=N, stratified=importance_sampling,
                               twin_n=_twin_n(N, importance_sampling))
    u1a, u2a = _u_arrays(u1, u2, N, device)
    lnL, lnL_twin = _eb_lnZ_pair(d, t, obs_dev, F32(sigma), u1a, u2a,
                                 exptime, n_t, nsamples, backend)
    res, res_twin = _eb_results_noprior(
        d, lnL, lnL_twin, None, M_s=_full(M_s), R_s=_full(R_s), u1=_full(u1),
        u2=_full(u2), R_p=_zeros(), fluxratio_comp=_zeros())
    res_twin["R_EB"] = np.full(N_SAMPLES, R_s)
    return res, res_twin
