"""Public scenario-evidence API for the ported scenarios: ``lnZ_TTP`` and
``lnZ_TEB``.

Counterpart of the same functions in the JAX package's ``scenarios/api.py``
(reference marginal_likelihoods.py:39-383): sample on the device, score the
draws with the chunked likelihood core, reduce to lnZ and the top-100
best fits. Results hold device tensors until the caller pulls them.

Each function takes an explicit ``device`` (default ``"cuda"``) and an
optional ``torch.Generator`` on that device; without one, a generator is
seeded from numpy's global RNG, so ``np.random.seed`` gives
reproducibility as in the reference. ``backend`` selects the likelihood
path (``ops/lightcurve.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import G, MSUN, RSUN
from ..populations.ldc import lookup_target
from ..ops import lightcurve
from ..ops.lightcurve import lnL_planet, lnL_eb
from . import engine as eng

F32 = np.float32
N_SAMPLES = eng.N_SAMPLES

__all__ = ["lnZ_TTP", "lnZ_TEB"]


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


def _lc(time, flux, nsamples, device):
    """(time, obs_dev, n_t, chunk): float32 device tensors of the curve,
    with obs_dev = flux - 1 formed in float64 on the host."""
    time = np.asarray(time, dtype=np.float64)
    obs_dev = (np.asarray(flux, dtype=np.float64) - 1.0).astype(F32)
    n_t = len(time)
    chunk = lightcurve.draw_chunk(n_t, nsamples)
    return (torch.as_tensor(time.astype(F32), device=device),
            torch.as_tensor(obs_dev, device=device), n_t, chunk)


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
    t, obs_dev, n_t, chunk = _lc(time, flux, nsamples, device)
    d = eng.sample_planet_target(gen, P_lo, P_hi, F32(M_s), F32(R_s), N=N,
                                 flatpriors=flatpriors,
                                 stratified=importance_sampling)
    u1a = torch.full((N,), float(F32(u1)), device=device)
    u2a = torch.full((N,), float(F32(u2)), device=device)
    lnL = lnL_planet(t, obs_dev, F32(sigma), d["k"], d["P"], d["a_R"],
                     d["inc_rad"], d["eccs"], d["w_rad"], u1a, u2a,
                     torch.ones((N,), device=device), d["mask"],
                     exptime=exptime, n_t=n_t, ns=nsamples, chunk=chunk,
                     backend=backend)
    lnZ, g = eng.run_finalize(lnL, d["lnw"],
                              _gd(d, "P", "incs", "b", "rps", "eccs", "argps"))
    return _res(lnZ, {"P_orb": g["P"], "inc": g["incs"], "b": g["b"],
                      "R_p": g["rps"], "ecc": g["eccs"], "argp": g["argps"]},
                M_s=_full(M_s), R_s=_full(R_s), u1=_full(u1), u2=_full(u2),
                M_EB=_zeros(), R_EB=_zeros(), fluxratio_EB=_zeros(),
                fluxratio_comp=_zeros())


def _twin_n(N, importance_sampling):
    """Twin-branch conditioned draw count: N // TWIN_DIV under importance
    sampling, 0 (legacy shared draws) otherwise."""
    return max(N // eng.TWIN_DIV, 1) if importance_sampling else 0


def _eb_lnZ_pair(d, t, obs_dev, sigma, u1a, u2a, exptime, n_t, ns, chunk,
                 backend):
    """Normal (veto on) and twin (veto off, 2P) EB log-likelihoods; the
    twin branch is read from d['twin']."""
    lnL = lnL_eb(t, obs_dev, sigma, d["k"], d["ksec"], d["P"], d["a_R"],
                 d["inc_rad"], d["eccs"], d["w_rad"], u1a, u2a,
                 d["g_pri"], d["g_sec"], d["mask"],
                 exptime=exptime, n_t=n_t, ns=ns, chunk=chunk,
                 apply_veto=True, backend=backend)
    tw = d["twin"]
    nt = tw["P"].shape[0]
    lnL_twin = lnL_eb(t, obs_dev, sigma, tw["k"], tw["ksec"], 2.0 * tw["P"],
                      tw["a_R"], tw["inc_rad"], tw["eccs"], tw["w_rad"],
                      u1a[:nt], u2a[:nt], tw["g_pri"], tw["g_sec"],
                      tw["mask"], exptime=exptime, n_t=n_t, ns=ns,
                      chunk=chunk, apply_veto=False, backend=backend)
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
    t, obs_dev, n_t, chunk = _lc(time, flux, nsamples, device)
    d = eng.sample_teb(gen, P_lo, P_hi, F32(M_s), F32(R_s), F32(Teff),
                       N=N, stratified=importance_sampling,
                       twin_n=_twin_n(N, importance_sampling))
    tw = d["twin"]
    u1a = torch.full((N,), float(F32(u1)), device=device)
    u2a = torch.full((N,), float(F32(u2)), device=device)
    lnL, lnL_twin = _eb_lnZ_pair(d, t, obs_dev, F32(sigma), u1a, u2a,
                                 exptime, n_t, nsamples, chunk, backend)
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
