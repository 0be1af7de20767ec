"""Chunked transit/eclipse likelihood cores (the hot path).

Counterpart of the JAX package's ``ops/lightcurve.py``. Each core evaluates,
for N Monte-Carlo draws, the model light curve over each exposure, applies
the flux-dilution multiplier g, and reduces chi^2 against the observed
curve, in draw chunks so memory stays O(chunk x n_t x nodes).

The model is carried as a deficit from unity: the residual is
obs_dev + g * deficit, with obs_dev = flux - 1 formed on the host in f64.

Paths per call:

* ``backend="auto"`` (default, fast): the fused chi^2 of
  ``ops/chi2_core.py`` straight from the tabulated coefficients and each
  draw's orbit (``chi2_from_orbit``): on a CUDA tensor a hand-written
  kernel that computes the exposure z^2 model per point itself, in draw
  chunks of up to 2^20 (``orbit_chunk``); on a CPU tensor its plain torch
  version, in ``draw_chunk``'s chunks. ``CHI2_SCHEDULE`` picks the kernel: the
  v2 schedule (default) or, with ``TRICERATOPS_PALLAS_V=3`` in the
  environment when this module is imported, the v3 one.
* ``backend="torch"``: the unfused plain-torch fast path
  (``_mean_deficit_fast``), which materializes the deficit.
* ``exact=True``: a full Kepler solve and exact kernel per supersample.

The EB secondary-eclipse veto (diluted secondary depth >= 1.5 sigma) is a
mask: excluded draws keep zero weight but count in N_total.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..core.kepler import projected_z
from . import chi2_core
from .fastcore import (
    deficit_coeffs, cheb_deficit_eval, exposure_z2_poly, z_supersampled,
)
from .occult import occult_quad_deficit

# Fixed secondary-eclipse scan grid (reference likelihoods.py:135, :421)
SEC_GRID = np.linspace(-0.05, 0.05, 25)

LN2PI = float(np.log(2.0 * np.pi))

# chi^2 kernel schedule, read once at import as the JAX package reads its
# Pallas schedule: "2" (chi2_core.chi2_from_orbit) or "3"
# (chi2_core.chi2_from_orbit_v3)
CHI2_SCHEDULE = os.environ.get("TRICERATOPS_PALLAS_V", "2")

# Largest draw chunk of the orbit kernels on a CUDA tensor. No (C, n_t)
# tensor is made there: the per-chunk tensors are (C, 18)-sized and the EB
# veto's (25, C), ~2.6 GiB of device memory at peak for a 1e6-draw chunk,
# so a 1e6-draw core runs as one launch and larger N stays bounded
ORBIT_CHUNK_MAX = 1 << 20

_GL_EXPO_MAX = 4


def _ss_offsets(exptime: float, ns: int):
    return exptime * ((np.arange(ns) + 0.5) / ns - 0.5)


def supersample_times(time: np.ndarray, exptime: float,
                      nsamples: int) -> np.ndarray:
    """Supersampled exposure grid, an (n_t * nsamples,) host array: each
    exposure of length ``exptime`` sampled at ``nsamples`` midpoints,
    exposure-major (reference likelihoods.py:61)."""
    time = np.asarray(time, dtype=np.float64)
    if nsamples <= 1:
        return time
    offs = _ss_offsets(exptime, nsamples)
    return (time[:, None] + offs[None, :]).reshape(-1)


def _pad_chunk(arrs, N, chunk):
    """Zero-pad each (N, ...) tensor to whole chunks and view it as
    (n_chunks, chunk, ...). Padded draws carry mask = False."""
    n_chunks = -(-N // chunk)
    pad = n_chunks * chunk - N
    out = []
    for a in arrs:
        if pad:
            a = torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
        out.append(a.reshape((n_chunks, chunk) + tuple(a.shape[1:])))
    return out


def draw_chunk(n_t: int, ns: int) -> int:
    """Draw-axis chunk size: keeps the (chunk, n_t * nodes) f32
    intermediate ~40 MB (16384 draws at n_t = 100, GL-4)."""
    n_ss = n_t * min(max(ns, 1), _GL_EXPO_MAX)
    return int(max(256, min(16384, (1 << 25) // max(n_ss, 1))))


def _gl_exposure_nodes(exptime: float, ns: int):
    """Gauss-Legendre nodes and weights over one exposure, GL-min(ns, 4)
    (float32 numpy): a low-order GL rule matches the reference's ns-point
    midpoint rule to well below the kernel tolerance."""
    n_eff = min(ns, _GL_EXPO_MAX)
    x, wgt = np.polynomial.legendre.leggauss(n_eff)
    return (exptime / 2.0 * x).astype(np.float32), (wgt / 2.0).astype(np.float32)


def _mean_deficit_exact(time, exptime, k, P, a_R, inc, e, w, u1, u2,
                        n_t, ns):
    """Exact path: full Kepler + kernel per supersample, (chunk, n_t)."""
    if ns > 1:
        offs = torch.as_tensor(_ss_offsets(exptime, ns), dtype=time.dtype,
                               device=time.device)
        t_ss = (offs[:, None] + time[None, :]).reshape(-1)
    else:
        t_ss = time
    z, front = projected_z(t_ss[None, :], 0.0, P[:, None], a_R[:, None],
                           inc[:, None], e[:, None], w[:, None])
    D = occult_quad_deficit(k[:, None], z, u1[:, None], u2[:, None])
    D = torch.where(front, D, torch.zeros_like(D))
    if ns > 1:
        D = D.reshape(D.shape[0], ns, n_t).mean(dim=1)
    return D


def _mean_deficit_fast(time, exptime, k, P, a_R, inc, e, w, u1, u2,
                       n_t, ns):
    """Unfused fast path: Chebyshev deficit proxy + per-exposure Kepler."""
    coeffs = deficit_coeffs(k, u1, u2)
    if ns > 1:
        q0, q1, q2, front = exposure_z2_poly(time, exptime / 2.0, P, a_R,
                                             inc, e, w)
        offs, wgt = _gl_exposure_nodes(exptime, ns)
        z = z_supersampled(q0, q1, q2,
                           torch.as_tensor(offs, device=time.device))
        D = cheb_deficit_eval(coeffs, z.reshape(z.shape[0], -1))
        D = D.reshape(z.shape) * front[:, None, :]
        return torch.einsum("cst,s->ct", D,
                            torch.as_tensor(wgt, device=time.device))
    z, front = projected_z(time[None, :], 0.0, P[:, None], a_R[:, None],
                           inc[:, None], e[:, None], w[:, None])
    D = cheb_deficit_eval(coeffs, z)
    return torch.where(front, D, torch.zeros_like(D))


def _mean_deficit(time, exptime, k, P, a_R, inc, e, w, u1, u2, n_t, ns,
                  exact):
    fn = _mean_deficit_exact if exact else _mean_deficit_fast
    return fn(time, exptime, k, P, a_R, inc, e, w, u1, u2, n_t, ns)


def _chi2_fused(time, exptime, obs_dev, k, P, a_R, inc, e, w, u1, u2, g,
                n_t, ns):
    """chi^2 of one chunk straight from per-draw parameters through
    ``chi2_core.chi2_from_orbit`` or, under ``CHI2_SCHEDULE == "3"``,
    ``chi2_core.chi2_from_orbit_v3`` (a kernel on CUDA, the plain version
    on CPU): GL exposure nodes and the Taylor z^2 model for ns > 1, the
    exact projected separation at one node for ns = 1."""
    cA, cB1, cB2, zsplit, zmid, invA, invB1, invB2 = deficit_coeffs(k, u1, u2)
    if ns > 1:
        offs, wgt = _gl_exposure_nodes(exptime, ns)
    else:
        offs, wgt = np.zeros(1, np.float32), np.ones(1, np.float32)
    seg = torch.stack([zsplit, zmid, invA, invB1, invB2], dim=1)
    fn = (chi2_core.chi2_from_orbit_v3 if CHI2_SCHEDULE == "3"
          else chi2_core.chi2_from_orbit)
    return fn(*(x.contiguous() for x in (time, P, a_R, inc, e, w, cA, cB1,
                                         cB2)),
              seg, g[:, None].contiguous(), obs_dev[None, :].contiguous(),
              offs=offs, wgts=wgt, ns=ns)


def _sigma_terms(sigma):
    """(1/sigma^2, ln sigma) in float32, as the JAX cores form them."""
    sigma = np.float32(sigma)
    return float(np.float32(1.0) / (sigma * sigma)), float(np.log(sigma))


def _chunk_chi2(time, exptime, obs_dev, kc, Pc, ac, ic, ec, wc, u1c, u2c,
                gc, n_t, ns, exact, backend):
    if backend == "auto" and not exact:
        return _chi2_fused(time, exptime, obs_dev, kc, Pc, ac, ic, ec, wc,
                           u1c, u2c, gc, n_t, ns)
    D = _mean_deficit(time, exptime, kc, Pc, ac, ic, ec, wc, u1c, u2c, n_t,
                      ns, exact)
    resid = obs_dev[None, :] + gc[:, None] * D
    return torch.sum(resid * resid, dim=1)


def _kernel_chunk(chunk):
    """The draw chunk rounded up to the selected kernel's draw multiple."""
    tile = (chi2_core.DRAW_LANES if CHI2_SCHEDULE == "3"
            else chi2_core.DRAW_TILE)
    return -(-chunk // tile) * tile


def orbit_chunk(N: int) -> int:
    """Draw chunk of the orbit kernels on a CUDA tensor, whatever n_t: N
    split into ceil(N / 2^20) near-equal chunks, each rounded up to a
    multiple of 256 (both schedules' draw multiple), so N <= 2^20 runs as
    one chunk (1000192 draws at N = 1e6)."""
    n_chunks = max(1, -(-N // ORBIT_CHUNK_MAX))
    per = -(-max(N, 1) // n_chunks)
    return -(-per // chi2_core.DRAW_TILE) * chi2_core.DRAW_TILE


def _core_chunk(chunk, N, time, n_t, ns, exact, backend):
    """The draw chunk a core runs: the caller's ``chunk`` if given, else
    ``orbit_chunk(N)`` where the orbit kernels run (a CUDA tensor under
    ``backend="auto"``, not ``exact``), which make no (chunk, n_t) tensor,
    and ``draw_chunk(n_t, ns)`` elsewhere, whose (chunk, n_t) tensors it
    bounds. Under ``backend="auto"`` it is rounded up to the kernel's draw
    multiple."""
    if chunk is None:
        orbit = (backend == "auto" and not exact
                 and time.device.type == "cuda")
        chunk = orbit_chunk(N) if orbit else draw_chunk(n_t, ns)
    return _kernel_chunk(chunk) if backend == "auto" else chunk


def _check_backend(backend):
    if backend not in ("auto", "torch"):
        raise ValueError(f"backend must be 'auto' or 'torch', got {backend!r}")


def lnL_planet(time, obs_dev, sigma, k, P, a_R, inc, e, w, u1, u2, g, mask,
               *, exptime: float, n_t: int, ns: int,
               chunk: int | None = None, exact: bool = False,
               backend: str = "auto"):
    """Transiting-planet family log-likelihoods for N draws.

    Returns lnL (N,) = -0.5 ln 2pi - ln sigma - 0.5 chi^2 for masked-in
    draws, -inf otherwise (reference marginal_likelihoods.py:117-137).
    ``chunk`` (draws per step) is picked by ``_core_chunk`` unless given."""
    _check_backend(backend)
    N = k.shape[0]
    inv_sig2, ln_sigma = _sigma_terms(sigma)
    chunk = _core_chunk(chunk, N, time, n_t, ns, exact, backend)
    parts = _pad_chunk([k, P, a_R, inc, e, w, u1, u2, g, mask], N, chunk)
    out = torch.empty((parts[0].shape[0], chunk), dtype=time.dtype,
                      device=time.device)
    for i in range(out.shape[0]):
        kc, Pc, ac, ic, ec, wc, u1c, u2c, gc, mc = (p[i] for p in parts)
        chi2 = _chunk_chi2(time, exptime, obs_dev, kc, Pc, ac, ic, ec, wc,
                           u1c, u2c, gc, n_t, ns, exact, backend) * inv_sig2
        lnL = (-0.5 * LN2PI - ln_sigma) - 0.5 * chi2
        out[i] = torch.where(mc, lnL, torch.full_like(lnL, -math.inf))
    return out.reshape(-1)[:N]


def lnL_eb(time, obs_dev, sigma, k, ksec, P, a_R, inc, e, w, u1, u2,
           g_pri, g_sec, mask, *, exptime: float, n_t: int, ns: int,
           chunk: int | None = None, apply_veto: bool = True,
           exact: bool = False, backend: str = "auto"):
    """Eclipsing-binary family log-likelihoods for N draws.

    k is the (quirk-adjusted) primary radius ratio, ksec the secondary
    one. With apply_veto, draws whose diluted secondary depth is >= 1.5
    sigma are excluded (ref likelihoods.py:535-538); the twin branch
    passes apply_veto=False. The deficit is monotone non-increasing in z,
    so the 25-point secondary scan's maximum deficit is one exact kernel
    evaluation at the minimum in-front z. ``chunk`` as in ``lnL_planet``."""
    _check_backend(backend)
    N = k.shape[0]
    inv_sig2, ln_sigma = _sigma_terms(sigma)
    chunk = _core_chunk(chunk, N, time, n_t, ns, exact, backend)
    sec_grid = torch.as_tensor(SEC_GRID, dtype=time.dtype, device=time.device)
    parts = _pad_chunk([k, ksec, P, a_R, inc, e, w, u1, u2, g_pri, g_sec,
                        mask], N, chunk)
    out = torch.empty((parts[0].shape[0], chunk), dtype=time.dtype,
                      device=time.device)
    veto_depth = float(np.float32(1.5) * np.float32(sigma))
    for i in range(out.shape[0]):
        (kc, ksc, Pc, ac, ic, ec, wc, u1c, u2c, gpc, gsc,
         mc) = (p[i] for p in parts)
        chi2 = _chunk_chi2(time, exptime, obs_dev, kc, Pc, ac, ic, ec, wc,
                           u1c, u2c, gpc, n_t, ns, exact, backend) * inv_sig2
        lnL = (-0.5 * LN2PI - ln_sigma) - 0.5 * chi2
        if apply_veto:
            zs, fronts = projected_z(sec_grid[:, None], 0.0, Pc[None, :],
                                     ac[None, :], ic[None, :], ec[None, :],
                                     wc[None, :] + math.pi)
            big = torch.full_like(zs, 1e30)
            z_eff = torch.min(torch.where(fronts, zs, big), dim=0).values
            has_front = torch.any(fronts, dim=0)
            D_eff = occult_quad_deficit(ksc, torch.clamp_max(z_eff, 1e30),
                                        u1c, u2c)
            secdepth = gsc * torch.where(has_front, D_eff,
                                         torch.zeros_like(D_eff))
            mc = mc & (secdepth < veto_depth)
        out[i] = torch.where(mc, lnL, torch.full_like(lnL, -math.inf))
    return out.reshape(-1)[:N]


def eb_radius_ratios(radii, R_host):
    """Primary/secondary radius ratios with the reference's batch-path
    near-unity adjustment: every k < 1 + 1e-6 is scaled by 0.999
    (reference likelihoods.py:405-406, :417-418)."""
    k = radii / R_host
    k = torch.where((k - 1.0) < 1e-6, k * 0.999, k)
    ksec = R_host / radii
    ksec = torch.where((ksec - 1.0) < 1e-6, ksec * 0.999, ksec)
    return k, ksec


def tp_dilution(F_comp, companion_is_host: bool):
    """Deficit multiplier g for the TP dilution chain
    (reference likelihoods.py:352-357)."""
    if companion_is_host:
        return 1.0 / (1.0 + 1.0 / F_comp)
    return 1.0 / (1.0 + F_comp)


def eb_dilution(F_EB, F_comp, companion_is_host: bool):
    """(g_pri, g_sec) deficit multipliers for the EB dilution chains
    (reference likelihoods.py:427-438)."""
    if companion_is_host:
        x1 = F_EB / F_comp
        x2 = 1.0 / (F_comp + F_EB)
        y1 = F_comp / F_EB
    else:
        x1 = F_EB
        x2 = F_comp / (1.0 + F_EB)
        y1 = 1.0 / F_EB
    g_pri = 1.0 / ((1.0 + x1) * (1.0 + x2))
    g_sec = 1.0 / ((1.0 + y1) * (1.0 + x2))
    return g_pri, g_sec
