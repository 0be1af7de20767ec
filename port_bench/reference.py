"""Plain reference of what the benchmark's cells compute, in plain torch.

Imports nothing of the program. It follows upstream TRICERATOPS's
semantics (Giacalone et al. 2021; the batman-style transit model):

* ``projected_z``: the sky-projected separation of a body on a Keplerian
  orbit, transit epoch at t = 0 (true anomaly pi/2 - w at conjunction), in
  front where sin(w + f) > 0; Kepler's equation by a fixed number of
  Newton steps.
* ``occult_deficit``: the quadratic limb-darkened flux blocked by a disk
  of radius k at separation z, by radial integration: the fully covered
  disk r < k - z in closed form, the partly covered annuli
  |z - k| < r < min(1, z + k) by Gauss-Legendre over theta with
  r = r_lo + (r_hi - r_lo) (1 - cos theta) / 2, which makes the arc's
  square-root ends smooth.
* ``lnL``: the ``nsamples``-point midpoint exposure average of the model
  flux 1 - g D (upstream's supersampling), chi^2 against the observed
  flux, lnL = -ln(2 pi) / 2 - ln sigma - chi^2 / (2 sigma^2), -inf where
  the draw is masked out or, for an eclipsing binary with the veto on,
  where its diluted secondary depth over a 25-point scan is >= 1.5 sigma.
* ``finalize``: lnZ = log mean exp(lnL + ln prior) over all draws.
* ``probabilities``: the scenario probabilities, FPP and NFPP.
* ``flux_ratios`` / ``renorm``: each star's share of the 5 x 5 pixel
  aperture under a Gaussian PSF, and the curve renormalized to a star.

Every function takes a ``dtype``: float64 is the reference, bfloat16 the
precision control (``check.py``). The exposure average and chi^2 are
matrix products, as upstream averages the supersampled flux.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.special import ndtr

# Newton steps of Kepler's equation (float64 converges in < 10 from the
# Danby start for e < 0.995)
KEPLER_STEPS = 30
# Gauss-Legendre nodes of the partly covered annuli
RADIAL_NODES = 48
# the eclipsing-binary veto's secondary scan (upstream likelihoods.py)
SEC_GRID = np.linspace(-0.05, 0.05, 25)
VETO_SIGMA = 1.5
# TESS pixel [arcsec] and PSF width [pixels] of the aperture model
PIXEL_ARCSEC = {"TESS": 20.25, "Kepler": 4.0, "K2": 4.0}
PSF_SIGMA_PIX = 0.75
LN2PI = math.log(2.0 * math.pi)


def solve_kepler(M, e):
    """E with E - e sin E = M."""
    E = M + 0.85 * e * torch.sign(torch.sin(M))
    for _ in range(KEPLER_STEPS):
        E = E - (E - e * torch.sin(E) - M) / (1.0 - e * torch.cos(E))
    return E


def projected_z(t, P, a_R, inc, e, w):
    """(z, front): separation in stellar radii and the in-front flag at
    times t (days from mid-transit); orbital arguments broadcast with t."""
    f_c = math.pi / 2.0 - w
    E_c = 2.0 * torch.atan2(torch.sqrt(1.0 - e) * torch.sin(f_c / 2.0),
                            torch.sqrt(1.0 + e) * torch.cos(f_c / 2.0))
    M = E_c - e * torch.sin(E_c) + 2.0 * math.pi * t / P
    E = solve_kepler(M, e)
    f = 2.0 * torch.atan2(torch.sqrt(1.0 + e) * torch.sin(E / 2.0),
                          torch.sqrt(1.0 - e) * torch.cos(E / 2.0))
    r = a_R * (1.0 - e * torch.cos(E))
    su = torch.sin(w + f)
    z = r * torch.sqrt(torch.clamp_min(1.0 - su * su * torch.sin(inc) ** 2,
                                       0.0))
    return z, su > 0.0


def _disk_integral(A, u1, u2):
    """int_0^A I ds with s = r^2, I = 1 - u1 (1 - mu) - u2 (1 - mu)^2."""
    mu3 = torch.clamp_min(1.0 - A, 0.0) ** 1.5
    return ((1.0 - u1 - u2) * A + (u1 + 2.0 * u2) * (2.0 / 3.0) * (1.0 - mu3)
            - u2 * (A - A * A / 2.0))


def occult_deficit(k, z, u1, u2):
    """Blocked share of the star's flux (broadcasts); 0 out of transit."""
    dtype, dev = z.dtype, z.device
    k, z = torch.broadcast_tensors(k.to(dtype), z)
    u1, u2 = (torch.broadcast_to(u.to(dtype), z.shape) for u in (u1, u2))
    full = _disk_integral(torch.tensor(1.0, dtype=dtype, device=dev), u1, u2)
    a = torch.clamp(k - z, 0.0, 1.0)
    blocked = math.pi * _disk_integral(a * a, u1, u2)
    r_lo = torch.abs(z - k)
    r_hi = torch.clamp_max(z + k, 1.0)
    part = (r_lo < r_hi) & (z > 0.0)
    x, wq = np.polynomial.legendre.leggauss(RADIAL_NODES)
    th = torch.as_tensor((x + 1.0) * (math.pi / 2.0), dtype=dtype,
                         device=dev)
    wt = torch.as_tensor(wq * (math.pi / 2.0), dtype=dtype, device=dev)
    span = torch.where(part, r_hi - r_lo, torch.zeros_like(z))[..., None]
    r = r_lo[..., None] + span * (1.0 - torch.cos(th)) / 2.0
    dr = span * torch.sin(th) / 2.0
    zz, kk = z[..., None], k[..., None]
    c = (r * r + zz * zz - kk * kk) / torch.clamp_min(2.0 * r * zz, 1e-30)
    alpha = torch.acos(torch.clamp(c, -1.0, 1.0))
    mu = torch.sqrt(torch.clamp_min(1.0 - r * r, 0.0))
    one_mu = 1.0 - mu
    inten = 1.0 - u1[..., None] * one_mu - u2[..., None] * one_mu * one_mu
    blocked = blocked + torch.where(
        part, torch.sum(inten * 2.0 * r * alpha * dr * wt, -1),
        torch.zeros_like(z))
    return torch.where(z >= 1.0 + k, torch.zeros_like(z),
                       blocked / (math.pi * full))


def exposure_offsets(exptime, nsamples):
    """Midpoints of an exposure of ``exptime`` days split ``nsamples``
    ways, relative to its centre (upstream's supersampling)."""
    if nsamples <= 1:
        return np.zeros(1)
    return exptime * ((np.arange(nsamples) + 0.5) / nsamples - 0.5)


def lnL(time, flux, sigma, draws, *, exptime, nsamples, veto, dtype,
        block_elems=1 << 22):
    """Per-draw log-likelihood of C draws of one target's curve.

    time, flux: (n_t,) float64 numpy; sigma: float. ``draws``: dict of (C,)
    tensors k, P, a_R, inc, e, w, u1, u2, g, mask and, with ``veto``,
    ksec and g_sec. Returns (lnL (C,), secondary depth over 1.5 sigma (C,)
    or None) in ``dtype``, computed in blocks of draws of about
    ``block_elems`` (draw, exposure, midpoint) triples; the deficit only
    where the body is in front and z < 1 + k."""
    dev = draws["k"].device
    offs = exposure_offsets(exptime, nsamples)
    t = torch.as_tensor(np.asarray(time, np.float64)[:, None] + offs[None, :],
                        dtype=dtype, device=dev)
    obs = torch.as_tensor(np.asarray(flux, np.float64), dtype=dtype,
                          device=dev)
    wts = torch.full((len(offs), 1), 1.0 / len(offs), dtype=dtype,
                     device=dev)
    sec_t = torch.as_tensor(SEC_GRID, dtype=dtype, device=dev)
    sig = torch.tensor(float(sigma), dtype=torch.float64)
    const = float(-0.5 * LN2PI - math.log(float(sigma)))
    C = draws["k"].shape[0]
    block = max(1, block_elems // (len(time) * len(offs)))
    out, sec_out = [], []
    for i in range(0, C, block):
        d = {n: v[i:i + block].to(dtype) if v.dtype.is_floating_point
             else v[i:i + block] for n, v in draws.items()}
        col = {n: d[n][:, None, None] for n in
               ("k", "P", "a_R", "inc", "e", "w", "u1", "u2")}
        z, front = projected_z(t[None], col["P"], col["a_R"], col["inc"],
                               col["e"], col["w"])
        D = torch.zeros_like(z)
        shape = z.shape
        live = front & (z < 1.0 + col["k"])
        if live.any():
            pick = {n: col[n].expand(shape)[live] for n in ("k", "u1", "u2")}
            D[live] = occult_deficit(pick["k"], z[live], pick["u1"],
                                     pick["u2"])
        model = 1.0 - d["g"][:, None, None] * D
        nodes = model.shape[-1]
        mean = (model.reshape(-1, nodes) @ wts).reshape(model.shape[:2])
        resid = (obs[None, :] - mean) / sig.to(dtype)
        chi2 = (resid * resid) @ torch.ones((resid.shape[1], 1), dtype=dtype,
                                            device=dev)
        ll = const - 0.5 * chi2[:, 0]
        ok = d["mask"].bool()
        if veto:
            c2 = {n: d[n][:, None] for n in
                  ("P", "a_R", "inc", "e", "w", "ksec", "u1", "u2")}
            zs, fs = projected_z(sec_t[None], c2["P"], c2["a_R"], c2["inc"],
                                 c2["e"], c2["w"] + math.pi)
            Ds = occult_deficit(c2["ksec"], zs, c2["u1"], c2["u2"]) * fs
            depth = d["g_sec"] * torch.amax(Ds, dim=1)
            ratio = depth / (VETO_SIGMA * sig.to(dtype))
            ok = ok & (ratio < 1.0)
            sec_out.append(ratio)
        out.append(torch.where(ok, ll, torch.full_like(ll, -math.inf)))
    return torch.cat(out), (torch.cat(sec_out) if veto else None)


def finalize(logw, dtype=torch.float64):
    """log mean exp over all draws of lnL + ln prior: NaN and -inf weigh
    nothing and stay in the count, any +inf gives +inf, none finite -inf."""
    x = logw.to(dtype)
    n = x.shape[-1]
    if torch.isposinf(x).any():
        return float("inf")
    fin = torch.isfinite(x)
    if not fin.any():
        return -math.inf
    x = torch.where(fin, x, torch.full_like(x, -math.inf))
    m = x.max()
    s = torch.exp(x - m).sum()
    return float(m + torch.log(s) - math.log(n))


def probabilities(lnZ, dtype=torch.float64):
    """(probs, FPP, NFPP) of scenario log-evidences in calc_probs' row
    order: FPP = 1 - P(TP) - P(PTP) - P(DTP), NFPP the nearby rows'."""
    z = torch.as_tensor(np.asarray(lnZ, np.float64)).to(dtype)
    p = torch.exp(z - torch.logsumexp(z, 0)).double().numpy()
    fpp = max(1.0 - (p[0] + p[3] + p[9]), 0.0)
    return p, fpp, float(p[15:].sum()) if len(p) > 15 else 0.0


def flux_ratios(tmag, sep_arcsec, pa_deg, mission="TESS", search_radius=10):
    """Each star's share of the flux in a 5 x 5 pixel aperture centred on
    the target, Gaussian PSFs of 0.75 px at the stars' offsets (upstream
    calc_depths with its default aperture)."""
    px = PIXEL_ARCSEC[mission]
    centre = (2 * search_radius + 2) / 2.0
    sep = np.asarray(sep_arcsec, float) / px
    pa = np.deg2rad(np.asarray(pa_deg, float))
    off = np.c_[sep * np.sin(pa), sep * np.cos(pa)]
    mu = centre + np.where(np.isfinite(off), off, 0.0)
    tp = np.round(mu[0])
    pix = np.array([np.repeat(np.arange(tp[0] - 2, tp[0] + 3), 5),
                    np.tile(np.arange(tp[1] - 2, tp[1] + 3), 5)]).T
    amp = 10 ** ((np.min(tmag) - np.asarray(tmag, float)) / 2.5)
    s = PSF_SIGMA_PIX
    dx = (ndtr((pix[None, :, 0] + 0.5 - mu[:, 0, None]) / s)
          - ndtr((pix[None, :, 0] - 0.5 - mu[:, 0, None]) / s))
    dy = (ndtr((pix[None, :, 1] + 0.5 - mu[:, 1, None]) / s)
          - ndtr((pix[None, :, 1] - 0.5 - mu[:, 1, None]) / s))
    rel = amp * np.sum(dx * dy, axis=1)
    return rel / rel.sum()


def required_depths(fluxratio, tdepth):
    """Depth each star would need to show the observed one; 0 where it
    cannot (upstream calc_depths)."""
    fr = np.asarray(fluxratio, float)
    d = np.where(fr != 0, 1 - (fr - tdepth) / np.where(fr != 0, fr, 1.0), 0.0)
    return np.where(d > 1, 0.0, d)


def renorm(flux, sigma, fluxratio):
    """The curve as the star of this flux share sees it."""
    return (np.asarray(flux) - (1 - fluxratio)) / fluxratio, sigma / fluxratio
