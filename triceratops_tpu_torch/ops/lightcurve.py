"""Chunked transit/eclipse likelihood cores (the hot path).

Counterpart of the JAX package's ``ops/lightcurve.py``. Each core evaluates,
for N Monte-Carlo draws, the model light curve over each exposure, applies
the flux-dilution multiplier g, and reduces chi^2 against the observed
curve, in draw chunks so memory stays O(chunk x n_t x nodes).

The model is carried as a deficit from unity: the residual is
obs_dev + g * deficit, with obs_dev = flux - 1 formed on the host in f64.

Paths per call:

* ``backend="auto"`` (default, fast): the fused chi^2 of
  ``ops/chi2_core.py`` straight from each draw's parameters and orbit. On
  a CUDA tensor a hand-written kernel computes the exposure z^2 model per
  point itself, in draw chunks of up to 2^20 (``orbit_chunk``), and the
  deficit coefficients too where ``in_kernel_coeffs`` names a stage:
  tabulated ones (``chi2_from_orbit_tab``, or ``chi2_from_orbit_v3_tab``
  under v3) or, under ``TRICERATOPS_COEFFS=exact`` on v2, exact ones
  (``chi2_from_orbit_exact``); otherwise the torch coefficient stage feeds
  it. On a CPU tensor the torch coefficient stage feeds the kernel's plain
  torch version, in ``draw_chunk``'s chunks. ``CHI2_SCHEDULE`` picks the
  kernel: the v2 schedule (default) or, with ``TRICERATOPS_PALLAS_V=3`` in
  the environment when this module is imported, the v3 one.
* ``backend="torch"``: the unfused plain-torch fast path
  (``_mean_deficit_fast``), which materializes the deficit.
* ``exact=True``: a full Kepler solve and exact kernel per supersample.

The EB secondary-eclipse veto (diluted secondary depth >= 1.5 sigma) is a
mask: excluded draws keep zero weight but count in N_total.

Each core runs in the span ``tri.core.lnL_planet`` / ``tri.core.lnL_eb``
(the EB veto in ``tri.core.veto``) of ``utils/profiling.py`` and adds its
draws to the counter ``draws.core``.

A core takes one target (time and obs_dev (n_t,), sigma a scalar) or B
targets at once, the counterpart of the JAX package's ``jax.vmap`` over a
core (``parallel/sharding.py::_build_family_step``): time and obs_dev
(B, n_t), sigma (B,), the per-draw arrays B * N draws target-major. Each
target's draws are padded to whole chunks on their own, and each draw's
lnL is what its target alone gives. On a CUDA tensor under
``backend="auto"`` the targets' chunks go to the orbit kernel together,
one launch over as many whole targets as ``DRAW_CAP`` holds; elsewhere
each chunk runs on its own.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..core.kepler import projected_z
from ..core.numerics import full_precision_matmul
from ..utils import profiling
from . import chi2_core, fastcore
from .fastcore import (
    deficit_coeffs, cheb_deficit_eval, exposure_z2_poly, z_supersampled,
)
from .occult import occult_quad_deficit

# Fixed secondary-eclipse scan grid (reference likelihoods.py:135, :421)
SEC_GRID = np.linspace(-0.05, 0.05, 25)

LN2PI = float(np.log(2.0 * np.pi))

# chi^2 kernel schedule, read once at import as the JAX package reads its
# Pallas schedule: "2" (chi2_core.chi2_from_orbit_tab, or
# chi2_from_orbit_exact under exact coefficients) or "3"
# (chi2_core.chi2_from_orbit_v3_tab, or chi2_from_orbit_v3 fed by the torch
# exact stage); v3 skips the Kepler solve outside each draw's transit
# window, which pays on long unbinned curves
CHI2_SCHEDULE = os.environ.get("TRICERATOPS_PALLAS_V", "2")

# Largest draw chunk of the orbit kernels on a CUDA tensor. No (C, n_t)
# tensor is made there: the per-chunk tensors are (C, 18)-sized and the EB
# veto's (25, C), ~2.6 GiB of device memory at peak for a 1e6-draw chunk,
# so a 1e6-draw core runs as one launch and larger N stays bounded
ORBIT_CHUNK_MAX = 1 << 20

# Most draws one orbit-kernel launch of a batched core takes: whole targets
# (one chunk each) go to one launch while their padded draws fit. Set from
# memory, not speed: a torch coefficient stage on the card holds per-draw
# intermediates for the whole launch (the tab stage (C, 152) and (C, 162)
# f32 products, ~1.3 KB a draw, which at 2^23 (8 targets of 1000192) took
# an 8-target batch call to 14.2 GiB (PERF.md); the exact stage, which v3
# under TRICERATOPS_COEFFS=exact still runs, (C, 18, 11) ones);
# chi2_from_orbit_tab, chi2_from_orbit_v3_tab and chi2_from_orbit_exact
# make none
DRAW_CAP = 1 << 23

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


def _pad_chunk(arrs, N, chunk, B=1):
    """Zero-pad each target's N draws of each (B * N, ...) tensor to whole
    chunks and view it as (B * n_chunks, chunk, ...), target-major. Padded
    draws carry mask = False."""
    n_chunks = -(-N // chunk)
    pad = n_chunks * chunk - N
    out = []
    for a in arrs:
        rest = tuple(a.shape[1:])
        a = a.reshape((B, N) + rest)
        if pad:
            a = torch.cat([a, a.new_zeros((B, pad) + rest)], dim=1)
        out.append(a.reshape((B * n_chunks, chunk) + rest))
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
        with full_precision_matmul():
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


def in_kernel_coeffs(device, dtype, coeffs_backend, schedule):
    """The coefficient stage that ``_chi2_fused``'s kernel runs itself for
    draws of ``dtype`` on ``device`` under a ``fastcore.COEFFS_BACKEND``
    value and a ``CHI2_SCHEDULE``: "tab" on a CUDA device when the
    coefficients are tabulated (``fastcore.uses_tab``), under either
    schedule (``chi2_core.chi2_from_orbit_tab``, or
    ``chi2_from_orbit_v3_tab`` under v3); "exact" on a CUDA device for
    float32 draws under "exact" on v2 (``chi2_from_orbit_exact``); else
    None: the torch coefficient stage feeds the schedule's orbit entry
    point, ``chi2_from_orbit`` or ``chi2_from_orbit_v3`` (on a CPU device
    its plain version). Settings, not fallbacks: nothing tries one route
    and takes another."""
    if torch.device(device).type != "cuda":
        return None
    if fastcore.uses_tab(coeffs_backend, dtype):
        return "tab"
    if (coeffs_backend == "exact" and dtype == torch.float32
            and schedule == "2"):
        return "exact"
    return None


def _chi2_fused(time, exptime, obs_dev, k, P, a_R, inc, e, w, u1, u2, g,
                n_t, ns):
    """chi^2 of one chunk straight from per-draw parameters (a kernel on
    CUDA, the plain version on CPU): where ``in_kernel_coeffs`` names
    "tab" ``chi2_core.chi2_from_orbit_tab`` or, under ``CHI2_SCHEDULE ==
    "3"``, ``chi2_from_orbit_v3_tab``; where it names "exact"
    ``chi2_core.chi2_from_orbit_exact``; else the torch coefficient stage
    into ``chi2_core.chi2_from_orbit`` or, under v3,
    ``chi2_core.chi2_from_orbit_v3``. GL exposure nodes and the Taylor z^2
    model for ns > 1, the exact projected separation at one node for ns =
    1. time and obs_dev are (n_t,) for one target or (B, n_t), the draws
    then B equal target-major blocks. The v2 kernels skip the deficit in
    each 32-point group of a draw with no point in transit and, on curves
    of at least ``chi2_core.V2_WINDOW_MIN_T`` exposures, the Kepler solve
    too in each group with no point inside the draw's transit window, with
    the same output; a curve sorted by time, as ``api._lc`` keeps a folded
    one, puts most of a long curve's groups outside the window."""
    if ns > 1:
        offs, wgt = _gl_exposure_nodes(exptime, ns)
    else:
        offs, wgt = np.zeros(1, np.float32), np.ones(1, np.float32)
    dtype = torch.promote_types(torch.promote_types(k.dtype, u1.dtype),
                                u2.dtype)
    orbit = [x.contiguous() for x in (time, P, a_R, inc, e, w)]
    obs = obs_dev.reshape(-1, time.shape[-1]).contiguous()
    v3 = CHI2_SCHEDULE == "3"
    stage = in_kernel_coeffs(time.device, dtype, fastcore.COEFFS_BACKEND,
                             CHI2_SCHEDULE)
    if stage is not None:
        fn = (chi2_core.chi2_from_orbit_exact if stage == "exact"
              else chi2_core.chi2_from_orbit_v3_tab if v3
              else chi2_core.chi2_from_orbit_tab)
        return fn(*orbit, *(x.contiguous() for x in (k, u1, u2, g)), obs,
                  offs=offs, wgts=wgt, ns=ns)
    cA, cB1, cB2, zsplit, zmid, invA, invB1, invB2 = deficit_coeffs(k, u1, u2)
    seg = torch.stack([zsplit, zmid, invA, invB1, invB2], dim=1)
    fn = chi2_core.chi2_from_orbit_v3 if v3 else chi2_core.chi2_from_orbit
    return fn(*orbit, cA.contiguous(), cB1.contiguous(), cB2.contiguous(),
              seg, g[:, None].contiguous(), obs, offs=offs, wgts=wgt, ns=ns)


def _targets(time, obs_dev, sigma, n_draws):
    """A core's targets: time and obs_dev as (B, n_t), sigma as a (B,)
    float32 array, N (the draws per target), and per target as (B, 1)
    float32 tensors the lnL constant -0.5 ln 2pi - ln sigma and 1/sigma^2,
    formed as the JAX cores form them. time (n_t,) with a scalar sigma is
    one target."""
    if time.dim() == 1:
        time, obs_dev = time[None, :], obs_dev[None, :]
    B, n_t = time.shape
    sig = np.asarray(sigma, np.float32).reshape(-1)
    if tuple(obs_dev.shape) != (B, n_t) or sig.shape != (B,):
        raise ValueError(f"time {tuple(time.shape)} needs obs_dev ({B}, "
                         f"{n_t}) and {B} sigmas, got {tuple(obs_dev.shape)} "
                         f"and {sig.shape[0]}")
    if n_draws % B:
        raise ValueError(f"{n_draws} draws do not split over {B} targets")
    inv = np.float32(1.0) / (sig * sig)
    const = (-0.5 * LN2PI - np.log(sig).astype(np.float64)).astype(np.float32)
    const, inv = (torch.as_tensor(a[:, None], device=time.device)
                  for a in (const, inv))
    return time, obs_dev, sig, n_draws // B, const, inv


def _launch_groups(B, n_chunks, chunk, grouped):
    """(targets, draws) slices of each step of a core over the padded
    (B * n_chunks * chunk,) draws: with ``grouped`` and one chunk per
    target, as many whole targets per step as ``DRAW_CAP`` holds (at least
    one); otherwise one chunk per step."""
    per = max(1, DRAW_CAP // chunk) if grouped and n_chunks == 1 else 1
    for p0 in range(0, B * n_chunks, per):
        p1 = min(p0 + per, B * n_chunks)
        b0 = p0 // n_chunks
        yield slice(b0, (p1 - 1) // n_chunks + 1), slice(p0 * chunk,
                                                          p1 * chunk)


def _core_steps(arrs, B, N, chunk, grouped):
    """The steps of a core over B targets' draws, each target's padded to
    whole chunks (``_pad_chunk``): per step its (targets, draws) slices
    (``_launch_groups``) and its slice of each of ``arrs``."""
    parts = [p.reshape((-1,) + tuple(p.shape[2:]))
             for p in _pad_chunk(arrs, N, chunk, B)]
    for tg, dr in _launch_groups(B, -(-N // chunk), chunk, grouped):
        yield tg, dr, [p[dr] for p in parts]


def _unpad(out, B, N):
    """The (B * N,) draws of a core's padded (B * n_chunks * chunk,)
    output."""
    return out.view(B, -1)[:, :N].reshape(-1)


def _chunk_chi2(time, exptime, obs_dev, kc, Pc, ac, ic, ec, wc, u1c, u2c,
                gc, n_t, ns, exact, backend):
    """chi^2 of one step's draws; time and obs_dev (B, n_t), B > 1 only
    on the fused path."""
    if backend == "auto" and not exact:
        return _chi2_fused(time, exptime, obs_dev, kc, Pc, ac, ic, ec, wc,
                           u1c, u2c, gc, n_t, ns)
    (time,), (obs_dev,) = time, obs_dev
    D = _mean_deficit(time, exptime, kc, Pc, ac, ic, ec, wc, u1c, u2c, n_t,
                      ns, exact)
    resid = obs_dev[None, :] + gc[:, None] * D
    return torch.sum(resid * resid, dim=1)


@profiling.span("tri.core.veto")
def _secondary_depth(sec_grid, P, a_R, inc, e, w, ksec, u1, u2, g_sec):
    """Diluted secondary-eclipse depth per draw: the deficit is monotone
    non-increasing in z, so the 25-point scan's maximum is one exact
    kernel evaluation at the minimum in-front z. The (25, C) scan is
    formed ORBIT_CHUNK_MAX draws at a time, so its memory stays that of
    one target's core whatever the step's size."""
    out = []
    for i in range(0, P.shape[0], ORBIT_CHUNK_MAX):
        s = slice(i, i + ORBIT_CHUNK_MAX)
        zs, fronts = projected_z(sec_grid[:, None], 0.0, P[None, s],
                                 a_R[None, s], inc[None, s], e[None, s],
                                 w[None, s] + math.pi)
        big = torch.full_like(zs, 1e30)
        z_eff = torch.min(torch.where(fronts, zs, big), dim=0).values
        has_front = torch.any(fronts, dim=0)
        D_eff = occult_quad_deficit(ksec[s], torch.clamp_max(z_eff, 1e30),
                                    u1[s], u2[s])
        out.append(g_sec[s] * torch.where(has_front, D_eff,
                                          torch.zeros_like(D_eff)))
    return torch.cat(out)


def _lnL(chi2, mask, const, inv):
    """lnL = const - 0.5 chi^2 / sigma^2 of one step, -inf where masked
    out; const and inv are the step's (B, 1) rows."""
    chi2 = chi2.view(const.shape[0], -1) * inv
    lnL = (const - 0.5 * chi2).view(-1)
    return torch.where(mask, lnL, torch.full_like(lnL, -math.inf))


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


def _grouped(time, exact, backend):
    """Whether a core's targets share launches: the orbit kernels on a CUDA
    tensor."""
    return backend == "auto" and not exact and time.device.type == "cuda"


def _core_chunk(chunk, N, time, n_t, ns, exact, backend):
    """The draw chunk a core runs: the caller's ``chunk`` if given, else
    ``orbit_chunk(N)`` where the orbit kernels run (a CUDA tensor under
    ``backend="auto"``, not ``exact``), which make no (chunk, n_t) tensor,
    and ``draw_chunk(n_t, ns)`` elsewhere, whose (chunk, n_t) tensors it
    bounds. Under ``backend="auto"`` it is rounded up to the kernel's draw
    multiple."""
    if chunk is None:
        chunk = (orbit_chunk(N) if _grouped(time, exact, backend)
                 else draw_chunk(n_t, ns))
    return _kernel_chunk(chunk) if backend == "auto" else chunk


def _check_backend(backend):
    if backend not in ("auto", "torch"):
        raise ValueError(f"backend must be 'auto' or 'torch', got {backend!r}")


@profiling.span("tri.core.lnL_planet")
def lnL_planet(time, obs_dev, sigma, k, P, a_R, inc, e, w, u1, u2, g, mask,
               *, exptime: float, n_t: int, ns: int,
               chunk: int | None = None, exact: bool = False,
               backend: str = "auto"):
    """Transiting-planet family log-likelihoods for N draws of one target,
    or N per target of B (module docstring).

    Returns lnL (B * N,) = -0.5 ln 2pi - ln sigma - 0.5 chi^2 for
    masked-in draws, -inf otherwise (reference
    marginal_likelihoods.py:117-137). ``chunk`` (draws per step and
    target) is picked by ``_core_chunk`` unless given."""
    _check_backend(backend)
    profiling.count("draws.core", k.shape[0])
    time, obs_dev, _, N, const, inv = _targets(time, obs_dev, sigma,
                                               k.shape[0])
    B = time.shape[0]
    chunk = _core_chunk(chunk, N, time, n_t, ns, exact, backend)
    out = torch.empty((B * -(-N // chunk) * chunk,), dtype=time.dtype,
                      device=time.device)
    for tg, dr, (kc, Pc, ac, ic, ec, wc, u1c, u2c, gc, mc) in _core_steps(
            [k, P, a_R, inc, e, w, u1, u2, g, mask], B, N, chunk,
            _grouped(time, exact, backend)):
        chi2 = _chunk_chi2(time[tg], exptime, obs_dev[tg], kc, Pc, ac, ic,
                           ec, wc, u1c, u2c, gc, n_t, ns, exact, backend)
        out[dr] = _lnL(chi2, mc, const[tg], inv[tg])
    return _unpad(out, B, N)


@profiling.span("tri.core.lnL_eb")
def lnL_eb(time, obs_dev, sigma, k, ksec, P, a_R, inc, e, w, u1, u2,
           g_pri, g_sec, mask, *, exptime: float, n_t: int, ns: int,
           chunk: int | None = None, apply_veto: bool = True,
           exact: bool = False, backend: str = "auto"):
    """Eclipsing-binary family log-likelihoods for N draws.

    k is the (quirk-adjusted) primary radius ratio, ksec the secondary
    one. With apply_veto, draws whose diluted secondary depth
    (``_secondary_depth``) is >= 1.5 sigma of their target are excluded
    (ref likelihoods.py:535-538); the twin branch passes
    apply_veto=False. Targets and ``chunk`` as in ``lnL_planet``."""
    _check_backend(backend)
    profiling.count("draws.core", k.shape[0])
    time, obs_dev, sig, N, const, inv = _targets(time, obs_dev, sigma,
                                                 k.shape[0])
    B = time.shape[0]
    veto = torch.as_tensor((np.float32(1.5) * sig)[:, None],
                           device=time.device)
    chunk = _core_chunk(chunk, N, time, n_t, ns, exact, backend)
    sec_grid = torch.as_tensor(SEC_GRID, dtype=time.dtype, device=time.device)
    out = torch.empty((B * -(-N // chunk) * chunk,), dtype=time.dtype,
                      device=time.device)
    for tg, dr, (kc, ksc, Pc, ac, ic, ec, wc, u1c, u2c, gpc, gsc,
                 mc) in _core_steps(
            [k, ksec, P, a_R, inc, e, w, u1, u2, g_pri, g_sec, mask], B, N,
            chunk, _grouped(time, exact, backend)):
        chi2 = _chunk_chi2(time[tg], exptime, obs_dev[tg], kc, Pc, ac, ic,
                           ec, wc, u1c, u2c, gpc, n_t, ns, exact, backend)
        if apply_veto:
            secdepth = _secondary_depth(sec_grid, Pc, ac, ic, ec, wc, ksc,
                                        u1c, u2c, gsc)
            mc = mc & (secdepth.view(veto[tg].shape[0], -1)
                       < veto[tg]).view(-1)
        out[dr] = _lnL(chi2, mc, const[tg], inv[tg])
    return _unpad(out, B, N)


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
