"""Fused exposure z^2 -> supersample -> Chebyshev deficit -> chi^2 for one
draw chunk.

Counterpart of the JAX package's ``ops/pallas_core.py::chi2_supersampled``
(the v2 schedule) and ``chi2_supersampled_v3`` (the time-major v3
schedule). Each schedule has two entry points over one hand-written kernel
in ``csrc/chi2_supersampled.cu`` (built with nvcc for sm_90a at first use
and loaded with ctypes), which differ in where the exposure z^2 model
comes from:

* ``chi2_supersampled`` / ``chi2_supersampled_v3`` read it from four
  (C, n_t) planes q0, q1, q2, front (the TPU kernels' contract);
* ``chi2_from_orbit`` / ``chi2_from_orbit_v3`` compute it inside the
  kernel from each draw's orbit and the exposure times, so no (C, n_t)
  tensor is made. They take B targets in one launch, the counterpart of
  ``jax.vmap`` over the Pallas call: time and obs_dev (B, n_t), the draws
  target-major, Cb = C / B per target, a multiple of the schedule's draw
  tile.

Each schedule has an orbit entry point that takes each draw's (k, u1,
u2) instead of its deficit coefficients and computes the coefficients
inside the kernel, as the JAX package's ``_chi2_pallas`` does in one call:
``chi2_from_orbit_tab`` (v2, the main path on the card:
``ops/lightcurve.py::_chi2_fused``) and ``chi2_from_orbit_v3_tab`` (v3)
the tabulated ones (``fastcore.cheb_deficit_coeffs_tab``) from a
shared-memory copy of the coefficient table; ``chi2_from_orbit_exact``
(v2, the route of ``TRICERATOPS_COEFFS=exact``) the exact ones
(``fastcore.cheb_deficit_coeffs``: the occultation deficit at 54 nodes
per draw, then a DCT). ``deficit_coeffs_tab`` and ``deficit_coeffs_exact``
run those in-kernel coefficient stages alone, to check them; no path
calls them. In the source every v2 entry point is one kernel body over a
coefficient stage (copy, tab or exact), and every v3 one another.

The orbit kernels skip the Kepler solve outside each draw's transit
window (``transit_window``, ``window_contains``, ``window_groups``: their
plain twins, for tests and bounds; no path calls them): the v3 ones at
every curve, the v2 ones (``chi2_from_orbit``, ``_tab``, ``_exact``) on
curves of at least ``V2_WINDOW_MIN_T`` exposures (``_exact``:
``V2_EXACT_WINDOW_MIN_T``), where they solve only the 32-point groups
that hold a point of the draw's window and give the same output bit for
bit. While the tracer of ``utils/profiling.py`` is on, those windowed
launches count on the card the (draw, group) pairs they walk and solve,
``window.groups`` and ``window.groups_solved``, folded into
``profiling.counters()`` when it is read.

On a CUDA tensor each launches its kernel; on a CPU tensor each runs its
plain torch version (``chi2_supersampled_plain``,
``chi2_from_orbit_plain``, ``chi2_from_orbit_tab_plain``,
``chi2_from_orbit_exact_plain``, ``fastcore.cheb_deficit_coeffs_tab``,
``fastcore.cheb_deficit_coeffs``). There is no fallback between them.

Each kernel launch (not a plain-path call) runs in the span
``tri.launch.<instance>`` and adds one to the counter
``launch.<instance>`` of ``utils/profiling.py``, the instance being the
entry point's name (``deficit_coeffs_tab`` / ``_exact`` for the
coefficient functions), so a run can show which kernel its main path went
through; ``build.chi2`` counts the library's nvcc builds.
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache
from pathlib import Path

import torch

from ..core.kepler import E_MAX, projected_z
from ..tables import dct_nodes, load_tables
from ..utils import profiling
from .fastcore import (
    M_CHEB, TAB_SEGMENTS, _BREAK_FLOOR, _BREAK_SLOPE, _TAB_BREAKS, _TAB_DEGS,
    cheb_deficit_coeffs, cheb_deficit_coeffs_tab, cheb_deficit_eval,
    exposure_z2_poly,
)
from .nvcc import build_library, library_file
from .occult import _N_GL_F32, _gl_tables

DRAW_TILE = 256     # v2: C % DRAW_TILE == 0
DRAW_LANES = 128    # v3: C % DRAW_LANES == 0
V2_GROUP = 32       # v2: points of one draw whose deficit is skipped at once
# v2: the fewest exposures at which the orbit kernels take their windowed
# instance, with the copy or tab stage and with the exact one
# (csrc/chi2_supersampled.cu keeps the same values), and its counters
V2_WINDOW_MIN_T = 256
V2_EXACT_WINDOW_MIN_T = 512
WINDOW_COUNTERS = ("window.groups", "window.groups_solved")
V3_DRAWS = 8        # draws a warp of the v3 kernels takes at once
MAX_NODES = 4

# The v3 kernels' transit-window margins (csrc/chi2_supersampled.cu,
# transit_window): a pad in mean anomaly (rad), a relative margin for
# float32 rounding of z^2, a per-point relative margin on |n t|, the
# shortest true-anomaly arc whose mean-anomaly arc is trusted, and the
# half width that stands for the whole orbit
WIN_PAD = 1e-4
WIN_REL = 1e-5
WIN_REL_M = 1e-6
WIN_MIN_ARC = 1e-3
WIN_WHOLE = 4.0

_SOURCES = ("chi2_supersampled.cu",)

_lib = None


class TabSegs(ctypes.Structure):
    """The coefficient table's k-segments as the tab stages read them
    (``csrc/chi2_supersampled.cu::TabSegs``)."""
    _fields_ = [("lo", ctypes.c_float * 8), ("shift", ctypes.c_float * 8),
                ("den", ctypes.c_float * 8), ("kind", ctypes.c_int * 8),
                ("deg", ctypes.c_int * 8), ("row0", ctypes.c_int * 8),
                ("kmin", ctypes.c_float), ("kmax", ctypes.c_float),
                ("slope", ctypes.c_float), ("floor", ctypes.c_float),
                ("n_rows", ctypes.c_int)]


@lru_cache(maxsize=None)
def _tab_segs():
    """The TabSegs of ``fastcore.TAB_SEGMENTS``: each Python float rounded
    to float32 (ctypes rounds to nearest, as torch rounds a Python float
    that meets a float32 tensor)."""
    degs = [int(d) for d in _TAB_DEGS]
    row0 = [sum(degs[:g]) for g in range(len(degs))]
    lo, _, kind, shift, den = zip(*TAB_SEGMENTS)
    return TabSegs(
        (ctypes.c_float * 8)(*lo), (ctypes.c_float * 8)(*shift),
        (ctypes.c_float * 8)(*den), (ctypes.c_int * 8)(*kind),
        (ctypes.c_int * 8)(*degs), (ctypes.c_int * 8)(*row0),
        float(_TAB_BREAKS[0]), float(_TAB_BREAKS[-1]), _BREAK_SLOPE,
        _BREAK_FLOOR, sum(degs))


class ExactConsts(ctypes.Structure):
    """The exact stage's constants (``csrc/chi2_supersampled.cu::
    ExactConsts``): the S-nodes, occult.py's float32 Gauss-Legendre rule
    and ``_segments``' break."""
    _fields_ = [("s_nodes", ctypes.c_float * M_CHEB),
                ("sin2t", ctypes.c_float * _N_GL_F32),
                ("wgt", ctypes.c_float * _N_GL_F32),
                ("slope", ctypes.c_float), ("floor", ctypes.c_float)]


@lru_cache(maxsize=None)
def _exact_consts():
    """The ExactConsts of ``tables.dct_nodes`` and ``occult._gl_tables``:
    each float64 rounded to float32 (ctypes rounds to nearest, as torch
    rounds the float64 arrays of ``load_tables`` and ``occult._gl``)."""
    sin2t, wgt = _gl_tables(_N_GL_F32)
    return ExactConsts((ctypes.c_float * M_CHEB)(*dct_nodes()[1]),
                       (ctypes.c_float * _N_GL_F32)(*sin2t),
                       (ctypes.c_float * _N_GL_F32)(*wgt), _BREAK_SLOPE,
                       _BREAK_FLOOR)


def library_path() -> Path:
    """Shared library path, keyed by a hash of the sources and flags so an
    edited ``.cu`` file is rebuilt."""
    return library_file("chi2", _SOURCES)


def build(verbose: bool = False) -> Path:
    """Compile the chi^2 kernel library if it is not built yet; returns its
    path (``build_library``, counted under ``build.chi2``)."""
    return build_library("chi2", _SOURCES, verbose)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        P, I = ctypes.c_void_p, ctypes.c_int
        tail = [I, I, P, P, I]   # C, n_t, offs, wgts, n_nodes
        # the orbit entry points: 13 arrays, tail, projected and Cb, then
        # the stage's constants (the tab and exact stages), the window
        # counters (v2) and the stream
        orbit = [P] * 13 + tail + [I, I]
        for name, types in {
                "chi2_supersampled_launch": [P] * 11 + tail + [P],
                "chi2_supersampled_v3_launch": [P] * 11 + tail + [P],
                "chi2_from_orbit_launch": orbit + [P, P],
                "chi2_from_orbit_v3_launch": orbit + [P],
                "chi2_from_orbit_tab_launch": orbit + [P, P, P],
                "chi2_from_orbit_exact_launch": orbit + [P, P, P],
                "chi2_from_orbit_v3_tab_launch": orbit + [P, P],
                "deficit_coeffs_tab_launch": [P] * 5 + [I, P, P],
                "deficit_coeffs_exact_launch": [P] * 5 + [I, P, P],
                "chi2_from_orbit_v2_info": [I] * 5 + [P],
                "chi2_from_orbit_v3_info": [I] * 4 + [P]}.items():
            fn = getattr(lib, name)
            fn.argtypes = types
            fn.restype = I
        _lib = lib
    return _lib


def _check_arrays(arrs, shapes, offs, wgts):
    """Shape, dtype, device and contiguity of each named tensor, and the
    node count."""
    first, ref = next(iter(arrs.items()))
    for name, a in arrs.items():
        if tuple(a.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, "
                             f"expected {shapes[name]}")
        if a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {a.dtype}")
        if a.device != ref.device:
            raise ValueError(f"{name} is on {a.device}, {first} on "
                             f"{ref.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not (1 <= len(offs) <= MAX_NODES) or len(offs) != len(wgts):
        raise ValueError(f"need 1..{MAX_NODES} offsets with one weight "
                         f"each, got {len(offs)} and {len(wgts)}")


def _coeff_shapes(C, n_t, B=1):
    return dict(cA=(C, M_CHEB), cB1=(C, M_CHEB), cB2=(C, M_CHEB),
                seg=(C, 5), g=(C, 1), obs_dev=(B, n_t))


def _check(q0, q1, q2, front, cA, cB1, cB2, seg, g, obs_dev, offs, wgts,
           tile):
    if q0.dim() != 2:
        raise ValueError(f"q0 must be (C, n_t), got {tuple(q0.shape)}")
    C, n_t = q0.shape
    if C % tile:
        raise ValueError(f"chunk {C} must be a multiple of {tile}")
    _check_arrays(dict(q0=q0, q1=q1, q2=q2, front=front, cA=cA, cB1=cB1,
                       cB2=cB2, seg=seg, g=g, obs_dev=obs_dev),
                  dict(q0=(C, n_t), q1=(C, n_t), q2=(C, n_t),
                       front=(C, n_t), **_coeff_shapes(C, n_t)), offs, wgts)


def _orbit_layout(time, P, tile):
    """(C, n_t, B, Cb) of an orbit entry point's draws: time (n_t,) is one
    target, time (B, n_t) B targets of Cb = C / B draws, a multiple of
    ``tile``."""
    if time.dim() not in (1, 2) or P.dim() != 1:
        raise ValueError(f"time must be (n_t,) or (B, n_t) and P 1-d, got "
                         f"{tuple(time.shape)} and {tuple(P.shape)}")
    B = time.shape[0] if time.dim() == 2 else 1
    n_t, C = time.shape[-1], P.shape[0]
    if B < 1 or C % B:
        raise ValueError(f"{C} draws are not B x Cb for B = {B} targets")
    Cb = C // B
    if Cb % tile:
        raise ValueError(f"draws per target {Cb} (chunk {C}, B = {B}) must "
                         f"be a multiple of {tile}")
    return C, n_t, B, Cb


def _check_ns(ns, offs, wgts):
    if ns < 1 or (ns == 1 and (offs, wgts) != ((0.0,), (1.0,))):
        raise ValueError(f"ns = {ns}: ns = 1 takes the one node offs = (0,), "
                         f"wgts = (1,), got {offs} and {wgts}")


def _check_orbit(time, P, a_R, inc, e, w, cA, cB1, cB2, seg, g, obs_dev,
                 offs, wgts, ns, tile):
    """The orbit entry points' checks; returns Cb, the draws per target.
    time (n_t,) is one target, time (B, n_t) B targets."""
    C, n_t, B, Cb = _orbit_layout(time, P, tile)
    _check_arrays(dict(time=time, P=P, a_R=a_R, inc=inc, e=e, w=w, cA=cA,
                       cB1=cB1, cB2=cB2, seg=seg, g=g, obs_dev=obs_dev),
                  dict(time=tuple(time.shape), P=(C,), a_R=(C,), inc=(C,),
                       e=(C,), w=(C,), **_coeff_shapes(C, n_t, B)), offs,
                  wgts)
    _check_ns(ns, offs, wgts)
    return Cb


_TAB_DRAW_ARGS = ("P", "a_R", "inc", "e", "w", "k", "u1", "u2", "g")


def _check_orbit_tab(time, P, a_R, inc, e, w, k, u1, u2, g, obs_dev, offs,
                     wgts, ns, tile):
    """The checks of the entry points that compute the coefficients in the
    kernel (``chi2_from_orbit_tab``, ``_v3_tab``, ``_exact``): those of
    ``_check_orbit`` with (k, u1, u2, g) (C,) in place of the
    coefficients; returns Cb."""
    C, n_t, B, Cb = _orbit_layout(time, P, tile)
    draws = (P, a_R, inc, e, w, k, u1, u2, g)
    _check_arrays(dict(time=time, **dict(zip(_TAB_DRAW_ARGS, draws)),
                       obs_dev=obs_dev),
                  dict(time=tuple(time.shape),
                       **{n: (C,) for n in _TAB_DRAW_ARGS},
                       obs_dev=(B, n_t)), offs, wgts)
    _check_ns(ns, offs, wgts)
    return Cb


def chi2_supersampled_plain(q0, q1, q2, front, cA, cB1, cB2, seg, g,
                            obs_dev, *, offs, wgts, group=None):
    """Plain torch version of both kernels (any device): the same function
    as ``chi2_supersampled`` and ``chi2_supersampled_v3``, on draw-major
    inputs. By default it evaluates every point, as the JAX package's XLA
    path does; the kernels skip groups of points that are out of transit
    (v2: ``V2_GROUP`` time points of one draw; v3: a time step of 8
    draws), which drops the deficit series' residue at z >= zmax there
    (tabulated series ~3e-9, exact float32 series up to ~6e-6). With
    ``group``, a point counts only if some point of its run of ``group``
    consecutive points of the draw (runs start at t = 0) is in front with
    z^2 < zmax^2 at a node: the v2 kernels' skip rule at ``group =
    V2_GROUP``."""
    coeffs = (cA, cB1, cB2, *seg.unbind(1))
    Dbar = torch.zeros_like(q0)
    seen = None
    if group is not None:
        zmax = seg[:, 1:2] + 1.0 / seg[:, 4:5]
        zmax2 = zmax * zmax
        seen = torch.zeros(q0.shape, dtype=torch.bool, device=q0.device)
    for d, wt in zip(offs, wgts):
        z2 = q0 + q1 * d + q2 * (d * d)
        if seen is not None:
            seen |= z2 < zmax2
        z = torch.sqrt(torch.clamp_min(z2, 0.0))
        Dbar = Dbar + wt * cheb_deficit_eval(coeffs, z)
    gD = g * (Dbar * front)
    delta = gD * (2.0 * obs_dev + gD)
    if seen is not None:
        C, n_t = q0.shape
        seen &= front > 0.0
        runs = torch.nn.functional.pad(seen, (0, -n_t % group)).view(
            C, -1, group).any(dim=2)
        delta = delta * runs.repeat_interleave(group, dim=1)[:, :n_t]
    return torch.sum(delta, dim=1) + torch.sum(obs_dev * obs_dev)


def _launch(name, arrays, C, n_t, offs, wgts, *flags):
    """Launch one kernel of the library on the current stream: the device
    pointers of ``arrays`` and the output, then C, n_t, the nodes and
    ``flags``; raises if the launch is refused. Counts ``launch.<name>``."""
    lib = _load()
    with profiling.span(f"tri.launch.{name}"):
        out = torch.empty((C,), dtype=torch.float32,
                          device=arrays[0].device)
        offs_h = (ctypes.c_float * len(offs))(*offs)
        wgts_h = (ctypes.c_float * len(wgts))(*wgts)
        with torch.cuda.device(out.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = getattr(lib, f"{name}_launch")(
                *(a.data_ptr() for a in arrays), out.data_ptr(), C, n_t,
                ctypes.addressof(offs_h), ctypes.addressof(wgts_h),
                len(offs), *flags, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    profiling.count(f"launch.{name}")
    return out


def _window_counts(device):
    """The device address a windowed v2 orbit launch adds its window
    counters to (``WINDOW_COUNTERS``, kept by the tracer), or None (null:
    not counted) while tracing is off. An unwindowed launch does not read
    it."""
    if not profiling.enabled():
        return None
    return profiling.device_counters(WINDOW_COUNTERS, device).data_ptr()


def _nodes(offs, wgts):
    return tuple(float(o) for o in offs), tuple(float(w) for w in wgts)


def _device_path(q0):
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (the plain version); any other device raises."""
    if q0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no chi2 kernel for device {q0.device}")
    return q0.device.type == "cuda"


def chi2_supersampled(q0, q1, q2, front, cA, cB1, cB2, seg, g, obs_dev, *,
                      offs, wgts):
    """chi^2 (unnormalized by sigma) for one draw chunk, v2 schedule.

    Args (all float32, contiguous, on one device):
        q0, q1, q2: (C, n_t) per-exposure quadratic z^2 model.
        front: (C, n_t) visibility gate (0/1).
        cA, cB1, cB2: (C, 18) Chebyshev deficit coefficients per segment.
        seg: (C, 5) [zsplit, zmid, invA, invB1, invB2].
        g: (C, 1) dilution multiplier.
        obs_dev: (1, n_t) observed flux - 1.
        offs, wgts: exposure quadrature nodes and weights (1 to 4 floats).
    Returns:
        (C,) sum of squared residuals (divide by sigma^2 outside).
    C must be a multiple of 256. A CPU tensor runs the plain version; a
    CUDA tensor launches the kernel.
    """
    offs, wgts = _nodes(offs, wgts)
    _check(q0, q1, q2, front, cA, cB1, cB2, seg, g, obs_dev, offs, wgts,
           DRAW_TILE)
    if not _device_path(q0):
        return chi2_supersampled_plain(q0, q1, q2, front, cA, cB1, cB2, seg,
                                       g, obs_dev, offs=offs, wgts=wgts)
    return _launch("chi2_supersampled", (q0, q1, q2, front, cA, cB1, cB2,
                                         seg, g, obs_dev), *q0.shape, offs,
                   wgts)


def time_major(q0, q1, q2, front):
    """The four (C, n_t) planes as contiguous time-major (n_t, C) tensors,
    the layout the v3 kernel reads."""
    return tuple(p.t().contiguous() for p in (q0, q1, q2, front))


def launch_v3(planes_t, cA, cB1, cB2, seg, g, obs_dev, *, offs, wgts):
    """Launch the v3 kernel on time-major planes (``time_major``); CUDA
    tensors already checked by ``chi2_supersampled_v3``."""
    offs, wgts = _nodes(offs, wgts)
    n_t, C = planes_t[0].shape
    return _launch("chi2_supersampled_v3",
                   (*planes_t, cA, cB1, cB2, seg, g, obs_dev), C, n_t, offs,
                   wgts)


def chi2_supersampled_v3(q0, q1, q2, front, cA, cB1, cB2, seg, g, obs_dev,
                         *, offs, wgts):
    """chi^2 for one draw chunk, v3 schedule: the same arguments, checks
    and result as ``chi2_supersampled``, with C a multiple of 128. On a
    CUDA tensor the four planes are transposed to time-major here and the
    time-major kernel is launched; a CPU tensor runs the plain version."""
    offs, wgts = _nodes(offs, wgts)
    _check(q0, q1, q2, front, cA, cB1, cB2, seg, g, obs_dev, offs, wgts,
           DRAW_LANES)
    if not _device_path(q0):
        return chi2_supersampled_plain(q0, q1, q2, front, cA, cB1, cB2, seg,
                                       g, obs_dev, offs=offs, wgts=wgts)
    return launch_v3(time_major(q0, q1, q2, front), cA, cB1, cB2, seg, g,
                     obs_dev, offs=offs, wgts=wgts)


def orbit_planes(time, P, a_R, inc, e, w, ns):
    """The exposure z^2 model as four contiguous (C, n_t) planes (q0, q1,
    q2, front as float32), as the orbit kernels compute it per point:
    ``exposure_z2_poly`` for ns > 1, ``projected_z`` (q0 = z^2, q1 = q2 =
    0) for ns = 1."""
    if ns > 1:
        q0, q1, q2, front = exposure_z2_poly(time, 0.0, P, a_R, inc, e, w)
    else:
        z, front = projected_z(time[None, :], 0.0, P[:, None], a_R[:, None],
                               inc[:, None], e[:, None], w[:, None])
        q0 = z * z
        q1 = torch.zeros_like(q0)
        q2 = torch.zeros_like(q0)
    return (q0.contiguous(), q1.contiguous(), q2.contiguous(),
            front.to(q0.dtype))


def chi2_from_orbit_plain(time, P, a_R, inc, e, w, cA, cB1, cB2, seg, g,
                          obs_dev, *, offs, wgts, ns, group=None):
    """Plain torch version of both orbit kernels (any device): the planes of
    ``orbit_planes``, then ``chi2_supersampled_plain`` (with its
    ``group``). With time (B, n_t) the draws are target-major, Cb = C / B
    per target, and each target's draws run on its own rows of time and
    obs_dev."""
    if time.dim() == 1:
        return chi2_supersampled_plain(
            *orbit_planes(time, P, a_R, inc, e, w, ns), cA, cB1, cB2, seg, g,
            obs_dev, offs=offs, wgts=wgts, group=group)
    Cb = P.shape[0] // time.shape[0]
    draws = (P, a_R, inc, e, w, cA, cB1, cB2, seg, g)
    return torch.cat([
        chi2_from_orbit_plain(time[b], *(x[b * Cb:(b + 1) * Cb]
                                         for x in draws),
                              obs_dev[b:b + 1], offs=offs, wgts=wgts, ns=ns,
                              group=group)
        for b in range(time.shape[0])])


def chi2_from_orbit(time, P, a_R, inc, e, w, cA, cB1, cB2, seg, g, obs_dev,
                    *, offs, wgts, ns):
    """chi^2 (unnormalized by sigma) for one draw chunk, v2 schedule, with
    the exposure z^2 model computed inside the kernel.

    Args (all float32, contiguous, on one device):
        time: (n_t,) exposure centres of one target, or (B, n_t) of B.
        P, a_R, inc, e, w: (C,) each draw's orbit (transit epoch 0); with
            B targets target-major, Cb = C / B draws each.
        cA, cB1, cB2, seg, g: as ``chi2_supersampled``.
        obs_dev: (B, n_t) observed flux - 1 ((1, n_t) for one target).
        offs, wgts: exposure quadrature nodes and weights (1 to 4 floats).
        ns: supersamples per exposure; ns > 1 takes the Taylor z^2 model
            (``exposure_z2_poly``) at the nodes, ns = 1 the exact
            ``projected_z`` at the one node offs = (0,), wgts = (1,).
    Returns:
        (C,) sum of squared residuals (divide by sigma^2 outside).
    Cb must be a multiple of 256. A CPU tensor runs the plain version; a
    CUDA tensor launches the kernel, once for all B targets.
    """
    offs, wgts = _nodes(offs, wgts)
    args = (time, P, a_R, inc, e, w, cA, cB1, cB2, seg, g, obs_dev)
    Cb = _check_orbit(*args, offs, wgts, ns, DRAW_TILE)
    if not _device_path(P):
        return chi2_from_orbit_plain(*args, offs=offs, wgts=wgts, ns=ns)
    return _launch("chi2_from_orbit", args, P.shape[0], time.shape[-1],
                   offs, wgts, int(ns == 1), Cb, _window_counts(P.device))


def chi2_from_orbit_v3(time, P, a_R, inc, e, w, cA, cB1, cB2, seg, g,
                       obs_dev, *, offs, wgts, ns):
    """chi^2 for one draw chunk, v3 schedule (draws on lanes): the same
    arguments, checks and result as ``chi2_from_orbit``, with Cb a multiple
    of 128; the kernel skips the solve outside each draw's transit window,
    as ``chi2_from_orbit_v3_tab`` does."""
    offs, wgts = _nodes(offs, wgts)
    args = (time, P, a_R, inc, e, w, cA, cB1, cB2, seg, g, obs_dev)
    Cb = _check_orbit(*args, offs, wgts, ns, DRAW_LANES)
    if not _device_path(P):
        return chi2_from_orbit_plain(*args, offs=offs, wgts=wgts, ns=ns)
    return _launch("chi2_from_orbit_v3", args, P.shape[0], time.shape[-1],
                   offs, wgts, int(ns == 1), Cb)


def _device_table(device, name="tab_C"):
    """A float32 table of ``load_tables`` on ``device``, as a kernel's
    stage copies it into shared memory: contiguous and 16-byte aligned.
    "tab_C": the (sum_degs, 162) coefficient table of the tab stages;
    "dct_T": the (18, 18) DCT of the exact stage."""
    tab = load_tables(device, torch.float32)[name]
    if not tab.is_contiguous() or tab.data_ptr() % 16:
        raise ValueError(f"the table {name} must be contiguous and 16-byte "
                         "aligned")
    return tab


# Each in-kernel coefficient stage: its coefficient function (the plain
# version), the table it copies into shared memory and its constants
_STAGES = {"tab": (cheb_deficit_coeffs_tab, "tab_C", _tab_segs),
           "exact": (cheb_deficit_coeffs, "dct_T", _exact_consts)}


def _orbit_plain_from(stage, time, P, a_R, inc, e, w, k, u1, u2, g, obs_dev,
                      *, offs, wgts, ns, group=None):
    """The coefficients of ``stage``'s coefficient function, then
    ``chi2_from_orbit_plain``."""
    cA, cB1, cB2, *segs = _STAGES[stage][0](k, u1, u2)
    return chi2_from_orbit_plain(
        time, P, a_R, inc, e, w, cA.contiguous(), cB1.contiguous(),
        cB2.contiguous(), torch.stack(segs, 1), g[:, None], obs_dev,
        offs=offs, wgts=wgts, ns=ns, group=group)


def chi2_from_orbit_tab_plain(time, P, a_R, inc, e, w, k, u1, u2, g,
                              obs_dev, *, offs, wgts, ns, group=None):
    """Plain torch version of the tab kernels (any device): the tabulated
    coefficients of ``fastcore.cheb_deficit_coeffs_tab``, then
    ``chi2_from_orbit_plain`` (``group = V2_GROUP``: the v2 kernels' skip
    rule)."""
    return _orbit_plain_from("tab", time, P, a_R, inc, e, w, k, u1, u2, g,
                             obs_dev, offs=offs, wgts=wgts, ns=ns,
                             group=group)


def chi2_from_orbit_exact_plain(time, P, a_R, inc, e, w, k, u1, u2, g,
                                obs_dev, *, offs, wgts, ns, group=None):
    """Plain torch version of the exact kernel (any device): the exact
    coefficients of ``fastcore.cheb_deficit_coeffs``, then
    ``chi2_from_orbit_plain``; ``group = V2_GROUP`` gives the kernel's skip
    rule, which drops the exact float32 series' residue beyond zmax (up to
    ~6e-6) at the groups it skips (``chi2_supersampled_plain``)."""
    return _orbit_plain_from("exact", time, P, a_R, inc, e, w, k, u1, u2, g,
                             obs_dev, offs=offs, wgts=wgts, ns=ns,
                             group=group)


def chi2_from_orbit_tab(time, P, a_R, inc, e, w, k, u1, u2, g, obs_dev, *,
                        offs, wgts, ns):
    """chi^2 (unnormalized by sigma) for one draw chunk, v2 schedule, with
    the exposure z^2 model and the tabulated deficit coefficients
    (``fastcore.cheb_deficit_coeffs_tab``) computed inside the kernel.

    Args (all float32, contiguous, on one device): as ``chi2_from_orbit``,
    with each draw's radius ratio and limb darkening k, u1, u2 (C,) in
    place of cA, cB1, cB2 and seg, and g (C,).
    Returns:
        (C,) sum of squared residuals (divide by sigma^2 outside).
    Cb must be a multiple of 256. A CPU tensor runs the plain version; a
    CUDA tensor launches the kernel, once for all B targets, and a draw's
    result is the same whatever else the launch holds. The kernel skips
    the deficit in each 32-point group of a draw with no point in transit
    and, from ``V2_WINDOW_MIN_T`` exposures on, the Kepler solve and z^2
    model too in each group with no point inside the draw's transit
    window (``window_groups``); a skipped group adds obs^2 alone, and the
    output is the same bit for bit with or without the window. On a curve
    sorted by time, as folded curves are, a long curve's groups mostly
    fall outside the window.
    """
    offs, wgts = _nodes(offs, wgts)
    args = (time, P, a_R, inc, e, w, k, u1, u2, g, obs_dev)
    Cb = _check_orbit_tab(*args, offs, wgts, ns, DRAW_TILE)
    if not _device_path(P):
        return chi2_from_orbit_tab_plain(*args, offs=offs, wgts=wgts, ns=ns)
    return _launch_kud("chi2_from_orbit_tab", "tab", args, offs, wgts, ns, Cb)


def chi2_from_orbit_exact(time, P, a_R, inc, e, w, k, u1, u2, g, obs_dev,
                          *, offs, wgts, ns):
    """chi^2 (unnormalized by sigma) for one draw chunk, v2 schedule, with
    the exposure z^2 model and the exact deficit coefficients
    (``fastcore.cheb_deficit_coeffs``: the deficit of
    ``occult.occult_quad_deficit`` at each draw's 3 x 18 Chebyshev nodes,
    then the DCT) computed inside the kernel.

    Args, checks and result as ``chi2_from_orbit_tab``. A CPU tensor runs
    the plain version (``chi2_from_orbit_exact_plain``); a CUDA tensor
    launches the kernel, once for all B targets, and a draw's result is
    the same whatever else the launch holds. The kernel skips as the tab
    kernel does, the Kepler solve outside the transit window from
    ``V2_EXACT_WINDOW_MIN_T`` exposures on (its coefficient stage is most
    of a draw's work on a shorter curve).
    """
    offs, wgts = _nodes(offs, wgts)
    args = (time, P, a_R, inc, e, w, k, u1, u2, g, obs_dev)
    Cb = _check_orbit_tab(*args, offs, wgts, ns, DRAW_TILE)
    if not _device_path(P):
        return chi2_from_orbit_exact_plain(*args, offs=offs, wgts=wgts,
                                           ns=ns)
    return _launch_kud("chi2_from_orbit_exact", "exact", args, offs, wgts, ns,
                       Cb)


def _launch_kud(name, stage, args, offs, wgts, ns, Cb):
    """Launch an entry point that computes ``stage``'s coefficients in the
    kernel, on checked CUDA tensors ``args`` (those of
    ``chi2_from_orbit_tab``), with the stage's table on the device and its
    constants, and for a v2 one the window counters."""
    time, P = args[0], args[1]
    _, table, consts = _STAGES[stage]
    consts = consts()
    v2 = () if name == "chi2_from_orbit_v3_tab" else (
        _window_counts(P.device),)
    return _launch(name, (*args, _device_table(P.device, table)), P.shape[0],
                   time.shape[-1], offs, wgts, int(ns == 1), Cb,
                   ctypes.addressof(consts), *v2)


def chi2_from_orbit_v3_tab(time, P, a_R, inc, e, w, k, u1, u2, g, obs_dev,
                           *, offs, wgts, ns):
    """chi^2 for one draw chunk, v3 schedule (draws on lanes), with the
    exposure z^2 model and the tabulated deficit coefficients computed
    inside the kernel: the arguments, checks and result of
    ``chi2_from_orbit_tab``, with Cb a multiple of 128. The kernel solves
    Kepler only at the exposures some draw of a warp may transit
    (``transit_window``); the rest add nothing but obs^2, as a skipped
    point of the v2 kernels does. A CPU tensor runs the plain version
    (``chi2_from_orbit_tab_plain``)."""
    offs, wgts = _nodes(offs, wgts)
    args = (time, P, a_R, inc, e, w, k, u1, u2, g, obs_dev)
    Cb = _check_orbit_tab(*args, offs, wgts, ns, DRAW_LANES)
    if not _device_path(P):
        return chi2_from_orbit_tab_plain(*args, offs=offs, wgts=wgts, ns=ns)
    return _launch_kud("chi2_from_orbit_v3_tab", "tab", args, offs, wgts, ns,
                       Cb)


def _ecc_anomaly(f, sm, sp):
    """E of true anomaly f (``kepler.mean_anomaly_at_transit``'s map)."""
    return 2.0 * torch.atan2(sm * torch.sin(f / 2.0), sp * torch.cos(f / 2.0))


def _mean_arc(E1, E2, e):
    """The mean anomaly swept going forward from E1 to E2."""
    dE = E2 - E1
    dE = dE - (2.0 * math.pi) * torch.floor(dE * (1.0 / (2.0 * math.pi)))
    return dE - e * (torch.sin(E2) - torch.sin(E1))


def transit_window(P, a_R, inc, e, w, zmax, offs):
    """Plain version of the v3 kernels' per-draw transit window
    (``csrc/chi2_supersampled.cu::transit_window``): (mid, half), each
    (C,), such that an exposure centred at t can have a node in front of
    the star with model z^2 < zmax^2 only if ``window_contains`` holds,
    i.e. n t (n = 2 pi / P), wrapped to within pi of mid, lies within half
    of mid; half < 0 never, half >= WIN_WHOLE the whole orbit. ``offs``
    are the exposure nodes' offsets (days) from the centre.

    z^2 = r^2 (cos^2 u + cos^2 i sin^2 u), u = w + f, r >= a_R (1 - e), so
    z < zeff needs u within th of pi/2 (or of 3pi/2, behind the star).
    zeff^2 is zmax^2 plus the most the quadratic z^2 model can undershoot
    z^2 at a node (|d|^3 / 6 times a bound on |d^3 z^2 / dt^3| from the
    orbit's speed, acceleration and jerk) and float32 margins. The ends of
    the arc map to mean anomaly through E(f), padded by the nodes' spread
    n max|d|; a centre in front whose nodes could reach the u = 3pi/2
    branch makes the window the whole orbit."""
    e = torch.clamp(e, 0.0, E_MAX)
    n = (1.0 / P) * (2.0 * math.pi)
    si, ci = torch.sin(inc), torch.cos(inc)
    S, C = si * si, ci * ci
    dmax = max(abs(float(o)) for o in offs)
    ome, ope = 1.0 - e, 1.0 + e
    rmin, rmax = a_R * ome, a_R * ope
    V = a_R * n * torch.sqrt(ope / ome)
    A = a_R * n * n / (ome * ome)
    J = 4.0 * n * n * V / (ome * ome * ome)
    T = (dmax ** 3 / 6.0 * (2.0 * rmax * J + 6.0 * V * A)
         + WIN_REL * (rmax * rmax + 2.0 * rmax * V * dmax
                      + (V * V + rmax * A) * dmax ** 2))
    zeff2 = (zmax * zmax + T) * (1.0 + WIN_REL)
    x = zeff2 / (rmin * rmin) - C
    th = torch.asin(torch.sqrt(torch.clamp(x / S, 0.0, 1.0)))
    spread = n * dmax + WIN_PAD
    sm, sp = torch.sqrt(ome), torch.sqrt(ope)
    fc = math.pi / 2.0 - w
    Ec = _ecc_anomaly(fc, sm, sp)
    a = _mean_arc(_ecc_anomaly(fc - th, sm, sp), Ec, e)
    b = _mean_arc(Ec, _ecc_anomaly(fc + th, sm, sp), e)
    fs = 1.5 * math.pi - w
    gap = torch.minimum(
        _mean_arc(_ecc_anomaly(math.pi - w, sm, sp),
                  _ecc_anomaly(fs - th, sm, sp), e),
        _mean_arc(_ecc_anomaly(fs + th, sm, sp), _ecc_anomaly(-w, sm, sp), e))
    whole = ~(math.pi / 2.0 - th > WIN_MIN_ARC) | ~(gap > spread) | ~(
        a + b + 2.0 * spread < 2.0 * math.pi)
    half = torch.where(whole, torch.full_like(a, WIN_WHOLE),
                       0.5 * (a + b) + spread)
    half = torch.where(x > 0.0, half, torch.full_like(half, -1.0))
    mid = torch.where((x > 0.0) & ~whole, 0.5 * (b - a),
                      torch.zeros_like(a))
    return mid, half


def window_contains(time, P, mid, half):
    """(C, n_t) bool: which exposure centres ``time`` (n_t,) lie in each
    draw's window (mid, half of ``transit_window``), as the orbit kernels
    test them before solving Kepler."""
    n = ((1.0 / P) * (2.0 * math.pi))[:, None]
    x = n * time[None, :]
    y = x - mid[:, None]
    yw = y - (2.0 * math.pi) * torch.round(y * (1.0 / (2.0 * math.pi)))
    return (half[:, None] >= WIN_WHOLE) | (
        torch.abs(yw) <= half[:, None] + WIN_REL_M * torch.abs(x))


def window_groups(time, P, mid, half):
    """(C, ceil(n_t / V2_GROUP)) bool: the windowed v2 kernels' vote, which
    of each draw's runs of ``V2_GROUP`` consecutive exposures (runs start
    at the first exposure) hold a centre inside the draw's window
    (``window_contains``) and so run the Kepler solve."""
    inside = window_contains(time, P, mid, half)
    n_t = inside.shape[1]
    return torch.nn.functional.pad(inside, (0, -n_t % V2_GROUP)).view(
        inside.shape[0], -1, V2_GROUP).any(dim=2)


def _coeffs_launch(stage, k, u1, u2):
    """``stage``'s in-kernel coefficient function over the CUDA draws (k,
    u1, u2) (``deficit_coeffs_<stage>_launch``): the outputs of
    ``fastcore.cheb_deficit_coeffs``."""
    lib = _load()
    C = k.shape[0]
    name = f"deficit_coeffs_{stage}"
    _, table, consts = _STAGES[stage]
    consts = consts()
    with profiling.span(f"tri.launch.{name}"):
        out = torch.empty((C, 3 * M_CHEB + 5), dtype=torch.float32,
                          device=k.device)
        with torch.cuda.device(k.device):
            err = getattr(lib, f"{name}_launch")(
                k.data_ptr(), u1.data_ptr(), u2.data_ptr(),
                _device_table(k.device, table).data_ptr(), out.data_ptr(), C,
                ctypes.addressof(consts),
                torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    profiling.count(f"launch.{name}")
    m = M_CHEB
    return (out[:, :m], out[:, m:2 * m], out[:, 2 * m:3 * m],
            *out[:, 3 * m:].unbind(1))


def _check_kud(k, u1, u2):
    if k.dim() != 1 or k.shape[0] < 1:
        raise ValueError(f"k must be (C,) with C >= 1, got {tuple(k.shape)}")
    C = k.shape[0]
    _check_arrays(dict(k=k, u1=u1, u2=u2), dict(k=(C,), u1=(C,), u2=(C,)),
                  (0.0,), (1.0,))


def deficit_coeffs_tab(k, u1, u2):
    """``fastcore.cheb_deficit_coeffs_tab`` (same arguments and outputs) as
    ``chi2_from_orbit_tab`` computes it: on a CUDA tensor the kernel's own
    coefficient function over the draws (``deficit_coeffs_tab_launch``),
    on a CPU tensor the torch version. For checking the in-kernel
    coefficients; no path calls it."""
    _check_kud(k, u1, u2)
    if not _device_path(k):
        return cheb_deficit_coeffs_tab(k, u1, u2)
    return _coeffs_launch("tab", k, u1, u2)


def deficit_coeffs_exact(k, u1, u2):
    """``fastcore.cheb_deficit_coeffs`` on float32 draws (same arguments
    and outputs) as ``chi2_from_orbit_exact`` computes it: on a CUDA tensor
    the kernel's own coefficient function over the draws
    (``deficit_coeffs_exact_launch``), on a CPU tensor the torch version.
    For checking the in-kernel coefficients; no path calls it."""
    _check_kud(k, u1, u2)
    if not _device_path(k):
        return cheb_deficit_coeffs(k, u1, u2)
    return _coeffs_launch("exact", k, u1, u2)


def _info(fn_name, args, device):
    """A kernel-info entry point's six numbers as a dict."""
    out = (ctypes.c_int * 6)()
    with torch.cuda.device(torch.device(device)):
        err = getattr(_load(), fn_name)(*args, out)
    if err != 0:
        raise RuntimeError(f"{fn_name} failed: cudaError {err}")
    regs, local, blocks, threads, smem, sms = out
    return dict(registers=regs, local_bytes=local, blocks_per_sm=blocks,
                warps_per_sm=blocks * threads // 32, threads=threads,
                smem_bytes=smem, sms=sms)


V2_STAGES = ("copy", "tab", "exact")   # chi2_from_orbit_v2_info's codes


def v2_kernel_info(stage, ns, n_nodes, n_t=1, device="cuda"):
    """What the compiler and the occupancy calculator give the v2 orbit
    kernel's instance with coefficient stage ``stage`` ("copy":
    ``chi2_from_orbit``, "tab": ``chi2_from_orbit_tab``, "exact":
    ``chi2_from_orbit_exact``) for ``ns`` and ``n_nodes`` on ``device``,
    the one a launch over ``n_t`` exposures runs (windowed from
    ``V2_WINDOW_MIN_T``, or for "exact" ``V2_EXACT_WINDOW_MIN_T``, on):
    registers and local memory bytes (spills) a thread, resident blocks
    and warps per SM, threads and dynamic shared memory bytes a block, and
    the SMs."""
    return _info("chi2_from_orbit_v2_info",
                 (V2_STAGES.index(stage), n_nodes, int(ns == 1),
                  _tab_segs().n_rows, n_t), device)


def tab_kernel_info(ns, n_nodes, n_t=1, device="cuda"):
    """``v2_kernel_info`` of the tab instance."""
    return v2_kernel_info("tab", ns, n_nodes, n_t, device)


def exact_kernel_info(ns, n_nodes, n_t=1, device="cuda"):
    """``v2_kernel_info`` of the exact instance."""
    return v2_kernel_info("exact", ns, n_nodes, n_t, device)


def v3_kernel_info(ns, n_nodes, tab=True, device="cuda"):
    """``v2_kernel_info`` for the v3 orbit kernel's instance (the tab
    stage, or with ``tab=False`` the copy one of ``chi2_from_orbit_v3``)."""
    return _info("chi2_from_orbit_v3_info",
                 (n_nodes, int(ns == 1), int(tab), _tab_segs().n_rows),
                 device)
