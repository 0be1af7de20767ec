"""Fused scenario samplers on the card: one launch per sampler branch.

``csrc/samplers.cu`` (built by ``ops/nvcc.py`` for sm_90a at first use,
into ``_build/``, as the chi^2 kernels are, and loaded with ctypes;
``build.samplers`` counts the builds) turns one branch's uniform
streams into every per-draw field the branch returns: ``launch("planet",
...)`` a planet branch (TP / NTP, PTP, STP, DTP, BTP), ``launch("eb", ...)``
an EB normal branch with, when asked, its shared-draw twin, and
``launch("twin", ...)`` a conditioned twin draw set. The star letter says
where the host comes from (the kernel's compile-time policy): ``T`` the
target, ``P`` the target with a bound companion diluting it, ``S`` the
bound companion, ``D`` the target with a drawn TRILEGAL row diluting it,
``B`` the drawn row.

``scenarios/engine.py`` calls it for a CUDA generator; a CPU generator
takes the plain torch chain there, which is the kernels' plain version (the
card tests hold every field to it bit for bit). ``launch`` checks device,
dtype, shape and contiguity before it loads the library and raises on what
the kernel does not take; there is no fallback. Each launch adds one to
the counter ``launch.sampler.<entry>`` of ``utils/profiling.py``; it opens
no span of its own, so its device event falls in the sampler's
``tri.sample.<name>`` (``tri.launch.*`` is the chi^2 kernels').

Host scalars go to the kernel by value, rounded to float32 as
``engine._scalars`` rounds them (``by_value``); the kernel writes them back
to a small device tensor, whose 0-d views stand in for ``_scalars``'
tensors in the priors that run on the kernel's fields, so no scalar is
uploaded. Every constant the plain chain forms in Python doubles reaches
the kernel rounded as torch rounds a Python scalar that meets a float32
tensor (``Consts``).
"""

from __future__ import annotations

import ctypes
import math
from functools import lru_cache

import numpy as np
import torch

from ..constants import G, MSUN, PI, REARTH, RSUN
from ..populations.packs import BG_PACK_FIELDS
from ..priors.samplers import _broken3_constants, _q_cdf95_3seg
from ..tables import BETA_A, BETA_B, BETA_USPLIT, beta_ppf_cheb, load_tables
from ..utils import profiling
from .nvcc import build_library

_SOURCES = ("samplers.cu",)

# the kernel's output fields and masks (csrc/samplers.cu::Field, Mask)
FIELDS = ("P", "rps", "qs", "eccs", "argps", "masses", "radii", "fluxratios",
          "a", "b", "incs", "lnw", "inc_rad", "w_rad", "k", "ksec", "a_R",
          "g", "g_pri", "g_sec", "a_twin", "b_twin", "incs_twin", "lnw_twin",
          "inc_rad_twin", "a_R_twin", "fluxratios_comp", "masses_comp",
          "radii_comp", "u1s", "u2s", "host_mass", "host_rad", "delta_band",
          "fluxratios_cc")
MASKS = ("mask", "mask_twin")
ENTRIES = ("planet", "eb", "twin")
STARS = {"T": 0, "P": 1, "S": 2, "D": 3, "B": 4}
# the splines the kernel reads (csrc/samplers.cu::Spline)
SPLINES = ("torres_rad", "torres_teff", "cdwrf_rad", "cdwrf_teff", "TESS")
# the by-value scalars, in the order the kernel writes them back
SCALARS = ("P_lo", "P_hi", "M_s", "R_s", "Teff", "plx")

_lib = None

_F, _I, _P = ctypes.c_float, ctypes.c_int, ctypes.c_void_p


def _floats(*names):
    return [(n, _F) for n in names]


class PowSpec(ctypes.Structure):
    """How torch's CUDA pow computes tensor ** e for a Python float e
    (``_pow_spec``)."""
    _fields_ = [("code", _I), ("e", _F)]


class Broken3(ctypes.Structure):
    _fields_ = (_floats("inv_norm", "c1", "add1") + [("e1", PowSpec)]
                + _floats("I1", "c2", "inv_A1", "add2") + [("e2", PowSpec)]
                + _floats("I2", "c3", "inv_A1A2", "add3") + [("e3", PowSpec)]
                + _floats("thr1", "thr2"))


class QLaw(ctypes.Structure):
    _fields_ = ([("big", Broken3)]
                + [(n, PowSpec) for n in ("e_p1", "e_inv_p1", "e_p2",
                                          "e_inv_p2")]
                + _floats("c_p1", "inv_cp1", "c03p1", "I2m", "I3m", "c_p2",
                          "inv_cp2", "inv_A1", "inv_A1A2", "add03", "add095",
                          "c1p2", "cF", "inv_T2", "cI3", "cdf95_big"))


class Consts(ctypes.Structure):
    _fields_ = ([("rp_hot", Broken3), ("rp_cool", Broken3)]
                + _floats("rp_flat_inv", "rp_flat_add", "rp_m_split")
                + [("q_bin", QLaw), ("q_comp", QLaw)]
                + _floats("q_m_floor", "q_c01", "q_cap", "q_m_low", "q_m_mid",
                          "q_m_big")
                + [("beta_ea", PowSpec), ("beta_eb", PowSpec)]
                + _floats("beta_split", "beta_inv_vmax", "beta_inv_wmax",
                          "ecc_e_short", "ecc_e_long", "ecc_p_split", "pi",
                          "inv180", "deg_per_rad", "rad_per_deg", "G", "MSUN",
                          "RSUN", "REARTH", "day_s", "inv_4pi2")
                + [("e_third", PowSpec)]
                + _floats("inc_inv_norm", "cos_lower", "deg_per_rad_inc",
                          "k_eps", "k_shrink", "q_twin", "m_hot", "r_floor",
                          "teff_floor", "logg_min", "teff_max",
                          "logg_inv_step", "teff_inv_step", "w_scale",
                          "w_zero", "ten", "mix_m1", "mix_m2", "mix_t1",
                          "mix_t2", "mix_inv_d1", "mix_inv_d2", "mix_inv_d3",
                          "mix_d1", "mix_d2", "mix_d3"))


class Args(ctypes.Structure):
    """One launch's arguments (``csrc/samplers.cu::Args``), passed to the
    kernel by value."""
    _fields_ = ([("u", _P * 6)]
                + [(n, _P) for n in ("perm", "idx", "qs_in", "pack", "u1_tab",
                                     "u2_tab", "P", "P_mean")]
                + [("sp_br", _P * len(SPLINES)), ("sp_cf", _P * len(SPLINES))]
                + [(n, _P) for n in ("beta_cL", "beta_cH", "out", "mask",
                                     "scal")]
                + [("n", ctypes.c_longlong), ("sp_n", _I * len(SPLINES)),
                   ("row", _I * len(FIELDS)), ("mrow", _I * len(MASKS))]
                + [(n, _I) for n in ("n_teff", "n_perm", "flatpriors",
                                     "stratified", "use_molusc",
                                     "shared_twin")]
                + _floats("inv_n", *SCALARS) + [("c", Consts)])


# ---------------------------------------------------------------------------
# Python scalars as the torch chain on the card sees them
# ---------------------------------------------------------------------------

def _f32(x) -> float:
    """A Python scalar as a float32 tensor op reads it: rounded to
    nearest."""
    return float(np.float32(float(x)))


def _inv(x) -> float:
    """What tensor / x multiplies by for a Python scalar x on the card
    (torch's div_true_kernel_cuda): the reciprocal of the Python float,
    rounded to float32."""
    return float(np.float32(1.0 / float(x)))


def by_value(*xs):
    """Host scalars rounded to float32 as ``engine._scalars`` rounds them
    (``torch.as_tensor(x, dtype=float32)``): the values the kernel takes
    by value."""
    return tuple(_f32(x) for x in xs)


POW_CODES = ("ones", "ident", "sqrt", "rsqrt", "recip", "square", "cube",
             "inv_square", "generic")


def _pow_spec(e: float) -> PowSpec:
    """tensor ** e for a Python float e as torch computes it on the card:
    Pow.cpp fills ones at 0 and copies at 1; PowKernel.cu takes sqrt at
    0.5, rsqrt at -0.5 and the reciprocal at -1, then on the float32
    exponent base * base at 2, base^3 at 3, 1 / base^2 at -2, and powf
    otherwise."""
    code = {0.0: "ones", 1.0: "ident", 0.5: "sqrt", -0.5: "rsqrt",
            -1.0: "recip"}.get(e)
    ef = np.float32(e)
    if code is None:
        code = {2.0: "square", 3.0: "cube", -2.0: "inv_square"}.get(
            float(ef), "generic")
    return PowSpec(POW_CODES.index(code), float(ef))


def _broken3(A1, A2, I1, I2, Norm, p1, p2, p3, lo, b1, b2) -> Broken3:
    """A three-segment inverse CDF whose constants are Python floats
    (``_broken3_invcdf``; ``_q_invcdf_3seg`` at a Python q_min)."""
    return Broken3(
        _inv(Norm), _f32(p1 + 1), _f32(lo ** (p1 + 1)),
        _pow_spec(1.0 / (p1 + 1)),
        _f32(I1), _f32(p2 + 1), _inv(A1), _f32(b1 ** (p2 + 1)),
        _pow_spec(1.0 / (p2 + 1)),
        _f32(I2), _f32(p3 + 1), _inv(A1 * A2), _f32(b2 ** (p3 + 1)),
        _pow_spec(1.0 / (p3 + 1)),
        _f32(Norm * I1), _f32(Norm * (I1 + I2)))


def _rp(p2) -> Broken3:
    """sample_rp's broken power law for slope p2 (hot: -4, cool: -7)."""
    p1, p3, r_min, r_b1, r_b2, r_max = 0.0, -0.5, 0.5, 3.0, 6.0, 20.0
    A1, A2, I1, I2, _, Norm = _broken3_constants(p1, p2, p3, r_min, r_b1,
                                                 r_b2, r_max)
    return _broken3(A1, A2, I1, I2, Norm, p1, p2, p3, r_min, r_b1, r_b2)


def _qlaw(p1, p2, F_twin) -> QLaw:
    """_sample_q_generic's constants (priors/samplers.py, the same Python
    expressions): the 3-segment law at q_min = 0.1, and the Python parts
    of the 3- and 2-segment laws at the host's q_min."""
    q_min = 0.1
    A1 = (0.3**p1) / (0.3**p2)
    A2 = (1 + F_twin / (1 - F_twin)
          * ((1.0 ** (p2 + 1) - 0.3 ** (p2 + 1)) / (p2 + 1))
          / ((1.0 ** (p2 + 1) - 0.95 ** (p2 + 1)) / (p2 + 1)))
    I1 = (0.3 ** (p1 + 1) - q_min ** (p1 + 1)) / (p1 + 1)
    I2 = A1 * (0.95 ** (p2 + 1) - 0.3 ** (p2 + 1)) / (p2 + 1)
    I3 = A2 * A1 * (1.0 ** (p2 + 1) - 0.95 ** (p2 + 1)) / (p2 + 1)
    Norm = 1.0 / (I1 + I2 + I3)
    T2 = (1.0 ** (p2 + 1) - 0.95 ** (p2 + 1)) / (p2 + 1)
    return QLaw(
        big=_broken3(A1, A2, I1, I2, Norm, p1, p2, p2, q_min, 0.3, 0.95),
        e_p1=_pow_spec(p1 + 1), e_inv_p1=_pow_spec(1.0 / (p1 + 1)),
        e_p2=_pow_spec(p2 + 1), e_inv_p2=_pow_spec(1.0 / (p2 + 1)),
        c_p1=_f32(p1 + 1), inv_cp1=_inv(p1 + 1), c03p1=_f32(0.3 ** (p1 + 1)),
        I2m=_f32(I2), I3m=_f32(I3), c_p2=_f32(p2 + 1), inv_cp2=_inv(p2 + 1),
        inv_A1=_inv(A1), inv_A1A2=_inv(A1 * A2), add03=_f32(0.3 ** (p2 + 1)),
        add095=_f32(0.95 ** (p2 + 1)), c1p2=_f32(1.0 ** (p2 + 1)),
        cF=_f32(F_twin / (1 - F_twin)), inv_T2=_inv(T2),
        cI3=_f32(1.0 ** (p2 + 1) - 0.95 ** (p2 + 1)),
        cdf95_big=_f32(_q_cdf95_3seg(q_min, p1, p2, F_twin)))


@lru_cache(maxsize=None)
def consts() -> Consts:
    """Every constant of the samplers' plain chain, as the card's torch ops
    read it."""
    _, _, vmax, wmax = beta_ppf_cheb()
    (a1, _), (a2, d1), (a3, d2) = ((0.5, 1.0), (0.5, 0.05), (0.0, 0.005))
    t1, t2 = 1.0 - d1, 1.0 - d2
    dens1, dens2 = a1, a1 + a2 / d1
    dens3 = a1 + a2 / d1 + a3 / d2
    m1 = dens1 * t1
    m2 = m1 + dens2 * (t2 - t1)
    inc_norm = 1.0 / (math.cos(0.0) - math.cos(90.0 * math.pi / 180))
    f = _f32
    return Consts(
        rp_hot=_rp(-4.0), rp_cool=_rp(-7.0), rp_flat_inv=_inv(1.0 / 19.5),
        rp_flat_add=f(0.5), rp_m_split=f(0.45),
        q_bin=_qlaw(0.3, -0.5, 0.30), q_comp=_qlaw(0.3, -0.95, 0.05),
        q_m_floor=f(1e-6), q_c01=f(0.1), q_cap=f(0.999), q_m_low=f(0.1),
        q_m_mid=f(0.3), q_m_big=f(1.0),
        beta_ea=_pow_spec(1.0 / BETA_A), beta_eb=_pow_spec(1.0 / BETA_B),
        beta_split=f(BETA_USPLIT), beta_inv_vmax=_inv(vmax),
        beta_inv_wmax=_inv(wmax),
        ecc_e_short=f(1.0 / 0.2), ecc_e_long=f(1.0 / 0.6), ecc_p_split=f(10.0),
        pi=f(PI), inv180=_inv(180.0), deg_per_rad=f(180.0 / PI),
        rad_per_deg=f(PI / 180.0), G=f(G), MSUN=f(MSUN), RSUN=f(RSUN),
        REARTH=f(REARTH), day_s=f(86400.0), inv_4pi2=_inv(4 * PI**2),
        e_third=_pow_spec(1.0 / 3.0),
        inc_inv_norm=_inv(inc_norm), cos_lower=f(math.cos(0.0)),
        deg_per_rad_inc=f(180.0 / math.pi),
        k_eps=f(1e-6), k_shrink=f(0.999), q_twin=f(0.95), m_hot=f(0.63),
        r_floor=f(0.1), teff_floor=f(2800.0), logg_min=f(3.5),
        teff_max=f(10000.0), logg_inv_step=_inv(0.5),
        teff_inv_step=_inv(250.0), w_scale=f(360.0), w_zero=f(90.0),
        ten=f(10.0), mix_m1=f(m1), mix_m2=f(m2), mix_t1=f(t1), mix_t2=f(t2),
        mix_inv_d1=_inv(dens1), mix_inv_d2=_inv(dens2),
        mix_inv_d3=_inv(dens3), mix_d1=f(dens1), mix_d2=f(dens2),
        mix_d3=f(dens3))


# ---------------------------------------------------------------------------
# The library
# ---------------------------------------------------------------------------

def build(verbose: bool = False):
    """Compile the sampler library if it is not built yet; returns its
    path."""
    return build_library("samplers", _SOURCES, verbose)


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name in ("sampler_planet_launch", "sampler_eb_launch",
                     "sampler_twin_launch"):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.POINTER(Args), _I, _P]
            fn.restype = _I
        lib.sampler_layout.argtypes = [ctypes.POINTER(_I)]
        lib.sampler_layout.restype = ctypes.c_char_p
        size = _I()
        layout = lib.sampler_layout(ctypes.byref(size)).decode()
        want = ";".join((",".join(FIELDS), ",".join(MASKS),
                         ",".join(BG_PACK_FIELDS)))
        if layout != want or size.value != ctypes.sizeof(Args):
            raise RuntimeError(
                f"samplers.cu's layout ({layout!r}, Args of {size.value} "
                f"bytes) is not this module's ({want!r}, "
                f"{ctypes.sizeof(Args)} bytes)")
        _lib = lib
    return _lib


def _tables(device):
    """(splines' breaks, coefs, break counts, Beta series) on ``device``:
    the tensors the plain chain reads (``tables.load_tables``)."""
    tabs = load_tables(device, torch.float32)
    splines = [tabs[f"ppoly/{name}"] for name in SPLINES]
    for breaks, coefs in splines:
        if coefs.shape != (4, breaks.shape[0] - 1):
            raise ValueError(f"spline coefficients {tuple(coefs.shape)} for "
                             f"{breaks.shape[0]} breaks: the kernel takes "
                             f"cubics")
    return splines, tabs["beta_cL"], tabs["beta_cH"]


def _need(name, t, shape, dtype, device):
    """Device, dtype, shape (None: any size on that axis) and contiguity
    of one argument."""
    if not torch.is_tensor(t):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the uniforms on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(s is not None and s != d
                                    for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple('*' if s is None else s for s in shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check(entry, star, n, u, names, P, P_mean, perm, idx, qs_in, pack, ldc,
           use_molusc):
    """Every check of ``launch``, before the library is touched."""
    if entry not in ENTRIES:
        raise ValueError(f"entry {entry!r} is not one of {ENTRIES}")
    if star not in STARS:
        raise ValueError(f"star {star!r} is not one of {tuple(STARS)}")
    bad = [x for x in names if x not in FIELDS and x not in MASKS]
    if bad or len(set(names)) != len(names):
        raise ValueError(f"unknown or repeated output names {bad or names}")
    if entry == "planet" and any(x.endswith("_twin") for x in names):
        raise ValueError("a planet branch has no twin fields")
    if n < 1:
        raise ValueError(f"n = {n}: need at least one draw")
    n_u = 6 if star in "PS" else 5
    if len(u) != n_u:
        raise ValueError(f"star {star} takes {n_u} uniform streams, got "
                         f"{len(u)}")
    if not torch.is_tensor(u[0]):
        raise TypeError(f"u[0] must be a tensor, got {type(u[0]).__name__}")
    device = u[0].device
    for j, s in enumerate(u):
        _need(f"u[{j}]", s, (n,), torch.float32, device)
    if entry != "planet":
        if P is None or P_mean is None:
            raise ValueError("an EB branch takes the periods P and P.mean()")
        _need("P", P, (n,), torch.float32, device)
        _need("P_mean", P_mean, (), torch.float32, device)
    if perm is not None:
        if entry == "planet" or perm.dim() != 2 or perm.shape[0] != n_u - 2:
            raise ValueError(f"lattice permutations of shape "
                             f"{tuple(perm.shape)} for a {entry} branch of "
                             f"star {star}")
        _need("perm", perm, (n_u - 2, n), torch.int64, device)
    if star in "DB":
        _need("idx", idx, (n,), torch.int64, device)
        _need("pack", pack, (None, 9), torch.float32, device)
    elif star in "PS" and use_molusc:
        if entry == "twin":
            _need("idx", idx, (n,), torch.int64, device)
            _need("qs_in", qs_in, (None,), torch.float32, device)
        else:
            if idx is not None:
                raise ValueError("a normal branch reads the MOLUSC row of "
                                 "its own draw: no idx")
            _need("qs_in", qs_in, (n,), torch.float32, device)
    elif idx is not None or qs_in is not None or pack is not None:
        raise ValueError(f"star {star} draws no rows: no idx, qs_in or pack")
    if star == "S":
        if ldc is None:
            raise ValueError("star S takes the LDC tables (u1_tab, u2_tab)")
        _need("u1_tab", ldc[0], (4, None), torch.float32, device)
        _need("u2_tab", ldc[1], tuple(ldc[0].shape), torch.float32, device)
    if device.type != "cuda":
        raise ValueError(f"the sampler kernels run on a CUDA device, not "
                         f"{device}")
    return device


def launch(entry, star, n, u, scalars, names, *, P=None, P_mean=None,
           perm=None, idx=None, qs_in=None, pack=None, ldc=None,
           flatpriors=False, stratified=True, use_molusc=False,
           shared_twin=False):
    """One sampler branch on the card.

    entry: "planet", "eb" or "twin"; star: "T", "P", "S", "D" or "B"
    (module docstring); n draws; u the branch's uniform streams (5, or 6
    for P and S); scalars (P_lo, P_hi, M_s, R_s[, Teff[, plx]]), host
    values; names: the fields and masks to return (``FIELDS``,
    ``MASKS``). EB branches take the periods P torch drew and P.mean();
    perm the (streams - 2, n) Latin-hypercube permutations; idx the drawn
    rows of pack (D, B) or, on a twin set, the MOLUSC rows of qs_in (P, S
    with use_molusc; a normal branch reads qs_in at its own draw); ldc the
    (u1_tab, u2_tab) grid (S). shared_twin adds the normal branch's
    shared-draw twin fields.

    Returns (fields, scal): the (n,) views by name, in ``names``' order,
    and a (len(SCALARS),) float32 device tensor holding the by-value
    scalars. Raises on any argument the kernel does not take, and if the
    launch fails."""
    device = _check(entry, star, n, u, names, P, P_mean, perm, idx, qs_in,
                    pack, ldc, use_molusc)
    lib = _load()
    fields = [x for x in names if x in FIELDS]
    masks = [x for x in names if x in MASKS]
    out = torch.empty((len(fields), n), dtype=torch.float32, device=device)
    mask = torch.empty((len(masks), n), dtype=torch.bool, device=device)
    scal = torch.empty((len(SCALARS),), dtype=torch.float32, device=device)
    splines, cL, cH = _tables(device)
    a = Args()
    for j, s in enumerate(u):
        a.u[j] = s.data_ptr()
    for name, t in (("perm", perm), ("idx", idx), ("qs_in", qs_in),
                    ("pack", pack), ("P", P), ("P_mean", P_mean)):
        setattr(a, name, None if t is None else t.data_ptr())
    if ldc is not None:
        a.u1_tab, a.u2_tab = ldc[0].data_ptr(), ldc[1].data_ptr()
        a.n_teff = ldc[0].shape[1]
    for j, (breaks, coefs) in enumerate(splines):
        a.sp_br[j], a.sp_cf[j] = breaks.data_ptr(), coefs.data_ptr()
        a.sp_n[j] = breaks.shape[0]
    a.beta_cL, a.beta_cH = cL.data_ptr(), cH.data_ptr()
    a.out, a.mask, a.scal = out.data_ptr(), mask.data_ptr(), scal.data_ptr()
    a.n = n
    for j, name in enumerate(FIELDS):
        a.row[j] = fields.index(name) if name in fields else -1
    for j, name in enumerate(MASKS):
        a.mrow[j] = masks.index(name) if name in masks else -1
    a.n_perm = 0 if perm is None else perm.shape[0]
    a.flatpriors, a.stratified = int(flatpriors), int(stratified)
    a.use_molusc, a.shared_twin = int(use_molusc), int(shared_twin)
    a.inv_n = _inv(n)
    for name, v in zip(SCALARS, by_value(*scalars)):
        setattr(a, name, v)
    a.c = consts()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, f"sampler_{entry}_launch")(
            ctypes.byref(a), STARS[star], stream)
    if err != 0:
        raise RuntimeError(f"sampler {entry} kernel (star {star}) launch "
                           f"failed: cudaError {err}")
    profiling.count(f"launch.sampler.{entry}")
    views = {x: out[fields.index(x)] for x in fields}
    views.update((x, mask[masks.index(x)]) for x in masks)
    return {x: views[x] for x in names}, scal
