"""Fast likelihood-core internals: per-draw Chebyshev deficit proxy and
per-exposure Kepler solves. Counterpart of
the JAX package's ``ops/fastcore.py`` (see its module docstring for the
derivation):

1. For one draw the deficit D(z) at fixed (k, u1, u2) is a Chebyshev
   series on three z-segments A = [0, |1-k|], B1 = [|1-k|, |1-k| + c],
   B2 = [|1-k| + c, 1+k], each under the symmetric sqrt map
   s = (z - z_lo) / (z_hi - z_lo), x = sqrt(s) - sqrt(1 - s).
2. z^2 is modelled as a quadratic over each exposure from one Kepler
   solve with closed-form derivatives.

The per-draw coefficients come from the k-tabulated basis (one
(N, sum_degs) @ (sum_degs, 162) matmul) for float32 inputs and from exact
kernel nodes plus a DCT for float64 inputs, unless ``TRICERATOPS_COEFFS``
forces one of them (``COEFFS_BACKEND``).
"""

from __future__ import annotations

import math
import os

import torch

from ..core.kepler import z2_taylor
from ..core.numerics import full_precision_matmul
from ..tables import M_CHEB, cheb_k_tables, load_tables
from .occult import occult_quad_deficit

_BREAK_SLOPE = 6.0
_BREAK_FLOOR = 0.02

# coefficient-stage backend, read once at import as the JAX package reads
# it: "auto" picks by dtype, "exact" / "tab" force one
COEFFS_BACKEND = os.environ.get("TRICERATOPS_COEFFS", "auto")

_TAB_BREAKS, _TAB_KINDS, _TAB_DEGS, _ = cheb_k_tables()
_TAB_MAXDEG = int(_TAB_DEGS.max())


def _tab_segment_map(g):
    """(lo, hi, kind, shift, den) of k-segment g as Python floats: its
    mapped variable is t = (kc - shift) / den (kind 0), (log kc - shift) /
    den (kind 1), 1 - sqrt(max(shift - kc, 0) / den) (kind 2) or
    sqrt(max(kc - shift, 0) / den) (kind 3)."""
    lo, hi = float(_TAB_BREAKS[g]), float(_TAB_BREAKS[g + 1])
    kind = int(_TAB_KINDS[g])
    if kind == 1:
        return lo, hi, kind, math.log(lo), math.log(hi) - math.log(lo)
    return lo, hi, kind, hi if kind == 2 else lo, hi - lo


TAB_SEGMENTS = tuple(_tab_segment_map(g) for g in range(8))


def _segments(k):
    """(zsplit, zmid, 1/wA, 1/wB1, 1/wB2) of the three z-segments, each
    (N, 1). The width floors keep a k = 0 lane finite."""
    kcol = k[:, None]
    zsplit = torch.abs(1.0 - kcol)
    zmax = 1.0 + kcol
    c = torch.minimum(torch.clamp_min(_BREAK_SLOPE * zsplit, _BREAK_FLOOR),
                      (zmax - zsplit) / 2.0)
    zmid = zsplit + c
    wA = torch.clamp_min(zsplit, 1e-6)
    wB1 = torch.clamp_min(c, 1e-6)
    wB2 = torch.clamp_min(zmax - zmid, 1e-6)
    return zsplit, zmid, wA, wB1, wB2


def cheb_deficit_coeffs(k, u1, u2):
    """Per-draw Chebyshev series of D(z) on the three z-segments from
    exact kernel evaluations at the Chebyshev nodes.

    Args: k, u1, u2 with shape (N,).
    Returns (cA, cB1, cB2, zsplit, zmid, invA, invB1, invB2): coefficient
    arrays (N, 18) and the (N,) segment maps.
    """
    zsplit, zmid, wA, wB1, wB2 = _segments(k)
    tabs = load_tables(k.device, k.dtype)
    s = tabs["s_nodes"][None, :]
    kcol, u1b, u2b = k[:, None], u1[:, None], u2[:, None]
    DA = occult_quad_deficit(kcol, wA * s, u1b, u2b)
    DB1 = occult_quad_deficit(kcol, zsplit + wB1 * s, u1b, u2b)
    DB2 = occult_quad_deficit(kcol, zmid + wB2 * s, u1b, u2b)
    dct = tabs["dct_T"]
    with full_precision_matmul():
        cA, cB1, cB2 = DA @ dct, DB1 @ dct, DB2 @ dct
    return (cA, cB1, cB2, zsplit[:, 0], zmid[:, 0], 1.0 / wA[:, 0],
            1.0 / wB1[:, 0], 1.0 / wB2[:, 0])


def _tab_kappa_onehot(kc):
    """Mapped Chebyshev variable of the active k-segment and the
    per-segment one-hot masks; kc is already clipped to the table range."""
    kappa = torch.zeros_like(kc)
    actives = []
    logk = torch.log(kc)
    for g, (lo, hi, kind, shift, den) in enumerate(TAB_SEGMENTS):
        if kind == 0:
            t = (kc - shift) / den
        elif kind == 1:
            t = (logk - shift) / den
        elif kind == 2:   # sqrt-resolved toward hi
            t = 1.0 - torch.sqrt(torch.clamp_min(shift - kc, 0.0) / den)
        else:             # sqrt-resolved toward lo
            t = torch.sqrt(torch.clamp_min(kc - shift, 0.0) / den)
        active = (kc >= lo) & ((kc <= hi) if g == 7 else (kc < hi))
        kap = torch.clamp(2.0 * t - 1.0, -1.0, 1.0)
        kappa = torch.where(active, kap, kappa)
        actives.append(active)
    return kappa, actives


def cheb_deficit_coeffs_tab(k, u1, u2):
    """Same output as :func:`cheb_deficit_coeffs`, from the k-tabulated
    basis coefficients: a Chebyshev-in-kappa design row per draw times the
    (sum_degs, 162) table. Both products run in IEEE float32 whatever
    the caller's matmul precision (``full_precision_matmul``), as the JAX
    package pins them with ``precision=HIGHEST``."""
    kc = torch.clamp(k, float(_TAB_BREAKS[0]), float(_TAB_BREAKS[-1]))
    kappa, actives = _tab_kappa_onehot(kc)
    T = [torch.ones_like(kappa), kappa]
    two_k = 2.0 * kappa
    for _ in range(2, _TAB_MAXDEG):
        T.append(two_k * T[-1] - T[-2])
    T = torch.stack(T, dim=1)                                 # (N, maxdeg)
    Tfull = torch.cat([T[:, : int(_TAB_DEGS[g])] * actives[g][:, None].to(k.dtype)
                       for g in range(8)], dim=1)             # (N, sum_degs)
    with full_precision_matmul():
        bas = Tfull @ load_tables(k.device, k.dtype)["tab_C"]  # (N, 162)
    bas = bas.reshape(-1, 3, M_CHEB, 3)

    om = 1.0 - u1 / 3.0 - u2 / 6.0
    # the tabulated basis rows are [A0, A1, J] / (pi * k^2)
    scale = torch.clamp_max(k, float(_TAB_BREAKS[-1])) ** 2 / om
    w = torch.stack([(1.0 - u1 - 2.0 * u2) * scale,
                     (u1 + 2.0 * u2) * scale,
                     u2 * scale], dim=-1)                      # (N, 3)
    with full_precision_matmul():
        coeffs = torch.einsum("nsmb,nb->nsm", bas, w)
    zsplit, zmid, wA, wB1, wB2 = _segments(k)
    return (coeffs[:, 0], coeffs[:, 1], coeffs[:, 2], zsplit[:, 0],
            zmid[:, 0], 1.0 / wA[:, 0], 1.0 / wB1[:, 0], 1.0 / wB2[:, 0])


def uses_tab(backend, *dtypes):
    """Whether ``deficit_coeffs`` takes the tabulated coefficients under
    ``backend`` (a ``COEFFS_BACKEND`` value) for inputs of ``dtypes``:
    "tab" always, "exact" never, "auto" unless one is float64."""
    if backend in ("exact", "tab"):
        return backend == "tab"
    return torch.float64 not in dtypes


def deficit_coeffs(k, u1, u2):
    """Tabulated coefficients for float32 (device) inputs, exact kernel
    nodes for float64 (reference) inputs; ``COEFFS_BACKEND`` "exact" or
    "tab" forces one whatever the dtype."""
    if uses_tab(COEFFS_BACKEND, k.dtype, u1.dtype, u2.dtype):
        return cheb_deficit_coeffs_tab(k, u1, u2)
    return cheb_deficit_coeffs(k, u1, u2)


def _clenshaw_select3(cA, cB1, cB2, in_B1, in_B2, x):
    """One Clenshaw pass in which each point takes its active segment's
    coefficient at every step."""
    b1 = torch.zeros_like(x)
    b2 = torch.zeros_like(x)
    two_x = 2.0 * x
    for m in range(M_CHEB - 1, 0, -1):
        cm = torch.where(in_B2, cB2[:, m][:, None],
                         torch.where(in_B1, cB1[:, m][:, None],
                                     cA[:, m][:, None]))
        b1, b2 = cm + two_x * b1 - b2, b1
    c0 = torch.where(in_B2, cB2[:, 0][:, None],
                     torch.where(in_B1, cB1[:, 0][:, None], cA[:, 0][:, None]))
    return c0 + x * b1 - b2


def cheb_deficit_eval(coeffs, z):
    """D(z) from :func:`cheb_deficit_coeffs` output; z: (N, P)."""
    cA, cB1, cB2, zsplit, zmid, invA, invB1, invB2 = coeffs
    zs = zsplit[:, None]
    zm = zmid[:, None]
    in_B2 = z >= zm
    in_B1 = (z >= zs) & ~in_B2
    s = torch.where(in_B2, (z - zm) * invB2[:, None],
                    torch.where(in_B1, (z - zs) * invB1[:, None],
                                z * invA[:, None]))
    s = torch.clamp(s, 0.0, 1.0)
    x = torch.sqrt(s) - torch.sqrt(1.0 - s)
    D = _clenshaw_select3(cA, cB1, cB2, in_B1, in_B2, x)
    return torch.clamp(D, 0.0, 1.0)


def exposure_z2_poly(t_exp, h, P, a_R, inc, e, w):
    """Quadratic (Taylor) model of z^2 over each exposure from one Kepler
    solve. t_exp: (n_t,) exposure centers; h (half exposure length) is
    unused, kept for the JAX signature. Per-draw parameters (N,). Returns
    (q0, q1, q2, front), each (N, n_t): z^2(t_exp + d) ~ q0 + q1 d + q2 d^2.
    """
    del h
    z2, dz2, d2z2, front = z2_taylor(t_exp[None, :], 0.0, P[:, None],
                                     a_R[:, None], inc[:, None], e[:, None],
                                     w[:, None])
    return z2, dz2, 0.5 * d2z2, front


def z_supersampled(q0, q1, q2, offsets):
    """z at the exposure offsets from the quadratic z^2 model.
    q*: (N, n_t); offsets: (ns,) tensor. Returns (N, ns, n_t)."""
    d = offsets[None, :, None]
    z2 = q0[:, None, :] + q1[:, None, :] * d + q2[:, None, :] * d * d
    return torch.sqrt(torch.clamp_min(z2, 0.0))

