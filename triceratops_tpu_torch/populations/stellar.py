"""Mass -> (radius, Teff) and mass -> flux-ratio relations on the device.

Counterpart of the JAX package's ``populations/stellar.py`` (device path).
The reference's cubic interpolating splines (Torres relations above
0.63 Msun, a cool-dwarf relation below, band-wise flux splines;
reference funcs.py:19-140) are converted on the host to piecewise
polynomials (``tables.ppoly_arrays``) and evaluated per draw with a
``torch.searchsorted`` interval lookup plus a Horner step. (The JAX
package's select chain was a TPU gather workaround.)
"""

from __future__ import annotations

import torch

from ..tables import load_tables


def ppoly_eval(x, breaks, coefs):
    """Evaluate a PPoly (breaks (n,), coefs (k, n-1), tensors) at x with
    the end intervals extrapolated."""
    idx = torch.searchsorted(breaks[1:-1].contiguous(), x.contiguous(),
                             right=True)
    dx = x - breaks[idx]
    out = coefs[0][idx]
    for j in range(1, coefs.shape[0]):
        out = out * dx + coefs[j][idx]
    return out


def _spline(name, x):
    breaks, coefs = load_tables(x.device, x.dtype)[f"ppoly/{name}"]
    return ppoly_eval(x, breaks, coefs)


def stellar_relations(masses, max_radii, max_teffs):
    """Radii and Teffs from masses, clamped (reference funcs.py:54-79)."""
    hot = masses > 0.63
    radii = torch.where(hot, _spline("torres_rad", masses),
                        _spline("cdwrf_rad", masses))
    teffs = torch.where(hot, _spline("torres_teff", masses),
                        _spline("cdwrf_teff", masses))
    radii = torch.clamp_min(torch.minimum(radii, max_radii), 0.1)
    teffs = torch.clamp_min(torch.minimum(teffs, max_teffs), 2800.0)
    return radii, teffs


def flux_relation(masses, filt: str = "TESS"):
    """Flux ratio vs a ~1 Msun star (reference funcs.py:121-140)."""
    name = "TESS" if filt in ("TESS", "Vis") else filt
    return 10.0 ** _spline(name, masses)
