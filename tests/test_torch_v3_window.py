"""The v3 kernels' per-draw transit window (``ops/chi2_core.py::
transit_window`` and ``window_contains``, the plain twins of
``csrc/chi2_supersampled.cu::transit_window`` and ``Window::contains``):
the kernels solve Kepler only at exposures inside some draw's window, so
the window must hold every exposure that can count (a node with model
z^2 < zmax^2 and the centre in front), and it must leave out enough of a
long curve to pay.

The exposure model is the port's own: ``chi2_core.orbit_planes``
(``z2_taylor`` per exposure centre for ns > 1, ``projected_z`` for
ns = 1), the planes the kernels compute per point, evaluated at the GL
nodes ``_chi2_fused`` picks.
"""

import numpy as np
import pytest
import torch

from triceratops_tpu_torch.core.kepler import E_MAX
from triceratops_tpu_torch.ops import chi2_core
from triceratops_tpu_torch.ops import fastcore as tfc
from triceratops_tpu_torch.ops import lightcurve as tlc

from test_torch_shared import tf

# periods of the draw groups (days), draws per group, exposures per curve
PERIODS = (0.5, 1.0, 3.0, 10.0)
N_PER_P = 5000
N_T = 500


def _draws(rng, N, P):
    """N f32 draws at period P: k in [0.01, 0.3], a_R in [2, 30], e in
    [0, 0.9] with a tenth at E_MAX and above it (clamped by the kernels),
    w uniform, and impact parameters from central to 20 % past grazing."""
    k = rng.uniform(0.01, 0.3, N)
    aR = rng.uniform(2.0, 30.0, N)
    e = rng.uniform(0.0, 0.9, N)
    e[: N // 20] = E_MAX
    e[N // 20: N // 10] = 0.999
    w = rng.uniform(-np.pi, np.pi, N)
    b = rng.uniform(0.0, 1.2, N) * (1.0 + k)
    inc = np.arccos(np.clip(b / aR, 0.0, 1.0))
    return [tf(x) for x in (np.full(N, P), aR, inc, e, w, k)]


def _nodes(ns, exptime):
    if ns == 1:
        return (0.0,)
    return tuple(map(float, tlc._gl_exposure_nodes(exptime, ns)[0]))


def _zmax(k):
    """zmax per draw as the kernels form it from the tab coefficients'
    segment scalars: zmid + 1 / invB2."""
    n = k.shape[0]
    segs = tfc.cheb_deficit_coeffs_tab(k, tf(np.full(n, 0.4)),
                                       tf(np.full(n, 0.2)))[3:]
    return segs[1] + 1.0 / segs[4]


def _counts(time, P, aR, inc, e, w, zmax, ns, offs):
    """(C, n_t) masks: exposures that count (a node with model z^2 <
    zmax^2, centre in front) and exposures inside the draw's window."""
    q0, q1, q2, front = chi2_core.orbit_planes(time, P, aR, inc, e, w, ns)
    counts = torch.zeros_like(q0, dtype=torch.bool)
    for d in offs:
        counts |= (q0 + q1 * d + q2 * (d * d)) < (zmax * zmax)[:, None]
    counts &= front > 0
    mid, half = chi2_core.transit_window(P, aR, inc, e, w, zmax, offs)
    return counts, chi2_core.window_contains(time, P, mid, half)


@pytest.mark.parametrize("ns,exptime", [(1, 0.0), (20, 2.0 / 1440),
                                        (20, 30.0 / 1440)])
def test_window_holds_every_counting_exposure(ns, exptime):
    """Over 2e4 seeded draws (four periods, each on a |t| < P/2 curve of
    500 exposures): every (draw, exposure) with a node at model z^2 <
    zmax^2 and the centre in front lies inside the draw's window."""
    offs = _nodes(ns, exptime)
    rng = np.random.default_rng(ns + int(exptime * 1440))
    n_counting = 0
    for P in PERIODS:
        P_, aR, inc, e, w, k = _draws(rng, N_PER_P, P)
        time = tf(np.linspace(-P / 2, P / 2, N_T))
        counts, inside = _counts(time, P_, aR, inc, e, w, _zmax(k), ns,
                                 offs)
        missed = counts & ~inside
        assert not missed.any(), (
            f"P = {P}: {int(missed.sum())} counting exposures outside the "
            f"window, draws {torch.nonzero(missed.any(1))[:5].ravel()}")
        n_counting += int(counts.sum())
    assert n_counting > 0.01 * len(PERIODS) * N_PER_P * N_T


def test_window_leaves_out_most_of_a_long_curve():
    """tests/test_pallas_core.py's draws (P = 3, a_R = 9.6, e <= 0.5,
    transiting) on a |t| < 1.5 d curve, GL-4 nodes of a 2-min exposure: at
    least half of the exposures lie outside every draw's window, and each
    draw's own window leaves out most of its curve."""
    rng = np.random.default_rng(5)
    N = 2048
    k = 10 ** rng.uniform(-2, -0.7, N)
    aR = np.full(N, 9.6)
    inc = np.arccos(rng.uniform(0, 1, N) * (1 + k) / aR)
    e = rng.uniform(0, 0.5, N)
    w = rng.uniform(-np.pi, np.pi, N)
    P, aR, inc, e, w, k = (tf(x) for x in (np.full(N, 3.0), aR, inc, e, w,
                                           k))
    time = tf(np.linspace(-1.5, 1.5, N_T))
    counts, inside = _counts(time, P, aR, inc, e, w, _zmax(k), 20,
                             _nodes(20, 2.0 / 1440))
    assert not (counts & ~inside).any()
    outside_all = float((~inside).all(0).float().mean())
    outside_own = float((~inside).float().mean())
    assert outside_all >= 0.5, outside_all
    assert outside_own >= 0.75, outside_own


def test_window_bounds():
    """The window's two ends: a draw whose orbit keeps z >= zeff at every
    phase (b = a_R cos i far past 1 + k, e = 0) has an empty window; one
    whose periastron dips inside zmax (a_R (1 - e) < zmax) has the whole
    orbit; a central circular transit's window is centred on the transit
    (mid 0) with a half width near asin(zmax / a_R), padded by the nodes'
    spread."""
    P, aR, e, w, zmax = (tf(x) for x in ([3.0] * 3, [10.0] * 3,
                                         [0.0, 0.95, 0.0], [0.3] * 3,
                                         [1.1] * 3))
    inc = tf([np.arccos(3.0 / 10.0), np.pi / 2, np.pi / 2])
    offs = _nodes(20, 2.0 / 1440)
    mid, half = chi2_core.transit_window(P, aR, inc, e, w, zmax, offs)
    assert float(half[0]) < 0
    assert float(half[1]) >= chi2_core.WIN_WHOLE
    n = 2 * np.pi / 3.0
    want = np.arcsin(1.1 / 10.0) + n * max(map(abs, offs))
    assert abs(float(mid[2])) < 1e-5
    assert want < float(half[2]) < want + 1e-3
    t = tf([0.0, 0.9 * want / n, 1.1 * want / n, 1.5])
    got = chi2_core.window_contains(t, P, mid, half)
    assert got.tolist() == [[False] * 4, [True] * 4,
                            [True, True, False, False]]
