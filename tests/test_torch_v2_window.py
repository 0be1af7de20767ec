"""The v2 orbit kernels' transit-window vote at their own granularity
(``ops/chi2_core.py::window_groups``, the plain twin of the windowed
``csrc/chi2_supersampled.cu::draw_chi2``): from ``V2_WINDOW_MIN_T``
exposures on, a warp solves Kepler only in the 32-point groups of its draw
that hold an exposure inside the draw's window, and a group it skips adds
obs^2 alone. That leaves the output bit for bit as it was only if every
group the window rejects is one whose deficit the kernel skipped anyway:
no point of it in front with model z^2 < zmax^2 at a node (the ``group``
rule of ``chi2_supersampled_plain``). The window must hold that on a long
curve sorted by time and on a shuffled copy of it.
"""

import numpy as np
import pytest
import torch

from triceratops_tpu_torch.core.kepler import E_MAX
from triceratops_tpu_torch.ops import chi2_core
from triceratops_tpu_torch.ops import fastcore as tfc
from triceratops_tpu_torch.ops import lightcurve as tlc

from test_torch_shared import tf

# periods of the draw groups (days), draws per period, draws a plane slice;
# the curve: bench_longlc.py's 8,055 centres in |t| < 0.4 d
PERIODS = (0.5, 1.0, 3.18, 10.0)
N_PER_P = 500
SLICE = 250
N_T = 8055
HALF_SPAN = 0.4


def _draws(rng, N, P):
    """N f32 draws at period P: k in [0.01, 0.5], a fifth in [0.5, 2]
    (eclipses), a_R in [1.5, 30], e in [0, 0.9] with a tenth at E_MAX and
    above it (the kernels clamp it), w uniform, impact parameters from
    central to 20 % past grazing, and limb darkening as the samplers give
    it."""
    k = rng.uniform(0.01, 0.5, N)
    k[-N // 5:] = rng.uniform(0.5, 2.0, N // 5)
    aR = rng.uniform(1.5, 30.0, N)
    e = rng.uniform(0.0, 0.9, N)
    e[: N // 20] = E_MAX
    e[N // 20: N // 10] = 0.999
    w = rng.uniform(-np.pi, np.pi, N)
    b = rng.uniform(0.0, 1.2, N) * (1.0 + k)
    inc = np.arccos(np.clip(b / aR, 0.0, 1.0))
    u1 = rng.uniform(0.1, 0.6, N)
    u2 = rng.uniform(0.0, 0.3, N)
    return [tf(x) for x in (np.full(N, P), aR, inc, e, w, k, u1, u2)]


def _active_groups(time, P, aR, inc, e, w, zmax, ns, offs):
    """(C, groups) bool: the groups with a point in front at model z^2 <
    zmax^2 at some node, on the exposure model the kernels compute per
    point (``orbit_planes``), grouped as ``chi2_supersampled_plain``'s
    ``group = V2_GROUP`` rule groups them."""
    q0, q1, q2, front = chi2_core.orbit_planes(time, P, aR, inc, e, w, ns)
    seen = torch.zeros(q0.shape, dtype=torch.bool)
    for d in offs:
        seen |= (q0 + q1 * d + q2 * (d * d)) < (zmax * zmax)[:, None]
    seen &= front > 0.0
    G = chi2_core.V2_GROUP
    return torch.nn.functional.pad(seen, (0, -N_T % G)).view(
        q0.shape[0], -1, G).any(dim=2)


@pytest.mark.parametrize("order", ["sorted", "shuffled"])
@pytest.mark.parametrize("ns", [20, 1])
def test_window_groups_hold_every_active_group(ns, order):
    """Over 2,000 seeded draws (four periods) on an 8,055-point curve in
    |t| < 0.4 d, sorted and shuffled, GL-4 nodes of a 2-min exposure (ns
    = 20) or one node (ns = 1): every 32-point group that holds no
    exposure inside the draw's window has no point that counts; of the
    draws that transit, the window rejects most groups of the sorted curve
    and few of the shuffled one."""
    assert N_T >= chi2_core.V2_WINDOW_MIN_T
    if ns > 1:
        offs = tuple(map(float, tlc._gl_exposure_nodes(2.0 / 1440, ns)[0]))
    else:
        offs = (0.0,)
    rng = np.random.default_rng(40 + ns)
    time = np.sort(rng.uniform(-HALF_SPAN, HALF_SPAN, N_T))
    if order == "shuffled":
        time = rng.permutation(time)
    time = tf(time)
    n_groups = n_solved = n_active = 0
    for P in PERIODS:
        P_, aR, inc, e, w, k, u1, u2 = _draws(rng, N_PER_P, P)
        segs = tfc.cheb_deficit_coeffs_tab(k, u1, u2)[3:]
        zmax = segs[1] + 1.0 / segs[4]
        mid, half = chi2_core.transit_window(P_, aR, inc, e, w, zmax, offs)
        for i in range(0, N_PER_P, SLICE):
            s = slice(i, i + SLICE)
            solved = chi2_core.window_groups(time, P_[s], mid[s], half[s])
            active = _active_groups(time, P_[s], aR[s], inc[s], e[s], w[s],
                                    zmax[s], ns, offs)
            missed = active & ~solved
            assert not missed.any(), (
                f"P = {P}: {int(missed.sum())} groups with a counting point "
                f"outside the window, draws "
                f"{(i + torch.nonzero(missed.any(1))[:5]).ravel()}")
            # the draws that transit the curve
            can = active.any(1)
            n_groups += int(can.sum()) * solved.shape[1]
            n_solved += int(solved[can].sum())
            n_active += int(active.sum())
    assert n_active > 0.01 * n_groups
    share = n_solved / n_groups
    if order == "sorted":
        assert share < 0.5, share
    else:
        assert share > 0.6, share


def test_window_groups_shape_and_runs():
    """``window_groups`` votes over runs of ``V2_GROUP`` exposures from the
    first, the last run short: a window over the two exposures either side
    of the first run's end marks the first two runs only; an empty window
    none, the whole orbit every run."""
    G = chi2_core.V2_GROUP
    t = np.linspace(-1.0, 1.0, 100)
    P = tf([10.0, 10.0, 10.0])
    n = 2 * np.pi / 10.0
    centre = 0.5 * (t[G - 1] + t[G])
    mid = tf([n * centre, 0.0, 0.0])
    half = tf([0.75 * n * (t[G] - t[G - 1]), -1.0, chi2_core.WIN_WHOLE])
    got = chi2_core.window_groups(tf(t), P, mid, half)
    assert got.shape == (3, -(-100 // G))
    assert got[0].tolist() == [True, True, False, False]
    assert not got[1].any()
    assert got[2].all()
