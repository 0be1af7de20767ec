"""The bound-companion rows on the companion law (no MOLUSC file), held to
upstream's float64 arithmetic: the port's float32 priors
``lnprior_bound_TP`` / ``_EB`` on the default contrast limit (2.2" at
1.0 mag) against ``port_bench/samplers.py::lnprior_bound``, and the law
branches of ``sample_ptp``, ``sample_stp``, ``sample_peb`` and
``sample_seb`` (their twin branches too) against
``port_bench/samplers.py::branch``, the benchmark's plain float64
reference, on the uniforms the port drew, with no JAX; the priors on a
contrast curve out to 10" against the JAX package on float64 inputs
(the benchmark's reference knows only the default limit).

The prior is piecewise in log10 Pmax with edges at 1, 2, 3.4, 5.5 and 8;
where the float64 log10 Pmax lies within ``EDGE_TOL`` of an edge,
rounding may put float32 on either side, and such a point is checked
only for taking one of the two branches (``_near_edge``).
"""

import math
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from port_bench import capture, samplers  # noqa: E402
from triceratops_tpu_torch.priors import companion as tco  # noqa: E402
from triceratops_tpu_torch.scenarios import engine as teng  # noqa: E402

EDGES = (1.0, 2.0, 3.4, 5.5, 8.0)
EDGE_TOL = 1e-5
# nats between the port's float32 output and the float64 reference
PRIOR_TOL = 1e-5
# the log weight (ln prior + importance weight) over max(1, |reference|),
# as the benchmark's prior_gap reads it: <= 1.4e-6 here on every branch
WEIGHT_TOL = 1e-5
PLX = (0.5, 1.0, 2.0, 5.0, 11.0, 25.0, 60.0, 120.0, 200.0, math.nan)
MASSES = (0.5, 1.0, 1.3)
DM = np.linspace(-2.0, 12.0, 281).astype(np.float32)
# a contrast curve out to 10" (arcsec, delta mag)
CURVE_10 = (np.float32([0.1, 0.3, 0.7, 1.5, 3.0, 6.0, 10.0]),
            np.float32([1.0, 2.5, 4.0, 5.5, 6.5, 7.5, 8.5]))


def _lp64(M_s, plx, sep_arcsec):
    """float64 log10 Pmax [d] as upstream computes it (priors.py)."""
    M = max(M_s, 1.0)
    plx = 0.1 if math.isnan(plx) else plx
    a = (1000.0 / plx) * np.asarray(sep_arcsec, np.float64) * samplers.AU
    P = np.sqrt(4 * math.pi**2 / (samplers.G * M * samplers.MSUN) * a**3)
    return np.log10(P / 86400.0)


def _near_edge(lp):
    return np.min(np.abs(np.subtract.outer(lp, EDGES)), axis=-1) <= EDGE_TOL


def _port_prior(kind, M_s, plx, dm, seps, cons):
    args = (torch.tensor(M_s, dtype=torch.float32),
            torch.tensor(plx, dtype=torch.float32),
            torch.as_tensor(np.abs(dm)), torch.as_tensor(seps),
            torch.as_tensor(cons))
    fn = tco.lnprior_bound_TP if kind == "TP" else tco.lnprior_bound_EB
    lnp = tco.clamp_companion_prior(fn(*args), torch.as_tensor(dm))
    a64 = [a.double() for a in args]
    lp = tco._log10_max_porb(torch.clamp_min(a64[0], 1.0), *a64[1:])
    return lnp.double().numpy(), lp.numpy()


def _check_prior(got, want, lp, lp64, msg):
    """Within PRIOR_TOL nats away from a branch edge; at one, only one of
    the two branches (log10 Pmax beside the edge)."""
    edge = _near_edge(lp64)
    assert np.isfinite(lp).all()
    np.testing.assert_allclose(got[~edge], want[~edge], rtol=0,
                               atol=PRIOR_TOL, err_msg=msg)
    assert np.all(_near_edge(lp[edge])), (msg, lp[edge])


@pytest.mark.parametrize("plx", PLX)
def test_bound_prior_default_curve(plx):
    """float32 within PRIOR_TOL nats of the float64 reference, no inf
    where it is finite, on upstream's default limit, for each host mass;
    fails where log10 Pmax overflows float32."""
    seps, cons = np.float32([2.2]), np.float32([1.0])
    for M_s in MASSES:
        lp64 = np.full(DM.shape, _lp64(M_s, plx, 2.2))
        for kind in ("TP", "EB"):
            got, lp = _port_prior(kind, M_s, plx, DM, seps, cons)
            want = samplers.lnprior_bound(
                kind, M_s, plx, torch.as_tensor(DM, dtype=torch.float64))
            _check_prior(got, want.numpy(), lp, lp64, (kind, M_s))


@pytest.mark.parametrize("plx", PLX)
def test_bound_prior_contrast_curve(plx):
    """On a contrast curve out to 10", for each host mass: the float32
    bound priors against the JAX package on float64 inputs, as
    ``test_bound_prior_default_curve`` holds them."""
    import jax.numpy as jnp
    from triceratops_tpu.priors import companion as jco

    seps, cons = CURVE_10
    for M_s in MASSES:
        jargs = tuple(jnp.asarray(a, jnp.float64) for a in (
            M_s, plx, np.abs(DM), seps, cons))
        lp64 = np.log10(np.asarray(jco._max_porbs(
            jnp.maximum(jargs[0], 1.0), *jargs[1:])))
        for kind in ("TP", "EB"):
            got, lp = _port_prior(kind, M_s, plx, DM, seps, cons)
            want = jco.clamp_companion_prior(
                getattr(jco, f"lnprior_bound_{kind}")(*jargs),
                jnp.asarray(DM, jnp.float64))
            _check_prior(got, np.asarray(want), lp, lp64, (kind, M_s))


def _branch_case(kind, M_s, R_s, Teff, plx, N, twin_div):
    """The sampler's call with no MOLUSC file and no contrast curve, as
    calc_probs makes it, at N draws."""
    P = 3.18
    args = [torch.Generator().manual_seed(7), P, P, M_s, R_s, Teff, plx,
            torch.zeros(N)]
    kw = dict(N=N, use_molusc=False, cc_filt=None)
    if kind in ("STP", "SEB"):
        from triceratops_tpu_torch.populations.ldc import grid_at_Z

        u1, u2 = grid_at_Z(0.0, "TESS", 10000 if kind == "STP" else 13000)
        args += [torch.as_tensor(u1, dtype=torch.float32),
                 torch.as_tensor(u2, dtype=torch.float32)]
    args += [torch.tensor([2.2]), torch.tensor([1.0])]
    if kind in ("PTP", "STP"):
        kw["flatpriors"] = False
    else:
        kw["twin_n"] = N // twin_div
    return args, kw, dict(P=P, M_s=M_s, R_s=R_s, Teff=Teff, plx=plx)


@pytest.mark.parametrize("kind,twin_div", [("PTP", 0), ("STP", 0),
                                           ("PEB", 4), ("SEB", 2)])
@pytest.mark.parametrize("star", [(1.09, 1.06, 5950.0, 11.0),
                                  (0.8, 0.8, 5000.0, 4.0)],
                         ids=["toi465", "k_dwarf"])
def test_law_branches_match_reference(kind, twin_div, star):
    """Every branch (the twin one of PEB / SEB too) at N = 4096: masks
    equal and log weights within WEIGHT_TOL of the float64 reference,
    draws within samplers.AMBIGUOUS of a jump left out."""
    N = 4096
    args, kw, ref_star = _branch_case(kind, *star, N, twin_div)
    cap = capture.Capture(0, 0, seed=11, sampler_draws=N)
    with capture.patched(capture.sampler_points(teng), cap):
        getattr(teng, f"sample_{kind.lower()}")(*args, **kw)
    (rec,) = cap.samplers
    assert rec["kind"] == kind and not rec["molusc"]
    f64 = samplers.Ops(torch.float64)
    assert len(rec["branches"]) == (2 if twin_div else 1)
    for br in rec["branches"]:
        _, w_mask, w_wt, amb = samplers.branch(kind, br["twin"], ref_star,
                                               br["u"], None, None, f64)
        ok = ~amb
        assert ok.float().mean() > 0.99
        np.testing.assert_array_equal(br["mask"][ok].numpy(),
                                      w_mask[ok].numpy())
        live = ok & w_mask
        assert live.sum() > 100
        g, w = br["weight"][live], w_wt[live]
        np.testing.assert_array_equal(torch.isfinite(g).numpy(),
                                      torch.isfinite(w).numpy())
        fin = torch.isfinite(w)
        gap = (torch.abs(g - w)[fin] / torch.clamp_min(w.abs()[fin], 1.0))
        assert float(gap.max()) < WEIGHT_TOL, (br["twin"], float(gap.max()))
