"""Port vs JAX reference for the public likelihoods surface
(``likelihoods.py``): the simulators simulate_TP_transit /
simulate_EB_transit, the log-likelihoods lnL_TP / lnL_EB / lnL_EB_twin and
their ``_p`` batch forms, and ``ops/lightcurve.supersample_times``, on the
same numpy inputs, plus the cases of tests/test_likelihoods_parity.py
(scalar vs batch, secondary veto and twin, dilution directions,
secondary-depth algebra) run on the port.

Both packages run these in float64 through the exact Kepler solve and
occultation kernel, so the gates are 1e-10 absolute on flux and secondary
depth and 1e-8 relative on lnL (+0.5 chi^2), with the veto pattern (inf
where inf) equal.
"""

import numpy as np
import pytest
import torch

from triceratops_tpu import likelihoods as jlk
from triceratops_tpu.ops import lightcurve as jlc
from triceratops_tpu_torch import likelihoods as tlk
from triceratops_tpu_torch.ops import lightcurve as tlc
from triceratops_tpu_torch.constants import G, MSUN

FLUX_ATOL = 1e-10
LNL_RTOL = 1e-8


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small CPU tensors: the suite
    runs in several worker processes on shared cores, where torch's
    default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _orbit(P=3.0, M=1.0):
    return ((G * M * MSUN) / (4 * np.pi**2) * (P * 86400) ** 2) ** (1 / 3)


def _flux_close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=FLUX_ATOL)


def _lnl_close(got, want):
    got, want = np.atleast_1d(got), np.atleast_1d(want)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=LNL_RTOL, atol=0)


def _batch(n=64, seed=0):
    """n parameter rows spanning dilution, eccentricity and grazing
    geometry, and a noisy transit curve."""
    rng = np.random.default_rng(seed)
    time = np.linspace(-0.12, 0.12, 40)
    R_s = rng.uniform(0.7, 1.4, n)
    M = rng.uniform(0.6, 1.5, n)
    P = np.full(n, 3.0)
    rows = dict(
        R_p=rng.uniform(1.0, 16.0, n), P_orb=P,
        inc=rng.uniform(86.5, 90.0, n),
        a=((G * M * MSUN) / (4 * np.pi**2) * (P * 86400) ** 2) ** (1 / 3),
        R_s=R_s, u1=rng.uniform(0.2, 0.5, n), u2=rng.uniform(0.1, 0.3, n),
        ecc=rng.uniform(0.0, 0.5, n), argp=rng.uniform(0.0, 360.0, n),
        companion_fluxratio=rng.uniform(0.0, 0.6, n))
    flux = 1.0 + rng.normal(0, 5e-4, len(time))
    eb = dict(rows, R_EB=R_s * rng.uniform(0.1, 1.0, n),
              EB_fluxratio=10 ** rng.uniform(-5, -0.5, n))
    eb.pop("R_p")
    # two rows at R_EB = R_s, the near-unity 0.999 adjustment
    eb["R_EB"][:2] = R_s[:2]
    return time, flux, rows, eb


def test_supersample_times():
    t = np.linspace(-0.1, 0.1, 17)
    for ns in (1, 4, 20):
        np.testing.assert_array_equal(tlc.supersample_times(t, 0.00139, ns),
                                      jlc.supersample_times(t, 0.00139, ns))


@pytest.mark.parametrize("host", [False, True])
class TestBatchParity:
    def test_tp(self, host):
        time, flux, rows, _ = _batch()
        args = [rows[k] for k in ("R_p", "P_orb", "inc", "a", "R_s", "u1",
                                  "u2", "ecc", "argp",
                                  "companion_fluxratio")]
        _flux_close(tlk.simulate_TP_transit_p(time, *args, host, nsamples=8,
                                              device="cpu"),
                    jlk.simulate_TP_transit_p(time, *args, host, nsamples=8))
        _lnl_close(tlk.lnL_TP_p(time, flux, 5e-4, *args, host, nsamples=8,
                                device="cpu"),
                   jlk.lnL_TP_p(time, flux, 5e-4, *args, host, nsamples=8))

    def test_eb(self, host):
        time, flux, _, eb = _batch(seed=1)
        args = [eb[k] for k in ("R_EB", "EB_fluxratio", "P_orb", "inc", "a",
                                "R_s", "u1", "u2", "ecc", "argp",
                                "companion_fluxratio")]
        (gf, gs), (wf, ws) = (
            tlk.simulate_EB_transit_p(time, *args, host, nsamples=8,
                                      device="cpu"),
            jlk.simulate_EB_transit_p(time, *args, host, nsamples=8))
        _flux_close(gf, wf)
        _flux_close(gs, ws)
        # the veto fires on some rows and spares others
        want = jlk.lnL_EB_p(time, flux, 5e-4, *args, host, nsamples=8)
        assert np.isinf(want).any() and np.isfinite(want).any()
        _lnl_close(tlk.lnL_EB_p(time, flux, 5e-4, *args, host, nsamples=8,
                                device="cpu"), want)
        _lnl_close(tlk.lnL_EB_twin_p(time, flux, 5e-4, *args, host,
                                     nsamples=8, device="cpu"),
                   jlk.lnL_EB_twin_p(time, flux, 5e-4, *args, host,
                                     nsamples=8))


@pytest.mark.parametrize("host", [False, True])
@pytest.mark.parametrize("row", [0, 1, 5])
def test_scalar_parity(host, row):
    """Scalar forms on single rows (row 0 and 1: R_EB = R_s)."""
    time, flux, tp, eb = _batch(seed=2)
    tpa = [tp[k][row] for k in ("R_p", "P_orb", "inc", "a", "R_s", "u1",
                                "u2", "ecc", "argp", "companion_fluxratio")]
    eba = [eb[k][row] for k in ("R_EB", "EB_fluxratio", "P_orb", "inc", "a",
                                "R_s", "u1", "u2", "ecc", "argp",
                                "companion_fluxratio")]
    _flux_close(tlk.simulate_TP_transit(time, *tpa, host, device="cpu"),
                jlk.simulate_TP_transit(time, *tpa, host))
    (gf, gs), (wf, ws) = (tlk.simulate_EB_transit(time, *eba, host,
                                                  device="cpu"),
                          jlk.simulate_EB_transit(time, *eba, host))
    _flux_close(gf, wf)
    _flux_close(gs, ws)
    for name, a in (("lnL_TP", tpa), ("lnL_EB", eba), ("lnL_EB_twin", eba)):
        _lnl_close(getattr(tlk, name)(time, flux, 5e-4, *a, host,
                                      device="cpu"),
                   getattr(jlk, name)(time, flux, 5e-4, *a, host))


class TestReferenceCases:
    """tests/test_likelihoods_parity.py's cases on the port."""

    def test_tp_scalar_vs_batch(self):
        time = np.linspace(-0.1, 0.1, 50)
        a = _orbit()
        flux = 1 + np.random.default_rng(0).normal(0, 5e-4, 50)
        Rps = np.array([2.0, 8.0, 14.0])
        incs = np.array([89.5, 89.0, 88.8])
        eccs = np.array([0.0, 0.2, 0.4])
        argps = np.array([90.0, 10.0, 250.0])
        frs = np.array([0.0, 0.3, 0.6])
        batch = tlk.lnL_TP_p(time, flux, 5e-4, Rps, 3.0, incs,
                             np.full(3, a), np.full(3, 1.0), np.full(3, 0.4),
                             np.full(3, 0.2), eccs, argps, frs, device="cpu")
        _lnl_close(batch, jlk.lnL_TP_p(time, flux, 5e-4, Rps, 3.0, incs,
                                       np.full(3, a), np.full(3, 1.0),
                                       np.full(3, 0.4), np.full(3, 0.2),
                                       eccs, argps, frs))
        for i in range(3):
            scalar = tlk.lnL_TP(time, flux, 5e-4, Rps[i], 3.0, incs[i], a,
                                1.0, 0.4, 0.2, eccs[i], argps[i],
                                companion_fluxratio=frs[i], device="cpu")
            assert np.isclose(batch[i], scalar, rtol=1e-5), i

    def test_eb_veto_and_twin(self):
        time = np.linspace(-0.1, 0.1, 50)
        a = _orbit(M=1.6)
        flux = np.ones(50)
        args = (0.6, 0.3, 3.0, 89.5, a, 1.0, 0.4, 0.2, 0.0, 90.0)
        # a deep undiluted EB: secondary depth >> 1.5 sigma, vetoed
        assert tlk.lnL_EB(time, flux, 5e-4, *args, device="cpu") == np.inf
        twin_args = (0.6, 0.3, 6.0) + args[3:]
        lnl_twin = tlk.lnL_EB_twin(time, flux, 5e-4, *twin_args,
                                   device="cpu")
        assert np.isfinite(lnl_twin)
        _lnl_close(lnl_twin, jlk.lnL_EB_twin(time, flux, 5e-4, *twin_args))
        col = [np.array([v]) for v in args]
        b = tlk.lnL_EB_p(time, flux, 5e-4, *col[:2], 3.0, *col[3:],
                         np.array([0.0]), device="cpu")
        assert b[0] == np.inf
        colt = [np.array([v]) for v in twin_args]
        bt = tlk.lnL_EB_twin_p(time, flux, 5e-4, *colt[:2], 6.0, *colt[3:],
                               np.array([0.0]), device="cpu")
        assert np.isclose(bt[0], lnl_twin, rtol=1e-5)

    def test_dilution_directions(self):
        """companion_is_host flips which flux dilutes the eclipse
        (reference likelihoods.py:74-79): depth ratio 0.3 / 0.7."""
        time = np.linspace(-0.05, 0.05, 30)
        a = _orbit()
        depth = {}
        for host in (True, False):
            f = tlk.simulate_TP_transit(time, 10.0, 3.0, 90.0, a, 1.0, 0.4,
                                        0.2, 0.0, 90.0,
                                        companion_fluxratio=0.3,
                                        companion_is_host=host, device="cpu")
            _flux_close(f, jlk.simulate_TP_transit(
                time, 10.0, 3.0, 90.0, a, 1.0, 0.4, 0.2, 0.0, 90.0,
                companion_fluxratio=0.3, companion_is_host=host))
            depth[host] = 1 - f.min()
        assert np.isclose(depth[True] / depth[False], 0.3 / 0.7, rtol=1e-3)

    def test_eb_secdepth_algebra(self):
        """A diluting companion lowers the secondary depth (reference
        likelihoods.py:150-159)."""
        time = np.linspace(-0.05, 0.05, 30)
        a = _orbit(M=1.5)
        args = (0.5, 0.25, 3.0, 90.0, a, 1.0, 0.4, 0.2, 0.0, 90.0)
        sd = {}
        for fr in (0.0, 0.5):
            _, sd[fr] = tlk.simulate_EB_transit(time, *args,
                                                companion_fluxratio=fr,
                                                device="cpu")
            _, want = jlk.simulate_EB_transit(time, *args,
                                              companion_fluxratio=fr)
            _flux_close(sd[fr], want)
        assert sd[0.5] < sd[0.0]
