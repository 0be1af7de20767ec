"""The port as a whole: target.from_stars -> calc_depths -> calc_probs on
a target plus two nearby stars, against the JAX package on shared
uniforms and star indices: the 9 target / nearby-star TP and EB rows with
the companion rows dropped, and every one of the 21 rows with a TRILEGAL
field, with and without a contrast curve and a MOLUSC file."""

import numpy as np
import pandas as pd
import pytest

import triceratops_tpu.scenarios.engine as jeng
from triceratops_tpu import target as jtarget
from triceratops_tpu_torch import target as ttarget

from test_torch_shared import shared_uniforms  # noqa: F401
from test_torch_companions import cc_file, molusc_file  # noqa: F401

UNPORTED = ["PTP", "PEB", "STP", "SEB"]
LIVE_ROWS = [0, 1, 2, 15, 16, 17, 18, 19, 20]
BEST_FIT = ["P_orb", "inc", "b", "ecc", "w", "R_p", "M_EB", "R_EB"]


def _stars():
    rows = [dict(ID="1000", Tmag=10.0, Jmag=9.3, Hmag=9.1, Kmag=9.0,
                 ra=120.0, dec=-30.0, mass=1.0, rad=1.0, Teff=5800.0,
                 plx=20.0, **{"sep (arcsec)": 0.0, "PA (E of N)": 0.0})]
    for i in range(2):
        rows.append(dict(ID=str(2000 + i), Tmag=13.5 + i, Jmag=12.9,
                         Hmag=12.7, Kmag=12.6, ra=120.001, dec=-30.001,
                         mass=0.8, rad=0.8, Teff=5000.0, plx=5.0,
                         **{"sep (arcsec)": 25.0 + 10 * i,
                            "PA (E of N)": 45.0 + 90 * i}))
    return pd.DataFrame(rows)


def _curve(n_t=50):
    from fixtures import make_transit_lightcurve
    time, flux, sigma, _ = make_transit_lightcurve(n_t=n_t, rp_re=8.0,
                                                   sigma=5e-4)
    return time, flux, sigma


@pytest.fixture
def top_two_gaps(monkeypatch):
    """Record, per reference finalize call, the gap between its top two
    lnL (calls come in row order: TP, EB, EBx2P, then NTP, NEB, NEBx2P per
    nearby star)."""
    gaps = []
    real = jeng.run_finalize

    def spy(lnL, lnprior, gather):
        top = np.sort(np.asarray(lnL))[-2:]
        gaps.append(top[1] - top[0])
        return real(lnL, lnprior, gather)

    monkeypatch.setattr(jeng, "run_finalize", spy)
    return gaps


@pytest.mark.usefixtures("shared_uniforms")
@pytest.mark.parametrize("importance_sampling", [True, False])
def test_calc_probs_matches_reference(importance_sampling, top_two_gaps):
    time, flux, sigma = _curve()
    kw = dict(N=8192, nsamples=4, verbose=0, drop_scenario=UNPORTED,
              importance_sampling=importance_sampling)
    ref = jtarget.from_stars(_stars(), ID=1000)
    ref.calc_depths(tdepth=0.005)
    ref.calc_probs(time, flux, sigma, P_orb=3.0, key=0, **kw)
    port = ttarget.from_stars(_stars(), ID=1000)
    port.calc_depths(tdepth=0.005)
    port.calc_probs(time, flux, sigma, P_orb=3.0, key=0, device="cpu", **kw)

    assert list(port.probs["scenario"]) == list(ref.probs["scenario"])
    # every live row computed, every other row at zero weight
    assert np.isfinite(ref.lnZ[LIVE_ROWS]).all()
    dead = np.setdiff1d(np.arange(21), LIVE_ROWS)
    assert np.isneginf(port.lnZ[dead]).all() and np.isneginf(ref.lnZ[dead]).all()
    # per-row lnZ within 1e-2 nats: f32 reordering noise in lnL washes out
    # at the evidence level (test_pallas_core.py evidence gate)
    np.testing.assert_allclose(port.lnZ[LIVE_ROWS], ref.lnZ[LIVE_ROWS],
                               atol=1e-2, rtol=0)
    # FPP / NFPP within 1e-3 absolute (a 1e-2 nat lnZ shift moves a
    # probability by at most ~1% of itself)
    assert abs(port.FPP - ref.FPP) < 1e-3
    assert abs(port.NFPP - ref.NFPP) < 1e-3
    # the best fit is the same draw wherever the reference's winner is
    # clear (top two lnL more than 0.05 apart)
    assert len(top_two_gaps) == len(LIVE_ROWS)
    for row, gap in zip(LIVE_ROWS, top_two_gaps):
        if gap > 0.05:
            got = port.probs.loc[row, BEST_FIT].to_numpy(float)
            want = ref.probs.loc[row, BEST_FIT].to_numpy(float)
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-4,
                                       err_msg=f"row {row}")


@pytest.fixture
def trilegal(tmp_path):
    from triceratops_tpu_torch.populations.synthetic import (
        make_synthetic_trilegal)
    return make_synthetic_trilegal(tmp_path / "tri.csv", Tmag_target=10.0,
                                   n_stars=300, seed=3)


@pytest.mark.usefixtures("shared_uniforms")
@pytest.mark.parametrize("constrained", [False, True])
def test_calc_probs_all_rows_match_reference(constrained, trilegal, cc_file,
                                             molusc_file):
    """All 21 rows (15 target rows with a 300-star TRILEGAL field, NTP /
    NEB / NEBx2P for two nearby stars); constrained: with a K-band
    contrast curve and a MOLUSC file."""
    time, flux, sigma = _curve()
    kw = dict(N=4096, nsamples=4, verbose=0)
    if constrained:
        kw.update(contrast_curve_file=cc_file, filt="K",
                  molusc_file=molusc_file)
    ref = jtarget.from_stars(_stars(), ID=1000, trilegal_fname=trilegal)
    ref.calc_depths(tdepth=0.005)
    ref.calc_probs(time, flux, sigma, P_orb=3.0, key=0, **kw)
    port = ttarget.from_stars(_stars(), ID=1000, trilegal_fname=trilegal)
    port.calc_depths(tdepth=0.005)
    port.calc_probs(time, flux, sigma, P_orb=3.0, key=0, device="cpu", **kw)

    assert list(port.probs["scenario"]) == list(ref.probs["scenario"])
    assert np.isfinite(ref.lnZ).all()
    np.testing.assert_allclose(port.lnZ, ref.lnZ, atol=1e-2, rtol=0)
    assert abs(port.FPP - ref.FPP) < 1e-3
    assert abs(port.NFPP - ref.NFPP) < 1e-3
    np.testing.assert_array_equal(port.star_num, ref.star_num)


def test_calc_probs_without_trilegal_runs_every_other_row():
    """No row needs dropping: without a TRILEGAL file the six background
    rows get zero weight and every other row runs."""
    t = ttarget.from_stars(_stars(), ID=1000)
    t.calc_depths(tdepth=0.005)
    time, flux, sigma = _curve()
    t.calc_probs(time, flux, sigma, P_orb=3.0, N=1024, nsamples=4,
                 device="cpu", verbose=0, key=1)
    background = [9, 10, 11, 12, 13, 14]
    assert list(t.probs["scenario"][background]) == [
        "DTP", "DEB", "DEBx2P", "BTP", "BEB", "BEBx2P"]
    assert np.isneginf(t.lnZ[background]).all()
    assert (t.probs["prob"][background] == 0).all()
    others = np.setdiff1d(np.arange(21), background)
    assert not np.isnan(t.lnZ[others]).any()
    assert np.isfinite(t.lnZ[[0, 1, 3, 6, 15, 18]]).all()
    assert abs(t.probs["prob"].sum() - 1.0) < 1e-9
    assert 0.0 <= t.FPP <= 1.0 and 0.0 <= t.NFPP <= 1.0


def test_calc_probs_before_calc_depths_raises():
    t = ttarget.from_stars(_stars(), ID=1000)
    time, flux, sigma = _curve()
    with pytest.raises(RuntimeError, match="calc_depths"):
        t.calc_probs(time, flux, sigma, P_orb=3.0, N=256, device="cpu")


def test_online_constructor_not_ported(monkeypatch):
    """The online constructor needs the optional network packages: without
    lightkurve it raises ImportError and points to target.from_stars."""
    import sys

    monkeypatch.setitem(sys.modules, "lightkurve", None)
    with pytest.raises(ImportError, match="from_stars"):
        ttarget(1000, [1])
