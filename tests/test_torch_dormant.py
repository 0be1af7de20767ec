"""Port vs JAX reference for the four dormant nearby-star scenarios of
hosts with unknown or evolved properties: the lookalike table
(api._prep_lookalikes), the empty-population results, the samplers
sample_ntp_unknown / sample_neb_unknown / sample_neb_evolved
(scenarios/engine.py) and the evidences lnZ_NTP_unknown,
lnZ_NEB_unknown, lnZ_NTP_evolved, lnZ_NEB_evolved (scenarios/api.py), on
shared numpy uniforms and shared star indices.

Tolerances as in test_torch_companions.py: f32 round-off for the
samplers (rtol 1e-4, atol 1e-5), 1e-2 nats for the evidences. The
lookalike table is host numpy code cast once to f32 and compared exactly.
"""

import os

import jax
import numpy as np
import pandas as pd
import pytest
import torch

import triceratops_tpu.scenarios.engine as jeng
from triceratops_tpu.scenarios import api as japi
from triceratops_tpu_torch.scenarios import engine as teng
from triceratops_tpu_torch.scenarios import api as tapi
from triceratops_tpu_torch.populations.synthetic import (
    make_synthetic_trilegal)

from test_torch_shared import shared_uniforms  # noqa: F401
from test_torch_scenarios import _check_dict, _lc

F32 = np.float32
TMAG = 14.0    # inside the synthetic field: a non-empty lookalike set


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's small CPU tensors: the suite
    runs in several worker processes on shared cores, where torch's
    default of one thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def trilegal(tmp_path):
    """A 300-star synthetic TRILEGAL field fainter than Tmag 10."""
    return make_synthetic_trilegal(tmp_path / "tri.csv", Tmag_target=10.0,
                                   n_stars=300, seed=3)


def _pop_pair(path, mission="TESS"):
    want, n = japi._prep_lookalikes(path, TMAG, mission)
    got, n_got = tapi._prep_lookalikes(path, TMAG, mission, "cpu")
    assert n_got == n > 0
    return want, got


class TestLookalikes:
    @pytest.mark.parametrize("mission", ["TESS", "Kepler"])
    def test_prep_lookalikes_exact(self, trilegal, mission):
        want, got = _pop_pair(trilegal, mission)
        np.testing.assert_array_equal(got["pack"].numpy(),
                                      np.asarray(want["pack"]))
        # the strict Tmag - 1 < Tmag_i < Tmag + 1 window, of the stars the
        # parser keeps (Tmag_i >= Tmag)
        t = pd.read_csv(trilegal)[:-2]["TESS"].to_numpy()
        t = t[t >= TMAG]
        assert got["pack"].shape[0] == int(((t > TMAG - 1)
                                            & (t < TMAG + 1)).sum())

    def test_cache_follows_a_rewritten_file(self, trilegal):
        _, n0 = tapi._prep_lookalikes(trilegal, TMAG, "TESS", "cpu")
        # same path, fewer stars: the file signature changes
        df = pd.read_csv(trilegal, index_col=0)
        df.iloc[::2].to_csv(trilegal)
        st = os.stat(trilegal)
        os.utime(trilegal, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
        got, n1 = tapi._prep_lookalikes(trilegal, TMAG, "TESS", "cpu")
        want, n_want = japi._prep_lookalikes(trilegal, TMAG, "TESS")
        assert n1 == n_want and 0 < n1 < n0
        np.testing.assert_array_equal(got["pack"].numpy(),
                                      np.asarray(want["pack"]))

    @pytest.mark.parametrize("name", ["NTP_unknown", "NEB_unknown"])
    def test_empty_population(self, name, trilegal):
        """No lookalike (the field is fainter than Tmag + 1): the
        reference's empty result, key for key (NTP's has no "b")."""
        time, flux = _lc()
        args = (time, flux, 5e-4, 3.0, -5.0, trilegal)
        want = getattr(japi, f"lnZ_{name}")(*args, N=256,
                                            key=jax.random.key(0))
        got = getattr(tapi, f"lnZ_{name}")(*args, N=256, device="cpu")
        assert list(got) == list(want)
        assert got == want
        assert np.isneginf(got["lnZ"])
        assert ("b" in got) == (name == "NEB_unknown")


@pytest.mark.usefixtures("shared_uniforms")
class TestDormantSamplers:
    N = 4096

    @pytest.mark.parametrize("stratified", [True, False])
    def test_sample_ntp_unknown(self, trilegal, stratified):
        jpop, tpop = _pop_pair(trilegal)
        kw = dict(N=self.N, flatpriors=False, stratified=stratified)
        want = jeng.sample_ntp_unknown(jax.random.key(0), F32(2.0), F32(4.0),
                                       jpop, **kw)
        got = teng.sample_ntp_unknown(torch.Generator(), F32(2.0), F32(4.0),
                                      tpop, **kw)
        assert set(got) == set(want)
        _check_dict(got, dict(want))

    @pytest.mark.parametrize("stratified,twin_n", [(True, 1024), (False, 0)])
    def test_sample_neb_unknown(self, trilegal, stratified, twin_n):
        jpop, tpop = _pop_pair(trilegal)
        kw = dict(N=self.N, stratified=stratified, twin_n=twin_n)
        want = jeng.sample_neb_unknown(jax.random.key(0), F32(2.0), F32(4.0),
                                       jpop, **kw)
        got = teng.sample_neb_unknown(torch.Generator(), F32(2.0), F32(4.0),
                                      tpop, **kw)
        assert set(got) == set(want)
        assert set(got["twin"]) == set(want["twin"])
        _check_dict(got, dict(want))

    @pytest.mark.parametrize("stratified,twin_n", [(True, 1024), (False, 0)])
    def test_sample_neb_evolved(self, stratified, twin_n):
        R_s = 2.0
        M_s = F32(tapi._evolved_mass(R_s))
        args = (F32(0.8), F32(1.2), M_s, F32(R_s), F32(5200.0))
        kw = dict(N=self.N, stratified=stratified, twin_n=twin_n)
        want = jeng.sample_neb_evolved(jax.random.key(0), *args, **kw)
        got = teng.sample_neb_evolved(torch.Generator(), *args, **kw)
        assert set(got) == set(want)
        assert set(got["twin"]) == set(want["twin"])
        _check_dict(got, dict(want))
        # the twin quirks: k = ksec = 0.999 (R_EB = R_s), 2 R_s collision
        tw = got["twin"]
        np.testing.assert_allclose(tw["k"].numpy(), 0.999, rtol=1e-6)
        np.testing.assert_allclose(tw["ksec"].numpy(), 0.999, rtol=1e-6)
        assert not (tw["mask"] & (2.0 * R_s * teng.RSUN
                                  > tw["a"] * (1.0 - tw["eccs"]))).any()


@pytest.mark.usefixtures("shared_uniforms")
class TestDormantEvidence:
    """lnZ within 1e-2 nats on shared uniforms and indices; the reference
    runs its CPU path (XLA fast core)."""

    kw = dict(N=8192, nsamples=4, exptime=0.00139)

    def _pairs(self, name, args, **extra):
        want = getattr(japi, f"lnZ_{name}")(*args, key=jax.random.key(0),
                                            **extra, **self.kw)
        got = getattr(tapi, f"lnZ_{name}")(*args, device="cpu", **extra,
                                           **self.kw)
        if isinstance(want, dict):
            return [(got, want)]
        assert len(got) == len(want) == 2
        return list(zip(got, want))

    @pytest.mark.parametrize("name", ["NTP_unknown", "NEB_unknown"])
    def test_unknown(self, name, trilegal):
        time, flux = _lc(seed=1 if name == "NEB_unknown" else 0)
        period = [2.0, 4.0] if name == "NEB_unknown" else 3.0
        for g, w in self._pairs(name, (time, flux, 5e-4, period, TMAG,
                                       trilegal)):
            assert set(g) == set(w)
            lz_g, lz_w = float(g["lnZ"]), float(w["lnZ"])
            assert np.isfinite(lz_w)
            assert abs(lz_g - lz_w) < 1e-2, (lz_g, lz_w)

    @pytest.mark.parametrize("name,sigma,importance_sampling",
                             [("NTP_evolved", 5e-4, True),
                              ("NEB_evolved", 3e-2, True),
                              ("NEB_evolved", 5e-4, False)])
    def test_evolved(self, name, sigma, importance_sampling):
        """R_s = 2.0 sets M_s = 0.146: every EB draw's flux ratio is then
        above 1.5 x 5e-4, so at sigma = 5e-4 the secondary veto empties
        NEB_evolved's normal branch (lnZ = -inf in both packages); at
        sigma = 3e-2 it keeps draws. The legacy shared-draw twin runs at
        sigma = 5e-4."""
        time, flux = _lc(seed=1)
        pairs = self._pairs(name, (time, flux, sigma, [2.0, 4.0], 2.0,
                                   5200.0, 0.0),
                            importance_sampling=importance_sampling)
        vetoed = name == "NEB_evolved" and sigma == 5e-4
        for i, (g, w) in enumerate(pairs):
            assert set(g) == set(w)
            lz_g, lz_w = float(g["lnZ"]), float(w["lnZ"])
            if vetoed and i == 0:
                assert np.isneginf(lz_w) and np.isneginf(lz_g)
                continue
            assert np.isfinite(lz_w)
            assert abs(lz_g - lz_w) < 1e-2, (lz_g, lz_w)
            np.testing.assert_allclose(np.asarray(g["M_s"]),
                                       np.asarray(w["M_s"]), rtol=1e-12)
        if name == "NEB_evolved":
            np.testing.assert_array_equal(pairs[1][0]["R_EB"],
                                          np.full(100, 2.0))
