"""Port vs JAX reference for the TRILEGAL background rows: the csv parser
(funcs.trilegal_results), the synthetic population writer, the per-star
LDC lookup, the packed background table, the samplers
sample_background_planet (DTP / BTP) and sample_background_eb (DEB / BEB)
and the evidences lnZ_DTP, lnZ_DEB, lnZ_BTP, lnZ_BEB, on shared numpy
uniforms and shared star indices.

Tolerances as in test_torch_companions.py: f32 round-off for the
samplers, 1e-2 nats for the evidences. The host-side numpy code (parser,
writer, LDC lookup) is compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import triceratops_tpu.scenarios.engine as jeng
from triceratops_tpu.scenarios import api as japi
from triceratops_tpu.populations import ldc as jldc
from triceratops_tpu.populations.synthetic import (
    make_synthetic_trilegal as j_make_trilegal)
from triceratops_tpu import funcs as jfuncs
from triceratops_tpu_torch.scenarios import engine as teng
from triceratops_tpu_torch.scenarios import api as tapi
from triceratops_tpu_torch.populations import ldc as tldc
from triceratops_tpu_torch.populations.synthetic import (
    make_synthetic_trilegal as t_make_trilegal)
from triceratops_tpu_torch import funcs as tfuncs

from test_torch_shared import f32, tf, shared_uniforms  # noqa: F401
from test_torch_scenarios import _check_dict, _lc
from test_torch_companions import SEPS, DMAGS, cc_file  # noqa: F401

F32 = np.float32
MAGS = (10.0, 9.3, 9.1, 9.0)   # target Tmag, Jmag, Hmag, Kmag


@pytest.fixture
def trilegal(tmp_path):
    """A 300-star synthetic TRILEGAL field written by the port."""
    return t_make_trilegal(tmp_path / "tri.csv", Tmag_target=MAGS[0],
                           n_stars=300, seed=3)


class TestHostTables:
    def test_make_synthetic_trilegal(self, tmp_path):
        got = pd.read_csv(t_make_trilegal(tmp_path / "t.csv", 9.7, 500, 42))
        want = pd.read_csv(j_make_trilegal(tmp_path / "j.csv", 9.7, 500, 42))
        pd.testing.assert_frame_equal(got, want, check_exact=True)

    @pytest.mark.parametrize("tess_column", [True, False])
    def test_trilegal_results(self, trilegal, tmp_path, tess_column):
        path = trilegal
        if not tess_column:
            # an older TRILEGAL table: Tmag from J - Ks (Stassun et al.)
            df = pd.read_csv(trilegal, index_col=0).drop(columns="TESS")
            path = str(tmp_path / "no_tess.csv")
            df.to_csv(path)
        got = tfuncs.trilegal_results(path, 12.0)
        want = jfuncs.trilegal_results(path, 12.0)
        assert len(got[0]) < 300     # the faintness cut and the banner rows
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)

    @pytest.mark.parametrize("mission", ["TESS", "Kepler"])
    def test_lookup_stars(self, mission):
        rng = np.random.default_rng(5)
        teffs = rng.uniform(2500, 14000, 3000)
        loggs = rng.uniform(2.0, 5.5, 3000)
        zs = rng.uniform(-1.5, 0.6, 3000)
        for g, w in zip(tldc.lookup_stars(teffs, loggs, zs, mission),
                        jldc.lookup_stars(teffs, loggs, zs, mission)):
            np.testing.assert_array_equal(g, w)

    @pytest.mark.parametrize("filt", ["TESS", "J", "H", "K"])
    def test_prep_background(self, trilegal, filt):
        for need_ldc, need_cc in ((False, False), (True, True)):
            got, n_got = tapi._prep_background(trilegal, *MAGS, "TESS", filt,
                                               need_ldc, "cpu", need_cc)
            want, n_want = japi._prep_background(trilegal, *MAGS, "TESS",
                                                 filt, need_ldc, need_cc)
            assert n_got == n_want
            np.testing.assert_array_equal(got["pack"].numpy(),
                                          np.asarray(want["pack"]))


def _bg_pair(path, filt, need_ldc, need_cc):
    want, n = japi._prep_background(path, *MAGS, "TESS", filt, need_ldc,
                                    need_cc)
    got, _ = tapi._prep_background(path, *MAGS, "TESS", filt, need_ldc, "cpu",
                                   need_cc)
    return want, got, n


def _curve_args(curve):
    seps, cons = (SEPS, DMAGS) if curve else (f32([2.2]), f32([1.0]))
    return (jnp.asarray(seps), jnp.asarray(cons)), (tf(seps), tf(cons))


@pytest.mark.usefixtures("shared_uniforms")
class TestBackgroundSamplers:
    N = 4096
    common = tuple(F32(x) for x in (2.0, 4.0, 1.05, 1.02))

    @pytest.mark.parametrize("host_is_bg", [False, True])
    @pytest.mark.parametrize("has_cc,stratified", [(False, True),
                                                   (True, False)])
    def test_sample_background_planet(self, trilegal, host_is_bg, has_cc,
                                      stratified):
        jbg, tbg, n = _bg_pair(trilegal, "K" if has_cc else "TESS",
                               host_is_bg, False)
        jc, tc = _curve_args(has_cc)
        kw = dict(N=self.N, flatpriors=False, has_cc=has_cc,
                  host_is_bg=host_is_bg, stratified=stratified)
        want = jeng.sample_background_planet(jax.random.key(0), *self.common,
                                             jbg, *jc, **kw)
        got = teng.sample_background_planet(torch.Generator(), *self.common,
                                            tbg, *tc, **kw)
        assert set(got) == set(want)
        _check_dict(got, dict(want))
        # the index quirk: DTP never draws the last star, BTP does
        assert int(got["idxs"].max()) == (n - 1 if host_is_bg else n - 2)

    @pytest.mark.parametrize("host_is_bg", [False, True])
    @pytest.mark.parametrize("has_cc,stratified,twin_n",
                             [(False, True, 1024), (True, True, 1024),
                              (False, False, 0)])
    def test_sample_background_eb(self, trilegal, host_is_bg, has_cc,
                                  stratified, twin_n):
        jbg, tbg, _ = _bg_pair(trilegal, "H" if has_cc else "TESS",
                               host_is_bg, host_is_bg)
        jc, tc = _curve_args(has_cc)
        kw = dict(N=self.N, has_cc=has_cc, host_is_bg=host_is_bg,
                  cc_filt="H" if has_cc else "TESS", stratified=stratified,
                  twin_n=twin_n)
        T = F32(5900.0)
        want = jeng.sample_background_eb(jax.random.key(0), *self.common, T,
                                         jbg, *jc, **kw)
        got = teng.sample_background_eb(torch.Generator(), *self.common, T,
                                        tbg, *tc, **kw)
        assert set(got) == set(want)
        assert set(got["twin"]) == set(want["twin"])
        _check_dict(got, dict(want))


@pytest.mark.usefixtures("shared_uniforms")
class TestBackgroundEvidence:
    """lnZ within 1e-2 nats on shared uniforms and indices; the reference
    runs its CPU path (XLA fast core). The cases here are those the
    whole-calc_probs test (test_torch_slice.py, no curve or a K-band
    curve, importance sampling on) does not run."""

    kw = dict(N=8192, nsamples=4, exptime=0.00139)

    @pytest.mark.parametrize("name", ["DTP", "BTP"])
    def test_planet_rows(self, name, trilegal, cc_file):
        time, flux = _lc()
        extra = dict(contrast_curve_file=cc_file, filt="J")
        star = (1.0, 1.0, 5800.0) + ((0.0,) if name == "DTP" else ())
        args = (time, flux, 5e-4, 3.0, *star, *MAGS, trilegal)
        want = getattr(japi, f"lnZ_{name}")(*args, key=jax.random.key(0),
                                            **extra, **self.kw)
        got = getattr(tapi, f"lnZ_{name}")(*args, device="cpu", **extra,
                                           **self.kw)
        lz_g, lz_w = float(got["lnZ"]), float(want["lnZ"])
        assert np.isfinite(lz_w)
        assert abs(lz_g - lz_w) < 1e-2, (lz_g, lz_w)

    @pytest.mark.parametrize("name", ["DEB", "BEB"])
    @pytest.mark.parametrize("curve,importance_sampling",
                             [(True, False), (False, False)])
    def test_eb_rows(self, name, curve, importance_sampling, trilegal,
                     cc_file):
        time, flux = _lc(seed=1)
        extra = dict(contrast_curve_file=cc_file, filt="H") if curve else {}
        star = (1.0, 1.0, 5800.0) + ((0.0,) if name == "DEB" else ())
        args = (time, flux, 5e-4, [2.0, 4.0], *star, *MAGS, trilegal)
        want = getattr(japi, f"lnZ_{name}")(
            *args, key=jax.random.key(0),
            importance_sampling=importance_sampling, **extra, **self.kw)
        got = getattr(tapi, f"lnZ_{name}")(
            *args, device="cpu", importance_sampling=importance_sampling,
            **extra, **self.kw)
        for g, w in zip(got, want):
            lz_g, lz_w = float(g["lnZ"]), float(w["lnZ"])
            assert np.isfinite(lz_w)
            assert abs(lz_g - lz_w) < 1e-2, (lz_g, lz_w)
