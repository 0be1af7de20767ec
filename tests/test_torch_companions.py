"""Port vs JAX reference for the bound-companion rows: the companion priors
(priors/companion.py), the companion mass-ratio law, the MOLUSC loader,
the nearest-Z LDC grid, the samplers sample_ptp / sample_stp / sample_peb
/ sample_seb (scenarios/engine.py) and the evidences lnZ_PTP, lnZ_PEB,
lnZ_STP, lnZ_SEB (scenarios/api.py), on shared numpy uniforms.

Tolerances: the samplers and priors run the same f32 formulas on the same
uniforms, so they agree to f32 round-off (``test_torch_scenarios._close``:
rtol 1e-4, atol 1e-5; the JAX tests of the same functions,
tests/test_priors_parity.py and tests/test_samplers.py, gate at 1e-5 to
1e-6 in float64). The evidences agree within 1e-2 nats, the
evidence-level gate of tests/test_pallas_core.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import triceratops_tpu.scenarios.engine as jeng
from triceratops_tpu.scenarios import api as japi
from triceratops_tpu.priors import companion as jco
from triceratops_tpu.priors import samplers as jsm
from triceratops_tpu.populations import ldc as jldc
from triceratops_tpu.populations import molusc as jmol
from triceratops_tpu import funcs as jfuncs
from triceratops_tpu_torch.scenarios import engine as teng
from triceratops_tpu_torch.scenarios import api as tapi
from triceratops_tpu_torch.priors import companion as tco
from triceratops_tpu_torch.priors import samplers as tsm
from triceratops_tpu_torch.populations import ldc as tldc
from triceratops_tpu_torch.populations import molusc as tmol
from triceratops_tpu_torch import funcs as tfuncs

from test_torch_shared import f32, tf, shared_uniforms  # noqa: F401
from test_torch_scenarios import _check_dict, _close, _lc

F32 = np.float32
SEPS = f32([0.1, 0.2, 0.5, 1.0, 2.0, 3.0])
DMAGS = f32([1.5, 3.0, 5.0, 6.5, 7.5, 8.0])


@pytest.fixture
def cc_file(tmp_path):
    """A contrast curve: (arcsec, delta mag) rows, delta mag negative as
    instruments write it (file_to_contrast_curve takes |delta mag|)."""
    path = tmp_path / "cc.csv"
    np.savetxt(path, np.c_[SEPS, -DMAGS], delimiter=",")
    return str(path)


@pytest.fixture
def molusc_file(tmp_path):
    """A MOLUSC posterior of 3000 rows, about half of them past the
    periastron cut."""
    import pandas as pd

    rng = np.random.default_rng(7)
    n = 3000
    path = tmp_path / "molusc.csv"
    pd.DataFrame({"semi-major axis(AU)": 10 ** rng.uniform(0, 3, n),
                  "eccentricity": rng.uniform(0, 0.9, n),
                  "mass ratio": rng.uniform(0.02, 1.0, n)}).to_csv(path)
    return str(path)


class TestCompanionPriors:
    def test_separation_at_contrast(self):
        x = f32(np.linspace(-1.0, 10.0, 2001))
        for seps, cons in ((SEPS, DMAGS), (f32([2.2]), f32([1.0]))):
            got = tco.separation_at_contrast(tf(x), tf(seps), tf(cons))
            want = jco.separation_at_contrast(jnp.asarray(x),
                                              jnp.asarray(seps),
                                              jnp.asarray(cons))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-7)

    @pytest.mark.parametrize("M_s", [0.5, 1.0, 1.3])
    @pytest.mark.parametrize("plx", [11.0, np.nan])
    @pytest.mark.parametrize("curve", [False, True])
    def test_bound_and_background_priors(self, M_s, plx, curve):
        """The bound priors against the JAX package on float64 inputs
        (upstream's arithmetic; in float32 its Pmax overflows, module
        priors/companion.py), the background prior in float32."""
        seps, cons = (SEPS, DMAGS) if curve else (f32([2.2]), f32([1.0]))
        dm = f32(np.linspace(-2.0, 12.0, 4001))
        targs = (torch.tensor(M_s, dtype=torch.float32),
                 torch.tensor(plx, dtype=torch.float32), tf(np.abs(dm)),
                 tf(seps), tf(cons))
        jargs = (jnp.float32(M_s), jnp.float32(plx),
                 jnp.asarray(np.abs(dm)), jnp.asarray(seps),
                 jnp.asarray(cons))
        jargs64 = tuple(jnp.asarray(a, jnp.float64) for a in jargs)
        for name in ("lnprior_bound_TP", "lnprior_bound_EB"):
            got = tco.clamp_companion_prior(getattr(tco, name)(*targs), tf(dm))
            want = jco.clamp_companion_prior(getattr(jco, name)(*jargs64),
                                             jnp.asarray(dm, jnp.float64))
            _close(got, want, name, rtol=1e-5)
        _close(tco.lnprior_background(2999, *targs[2:]),
               jco.lnprior_background(2999, *jargs[2:]), "background",
               rtol=1e-5)

    def test_host_priors(self):
        assert tco.lnprior_Mstar_planet(1.0) == jco.lnprior_Mstar_planet(1.0)
        assert tco.lnprior_Mstar_binary(1.0) == jco.lnprior_Mstar_binary(1.0)
        for P in (0.3, 5.0, 9.95, 10.0, 30.0):
            assert tco.lnprior_Porb_planet(P) == jco.lnprior_Porb_planet(P)
            assert (tco.lnprior_Porb_planet(P, True)
                    == jco.lnprior_Porb_planet(P, True))
            assert tco.lnprior_Porb_binary(P) == jco.lnprior_Porb_binary(P)

    def test_sample_q_companion(self):
        u = f32(np.random.default_rng(3).random(20000))
        for Ms in (0.08, 0.2, 0.5, 1.0, 1.5):
            _close(tsm.sample_q_companion(tf(u), torch.tensor(
                       Ms, dtype=torch.float32)),
                   jsm.sample_q_companion(jnp.asarray(u), jnp.float32(Ms)),
                   f"q_comp {Ms}")


class TestHostInputs:
    def test_contrast_curve_file(self, cc_file):
        for g, w in zip(tfuncs.file_to_contrast_curve(cc_file),
                        jfuncs.file_to_contrast_curve(cc_file)):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(
            tfuncs.separation_at_contrast(DMAGS + 0.3, SEPS, DMAGS),
            jfuncs.separation_at_contrast(DMAGS + 0.3, SEPS, DMAGS))

    def test_load_molusc(self, molusc_file):
        for M_s in (0.6, 1.1):
            got = tmol.load_molusc_qs(molusc_file, M_s, 4096)
            np.testing.assert_array_equal(
                got, jmol.load_molusc_qs(molusc_file, M_s, 4096))
            kept = tmol.load_molusc_kept(molusc_file, M_s)
            assert 0 < len(kept) < 4096 and (kept >= 0.1 / M_s).all()
            assert (got[len(kept):] == 0).all()
        with pytest.raises(ValueError, match="increase N"):
            tmol.load_molusc_qs(molusc_file, 1.0, 64)

    @pytest.mark.parametrize("mission", ["TESS", "Kepler"])
    def test_grid_at_Z_and_round_index(self, mission):
        for Z, teff_max in ((0.0, 10000), (0.3, 13000), (-0.7, 10000)):
            for g, w in zip(tldc.grid_at_Z(Z, mission, teff_max),
                            jldc.grid_at_Z(Z, mission, teff_max)):
                np.testing.assert_array_equal(g, w)
        # half-way points round to even in both (numpy / jnp.round)
        logg = f32([3.0, 3.75, 4.25, 4.49, 4.75, 5.25, 6.0])
        teff = f32([2000, 3625, 3875, 5000, 6125, 9875, 20000])
        for n_teff in (27, 39):
            got = tldc.round_index_comp(tf(logg), tf(teff), n_teff)
            want = jldc.round_index_comp(jnp.asarray(logg), jnp.asarray(teff),
                                         n_teff, xp=jnp)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _common(P_lo=2.0, P_hi=4.0, M_s=1.05, R_s=1.02, Teff=5900.0, plx=11.0):
    return tuple(F32(x) for x in (P_lo, P_hi, M_s, R_s, Teff, plx))


def _companion_inputs(molusc, curve, N, molusc_path=None, M_s=1.05):
    """(qs_in, seps, cons, cc_filt) for both packages."""
    if molusc:
        qs = f32(jmol.load_molusc_qs(molusc_path, M_s, N))
    else:
        qs = np.zeros(N, F32)
    seps, cons = (SEPS, DMAGS) if curve else (f32([2.2]), f32([1.0]))
    return ((jnp.asarray(qs), jnp.asarray(seps), jnp.asarray(cons)),
            (tf(qs), tf(seps), tf(cons)))


def _ldc_tabs(teff_max):
    u1, u2 = jldc.grid_at_Z(0.0, "TESS", teff_max=teff_max)
    return ((jnp.asarray(f32(u1)), jnp.asarray(f32(u2))), (tf(u1), tf(u2)))


# (use_molusc, cc_filt): no constraint, each contrast-curve band, MOLUSC
COMP_CASES = [(False, None), (False, "J"), (False, "H"), (False, "K"),
              (True, None)]


@pytest.mark.usefixtures("shared_uniforms")
class TestCompanionSamplers:
    N = 4096

    @pytest.mark.parametrize("use_molusc,cc_filt", COMP_CASES)
    def test_sample_ptp(self, use_molusc, cc_filt, molusc_file):
        j, t = _companion_inputs(use_molusc, cc_filt, self.N, molusc_file)
        kw = dict(N=self.N, flatpriors=False, use_molusc=use_molusc,
                  cc_filt=cc_filt)
        want = jeng.sample_ptp(jax.random.key(0), *_common(), *j, **kw)
        got = teng.sample_ptp(torch.Generator(), *_common(), *t, **kw)
        assert set(got) == set(want)
        _check_dict(got, dict(want))
        if not use_molusc:
            assert np.isfinite(got["lnprior"].numpy()).any()

    @pytest.mark.parametrize("use_molusc,cc_filt,stratified",
                             [(False, None, True), (False, "K", False),
                              (True, None, True)])
    def test_sample_stp(self, use_molusc, cc_filt, stratified, molusc_file):
        j, t = _companion_inputs(use_molusc, cc_filt, self.N, molusc_file)
        (ju1, ju2), (tu1, tu2) = _ldc_tabs(10000)
        kw = dict(N=self.N, flatpriors=False, use_molusc=use_molusc,
                  cc_filt=cc_filt, stratified=stratified)
        want = jeng.sample_stp(jax.random.key(0), *_common(), j[0], ju1, ju2,
                               *j[1:], **kw)
        got = teng.sample_stp(torch.Generator(), *_common(), t[0], tu1, tu2,
                              *t[1:], **kw)
        assert set(got) == set(want)
        _check_dict(got, dict(want))

    @pytest.mark.parametrize("use_molusc,cc_filt,stratified,twin_n",
                             [(False, None, True, 1024),
                              (False, "H", True, 1024),
                              (True, None, True, 1024),
                              (False, "J", False, 0)])
    def test_sample_peb(self, use_molusc, cc_filt, stratified, twin_n,
                        molusc_file):
        j, t = _companion_inputs(use_molusc, cc_filt, self.N, molusc_file)
        kw = dict(N=self.N, use_molusc=use_molusc, cc_filt=cc_filt,
                  stratified=stratified, twin_n=twin_n)
        want = jeng.sample_peb(jax.random.key(0), *_common(), *j, **kw)
        got = teng.sample_peb(torch.Generator(), *_common(), *t, **kw)
        assert set(got) == set(want)
        assert set(got["twin"]) == set(want["twin"])
        _check_dict(got, dict(want))

    @pytest.mark.parametrize("use_molusc,cc_filt,stratified,twin_n",
                             [(False, None, True, 2048),
                              (True, "J", True, 2048),
                              (False, "K", False, 0)])
    def test_sample_seb(self, use_molusc, cc_filt, stratified, twin_n,
                        molusc_file):
        j, t = _companion_inputs(use_molusc, cc_filt, self.N, molusc_file)
        (ju1, ju2), (tu1, tu2) = _ldc_tabs(13000)
        kw = dict(N=self.N, use_molusc=use_molusc, cc_filt=cc_filt,
                  stratified=stratified, twin_n=twin_n)
        want = jeng.sample_seb(jax.random.key(0), *_common(), j[0], ju1, ju2,
                               *j[1:], **kw)
        got = teng.sample_seb(torch.Generator(), *_common(), t[0], tu1, tu2,
                              *t[1:], **kw)
        assert set(got) == set(want)
        assert set(got["twin"]) == set(want["twin"])
        _check_dict(got, dict(want))


@pytest.mark.usefixtures("shared_uniforms")
class TestCompanionEvidence:
    """lnZ within 1e-2 nats on shared uniforms; the reference runs its CPU
    path (XLA fast core). The cases here are those the whole-calc_probs
    test (test_torch_slice.py) does not run: a contrast curve without a
    MOLUSC file, and the legacy shared-draw twin branch."""

    kw = dict(N=8192, nsamples=4, exptime=0.00139)

    @pytest.mark.parametrize("name", ["PTP", "STP"])
    def test_planet_rows(self, name, cc_file):
        time, flux = _lc()
        extra = dict(contrast_curve_file=cc_file, filt="K")
        args = (time, flux, 5e-4, 3.0, 1.0, 1.0, 5800.0, 0.0, 11.0)
        want = getattr(japi, f"lnZ_{name}")(*args, key=jax.random.key(0),
                                            **extra, **self.kw)
        got = getattr(tapi, f"lnZ_{name}")(*args, device="cpu", **extra,
                                           **self.kw)
        lz_g, lz_w = float(got["lnZ"]), float(want["lnZ"])
        assert np.isfinite(lz_w)
        assert abs(lz_g - lz_w) < 1e-2, (lz_g, lz_w)

    @pytest.mark.parametrize("name", ["PEB", "SEB"])
    @pytest.mark.parametrize("curve,importance_sampling",
                             [(True, True), (False, False)])
    def test_eb_rows(self, name, curve, importance_sampling, cc_file):
        time, flux = _lc(seed=1)
        extra = dict(contrast_curve_file=cc_file, filt="H") if curve else {}
        args = (time, flux, 5e-4, [2.0, 4.0], 1.0, 1.0, 5800.0, 0.0, 11.0)
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
