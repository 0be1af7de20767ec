"""Port vs JAX reference on shared uniforms: the samplers
(priors/samplers.py, populations/stellar.py, scenarios/engine.py) and the
scenario evidences lnZ_TTP / lnZ_TEB (scenarios/api.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import triceratops_tpu.scenarios.engine as jeng
from triceratops_tpu.scenarios import api as japi
from triceratops_tpu.populations import stellar as jst
from triceratops_tpu.priors import samplers as jsm
from triceratops_tpu_torch.scenarios import engine as teng
from triceratops_tpu_torch.scenarios import api as tapi
from triceratops_tpu_torch.populations import stellar as tst
from triceratops_tpu_torch.priors import samplers as tsm

from test_torch_shared import f32, tf, shared_uniforms  # noqa: F401

F32 = np.float32


def _close(got, want, name, rtol=1e-4, atol=1e-5):
    """Same uniforms through the same f32 formulas: equal up to f32
    round-off. Transcendentals differ by ~1 ulp between the two
    libraries, and arccos near cos(inc) = 1 or cos(inc) near 0 in the
    impact parameter amplify that, hence rtol 1e-4 and atol 1e-5 (2e-4
    degrees for the inclinations)."""
    if name.split(".")[-1] in ("inc", "incs"):
        atol = 2e-4
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=name)


class TestPriorSamplers:
    def test_samplers_match(self):
        rng = np.random.default_rng(0)
        u = f32(rng.random(20000))
        M = f32(rng.uniform(0.05, 2.0, 20000))
        for flat in (False, True):
            _close(tsm.sample_rp(tf(u), tf(M), flat),
                   jsm.sample_rp(jnp.asarray(u), jnp.asarray(M), flat), "rp")
        _close(tsm.sample_inc(tf(u)), jsm.sample_inc(jnp.asarray(u)), "inc")
        _close(tsm.sample_w(tf(u)), jsm.sample_w(jnp.asarray(u)), "w")
        # the Beta PPF: same Chebyshev constants and recurrence in f32
        _close(tsm.sample_ecc(tf(u), True, None),
               jsm.sample_ecc(jnp.asarray(u), True, None), "ecc planet",
               atol=2e-6)
        for P in (5.0, 20.0):
            _close(tsm.sample_ecc(tf(u), False, torch.tensor(P)),
                   jsm.sample_ecc(jnp.asarray(u), False, jnp.float32(P)),
                   "ecc binary")
        for Ms in (0.08, 0.2, 0.5, 1.0, 1.5):
            _close(tsm.sample_q(tf(u), torch.tensor(Ms, dtype=torch.float32)),
                   jsm.sample_q(jnp.asarray(u), jnp.float32(Ms)), "q")
            _close(tsm.q_below_twin_cdf(torch.tensor(Ms, dtype=torch.float32)),
                   jsm.q_below_twin_cdf(jnp.float32(Ms)), "q95")

    def test_stellar_relations_match(self):
        """searchsorted + Horner against the reference's select chain on
        the same f32 PPoly tables, across every interval and both
        extrapolated ends."""
        m = f32(np.concatenate([np.linspace(0.02, 3.5, 4000), [0.63, 1.0]]))
        rt, tt = tst.stellar_relations(tf(m), tf(np.full(m.size, 1.2)),
                                       tf(np.full(m.size, 6000.0)))
        rj, tj = jst.stellar_relations(jnp.asarray(m),
                                       jnp.full(m.size, 1.2, jnp.float32),
                                       jnp.full(m.size, 6000.0, jnp.float32),
                                       xp=jnp)
        _close(rt, rj, "radii")
        _close(tt, tj, "teffs", rtol=1e-6)
        for filt in ("TESS", "J", "H", "K"):
            _close(tst.flux_relation(tf(m), filt),
                   jst.flux_relation(jnp.asarray(m), filt, xp=jnp), filt)


def _check_dict(got, want, prefix=""):
    for name, w in want.items():
        if name == "twin":
            _check_dict(got["twin"], w, "twin.")
            continue
        _close(got[name], w, prefix + name)


@pytest.mark.usefixtures("shared_uniforms")
class TestEngineSamplers:
    @pytest.mark.parametrize("stratified", [True, False])
    def test_sample_planet_target(self, stratified):
        N = 8192
        want = jeng.sample_planet_target(
            jax.random.key(0), F32(3.0), F32(3.0), F32(1.05), F32(1.02), N=N,
            flatpriors=False, stratified=stratified)
        got = teng.sample_planet_target(
            torch.Generator(), F32(3.0), F32(3.0), F32(1.05), F32(1.02), N=N,
            flatpriors=False, stratified=stratified)
        assert set(got) == set(want)
        _check_dict(got, dict(want))

    @pytest.mark.parametrize("stratified,twin_n", [(True, 2048), (False, 0)])
    def test_sample_teb(self, stratified, twin_n):
        N = 8192
        want = jeng.sample_teb(jax.random.key(0), F32(2.0), F32(4.0),
                               F32(1.05), F32(1.02), F32(5900.0), N=N,
                               stratified=stratified, twin_n=twin_n)
        got = teng.sample_teb(torch.Generator(), F32(2.0), F32(4.0),
                              F32(1.05), F32(1.02), F32(5900.0), N=N,
                              stratified=stratified, twin_n=twin_n)
        assert set(got) == set(want)
        assert set(got["twin"]) == set(want["twin"])
        _check_dict(got, dict(want))


def _lc(n_t=50, seed=0):
    from triceratops_tpu_torch.core.kepler import projected_z
    from triceratops_tpu_torch.ops.occult import occult_quad_deficit

    time = np.linspace(-0.15, 0.15, n_t)
    t64 = torch.as_tensor(time)
    c = lambda v: torch.tensor(v, dtype=torch.float64)  # noqa: E731
    z, front = projected_z(t64, 0.0, c(3.0), c(9.6), c(np.deg2rad(89.5)),
                           c(0.0), c(0.0))
    D = occult_quad_deficit(c(0.08), z, c(0.4), c(0.2)) * front
    rng = np.random.default_rng(seed)
    return time, 1.0 - D.numpy() + rng.normal(0, 5e-4, n_t)


@pytest.mark.usefixtures("shared_uniforms")
class TestScenarioEvidence:
    """lnZ within 1e-2 nats on shared uniforms (the evidence-level gate of
    test_pallas_core.py): per-draw f32 reordering noise washes out in the
    log-mean-exp. The reference runs its CPU path (XLA fast core)."""

    kw = dict(N=8192, nsamples=4, exptime=0.00139)

    def test_lnZ_TTP(self):
        time, flux = _lc()
        want = japi.lnZ_TTP(time, flux, 5e-4, 3.0, 1.0, 1.0, 5800.0, 0.0,
                            key=jax.random.key(0), **self.kw)
        got = tapi.lnZ_TTP(time, flux, 5e-4, 3.0, 1.0, 1.0, 5800.0, 0.0,
                           device="cpu", **self.kw)
        assert abs(float(got["lnZ"]) - float(want["lnZ"])) < 1e-2
        _close(got["P_orb"][:1], np.asarray(want["P_orb"])[:1], "P_orb")

    @pytest.mark.parametrize("importance_sampling", [True, False])
    def test_lnZ_TEB(self, importance_sampling):
        time, flux = _lc(seed=1)
        want = japi.lnZ_TEB(time, flux, 5e-4, [2.0, 4.0], 1.0, 1.0, 5800.0,
                            0.0, key=jax.random.key(0),
                            importance_sampling=importance_sampling,
                            **self.kw)
        got = tapi.lnZ_TEB(time, flux, 5e-4, [2.0, 4.0], 1.0, 1.0, 5800.0,
                           0.0, device="cpu",
                           importance_sampling=importance_sampling,
                           **self.kw)
        for g, w in zip(got, want):
            lz_g, lz_w = float(g["lnZ"]), float(w["lnZ"])
            assert np.isfinite(lz_w)
            assert abs(lz_g - lz_w) < 1e-2, (lz_g, lz_w)
