"""Port vs JAX reference: core/numerics.py, core/kepler.py and
ops/occult.py, on the same numpy inputs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from triceratops_tpu.core import numerics as jnum
from triceratops_tpu.core import kepler as jkep
from triceratops_tpu.ops.occult import occult_quad_deficit as j_occult
from triceratops_tpu_torch.core import numerics as tnum
from triceratops_tpu_torch.core import kepler as tkep
from triceratops_tpu_torch.ops.occult import occult_quad_deficit as t_occult

from test_torch_shared import f32, jf, tf

INF = np.inf


class TestNumerics:
    @pytest.mark.parametrize("lnZ,status", [
        ([-1.0, -2.0, -INF], "ok"),
        ([-INF, -INF, -INF], "all_neginf"),
        ([-1.0, np.nan, -3.0], "anomaly"),
        ([-1.0, INF, -3.0], "anomaly"),
    ])
    def test_normalize_probabilities_status(self, lnZ, status):
        p_t, s_t = tnum.normalize_probabilities(np.array(lnZ))
        p_j, s_j = jnum.normalize_probabilities(np.array(lnZ))
        assert s_t == s_j == status
        np.testing.assert_array_equal(p_t, p_j)

    @pytest.mark.parametrize("logw", [
        [-1.0, -2.5, -INF, 0.3],
        [-1.0, np.nan, -3.0, -INF],
        [-INF, -INF, np.nan, -INF],
        [-1.0, INF, -3.0, -2.0],
    ])
    def test_log_mean_exp_rules(self, logw):
        """-inf/NaN get zero weight but count in N_total; +inf propagates.
        Equal to the host version to float64 round-off."""
        logw = np.array(logw)
        got = float(tnum.log_mean_exp_torch(torch.as_tensor(logw), len(logw)))
        want = float(jnum.log_mean_exp_jax(jnp.asarray(logw), len(logw)))
        host = tnum.log_mean_exp(np.where(np.isnan(logw), -INF, logw),
                                 N_total=len(logw))
        np.testing.assert_allclose([got, got], [want, host], rtol=1e-12)


class TestKepler:
    def test_f32_returned_sincos_contract(self):
        """The returned (sinE, cosE) of the port's f32 solver against the
        reference's f64 solve: within 1.5e-6, the gate of the JAX
        package's own contract test, over a stress grid with the high-e
        near-pericenter band and the e = E_MAX clamp edge."""
        rng = np.random.default_rng(9)
        n = 60000
        M = rng.uniform(-40, 40, n)
        e = np.concatenate([rng.uniform(0.0, jkep.E_MAX, n // 2),
                            rng.uniform(0.9, jkep.E_MAX, n // 4),
                            np.full(n - n // 2 - n // 4, jkep.E_MAX)])
        M[n // 2:] = rng.uniform(-0.3, 0.3, n - n // 2) \
            + 2 * np.pi * np.round(M[n // 2:] / (2 * np.pi))
        Mf, ef = f32(M), f32(e)
        _, s64, c64 = jkep.solve_kepler_sc(jnp.asarray(Mf, jnp.float64),
                                           jnp.asarray(ef, jnp.float64))
        _, s32, c32 = tkep.solve_kepler_sc(tf(Mf), tf(ef))
        assert np.abs(s32.double().numpy() - np.asarray(s64)).max() < 1.5e-6
        assert np.abs(c32.double().numpy() - np.asarray(c64)).max() < 1.5e-6

    def test_f64_matches_reference(self):
        """f64 Newton-8 path: equal to the reference to f64 round-off
        (1e-10 covers |M| up to 40)."""
        rng = np.random.default_rng(0)
        M = rng.uniform(-20, 20, 5000)
        e = rng.uniform(0, 0.99, 5000)
        Ej, sj, cj = jkep.solve_kepler_sc(jnp.asarray(M), jnp.asarray(e))
        Et, st, ct = tkep.solve_kepler_sc(torch.as_tensor(M),
                                          torch.as_tensor(e))
        for a, b in ((Et, Ej), (st, sj), (ct, cj)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-10)

    def _draws(self):
        rng = np.random.default_rng(7)
        n = 4000
        P = rng.uniform(1.0, 20.0, n)
        a_R = rng.uniform(3.0, 50.0, n)
        inc = np.arccos(rng.uniform(0.0, 1.0, n) / a_R)
        e = rng.uniform(0.0, 0.9, n)
        w = rng.uniform(-np.pi, np.pi, n)
        t = rng.uniform(-1.5, 1.5, n) * P / np.pi / a_R
        return t, P, a_R, inc, e, w

    def test_projected_z_f32_near_transit(self):
        """Port f32 z against the reference f64 z: in-transit error below
        the 1e-4 gate of TestF32NearTransitPrecision; the in-front masks
        agree wherever the reference's sin(w + nu) is not within f32
        round-off of 0."""
        t, P, a_R, inc, e, w = self._draws()
        z64, fr64 = jkep.projected_z(*map(jnp.asarray, (t, 0.0, P, a_R, inc,
                                                        e, w)))
        z32, fr32 = tkep.projected_z(tf(t), 0.0, tf(P), tf(a_R), tf(inc),
                                     tf(e), tf(w))
        z64 = np.asarray(z64)
        in_transit = z64 < 2.0
        err = np.abs(z32.double().numpy() - z64)
        assert err[in_transit].max() < 1e-4, err[in_transit].max()
        np.testing.assert_array_equal(fr32.numpy()[in_transit],
                                      np.asarray(fr64)[in_transit])

    def test_z2_taylor_matches_reference_f32(self):
        """Port vs reference, both f32: z2 and its derivatives agree to
        f32 round-off relative to each quantity's scale (1e-5)."""
        t, P, a_R, inc, e, w = self._draws()
        ref = jkep.z2_taylor(jf(t), np.float32(0.0), jf(P), jf(a_R), jf(inc),
                             jf(e), jf(w))
        got = tkep.z2_taylor(tf(t), 0.0, tf(P), tf(a_R), tf(inc), tf(e),
                             tf(w))
        for g, r in zip(got[:3], ref[:3]):
            r = np.asarray(r, np.float64)
            scale = np.abs(r).max()
            assert np.abs(g.double().numpy() - r).max() < 1e-5 * scale
        z2 = np.asarray(ref[0])
        np.testing.assert_array_equal(got[3].numpy()[z2 < 4.0],
                                      np.asarray(ref[3])[z2 < 4.0])

    def test_mean_anomaly_at_transit(self):
        rng = np.random.default_rng(4)
        e = rng.uniform(0, 0.99, 1000)
        w = rng.uniform(-np.pi, np.pi, 1000)
        got = tkep.mean_anomaly_at_transit(torch.as_tensor(e),
                                           torch.as_tensor(w))
        want = jkep.mean_anomaly_at_transit(jnp.asarray(e), jnp.asarray(w))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-12)


class TestOccult:
    def test_f32_absolute_error(self):
        """Port f32 (GL-11) against the reference f64 (GL-16): < 5e-6,
        the gate of the reference's TestFloat32."""
        rng = np.random.default_rng(1)
        p = 10 ** rng.uniform(-2, 0, 500)
        z = rng.uniform(0, 1, 500) * (1 + p)
        u1 = rng.uniform(0, 0.8, 500)
        u2 = rng.uniform(0, 0.4, 500)
        want = np.asarray(j_occult(*map(jnp.asarray, (p, z, u1, u2))))
        got = t_occult(tf(p), tf(z), tf(u1), tf(u2)).double().numpy()
        assert np.abs(got - want).max() < 5e-6

    def test_f32_near_contacts(self):
        """Near the contact points: < 1e-5 (reference TestFloat32)."""
        p = 0.1
        eps = np.array([1e-7, 1e-6, 1e-5, 1e-4, 1e-3])
        zs = np.concatenate([1 + p - eps, 1 - p + eps, 1 - p - eps, p + eps,
                             p - eps])
        n = zs.size
        args = (np.full(n, p), zs, np.full(n, 0.4), np.full(n, 0.2))
        want = np.asarray(j_occult(*map(jnp.asarray, args)))
        got = t_occult(*map(tf, args)).double().numpy()
        assert np.abs(got - want).max() < 1e-5

    def test_f64_matches_reference(self):
        """f64 GL-16 path: same formula, equal to f64 round-off."""
        rng = np.random.default_rng(2)
        p = 10 ** rng.uniform(-2, 0.5, 400)
        z = rng.uniform(0, 1.1, 400) * (1 + p)
        u1 = rng.uniform(0, 1, 400)
        u2 = rng.uniform(-0.2, 0.5, 400)
        want = np.asarray(j_occult(*map(jnp.asarray, (p, z, u1, u2))))
        got = t_occult(*map(torch.as_tensor, (p, z, u1, u2))).numpy()
        np.testing.assert_allclose(got, want, atol=1e-12)
