"""The port's public helpers outside the hot path against the JAX package's:
``core/kepler.py::solve_kepler`` and ``true_anomaly_from_E``, and
``ops/occult.py::occult_quad_flux`` and the host float64 quadrature oracle
``occult_quad_deficit_reference``, which also holds the port's deficit to
tests/test_occult.py's gates (5e-6 in float32, 5e-8 in float64)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triceratops_tpu.core import kepler as jkep
from triceratops_tpu.ops import occult as jocc
from triceratops_tpu_torch.core import kepler as tkep
from triceratops_tpu_torch.ops import occult as tocc


def _anomalies(n, lo, hi, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(lo, hi, n).astype(np.float32),
            np.concatenate([rng.uniform(0.0, tkep.E_MAX, n - n // 4),
                            np.full(n // 4, tkep.E_MAX)]).astype(np.float32))


class TestKeplerHelpers:
    def test_solve_kepler_f32(self):
        """float32: E within 1.5e-6 of the JAX package's float32 solve on
        wrapped anomalies, and within tests/test_kepler.py's 2e-5 of the
        float64 solve over unwrapped M in [-40, 40]."""
        M, e = _anomalies(20000, -np.pi, np.pi, 1)
        got = tkep.solve_kepler(torch.as_tensor(M), torch.as_tensor(e))
        assert got.dtype == torch.float32
        want = np.asarray(jkep.solve_kepler(jnp.asarray(M), jnp.asarray(e)))
        assert np.abs(got.numpy() - want).max() < 1.5e-6
        M, e = _anomalies(20000, -40.0, 40.0, 2)
        got = tkep.solve_kepler(torch.as_tensor(M), torch.as_tensor(e))
        ref = np.asarray(jkep.solve_kepler(jnp.asarray(M, jnp.float64),
                                           jnp.asarray(e, jnp.float64)))
        assert np.abs(got.numpy().astype(np.float64) - ref).max() < 2e-5

    def test_solve_kepler_f64(self):
        """float64 takes the Newton route: residual below 1e-10 and the
        JAX package's E to 1e-12."""
        M, e = (a.astype(np.float64) for a in _anomalies(5000, -20, 20, 3))
        got = tkep.solve_kepler(torch.as_tensor(M), torch.as_tensor(e))
        assert got.dtype == torch.float64
        E = got.numpy()
        ec = np.clip(e, 0, tkep.E_MAX)
        assert np.abs(E - ec * np.sin(E) - M).max() < 1e-10
        want = np.asarray(jkep.solve_kepler(jnp.asarray(M), jnp.asarray(e)))
        np.testing.assert_allclose(E, want, rtol=0, atol=1e-12)

    @pytest.mark.parametrize("dtype,tol", [(np.float32, 1.5e-6),
                                           (np.float64, 1e-12)])
    def test_true_anomaly_from_E(self, dtype, tol):
        """Against the JAX package's, e beyond E_MAX clipped; and nu of the
        solved E satisfies the orbit's r = 1 - e cos E = (1 - e^2) / (1 +
        e cos nu)."""
        E, e = (a.astype(dtype) for a in _anomalies(20000, -3.0, 3.0, 4))
        e[:10] = 0.999
        got = tkep.true_anomaly_from_E(torch.as_tensor(E),
                                       torch.as_tensor(e)).numpy()
        want = np.asarray(jkep.true_anomaly_from_E(jnp.asarray(E),
                                                   jnp.asarray(e)))
        assert np.abs(got - want).max() < tol
        if dtype == np.float64:
            ec = np.clip(e, 0, tkep.E_MAX)
            np.testing.assert_allclose(1 - ec * np.cos(E),
                                       (1 - ec ** 2) / (1 + ec * np.cos(got)),
                                       rtol=1e-10)


def _points(n=12, seed=5):
    rng = np.random.default_rng(seed)
    p = 10 ** rng.uniform(-2, 0.2, n)
    z = rng.uniform(0, 1, n) * (1 + p)
    return p, z, rng.uniform(0, 0.8, n), rng.uniform(0, 0.4, n)


class TestOccultHelpers:
    def test_reference_is_the_jax_oracle(self):
        """The port's own copy of the quadrature oracle gives the JAX
        package's numbers, out of transit, at contacts and inside."""
        p, z, u1, u2 = _points()
        pts = list(zip(p, z, u1, u2)) + [(0.1, 1.2, 0.3, 0.2),
                                         (0.1, 0.9, 0.4, 0.2),
                                         (2.0, 0.5, 0.4, 0.2),
                                         (0.3, 0.0, 0.5, 0.1)]
        for args in pts:
            assert (tocc.occult_quad_deficit_reference(*args)
                    == jocc.occult_quad_deficit_reference(*args))
        assert tocc.occult_quad_deficit_reference(0.1, 1.2, 0.3, 0.2) == 0.0

    @pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-6),
                                           (torch.float64, 5e-8)])
    def test_deficit_and_flux_match_the_oracle(self, dtype, tol):
        """occult_quad_deficit within test_occult.py's gate of the oracle;
        occult_quad_flux is 1 - D and equals the JAX package's."""
        p, z, u1, u2 = _points()
        want = np.array([tocc.occult_quad_deficit_reference(*a)
                         for a in zip(p, z, u1, u2)])
        t = [torch.as_tensor(a, dtype=dtype) for a in (p, z, u1, u2)]
        D = tocc.occult_quad_deficit(*t)
        assert np.abs(D.numpy().astype(np.float64) - want).max() < tol
        F = tocc.occult_quad_flux(*t)
        assert F.dtype == dtype
        torch.testing.assert_close(F, 1.0 - D, rtol=0, atol=0)
        jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
        jF = np.asarray(jocc.occult_quad_flux(
            *(jnp.asarray(a, jdt) for a in (p, z, u1, u2))))
        assert np.abs(F.numpy() - jF).max() < (2e-6 if dtype == torch.float32
                                               else 1e-12)
