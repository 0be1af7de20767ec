"""Port vs JAX reference: ops/fastcore.py (tabulated and exact Chebyshev
deficit coefficients, their evaluation, and the exposure z^2 model)."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from torch.overrides import TorchFunctionMode

from triceratops_tpu.ops import fastcore as jfc
from triceratops_tpu_torch.ops import fastcore as tfc

from test_torch_shared import REPO, f32, jf, tf


def _cases(n=1200, seed=3):
    """k over every k-segment of the table (the k = 1 contact degeneracy
    and the breakpoints included) with physical (u1, u2) pairs drawn
    jointly from the bundled LDC grids (as TestTabulatedCoeffs)."""
    rng = np.random.default_rng(seed)
    k = np.concatenate([
        10 ** rng.uniform(-3, 0.3, n // 2),
        rng.uniform(0.9, 1.1, n // 4),
        rng.uniform(0.99, 1.01, n // 8),
        rng.uniform(1.1, 2.0, n // 8),
        [1e-3, 2.0, 1.0, 6.0 / 7.0, 299.0 / 300.0, 301.0 / 300.0,
         7.0 / 6.0, 0.999999],
    ])
    grids = np.load(os.path.join(REPO, "triceratops_tpu", "data",
                                 "ldc_grids.npz"))
    U1 = np.concatenate([grids["tess_u1"], grids["kepler_u1"]])
    U2 = np.concatenate([grids["tess_u2"], grids["kepler_u2"]])
    idx = rng.integers(0, U1.size, k.size)
    return k, U1[idx], U2[idx]


class TestTabulatedCoeffs:
    def test_tab_f32_matches_exact_f64(self):
        """Port f32 tabulated coefficients, evaluated in f32, against the
        reference's f64 exact-node coefficients: < 3e-6, the gate of the
        reference's test_tab_matches_exact_f32 (f32 Clenshaw rounding plus
        the 7.7e-8 table error)."""
        k, u1, u2 = _cases()
        rng = np.random.default_rng(5)
        ce = jfc.cheb_deficit_coeffs(*map(jnp.asarray, (k, u1, u2)))
        ct = tfc.deficit_coeffs(tf(k), tf(u1), tf(u2))
        zg = rng.uniform(0, 1, (k.size, 96)) * (1 + k[:, None])
        De = np.asarray(jfc.cheb_deficit_eval(ce, jnp.asarray(zg)))
        Dt = tfc.cheb_deficit_eval(ct, tf(zg)).double().numpy()
        assert np.abs(De - Dt).max() < 3e-6

    def test_tab_matches_reference_tab_f32(self):
        """Port vs reference tabulated coefficients, both f32, on the same
        z grid: < 3e-6 in D, the same budget (the two differ only in f32
        rounding of the design row, matmul and Clenshaw)."""
        k, u1, u2 = _cases(seed=8)
        rng = np.random.default_rng(6)
        cj = jfc.cheb_deficit_coeffs_tab(jf(k), jf(u1), jf(u2))
        ct = tfc.cheb_deficit_coeffs_tab(tf(k), tf(u1), tf(u2))
        for a, b in zip(ct[3:], cj[3:]):           # segment maps: exact f32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
        zg = rng.uniform(0, 1, (k.size, 64)) * (1 + k[:, None])
        Dj = np.asarray(jfc.cheb_deficit_eval(cj, jf(zg)), np.float64)
        Dt = tfc.cheb_deficit_eval(ct, tf(zg)).double().numpy()
        assert np.abs(Dj - Dt).max() < 3e-6

    def test_exact_f64_matches_reference(self):
        """f64 exact-node coefficients (occult GL-16 + DCT): equal to f64
        round-off, and the dispatcher routes f64 to them."""
        k, u1, u2 = _cases(n=200, seed=9)
        cj = jfc.cheb_deficit_coeffs(*map(jnp.asarray, (k, u1, u2)))
        ct = tfc.deficit_coeffs(*map(torch.as_tensor, (k, u1, u2)))
        for a, b in zip(ct, cj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-12)


class TestExposureModel:
    def test_exposure_z2_poly_and_z_supersampled(self):
        """(q0, q1, q2, front) and z at the GL-4 exposure nodes: the port's
        front mask equals the reference's f32 one, and its f32 z is within
        1e-4 of the reference's f64 z in transit."""
        rng = np.random.default_rng(1)
        N, n_t = 500, 40
        time = np.linspace(-0.15, 0.15, n_t)
        P = rng.uniform(1, 10, N)
        aR = rng.uniform(5, 20, N)
        inc = np.arccos(rng.uniform(0, 1, N) / aR)
        e = rng.uniform(0, 0.5, N)
        w = rng.uniform(-np.pi, np.pi, N)
        args = (time, 0.0007, P, aR, inc, e, w)
        qj = jfc.exposure_z2_poly(*(jf(a) if isinstance(a, np.ndarray) else a
                                    for a in args))
        qt = tfc.exposure_z2_poly(*(tf(a) if isinstance(a, np.ndarray) else a
                                    for a in args))
        np.testing.assert_array_equal(qt[3].numpy(), np.asarray(qj[3]))
        q64 = jfc.exposure_z2_poly(*(jnp.asarray(f32(a), jnp.float64)
                                     if isinstance(a, np.ndarray) else a
                                     for a in args))
        offs = np.array([-6e-4, -2e-4, 2e-4, 6e-4], np.float32)
        z64 = np.asarray(jfc.z_supersampled(*q64[:3], jnp.asarray(
            offs, jnp.float64)))
        zt = tfc.z_supersampled(*qt[:3], torch.as_tensor(offs)).numpy()
        in_transit = z64 < 2.0
        err = np.abs(zt.astype(np.float64) - z64)[in_transit]
        # the reference's own f32 gate on in-transit z (test_kepler.py
        # TestF32NearTransitPrecision); both f32 paths measure ~1.5e-5
        assert err.max() < 1e-4, err.max()


def _backend_precisions():
    return (torch.backends.cuda.matmul.fp32_precision,
            torch.backends.mkldnn.matmul.fp32_precision)


class _ProductSpy(TorchFunctionMode):
    """Records the per-backend fp32 matmul precision in force at every
    matmul / einsum the block calls; raises at the first one when
    ``fail``."""

    def __init__(self, fail=False):
        super().__init__()
        self.seen, self.fail = [], fail

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if "matmul" in name or "einsum" in name:
            self.seen.append((name, _backend_precisions()))
            if self.fail:
                raise RuntimeError("spy")
        return func(*args, **(kwargs or {}))


class TestFullPrecisionProducts:
    """The coefficient products run in IEEE float32 whatever the caller's
    torch matmul precision (the JAX package pins its tab product to
    Precision.HIGHEST), and the caller's setting comes back."""

    @pytest.mark.parametrize("fn", ["cheb_deficit_coeffs_tab",
                                    "cheb_deficit_coeffs"])
    def test_guard_in_force_and_restored(self, fn):
        k, u1, u2 = (tf(a) for a in _cases(n=64, seed=2))
        try:
            torch.set_float32_matmul_precision("high")
            caller = _backend_precisions()
            assert caller == ("tf32", "tf32")
            with _ProductSpy() as spy:
                getattr(tfc, fn)(k, u1, u2)
            assert spy.seen, "no product was called"
            assert all(p == ("ieee", "ieee") for _, p in spy.seen), spy.seen
            assert _backend_precisions() == caller
            assert torch.get_float32_matmul_precision() == "high"
            with pytest.raises(RuntimeError, match="spy"):
                with _ProductSpy(fail=True):
                    getattr(tfc, fn)(k, u1, u2)
            assert _backend_precisions() == caller
            assert torch.get_float32_matmul_precision() == "high"
        finally:
            torch.set_float32_matmul_precision("highest")

    def test_node_mean_under_guard(self):
        """The plain path's GL node mean (lightcurve._mean_deficit_fast)
        also runs its einsum under the guard."""
        from triceratops_tpu_torch.ops import lightcurve as tlc

        rng = np.random.default_rng(4)
        n = 32
        args = (tf(np.linspace(-0.1, 0.1, 20)), 0.00139,
                tf(rng.uniform(0.05, 0.2, n)), tf(np.full(n, 3.0)),
                tf(np.full(n, 9.6)), tf(np.full(n, 1.55)),
                tf(np.zeros(n)), tf(np.zeros(n)), tf(np.full(n, 0.4)),
                tf(np.full(n, 0.2)), 20, 20)
        try:
            torch.set_float32_matmul_precision("medium")
            caller = _backend_precisions()
            with _ProductSpy() as spy:
                tlc._mean_deficit_fast(*args)
            assert any(n == "einsum" for n, _ in spy.seen)
            assert all(p == ("ieee", "ieee") for _, p in spy.seen), spy.seen
            assert _backend_precisions() == caller
        finally:
            torch.set_float32_matmul_precision("highest")

    @pytest.mark.cuda
    def test_tab_coeffs_under_tf32_on_card(self):
        """With TF32 on, the card's tabulated coefficients over 1e5 draws
        across all eight k-segments stay within 3e-6 of the CPU path's."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")
        k, u1, u2 = _cases(n=100_000, seed=11)
        args = [tf(a) for a in (k, u1, u2)]
        want = tfc.cheb_deficit_coeffs_tab(*args)
        try:
            torch.set_float32_matmul_precision("high")
            got = tfc.cheb_deficit_coeffs_tab(*(a.cuda() for a in args))
            torch.cuda.synchronize()
            assert torch.get_float32_matmul_precision() == "high"
        finally:
            torch.set_float32_matmul_precision("highest")
        err = max(float((g.cpu() - w).abs().max())
                  for g, w in zip(got, want))
        assert err < 3e-6, err
