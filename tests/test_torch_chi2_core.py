"""The kernel module (ops/chi2_core.py) and the likelihood cores that feed
it (ops/lightcurve.py), port vs the JAX Pallas kernels (the v2
``chi2_supersampled`` and the time-major ``chi2_supersampled_v3``) in
interpret mode.

Tolerances are those of tests/test_pallas_core.py: per-draw lnL carries
O(0.01-0.1) reordering noise when sigma is small (a ~1e-7 f32 rounding
difference in the deficit enters lnL as ~ D_err * resid / sigma^2), so
the gates are lnL p99 < 0.05 and max < 1.0 absolute, identical finite
masks, and lnZ within 1e-2 nats.
"""

import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from triceratops_tpu.core.numerics import log_mean_exp_jax
from triceratops_tpu.ops import fastcore as jfc
from triceratops_tpu.ops import lightcurve as jlc
from triceratops_tpu.ops.pallas_core import chi2_supersampled as j_chi2
from triceratops_tpu.ops.pallas_core import chi2_supersampled_v3 as j_chi2_v3
from triceratops_tpu_torch.core.numerics import log_mean_exp_torch
from triceratops_tpu_torch.ops import chi2_core
from triceratops_tpu_torch.ops import lightcurve as tlc

from test_torch_shared import REPO, f32, tf


def _inputs(N=1024, n_t=40, seed=0):
    """The draws of tests/test_pallas_core.py::_inputs, as numpy."""
    rng = np.random.default_rng(seed)
    time = np.linspace(-0.15, 0.15, n_t)
    obs = rng.normal(0, 5e-4, n_t)
    k = 10 ** rng.uniform(-2, -0.7, N)
    P = np.full(N, 3.0)
    aR = np.full(N, 9.6)
    inc = np.arccos(rng.uniform(0, 1, N) * (1 + k) / aR)
    e = rng.uniform(0, 0.5, N)
    w = rng.uniform(-np.pi, np.pi, N)
    u1 = np.full(N, 0.4)
    u2 = np.full(N, 0.2)
    g = rng.uniform(0.2, 1.0, N)
    return [f32(a) for a in (time, obs, k, P, aR, inc, e, w, u1, u2, g)]


def _lnL_args(arrays, mask, to):
    time, obs, *draws = arrays
    return (to(time), to(obs), np.float32(5e-4), *map(to, draws), mask)


def _gate(got, want):
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), finite)
    d = np.abs(got[finite] - want[finite])
    assert np.quantile(d, 0.99) < 0.05, np.quantile(d, 0.99)
    assert d.max() < 1.0, d.max()


def _chi2_inputs(ns, C=512, n_t=40, seed=3):
    """Identical (q0 ... obs_dev) for both kernels, built by the reference
    fast path from f32 draws, plus the static nodes."""
    a = _inputs(N=C, n_t=n_t, seed=seed)
    time, obs, k, P, aR, inc, e, w, u1, u2, g = map(jnp.asarray, a)
    cA, cB1, cB2, *segs = jfc.deficit_coeffs(k, u1, u2)
    q0, q1, q2, front = jfc.exposure_z2_poly(time, 0.0, P, aR, inc, e, w)
    if ns == 1:
        q1, q2 = jnp.zeros_like(q0), jnp.zeros_like(q0)
        offs, wgts = (0.0,), (1.0,)
    else:
        o, wt = jlc._gl_exposure_nodes(0.00139, ns)
        offs, wgts = tuple(map(float, o)), tuple(map(float, wt))
    arrs = (q0, q1, q2, front.astype(jnp.float32), cA, cB1, cB2,
            jnp.stack(segs, axis=1), g[:, None], obs[None, :])
    return [np.array(x) for x in arrs], offs, wgts


class TestChi2Kernel:
    @pytest.mark.parametrize("ns", [4, 1])
    def test_plain_matches_pallas_interpret(self, ns):
        """The wrapper on CPU tensors (the plain version) against the
        Pallas kernel in interpret mode on identical inputs, at the lnL
        scale (chi^2 / (2 sigma^2)): the plain version has no tile skip,
        which adds the ~1e-8 deficit residue at z >= zmax."""
        arrs, offs, wgts = _chi2_inputs(ns)
        want = np.asarray(j_chi2(*map(jnp.asarray, arrs), offs=offs,
                                 wgts=wgts, interpret=True))
        before = chi2_core.launches
        got = chi2_core.chi2_supersampled(
            *map(torch.as_tensor, arrs), offs=offs, wgts=wgts).numpy()
        assert chi2_core.launches == before   # CPU: plain path, no launch
        d = np.abs(got.astype(np.float64) - want) / (2 * 5e-4 ** 2)
        assert np.quantile(d, 0.99) < 0.05, np.quantile(d, 0.99)
        assert d.max() < 1.0, d.max()

    @pytest.mark.parametrize("n_t", [50, 137])
    @pytest.mark.parametrize("ns", [4, 1])
    def test_v3_plain_matches_pallas_v3_interpret(self, n_t, ns):
        """The v3 wrapper on CPU tensors (the plain version) against the
        Pallas v3 kernel in interpret mode, C = 256, with the gates above;
        n_t = 137 is not a multiple of the kernel's 8-row time blocks."""
        arrs, offs, wgts = _chi2_inputs(ns, C=256, n_t=n_t)
        want = np.asarray(j_chi2_v3(*map(jnp.asarray, arrs), offs=offs,
                                    wgts=wgts, interpret=True))
        before = chi2_core.launches_v3
        got = chi2_core.chi2_supersampled_v3(
            *map(torch.as_tensor, arrs), offs=offs, wgts=wgts).numpy()
        assert chi2_core.launches_v3 == before
        d = np.abs(got.astype(np.float64) - want) / (2 * 5e-4 ** 2)
        assert np.quantile(d, 0.99) < 0.05, np.quantile(d, 0.99)
        assert d.max() < 1.0, d.max()

    def test_v3_wrapper_checks(self):
        """v3 takes C a multiple of 128 where v2 needs 256, with the same
        checks otherwise; both give the plain result on the CPU."""
        C, n_t = 128, 40
        shapes = [(C, n_t)] * 4 + [(C, 18)] * 3 + [(C, 5), (C, 1), (1, n_t)]
        t = [torch.rand(s) for s in shapes]
        offs, wgts = (0.0,), (1.0,)
        want = chi2_core.chi2_supersampled_plain(*t, offs=offs, wgts=wgts)
        got = chi2_core.chi2_supersampled_v3(*t, offs=offs, wgts=wgts)
        assert torch.equal(got, want)
        with pytest.raises(ValueError, match="multiple of 256"):
            chi2_core.chi2_supersampled(*t, offs=offs, wgts=wgts)
        with pytest.raises(ValueError, match="multiple of 128"):
            chi2_core.chi2_supersampled_v3(*(x[:64] for x in t[:9]), t[9],
                                           offs=offs, wgts=wgts)
        with pytest.raises(TypeError, match="float32"):
            chi2_core.chi2_supersampled_v3(t[0].double(), *t[1:], offs=offs,
                                           wgts=wgts)
        with pytest.raises(ValueError, match="offsets"):
            chi2_core.chi2_supersampled_v3(*t, offs=(), wgts=())
        planes = chi2_core.time_major(*t[:4])
        assert all(p.shape == (n_t, C) and p.is_contiguous() for p in planes)
        assert torch.equal(planes[0], t[0].t())

    def test_wrapper_rejects_bad_inputs(self):
        C, n_t = 256, 40
        shapes = [(C, n_t)] * 4 + [(C, 18)] * 3 + [(C, 5), (C, 1), (1, n_t)]
        t = [torch.rand(s) for s in shapes]
        offs, wgts = (0.0,), (1.0,)
        with pytest.raises(ValueError, match="multiple of 256"):
            chi2_core.chi2_supersampled(*(x[:128] for x in t[:9]), t[9],
                                        offs=offs, wgts=wgts)
        with pytest.raises(TypeError, match="float32"):
            chi2_core.chi2_supersampled(t[0].double(), *t[1:], offs=offs,
                                        wgts=wgts)
        with pytest.raises(ValueError, match="contiguous"):
            bad = t[0].t().contiguous().t()
            chi2_core.chi2_supersampled(bad, *t[1:], offs=offs, wgts=wgts)
        with pytest.raises(ValueError, match="offsets"):
            chi2_core.chi2_supersampled(*t, offs=offs * 5, wgts=wgts * 5)

    @pytest.mark.cuda
    def test_kernel_matches_plain_on_card(self):
        """On the card: the CUDA kernel against its plain version on the
        same CUDA tensors, at the slice's chunk shape (16384 x 100, GL-4),
        with the lnL-scale gates above."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card and nvcc")
        a = _inputs(N=16384, n_t=100, seed=1)
        time, obs, k, P, aR, inc, e, w, u1, u2, g = (
            torch.as_tensor(x, device="cuda") for x in a)
        before = chi2_core.launches
        kern = tlc._chi2_fused(time, 0.00139, obs, k, P, aR, inc, e, w, u1,
                               u2, g, 100, 20)
        assert chi2_core.launches == before + 1
        from triceratops_tpu_torch.ops.fastcore import (
            deficit_coeffs, exposure_z2_poly)
        cA, cB1, cB2, *segs = deficit_coeffs(k, u1, u2)
        q0, q1, q2, front = exposure_z2_poly(time, 0.0, P, aR, inc, e, w)
        o, wt = tlc._gl_exposure_nodes(0.00139, 20)
        plain = chi2_core.chi2_supersampled_plain(
            q0, q1, q2, front.float(), cA, cB1, cB2, torch.stack(segs, 1),
            g[:, None], obs[None, :], offs=tuple(map(float, o)),
            wgts=tuple(map(float, wt)))
        d = ((kern - plain).abs().double() / (2 * 5e-4 ** 2)).cpu().numpy()
        assert np.quantile(d, 0.99) < 0.05 and d.max() < 1.0

    @pytest.mark.cuda
    @pytest.mark.parametrize("n_t,ns", [(100, 20), (137, 1)])
    def test_v3_kernel_matches_plain_on_card(self, n_t, ns, monkeypatch):
        """On the card: the v3 CUDA kernel against the plain version on the
        same CUDA tensors (C = 16384; n_t = 137 ends in a partial time
        block), with the lnL-scale gates above."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card and nvcc")
        monkeypatch.setattr(tlc, "CHI2_SCHEDULE", "3")
        a = _inputs(N=16384, n_t=n_t, seed=2)
        time, obs, k, P, aR, inc, e, w, u1, u2, g = (
            torch.as_tensor(x, device="cuda") for x in a)
        before = chi2_core.launches_v3, chi2_core.launches
        kern = tlc._chi2_fused(time, 0.00139, obs, k, P, aR, inc, e, w, u1,
                               u2, g, n_t, ns)
        assert (chi2_core.launches_v3, chi2_core.launches) == (
            before[0] + 1, before[1])
        from triceratops_tpu_torch.ops.fastcore import deficit_coeffs
        from triceratops_tpu_torch.core.kepler import projected_z
        cA, cB1, cB2, *segs = deficit_coeffs(k, u1, u2)
        if ns > 1:
            from triceratops_tpu_torch.ops.fastcore import exposure_z2_poly
            q0, q1, q2, front = exposure_z2_poly(time, 0.00139 / 2, P, aR,
                                                 inc, e, w)
            o, wt = tlc._gl_exposure_nodes(0.00139, ns)
        else:
            z, front = projected_z(time[None, :], 0.0, P[:, None],
                                   aR[:, None], inc[:, None], e[:, None],
                                   w[:, None])
            q0, q1, q2 = z * z, torch.zeros_like(z), torch.zeros_like(z)
            o, wt = np.zeros(1, np.float32), np.ones(1, np.float32)
        plain = chi2_core.chi2_supersampled_plain(
            q0, q1, q2, front.float(), cA, cB1, cB2, torch.stack(segs, 1),
            g[:, None], obs[None, :], offs=tuple(map(float, o)),
            wgts=tuple(map(float, wt)))
        d = ((kern - plain).abs().double() / (2 * 5e-4 ** 2)).cpu().numpy()
        assert np.quantile(d, 0.99) < 0.05 and d.max() < 1.0


class TestSchedule:
    def test_env_selects_v3_at_import(self):
        """TRICERATOPS_PALLAS_V is read once, when ops/lightcurve.py is
        imported, as the JAX package reads it."""
        code = ("from triceratops_tpu_torch.ops import lightcurve as lc\n"
                "print(lc.CHI2_SCHEDULE, lc._kernel_chunk(300))\n")
        outs = []
        for v in ("3", None):
            env = {k: x for k, x in os.environ.items()
                   if k != "TRICERATOPS_PALLAS_V"}
            if v:
                env["TRICERATOPS_PALLAS_V"] = v
            res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                                 env=env, capture_output=True, text=True,
                                 timeout=120)
            assert res.returncode == 0, res.stderr
            outs.append(res.stdout.split())
        assert outs == [["3", "384"], ["2", "512"]]

    def test_v3_schedule_gives_the_same_lnL(self, monkeypatch):
        """On the CPU both schedules run the plain version, so lnL_planet
        is the same; v3 rounds the chunk to a multiple of 128."""
        a = _inputs(N=640, seed=7)
        kw = dict(exptime=0.00139, n_t=40, ns=4, chunk=300)
        args = _lnL_args(a, torch.ones(640, dtype=torch.bool),
                         torch.as_tensor)
        want = tlc.lnL_planet(*args, **kw)
        monkeypatch.setattr(tlc, "CHI2_SCHEDULE", "3")
        assert tlc._kernel_chunk(300) == 384
        got = tlc.lnL_planet(*args, **kw)
        np.testing.assert_array_equal(got.numpy(), want.numpy())


class TestLikelihoodCores:
    @pytest.mark.parametrize("ns,N,chunk", [(4, 1024, 512), (1, 512, 256)])
    def test_lnL_planet_matches_pallas(self, ns, N, chunk):
        a = _inputs(N=N)
        kw = dict(exptime=0.00139, n_t=40, ns=ns, chunk=chunk)
        want = np.asarray(jlc.lnL_planet(
            *_lnL_args(a, jnp.ones(N, bool), jnp.asarray), **kw,
            backend="pallas", interpret=True))
        got = tlc.lnL_planet(*_lnL_args(a, torch.ones(N, dtype=torch.bool),
                                        torch.as_tensor), **kw).numpy()
        _gate(got, want)

    def test_lnL_eb_no_veto_matches_pallas(self):
        a = _inputs(N=512)
        a[2] = f32(np.clip(a[2] * 8.0, 0.05, 0.9))       # k of an EB
        time, obs, k, P, aR, inc, e, w, u1, u2, g = a
        ksec = f32(1.0 / k)
        kw = dict(exptime=0.00139, n_t=40, ns=4, chunk=256, apply_veto=False)
        args = (time, obs, np.float32(5e-4), k, ksec, P, aR, inc, e, w, u1,
                u2, g, g)
        want = np.asarray(jlc.lnL_eb(
            *(jnp.asarray(x) for x in args), jnp.ones(512, bool), **kw,
            backend="pallas", interpret=True))
        got = tlc.lnL_eb(*(torch.as_tensor(x) if isinstance(x, np.ndarray)
                           else x for x in args),
                         torch.ones(512, dtype=torch.bool), **kw).numpy()
        # undiluted deep eclipses against a flat curve: |lnL| ~ 1e6, so
        # the gate is relative, as in test_pallas_core.py::TestPallasEB
        finite = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), finite)
        rel = np.abs(got[finite] - want[finite]) / (np.abs(want[finite]) + 1.0)
        assert np.quantile(rel, 0.99) < 1e-3
        assert rel.max() < 2e-2

    def test_lnL_eb_veto_masks(self):
        """Veto on: the min-z secondary-eclipse veto excludes the same
        draws as the reference. Diluted EBs (g in [0.002, 0.02]) put the
        secondary depth on both sides of the 1.5 sigma threshold."""
        rng = np.random.default_rng(11)
        a = _inputs(N=1024, seed=4)
        a[2] = f32(np.clip(a[2] * 8.0, 0.05, 0.9))
        time, obs, k, P, aR, inc, e, w, u1, u2, _ = a
        g = f32(10 ** rng.uniform(-2.7, -1.7, 1024))
        args = (time, obs, np.float32(5e-4), k, f32(1.0 / k), P, aR, inc, e,
                w, u1, u2, g, g)
        kw = dict(exptime=0.00139, n_t=40, ns=4, chunk=512)
        want = np.asarray(jlc.lnL_eb(*(jnp.asarray(x) for x in args),
                                     jnp.ones(1024, bool), **kw,
                                     backend="pallas", interpret=True))
        got = tlc.lnL_eb(*(torch.as_tensor(x) if isinstance(x, np.ndarray)
                           else x for x in args),
                         torch.ones(1024, dtype=torch.bool), **kw).numpy()
        vetoed = ~np.isfinite(want)
        assert 0 < vetoed.sum() < 1024
        _gate(got, want)

    def test_lnZ_agreement(self):
        """Evidence level: log-mean-exp of the two paths' lnL within
        1e-2 nats (test_pallas_core.py::TestPallasEvidenceLevel)."""
        a = _inputs(N=4096, seed=5)
        kw = dict(exptime=0.00139, n_t=40, ns=4, chunk=512)
        want = jlc.lnL_planet(*_lnL_args(a, jnp.ones(4096, bool),
                                         jnp.asarray), **kw,
                              backend="pallas", interpret=True)
        got = tlc.lnL_planet(*_lnL_args(a, torch.ones(4096, dtype=torch.bool),
                                        torch.as_tensor), **kw)
        assert abs(float(log_mean_exp_torch(got, 4096))
                   - float(log_mean_exp_jax(want, 4096))) < 1e-2

    def test_torch_backend_matches_xla_path(self):
        """backend="torch" (the unfused plain path) against the reference's
        XLA fast path, with the same lnL gates."""
        a = _inputs(N=1024, seed=6)
        kw = dict(exptime=0.00139, n_t=40, ns=4, chunk=512)
        want = np.asarray(jlc.lnL_planet(
            *_lnL_args(a, jnp.ones(1024, bool), jnp.asarray), **kw,
            backend="xla"))
        got = tlc.lnL_planet(*_lnL_args(a, torch.ones(1024, dtype=torch.bool),
                                        torch.as_tensor), **kw,
                             backend="torch").numpy()
        _gate(got, want)

    def test_helpers(self):
        assert tlc.draw_chunk(100, 20) == jlc.draw_chunk(100, 20) == 16384
        for ns in (1, 2, 4, 20):
            for x, y in zip(tlc._gl_exposure_nodes(0.00139, ns),
                            jlc._gl_exposure_nodes(0.00139, ns)):
                np.testing.assert_array_equal(x, y)
        radii = tf([0.5, 1.0, 1.2])
        for x, y in zip(tlc.eb_radius_ratios(radii, 1.0),
                        jlc.eb_radius_ratios(jnp.asarray(f32([0.5, 1.0, 1.2])),
                                             1.0)):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-7)
        F = f32([0.1, 0.5, 2.0])
        Fr = F[::-1].copy()
        for host in (False, True):
            np.testing.assert_allclose(tlc.tp_dilution(tf(F), host).numpy(),
                                       np.asarray(jlc.tp_dilution(
                                           jnp.asarray(F), host)), rtol=1e-7)
            for x, y in zip(tlc.eb_dilution(tf(F), tf(Fr), host),
                            jlc.eb_dilution(jnp.asarray(F),
                                            jnp.asarray(Fr), host)):
                np.testing.assert_allclose(x.numpy(), np.asarray(y),
                                           rtol=1e-6)
        chunks = tlc._pad_chunk([torch.arange(5.0)], 5, 4)[0]
        assert chunks.shape == (2, 4) and chunks[1, 1:].eq(0).all()
