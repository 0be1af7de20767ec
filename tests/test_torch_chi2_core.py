"""The kernel module (ops/chi2_core.py) and the likelihood cores that feed
it (ops/lightcurve.py), port vs the JAX Pallas kernels (the v2
``chi2_supersampled`` and the time-major ``chi2_supersampled_v3``) in
interpret mode: the plane entry points against the kernels on identical
planes, the orbit entry points (``chi2_from_orbit``, ``_v3``, and
``chi2_from_orbit_tab`` and ``_v3_tab``, which compute the tabulated
coefficients themselves) against the JAX package's whole fused step,
``ops/lightcurve.py::_chi2_pallas``.

Tolerances are those of tests/test_pallas_core.py: per-draw lnL carries
O(0.01-0.1) reordering noise when sigma is small (a ~1e-7 f32 rounding
difference in the deficit enters lnL as ~ D_err * resid / sigma^2), so
the gates are lnL p99 < 0.05 and max < 1.0 absolute, identical finite
masks, and lnZ within 1e-2 nats.
"""

import os
import subprocess
import sys
from types import SimpleNamespace

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
from triceratops_tpu_torch.ops import fastcore as tfc
from triceratops_tpu_torch.ops import lightcurve as tlc
from triceratops_tpu_torch.utils import profiling

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
        before = _counts()
        got = chi2_core.chi2_supersampled(
            *map(torch.as_tensor, arrs), offs=offs, wgts=wgts).numpy()
        assert _counts() == before   # CPU: plain path, no launch
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
        before = _counts()
        got = chi2_core.chi2_supersampled_v3(
            *map(torch.as_tensor, arrs), offs=offs, wgts=wgts).numpy()
        assert _counts() == before
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
        """On the card: ``_chi2_fused`` launches the v2 tab kernel (and no
        other kernel), against the plain planes on the same CUDA tensors,
        at 16384 x 100, GL-4, with the lnL-scale gates above."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card and nvcc")
        a = _inputs(N=16384, n_t=100, seed=1)
        time, obs, k, P, aR, inc, e, w, u1, u2, g = (
            torch.as_tensor(x, device="cuda") for x in a)
        before = _counts()
        kern = tlc._chi2_fused(time, 0.00139, obs, k, P, aR, inc, e, w, u1,
                               u2, g, 100, 20)
        assert _counts() == _plus(before, "launch.chi2_from_orbit_tab")
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
        """On the card: under the v3 schedule ``_chi2_fused`` launches the
        v3 tab kernel only, against the plain version on the same CUDA
        tensors (C = 16384; n_t = 137 ends in a partial time block), with
        the lnL-scale gates above."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card and nvcc")
        monkeypatch.setattr(tlc, "CHI2_SCHEDULE", "3")
        a = _inputs(N=16384, n_t=n_t, seed=2)
        time, obs, k, P, aR, inc, e, w, u1, u2, g = (
            torch.as_tensor(x, device="cuda") for x in a)
        before = _counts()
        kern = tlc._chi2_fused(time, 0.00139, obs, k, P, aR, inc, e, w, u1,
                               u2, g, n_t, ns)
        assert _counts() == _plus(before, "launch.chi2_from_orbit_v3_tab")
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


    @pytest.mark.cuda
    @pytest.mark.parametrize("n_t,ns", [(100, 20), (137, 1)])
    @pytest.mark.parametrize("name", ["chi2_supersampled",
                                      "chi2_supersampled_v3"])
    def test_plane_kernels_match_plain_on_card(self, name, n_t, ns):
        """On the card: each plane kernel, off the main path now, against
        the plain version on the same CUDA planes (C = 4096)."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card and nvcc")
        arrs, offs, wgts = _chi2_inputs(ns, C=4096, n_t=n_t)
        t = [torch.as_tensor(x, device="cuda") for x in arrs]
        counter = f"launch.{name}"
        before = _counts()
        kern = getattr(chi2_core, name)(*t, offs=offs, wgts=wgts)
        assert _counts() == _plus(before, counter)
        plain = chi2_core.chi2_supersampled_plain(*t, offs=offs, wgts=wgts)
        d = ((kern - plain).abs().double() / (2 * 5e-4 ** 2)).cpu().numpy()
        assert np.quantile(d, 0.99) < 0.05 and d.max() < 1.0


COUNTERS = tuple(f"launch.{name}" for name in (
    "chi2_supersampled", "chi2_supersampled_v3", "chi2_from_orbit",
    "chi2_from_orbit_v3", "chi2_from_orbit_tab", "chi2_from_orbit_v3_tab",
    "chi2_from_orbit_exact", "deficit_coeffs_tab", "deficit_coeffs_exact"))


def _counts():
    counts = profiling.counters()
    return {c: counts.get(c, 0) for c in COUNTERS}


def _plus(counts, name):
    return {**counts, name: counts[name] + 1}


def _orbit_args(a, ns, to=torch.as_tensor):
    """(time, P, a_R, inc, e, w, cA, cB1, cB2, seg, g, obs_dev) for the
    orbit entry points from ``_inputs`` arrays, with the port's own
    coefficients, plus the nodes as ``_chi2_fused`` picks them."""
    time, obs, k, P, aR, inc, e, w, u1, u2, g = (to(x) for x in a)
    cA, cB1, cB2, *segs = tfc.deficit_coeffs(k, u1, u2)
    if ns > 1:
        o, wt = tlc._gl_exposure_nodes(0.00139, ns)
        offs, wgts = tuple(map(float, o)), tuple(map(float, wt))
    else:
        offs, wgts = (0.0,), (1.0,)
    args = (time, P, aR, inc, e, w, cA.contiguous(), cB1.contiguous(),
            cB2.contiguous(), torch.stack(segs, 1), g[:, None].contiguous(),
            obs[None, :].contiguous())
    return args, offs, wgts


ORBIT = {"2": ("chi2_from_orbit", "launch.chi2_from_orbit"),
         "3": ("chi2_from_orbit_v3", "launch.chi2_from_orbit_v3")}


class TestOrbitKernel:
    @pytest.mark.parametrize("n_t", [40, 137])
    @pytest.mark.parametrize("ns", [4, 1])
    @pytest.mark.parametrize("schedule", ["2", "3"])
    def test_plain_matches_jax_chi2_pallas(self, schedule, ns, n_t,
                                           monkeypatch):
        """Each orbit wrapper on CPU tensors (its plain version) against the
        JAX package's whole fused step, ``_chi2_pallas`` with the Pallas
        kernel of the same schedule in interpret mode, on the same f32
        draws (C = 256): lnL-scale gates p99 < 0.05 and max < 1.0, and lnZ
        within 1e-2 nats."""
        monkeypatch.setattr(jlc, "PALLAS_V", schedule)
        a = _inputs(N=256, n_t=n_t, seed=8)
        time, obs, k, P, aR, inc, e, w, u1, u2, g = map(jnp.asarray, a)
        want = np.asarray(jlc._chi2_pallas(time, 0.00139, obs, k, P, aR,
                                           inc, e, w, u1, u2, g, n_t, ns,
                                           True), np.float64)
        args, offs, wgts = _orbit_args(a, ns)
        name, counter = ORBIT[schedule]
        before = _counts()
        got = getattr(chi2_core, name)(*args, offs=offs, wgts=wgts,
                                       ns=ns).numpy().astype(np.float64)
        assert _counts() == before           # CPU: plain path, no launch
        inv = 1.0 / (2 * 5e-4 ** 2)
        d = np.abs(got - want) * inv
        assert np.quantile(d, 0.99) < 0.05, np.quantile(d, 0.99)
        assert d.max() < 1.0, d.max()
        dz = abs(float(log_mean_exp_torch(torch.as_tensor(-got * inv), 256))
                 - float(log_mean_exp_jax(jnp.asarray(-want * inv), 256)))
        assert dz < 1e-2, dz

    @pytest.mark.parametrize("schedule", ["2", "3"])
    def test_wrapper_rejects_bad_inputs(self, schedule):
        """dtype, shape, contiguity, the draw multiple (256 for v2, 128 for
        v3) and the node count, before anything runs."""
        fn = getattr(chi2_core, ORBIT[schedule][0])
        tile = 256 if schedule == "2" else 128
        args, offs, wgts = _orbit_args(_inputs(N=256, n_t=40), 4)
        kw = dict(offs=offs, wgts=wgts, ns=20)
        with pytest.raises(TypeError, match="float32"):
            fn(args[0].double(), *args[1:], **kw)
        with pytest.raises(ValueError, match="shape"):
            fn(*args[:3], args[3][:128], *args[4:], **kw)
        with pytest.raises(ValueError, match="1-d"):
            fn(args[0][None, None, :], *args[1:], **kw)
        with pytest.raises(ValueError, match="contiguous"):
            fn(*args[:6], args[6].t().contiguous().t(), *args[7:], **kw)
        short = (args[0], *(x[:tile // 2] for x in args[1:11]), args[11])
        with pytest.raises(ValueError, match=f"multiple of {tile}"):
            fn(*short, **kw)
        with pytest.raises(ValueError, match="offsets"):
            fn(*args, offs=offs * 2, wgts=wgts * 2, ns=20)
        with pytest.raises(ValueError, match="offsets"):
            fn(*args, offs=(), wgts=(), ns=20)
        with pytest.raises(ValueError, match="ns = 1"):
            fn(*args, offs=offs, wgts=wgts, ns=1)
        got = fn(*args, offs=(0.0,), wgts=(1.0,), ns=1)
        want = chi2_core.chi2_from_orbit_plain(*args, offs=(0.0,),
                                               wgts=(1.0,), ns=1)
        assert torch.equal(got, want)

    @pytest.mark.cuda
    @pytest.mark.parametrize("n_t,ns", [(100, 20), (137, 1), (2000, 20)])
    @pytest.mark.parametrize("schedule", ["2", "3"])
    def test_kernel_matches_plain_on_card(self, schedule, n_t, ns):
        """On the card: each orbit kernel against its plain version on the
        same CUDA tensors (C = 8192), with the lnL-scale gates above; at
        n_t = 2000 on the draws within 50 of the best lnL, where f32
        summation order moves the far-off draws' |lnL| ~ 1e4 by O(1)."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card and nvcc")
        a = _inputs(N=8192, n_t=n_t, seed=9)
        args, offs, wgts = _orbit_args(
            a, ns, lambda x: torch.as_tensor(x, device="cuda"))
        name, counter = ORBIT[schedule]
        before = _counts()
        kern = getattr(chi2_core, name)(*args, offs=offs, wgts=wgts, ns=ns)
        assert _counts() == _plus(before, counter)
        plain = chi2_core.chi2_from_orbit_plain(*args, offs=offs, wgts=wgts,
                                                ns=ns)
        inv = 1.0 / (2 * 5e-4 ** 2)
        lnL_p = (-plain.double() * inv).cpu().numpy()
        d = ((kern - plain).abs().double() * inv).cpu().numpy()
        near = lnL_p > lnL_p.max() - 50.0
        assert np.quantile(d[near], 0.99) < 0.05 and d[near].max() < 1.0


def _tab_inputs(N=256, n_t=40, seed=21):
    """``_inputs``-like f32 draws whose k spans the coefficient table's
    eight k-segments, N / 8 in each, with varied limb darkening; g scales
    the deeper draws down so every lnL stays within a few hundred nats of
    the curve (k up to 2 is an undiluted eclipse of depth ~1)."""
    rng = np.random.default_rng(seed)
    br = tfc._TAB_BREAKS
    time = np.linspace(-0.15, 0.15, n_t)
    obs = rng.normal(0, 5e-4, n_t)
    k = np.concatenate([rng.uniform(br[s], br[s + 1], N // 8)
                        for s in range(8)])
    P = np.full(N, 3.0)
    aR = np.full(N, 9.6)
    inc = np.arccos(rng.uniform(0, 1, N) * (1 + k) / aR)
    e = rng.uniform(0, 0.5, N)
    w = rng.uniform(-np.pi, np.pi, N)
    u1 = rng.uniform(0.1, 0.6, N)
    u2 = rng.uniform(0.0, 0.3, N)
    g = rng.uniform(0.2, 1.0, N) * np.minimum(1.0, (0.05 / k) ** 2)
    return [f32(a) for a in (time, obs, k, P, aR, inc, e, w, u1, u2, g)]


def _tab_args(a, ns, to=torch.as_tensor):
    """(time, P, a_R, inc, e, w, k, u1, u2, g, obs_dev) for
    ``chi2_from_orbit_tab`` from ``_inputs`` arrays, plus the nodes as
    ``_chi2_fused`` picks them."""
    time, obs, k, P, aR, inc, e, w, u1, u2, g = (to(x) for x in a)
    if ns > 1:
        o, wt = tlc._gl_exposure_nodes(0.00139, ns)
        offs, wgts = tuple(map(float, o)), tuple(map(float, wt))
    else:
        offs, wgts = (0.0,), (1.0,)
    return ((time, P, aR, inc, e, w, k, u1, u2, g, obs[None, :].contiguous()),
            offs, wgts)


def _window_delta(before):
    """The window counters' growth since ``before`` (a counters() copy)."""
    after = profiling.counters()
    return {n: after.get(n, 0) - before.get(n, 0)
            for n in chi2_core.WINDOW_COUNTERS}


def _long_tab_args(order, N=8192, seed=9):
    """``_tab_args`` (ns = 20) of ``_tab_inputs`` on an 8,055-point curve in
    |t| < 0.3 d, sorted by time or shuffled (time and obs together), as
    CUDA tensors."""
    a = _tab_inputs(N=N, n_t=8055, seed=seed)
    a[0] = f32(a[0] * 2.0)
    if order == "shuffled":
        perm = np.random.default_rng(seed).permutation(a[0].size)
        a[0], a[1] = a[0][perm], a[1][perm]
    return _tab_args(a, 20, lambda x: torch.as_tensor(x, device="cuda"))


class TestTabKernel:
    @pytest.mark.parametrize("n_t", [40, 137])
    @pytest.mark.parametrize("ns", [4, 1])
    def test_plain_matches_jax_chi2_pallas(self, ns, n_t, monkeypatch):
        """``chi2_from_orbit_tab`` on CPU tensors (its plain version: the
        torch tab coefficients, then the orbit plain version) against the
        JAX package's whole fused step, ``_chi2_pallas`` with the v2 Pallas
        kernel in interpret mode, which takes the same (k, u1, u2), on f32
        draws over all eight k-segments (C = 256): lnL p99 < 0.05, max <
        1.0, lnZ within 1e-2 nats; no kernel launched."""
        monkeypatch.setattr(jlc, "PALLAS_V", "2")
        a = _tab_inputs(n_t=n_t)
        time, obs, k, P, aR, inc, e, w, u1, u2, g = map(jnp.asarray, a)
        want = np.asarray(jlc._chi2_pallas(time, 0.00139, obs, k, P, aR,
                                           inc, e, w, u1, u2, g, n_t, ns,
                                           True), np.float64)
        args, offs, wgts = _tab_args(a, ns)
        before = _counts()
        got = chi2_core.chi2_from_orbit_tab(
            *args, offs=offs, wgts=wgts, ns=ns).numpy().astype(np.float64)
        assert _counts() == before
        inv = 1.0 / (2 * 5e-4 ** 2)
        d = np.abs(got - want) * inv
        assert np.quantile(d, 0.99) < 0.05, np.quantile(d, 0.99)
        assert d.max() < 1.0, d.max()
        dz = abs(float(log_mean_exp_torch(torch.as_tensor(-got * inv), 256))
                 - float(log_mean_exp_jax(jnp.asarray(-want * inv), 256)))
        assert dz < 1e-2, dz

    def test_wrapper_rejects_bad_inputs(self):
        """dtype, shape, contiguity, the draw multiple of 256, the node
        count and ns = 1's one node, before anything runs; on the CPU the
        wrapper gives its plain version, which is the torch coefficient
        stage into ``chi2_from_orbit_plain``."""
        fn = chi2_core.chi2_from_orbit_tab
        args, offs, wgts = _tab_args(_tab_inputs(), 4)
        kw = dict(offs=offs, wgts=wgts, ns=20)
        with pytest.raises(TypeError, match="float32"):
            fn(*args[:6], args[6].double(), *args[7:], **kw)
        with pytest.raises(ValueError, match="shape"):
            fn(*args[:7], args[7][:128], *args[8:], **kw)
        with pytest.raises(ValueError, match="shape"):
            fn(*args[:9], args[9][:, None], args[10], **kw)
        with pytest.raises(ValueError, match="1-d"):
            fn(args[0][None, None, :], *args[1:], **kw)
        with pytest.raises(ValueError, match="contiguous"):
            fn(*args[:6], torch.stack([args[6], args[6]], 1)[:, 0],
               *args[7:], **kw)
        short = (args[0], *(x[:128] for x in args[1:10]), args[10])
        with pytest.raises(ValueError, match="multiple of 256"):
            fn(*short, **kw)
        with pytest.raises(ValueError, match="offsets"):
            fn(*args, offs=offs * 2, wgts=wgts * 2, ns=20)
        with pytest.raises(ValueError, match="ns = 1"):
            fn(*args, offs=offs, wgts=wgts, ns=1)
        with pytest.raises(ValueError, match="no chi2 kernel"):
            fn(*(x.to("meta") for x in args), **kw)
        got = fn(*args, offs=(0.0,), wgts=(1.0,), ns=1)
        time, P, aR, inc, e, w, k, u1, u2, g, obs = args
        cA, cB1, cB2, *segs = tfc.cheb_deficit_coeffs_tab(k, u1, u2)
        want = chi2_core.chi2_from_orbit_plain(
            time, P, aR, inc, e, w, cA, cB1, cB2, torch.stack(segs, 1),
            g[:, None], obs, offs=(0.0,), wgts=(1.0,), ns=1)
        assert torch.equal(got, want)

    def test_targets_on_cpu(self):
        """B = 3 targets in one call (time and obs_dev (3, n_t), the draws
        target-major) give each target's draws what a call on that target
        alone gives."""
        per = [_tab_args(_tab_inputs(n_t=24, seed=30 + b), 4)
               for b in range(3)]
        offs, wgts = per[0][1:]
        args = [torch.stack([p[0][0] for p in per])]
        args += [torch.cat([p[0][i] for p in per]) for i in range(1, 11)]
        kw = dict(offs=offs, wgts=wgts, ns=20)
        got = chi2_core.chi2_from_orbit_tab(*args, **kw)
        alone = torch.cat([chi2_core.chi2_from_orbit_tab(*p[0], **kw)
                           for p in per])
        torch.testing.assert_close(got, alone, rtol=1e-6, atol=0)

    def test_coeffs_wrapper_on_cpu(self):
        """``deficit_coeffs_tab`` on CPU tensors is the torch tab stage;
        it checks its inputs and launches nothing."""
        a = _tab_inputs()
        k, u1, u2 = (torch.as_tensor(a[i]) for i in (2, 8, 9))
        before = _counts()
        got = chi2_core.deficit_coeffs_tab(k, u1, u2)
        assert _counts() == before
        for x, y in zip(got, tfc.cheb_deficit_coeffs_tab(k, u1, u2)):
            assert torch.equal(x, y)
        with pytest.raises(TypeError, match="float32"):
            chi2_core.deficit_coeffs_tab(k.double(), u1, u2)
        with pytest.raises(ValueError, match="shape"):
            chi2_core.deficit_coeffs_tab(k, u1[:8], u2)
        with pytest.raises(ValueError, match="C >= 1"):
            chi2_core.deficit_coeffs_tab(k[:0], u1[:0], u2[:0])

    def test_route(self, monkeypatch):
        """``lightcurve.in_kernel_coeffs``: on a CUDA device tabulated
        coefficients ("tab", or "auto" with float32 draws) name the tab
        stage, under v2 and v3 alike; "exact" with float32 draws names the
        exact stage under v2 and none under v3; float64 draws under "auto"
        or "exact" name none (the torch coefficient stage into the
        schedule's orbit entry point); a CPU device always names none (its
        plain version). ``_chi2_fused`` calls the entry point the stage and
        ``CHI2_SCHEDULE`` name, with (k, u1, u2) or the coefficients."""
        cuda, cpu = torch.device("cuda"), torch.device("cpu")
        f4, f8 = torch.float32, torch.float64
        route = tlc.in_kernel_coeffs
        for sched in ("2", "3"):
            assert route(cuda, f4, "auto", sched) == "tab"
            assert route("cuda:0", f4, "tab", sched) == "tab"
            assert route(cuda, f8, "tab", sched) == "tab"
            assert route(cuda, f8, "auto", sched) is None
            assert route(cuda, f8, "exact", sched) is None
            for backend in ("auto", "tab", "exact"):
                assert route(cpu, f4, backend, sched) is None
        assert route(cuda, f4, "exact", "2") == "exact"
        assert route(cuda, f4, "exact", "3") is None

        a = _tab_inputs(n_t=24)
        time, obs, k, P, aR, inc, e, w, u1, u2, g = map(torch.as_tensor, a)
        names = ("chi2_from_orbit_tab", "chi2_from_orbit_v3_tab",
                 "chi2_from_orbit_exact", "chi2_from_orbit",
                 "chi2_from_orbit_v3")
        called = []
        for name in names:
            monkeypatch.setattr(
                chi2_core, name,
                lambda *xs, _n=name, **kw: called.append((_n, len(xs))))
        for stage, schedule, want in (
                ("tab", "2", ("chi2_from_orbit_tab", 11)),
                ("tab", "3", ("chi2_from_orbit_v3_tab", 11)),
                ("exact", "2", ("chi2_from_orbit_exact", 11)),
                (None, "2", ("chi2_from_orbit", 12)),
                (None, "3", ("chi2_from_orbit_v3", 12))):
            monkeypatch.setattr(tlc, "in_kernel_coeffs",
                                lambda *_, _v=stage: _v)
            monkeypatch.setattr(tlc, "CHI2_SCHEDULE", schedule)
            called.clear()
            tlc._chi2_fused(time, 0.00139, obs, k, P, aR, inc, e, w, u1, u2,
                            g, 24, 20)
            assert called == [want]

    def test_fused_cpu_route_unchanged(self, monkeypatch):
        """On CPU tensors ``_chi2_fused`` runs the torch coefficient stage
        into the orbit plain version under every coefficient backend, and
        under "tab" / "auto" gives exactly the tab kernel's plain
        version."""
        a = _tab_inputs(n_t=24)
        time, obs, k, P, aR, inc, e, w, u1, u2, g = map(torch.as_tensor, a)
        args, offs, wgts = _tab_args(a, 20)
        want = chi2_core.chi2_from_orbit_tab_plain(*args, offs=offs,
                                                   wgts=wgts, ns=20)
        for backend in ("auto", "tab"):
            monkeypatch.setattr(tfc, "COEFFS_BACKEND", backend)
            before = _counts()
            got = tlc._chi2_fused(time, 0.00139, obs, k, P, aR, inc, e, w,
                                  u1, u2, g, 24, 20)
            assert _counts() == before
            assert torch.equal(got, want)

    @pytest.mark.cuda
    @pytest.mark.parametrize("n_t,ns", [(100, 20), (137, 1), (2000, 20)])
    def test_kernel_matches_plain_on_card(self, n_t, ns):
        """On the card: the tab kernel against its plain version on the same
        CUDA tensors (C = 8192, k over all eight k-segments), with the
        lnL-scale gates above, on the draws within 50 of the best lnL at
        n_t = 2000 (as ``TestOrbitKernel``)."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card and nvcc")
        a = _tab_inputs(N=8192, n_t=n_t, seed=9)
        args, offs, wgts = _tab_args(
            a, ns, lambda x: torch.as_tensor(x, device="cuda"))
        before = _counts()
        kern = chi2_core.chi2_from_orbit_tab(*args, offs=offs, wgts=wgts,
                                             ns=ns)
        assert _counts() == _plus(before, "launch.chi2_from_orbit_tab")
        plain = chi2_core.chi2_from_orbit_tab_plain(*args, offs=offs,
                                                    wgts=wgts, ns=ns)
        inv = 1.0 / (2 * 5e-4 ** 2)
        lnL_p = (-plain.double() * inv).cpu().numpy()
        d = ((kern - plain).abs().double() * inv).cpu().numpy()
        near = lnL_p > lnL_p.max() - 50.0
        assert np.quantile(d[near], 0.99) < 0.05 and d[near].max() < 1.0

    @pytest.mark.cuda
    def test_coeffs_match_cpu_on_card(self):
        """On the card: the kernel's own coefficient function
        (``deficit_coeffs_tab``) within 3e-6 of the CPU
        ``cheb_deficit_coeffs_tab`` (tests/test_fastcore.py's tolerance)
        over all eight k-segments and the break values themselves."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card and nvcc")
        rng = np.random.default_rng(17)
        br = tfc._TAB_BREAKS
        k = np.concatenate([rng.uniform(br[s], br[s + 1], 4096)
                            for s in range(8)] + [br, [5e-4, 2.5]])
        u1 = rng.uniform(0.0, 0.8, k.size)
        u2 = np.minimum(rng.uniform(0.0, 0.4, k.size), 1.0 - u1)
        cpu = [torch.as_tensor(f32(x)) for x in (k, u1, u2)]
        want = tfc.cheb_deficit_coeffs_tab(*cpu)
        before = _counts()
        got = chi2_core.deficit_coeffs_tab(*(x.cuda() for x in cpu))
        assert _counts() == _plus(before, "launch.deficit_coeffs_tab")
        for x, y in zip(got, want):
            assert float((x.cpu() - y).abs().max()) < 3e-6

    @staticmethod
    def _targets_in_one_launch(n_t):
        """One tab launch over B = 4 targets (each its own curve of n_t
        points) against four one-target launches, draw for draw."""
        per = []
        for b in range(4):
            a = _tab_inputs(N=4096, n_t=n_t, seed=60 + b)
            a[0] = f32(a[0] * (1.0 + 0.2 * b))
            per.append(_tab_args(
                a, 20, lambda x: torch.as_tensor(x, device="cuda")))
        offs, wgts = per[0][1:]
        args = [torch.stack([p[0][0] for p in per])]
        args += [torch.cat([p[0][i] for p in per]) for i in range(1, 11)]
        kw = dict(offs=offs, wgts=wgts, ns=20)
        before = _counts()
        kern = chi2_core.chi2_from_orbit_tab(*args, **kw)
        assert _counts() == _plus(before, "launch.chi2_from_orbit_tab")
        singles = torch.cat([chi2_core.chi2_from_orbit_tab(*p[0], **kw)
                             for p in per])
        torch.testing.assert_close(kern, singles, rtol=0, atol=0)

    @pytest.mark.cuda
    def test_targets_in_one_launch_on_card(self):
        """On the card: one launch over B = 4 targets (each its own curve)
        equals four one-target launches draw for draw."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card and nvcc")
        self._targets_in_one_launch(100)

    @pytest.mark.cuda
    def test_targets_in_one_windowed_launch_on_card(self):
        """The same at 512 points a curve, where the windowed instance runs
        (each draw's window on its own target's time row)."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card and nvcc")
        assert 512 >= chi2_core.V2_WINDOW_MIN_T
        self._targets_in_one_launch(512)

    @pytest.mark.cuda
    @pytest.mark.parametrize("order", ["sorted", "shuffled"])
    def test_windowed_kernel_matches_plain_on_card(self, order):
        """On the card, at n_t = 8055 (the windowed instance), on a sorted
        and on a shuffled curve: the tab kernel against its plain version
        under the v2 skip rule (``group = V2_GROUP``) on the same CUDA
        tensors (C = 8192, k over all eight k-segments), with the lnL-scale
        gates on the draws within 50 of the best lnL and the relative gate
        (p99 < 1e-3, max < 2e-2) on all draws."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card and nvcc")
        args, offs, wgts = _long_tab_args(order)
        assert args[0].shape[0] >= chi2_core.V2_WINDOW_MIN_T
        before = _counts()
        kern = chi2_core.chi2_from_orbit_tab(*args, offs=offs, wgts=wgts,
                                             ns=20)
        assert _counts() == _plus(before, "launch.chi2_from_orbit_tab")
        plain = chi2_core.chi2_from_orbit_tab_plain(
            *args, offs=offs, wgts=wgts, ns=20, group=chi2_core.V2_GROUP)
        inv = 1.0 / (2 * 5e-4 ** 2)
        lnL_p = (-plain.double() * inv).cpu().numpy()
        d = ((kern - plain).abs().double() * inv).cpu().numpy()
        near = lnL_p > lnL_p.max() - 50.0
        assert np.quantile(d[near], 0.99) < 0.05 and d[near].max() < 1.0
        rel = d / (np.abs(lnL_p) + 1.0)
        assert np.quantile(rel, 0.99) < 1e-3 and rel.max() < 2e-2

    @pytest.mark.cuda
    def test_window_counters_on_card(self):
        """On the card, with the tracer on: a windowed launch (n_t = 8055,
        C = 4096) adds C x ceil(n_t / 32) to ``window.groups`` and to
        ``window.groups_solved`` the groups of ``window_groups`` on the same
        draws, up to those whose deciding exposure lies within 1e-5 rad of
        the window's edge (the kernel and torch round the window apart);
        a launch below ``V2_WINDOW_MIN_T`` (n_t = 64) adds no window
        counter, and with the tracer off neither does a windowed one."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card and nvcc")
        args, offs, wgts = _long_tab_args("sorted", N=4096, seed=31)
        time, P, aR, inc, e, w, k, u1, u2 = args[:9]
        C, n_t = P.shape[0], time.shape[0]
        kw = dict(offs=offs, wgts=wgts, ns=20)
        before = profiling.counters()
        with profiling.tracing("host"):
            chi2_core.chi2_from_orbit_tab(*args, **kw)
            got = _window_delta(before)
        segs = tfc.cheb_deficit_coeffs_tab(k, u1, u2)[3:]
        mid, half = chi2_core.transit_window(P, aR, inc, e, w,
                                             segs[1] + 1.0 / segs[4], offs)
        lo, hi = (int(chi2_core.window_groups(time, P, mid, half + d).sum())
                  for d in (-1e-5, 1e-5))
        assert got["window.groups"] == C * -(-n_t // chi2_core.V2_GROUP)
        assert lo <= got["window.groups_solved"] <= hi, (got, lo, hi)
        assert got["window.groups_solved"] < 0.5 * got["window.groups"]

        none = dict.fromkeys(chi2_core.WINDOW_COUNTERS, 0)
        short, _, _ = _tab_args(_tab_inputs(N=4096, n_t=64, seed=32), 20,
                                lambda x: torch.as_tensor(x, device="cuda"))
        assert short[0].shape[0] < chi2_core.V2_WINDOW_MIN_T
        before = profiling.counters()
        with profiling.tracing("host"):
            chi2_core.chi2_from_orbit_tab(*short, **kw)
            assert _window_delta(before) == none
        before = profiling.counters()
        chi2_core.chi2_from_orbit_tab(*args, **kw)
        assert _window_delta(before) == none


class TestV3TabKernel:
    @pytest.mark.parametrize("ns,n_t", [(4, 40), (1, 24)])
    def test_plain_matches_jax_chi2_pallas_v3(self, ns, n_t, monkeypatch):
        """``chi2_from_orbit_v3_tab`` on CPU tensors (its plain version, the
        tab kernel's) against the JAX package's whole fused step under the
        v3 schedule, ``_chi2_pallas`` with ``chi2_supersampled_v3`` in
        interpret mode, on f32 draws over all eight k-segments (C = 256):
        lnL p99 < 0.05, max < 1.0, lnZ within 1e-2 nats; no launch."""
        monkeypatch.setattr(jlc, "PALLAS_V", "3")
        a = _tab_inputs(n_t=n_t)
        time, obs, k, P, aR, inc, e, w, u1, u2, g = map(jnp.asarray, a)
        want = np.asarray(jlc._chi2_pallas(time, 0.00139, obs, k, P, aR,
                                           inc, e, w, u1, u2, g, n_t, ns,
                                           True), np.float64)
        args, offs, wgts = _tab_args(a, ns)
        before = _counts()
        got = chi2_core.chi2_from_orbit_v3_tab(
            *args, offs=offs, wgts=wgts, ns=ns).numpy().astype(np.float64)
        assert _counts() == before
        inv = 1.0 / (2 * 5e-4 ** 2)
        d = np.abs(got - want) * inv
        assert np.quantile(d, 0.99) < 0.05, np.quantile(d, 0.99)
        assert d.max() < 1.0, d.max()
        dz = abs(float(log_mean_exp_torch(torch.as_tensor(-got * inv), 256))
                 - float(log_mean_exp_jax(jnp.asarray(-want * inv), 256)))
        assert dz < 1e-2, dz

    def test_wrapper_checks(self):
        """The tab wrapper's checks with v3's draw multiple of 128; on the
        CPU it gives the tab kernel's plain version, for one target and for
        B = 2 targets in one call, and launches nothing."""
        fn = chi2_core.chi2_from_orbit_v3_tab
        args, offs, wgts = _tab_args(_tab_inputs(N=128), 4)
        kw = dict(offs=offs, wgts=wgts, ns=20)
        before = _counts()
        got = fn(*args, **kw)
        assert _counts() == before
        assert torch.equal(got, chi2_core.chi2_from_orbit_tab_plain(*args,
                                                                    **kw))
        short = (args[0], *(x[:64] for x in args[1:10]), args[10])
        with pytest.raises(ValueError, match="multiple of 128"):
            fn(*short, **kw)
        with pytest.raises(TypeError, match="float32"):
            fn(*args[:6], args[6].double(), *args[7:], **kw)
        with pytest.raises(ValueError, match="ns = 1"):
            fn(*args, offs=offs, wgts=wgts, ns=1)
        with pytest.raises(ValueError, match="no chi2 kernel"):
            fn(*(x.to("meta") for x in args), **kw)
        two = [torch.stack([args[0], args[0] * 1.5])]
        two += [torch.cat([x, x.flip(0)]) for x in args[1:10]]
        two.append(torch.cat([args[10], args[10] * 0.5]))
        got2 = fn(*two, **kw)
        alone = torch.cat([fn(two[0][b], *(x[b * 128:(b + 1) * 128]
                                           for x in two[1:10]),
                              two[10][b:b + 1], **kw) for b in range(2)])
        torch.testing.assert_close(got2, alone, rtol=1e-6, atol=0)

    @pytest.mark.cuda
    @pytest.mark.parametrize("n_t,ns", [(100, 20), (100, 1), (8055, 20),
                                        (8055, 1)])
    def test_kernel_matches_plain_on_card(self, n_t, ns):
        """On the card: the v3 tab kernel against its plain version on the
        same CUDA tensors (C = 4096, k over all eight k-segments; n_t =
        8055 on |t| < 0.3 d), with the lnL-scale gates on the draws within
        50 of the best lnL, and at n_t = 8055 the relative gate (p99 <
        1e-3, max < 2e-2) on all draws."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card and nvcc")
        a = _tab_inputs(N=4096, n_t=n_t, seed=9)
        if n_t > 1000:
            a[0] = f32(a[0] * 2.0)
        args, offs, wgts = _tab_args(
            a, ns, lambda x: torch.as_tensor(x, device="cuda"))
        before = _counts()
        kern = chi2_core.chi2_from_orbit_v3_tab(*args, offs=offs, wgts=wgts,
                                                ns=ns)
        assert _counts() == _plus(before, "launch.chi2_from_orbit_v3_tab")
        plain = chi2_core.chi2_from_orbit_tab_plain(*args, offs=offs,
                                                    wgts=wgts, ns=ns)
        inv = 1.0 / (2 * 5e-4 ** 2)
        lnL_p = (-plain.double() * inv).cpu().numpy()
        d = ((kern - plain).abs().double() * inv).cpu().numpy()
        near = lnL_p > lnL_p.max() - 50.0
        assert np.quantile(d[near], 0.99) < 0.05 and d[near].max() < 1.0
        if n_t > 1000:
            rel = d / (np.abs(lnL_p) + 1.0)
            assert np.quantile(rel, 0.99) < 1e-3 and rel.max() < 2e-2

    @pytest.mark.cuda
    def test_targets_in_one_launch_on_card(self):
        """On the card: one launch over B = 8 targets (each its own curve)
        equals eight one-target launches draw for draw."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card and nvcc")
        per = []
        for b in range(8):
            a = _tab_inputs(N=2048, n_t=100, seed=70 + b)
            a[0] = f32(a[0] * (1.0 + 0.2 * b))
            per.append(_tab_args(
                a, 20, lambda x: torch.as_tensor(x, device="cuda")))
        offs, wgts = per[0][1:]
        args = [torch.stack([p[0][0] for p in per])]
        args += [torch.cat([p[0][i] for p in per]) for i in range(1, 11)]
        kw = dict(offs=offs, wgts=wgts, ns=20)
        before = _counts()
        kern = chi2_core.chi2_from_orbit_v3_tab(*args, **kw)
        assert _counts() == _plus(before, "launch.chi2_from_orbit_v3_tab")
        singles = torch.cat([chi2_core.chi2_from_orbit_v3_tab(*p[0], **kw)
                             for p in per])
        torch.testing.assert_close(kern, singles, rtol=0, atol=0)


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


class TestOrbitChunk:
    def test_values(self):
        """ceil(N / 2^20) near-equal chunks, each rounded up to 256: the
        1e6-draw cores and the 250k / 500k twin branches each run as one
        chunk."""
        assert [tlc.orbit_chunk(n) for n in (10**6, 250_000, 500_000)] == [
            1000192, 250112, 500224]
        assert tlc.orbit_chunk(1 << 20) == 1 << 20
        assert tlc.orbit_chunk((1 << 20) + 1) == 524544
        assert tlc.orbit_chunk(3 * 10**6) == 1000192
        assert tlc.orbit_chunk(1) == tlc.orbit_chunk(0) == 256

    def test_core_chunk_by_device(self):
        """Unless the caller gives a chunk, a CUDA tensor on the fused path
        takes the orbit chunk whatever n_t; the CPU route, ``exact`` and
        ``backend="torch"`` take the n_t-bound ``draw_chunk``. A given
        chunk is kept, rounded to the kernel's draw multiple under
        ``backend="auto"``."""
        cuda = SimpleNamespace(device=torch.device("cuda"))
        cpu = torch.zeros(3)
        orbit = tlc.orbit_chunk(10**6)
        for n_t in (100, 20099):
            assert tlc._core_chunk(None, 10**6, cuda, n_t, 20, False,
                                   "auto") == orbit
        assert tlc._core_chunk(None, 10**6, cpu, 100, 20, False,
                               "auto") == 16384
        assert tlc._core_chunk(None, 10**6, cuda, 8055, 20, True,
                               "auto") == 1280
        assert tlc._core_chunk(None, 10**6, cuda, 8055, 20, False,
                               "torch") == tlc.draw_chunk(8055, 20) == 1041
        assert tlc._core_chunk(300, 10**6, cuda, 100, 20, False,
                               "auto") == 512
        assert tlc._core_chunk(300, 10**6, cpu, 100, 20, False,
                               "torch") == 300

    def test_lnL_planet_does_not_depend_on_the_chunk(self):
        """Per-draw lnL on the CPU route is the same at the caller's chunk
        and at the orbit chunk (one chunk here)."""
        N = 640
        a = _inputs(N=N, seed=10)
        args = _lnL_args(a, torch.ones(N, dtype=torch.bool), torch.as_tensor)
        kw = dict(exptime=0.00139, n_t=40, ns=20)
        small = tlc.lnL_planet(*args, **kw, chunk=256)
        whole = tlc.lnL_planet(*args, **kw, chunk=tlc.orbit_chunk(N))
        np.testing.assert_array_equal(small.numpy(), whole.numpy())


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
