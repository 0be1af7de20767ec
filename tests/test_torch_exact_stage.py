"""The exact coefficient stage inside the v2 kernel (ops/chi2_core.py::
chi2_from_orbit_exact, deficit_coeffs_exact, the route of
TRICERATOPS_COEFFS=exact on the card) against the JAX package.

On the CPU the wrappers run their plain versions: the port's
``fastcore.cheb_deficit_coeffs`` (the occultation deficit at each draw's
3 x 18 Chebyshev nodes, then the DCT), then ``chi2_from_orbit_plain``.
Those are held to the JAX chain that feeds the Pallas kernel under exact
coefficients: ``fastcore.cheb_deficit_coeffs`` -> ``exposure_z2_poly``
(``projected_z`` at ns = 1) -> ``pallas_core.chi2_supersampled`` in
interpret mode, on the same float32 draws (tests/conftest.py turns on x64,
so float64 inputs would take the JAX package's float64 paths). The JAX
functions are compiled with XLA's backend optimizations off
(``_compiled``): each operation then rounds as it does when JAX runs it
eagerly, and the compile takes a fraction of the time. Gates:
coefficients within 3e-6 (tests/test_fastcore.py's tolerance), per-draw
lnL p99 < 0.05 and max < 1.0 and lnZ within 1e-2 nats
(tests/test_pallas_core.py). The card-only tests hold the kernel to its
plain version on the card, under the v2 kernels' skip rule
(``group=chi2_core.V2_GROUP``).
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from triceratops_tpu.core.kepler import projected_z as j_projected_z
from triceratops_tpu.core.numerics import log_mean_exp_jax
from triceratops_tpu.ops import fastcore as jfc
from triceratops_tpu.ops import lightcurve as jlc
from triceratops_tpu.ops.pallas_core import chi2_supersampled as j_chi2
from triceratops_tpu_torch.core.numerics import log_mean_exp_torch
from triceratops_tpu_torch.ops import chi2_core
from triceratops_tpu_torch.ops import fastcore as tfc
from triceratops_tpu_torch.ops import lightcurve as tlc
from triceratops_tpu_torch.utils import profiling

from test_torch_shared import f32

EXPTIME = 0.00139
SIGMA = 5e-4
COEFF_TOL = 3e-6
COUNTERS = tuple(f"launch.{name}" for name in (
    "chi2_supersampled", "chi2_supersampled_v3", "chi2_from_orbit",
    "chi2_from_orbit_v3", "chi2_from_orbit_tab", "chi2_from_orbit_v3_tab",
    "chi2_from_orbit_exact", "deficit_coeffs_tab", "deficit_coeffs_exact"))


def _counts():
    counts = profiling.counters()
    return {c: counts.get(c, 0) for c in COUNTERS}


def _kud(rng, N):
    """N float32 (k, u1, u2): k uniform within each of the coefficient
    table's eight k-segments (1e-3 to 2, the planet and EB samplers'
    range), then the breaks themselves and a few values outside them."""
    br = tfc._TAB_BREAKS
    extra = np.array([5e-4, 0.9999, 1.0001, 2.2, 2.5, 3.0, 1e-4])
    n = (N - br.size - extra.size) // 8
    k = np.concatenate([rng.uniform(br[s], br[s + 1], n) for s in range(8)]
                       + [br, extra])
    k = np.concatenate([k, rng.uniform(br[0], br[-1], N - k.size)])
    u1 = rng.uniform(0.0, 0.8, N)
    u2 = np.minimum(rng.uniform(0.0, 0.4, N), 1.0 - u1)
    return f32(k), f32(u1), f32(u2)


def _draws(N=256, n_t=40, seed=31, window=0.15):
    """One target's float32 (time, obs, k, P, aR, inc, e, w, u1, u2, g):
    k over all eight k-segments (``_kud``) with varied limb darkening, and
    g scaling the deeper draws down so every lnL stays within a few hundred
    nats of the curve."""
    rng = np.random.default_rng(seed)
    time = np.linspace(-window, window, n_t)
    obs = rng.normal(0, SIGMA, n_t)
    k, u1, u2 = _kud(rng, N)
    P = np.full(N, 3.0)
    aR = np.full(N, 9.6)
    inc = np.arccos(rng.uniform(0, 1, N) * (1 + np.minimum(k, 2.0)) / aR)
    e = rng.uniform(0, 0.5, N)
    w = rng.uniform(-np.pi, np.pi, N)
    g = rng.uniform(0.2, 1.0, N) * np.minimum(1.0, (0.05 / k) ** 2)
    return [f32(a) for a in (time, obs, k, P, aR, inc, e, w, u1, u2, g)]


def _nodes(ns):
    if ns == 1:
        return (0.0,), (1.0,)
    o, wt = tlc._gl_exposure_nodes(EXPTIME, ns)
    return tuple(map(float, o)), tuple(map(float, wt))


def _compiled(fn, *args, **static):
    """``fn`` jitted and compiled for ``args`` with XLA's backend
    optimizations off: no fusion across operations, no contraction of a
    product and a sum into one rounding, as when JAX runs the operations
    one at a time. Under the default options XLA's fused CPU code moves
    the deficit's first A-segment node at k just above 1 (fully occulted,
    D = 1) by up to 4e-3, and the coefficients by 4.6e-4."""
    return jax.jit(partial(fn, **static)).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def _jax_chain_fn(a, ns):
    time, obs, k, P, aR, inc, e, w, u1, u2, g = a
    cA, cB1, cB2, *segs = jfc.cheb_deficit_coeffs(k, u1, u2)
    if ns > 1:
        q0, q1, q2, front = jfc.exposure_z2_poly(time, EXPTIME / 2.0, P, aR,
                                                 inc, e, w)
    else:
        z, front = j_projected_z(time[None, :], 0.0, P[:, None], aR[:, None],
                                 inc[:, None], e[:, None], w[:, None])
        q0 = z * z
        q1, q2 = jnp.zeros_like(q0), jnp.zeros_like(q0)
    offs, wgts = _nodes(ns)
    return j_chi2(q0, q1, q2, front.astype(jnp.float32), cA, cB1, cB2,
                  jnp.stack(segs, axis=1), g[:, None], obs[None, :],
                  offs=offs, wgts=wgts, interpret=True)


_CHAINS = {}


def _jax_chain(a, ns):
    """The JAX package's chi^2 of one target under exact coefficients: its
    ``cheb_deficit_coeffs``, the exposure z^2 planes and the v2 Pallas
    kernel in interpret mode (float64 result), compiled once per shape."""
    a = tuple(map(jnp.asarray, a))
    key = (ns, tuple(x.shape for x in a))
    if key not in _CHAINS:
        _CHAINS[key] = _compiled(_jax_chain_fn, a, ns=ns)
    return np.asarray(_CHAINS[key](a), np.float64)


def _port_args(per, to=torch.as_tensor):
    """``chi2_from_orbit_exact``'s (time, P, a_R, inc, e, w, k, u1, u2, g,
    obs_dev) over the targets of ``per`` (a list of ``_draws``): time and
    obs (B, n_t), the draws target-major."""
    t = [[to(x) for x in a] for a in per]
    time = torch.stack([a[0] for a in t])
    obs = torch.stack([a[1] for a in t])
    draws = [torch.cat([a[i] for a in t]) for i in (3, 4, 5, 6, 7, 2, 8, 9,
                                                     10)]
    return (time, *draws[:5], *draws[5:], obs)


def _gate(got, want, C):
    inv = 1.0 / (2 * SIGMA ** 2)
    d = np.abs(got - want) * inv
    assert np.quantile(d, 0.99) < 0.05, np.quantile(d, 0.99)
    assert d.max() < 1.0, d.max()
    dz = abs(float(log_mean_exp_torch(torch.as_tensor(-got * inv), C))
             - float(log_mean_exp_jax(jnp.asarray(-want * inv), C)))
    assert dz < 1e-2, dz


def test_coeffs_match_jax():
    """The port's ``fastcore.cheb_deficit_coeffs`` (what the exact stage
    computes) on float32 draws over all eight k-segments against the JAX
    package's on the same float32 arrays: every output within 3e-6. The
    JAX function is compiled without fusion, so each operation rounds as
    torch's does: with XLA's fused CPU code the deficit's first A-segment
    node at k just above 1 (fully occulted, D = 1) moves by up to 4e-3,
    and the coefficients by 4.6e-4 (``_compiled``)."""
    k, u1, u2 = _kud(np.random.default_rng(5), 256)
    kud = tuple(map(jnp.asarray, (k, u1, u2)))
    want = _compiled(jfc.cheb_deficit_coeffs, *kud)(*kud)
    got = tfc.cheb_deficit_coeffs(*map(torch.as_tensor, (k, u1, u2)))
    for x, y in zip(got, want):
        assert x.dtype == torch.float32
        err = float(np.max(np.abs(x.numpy().astype(np.float64)
                                  - np.asarray(y, np.float64))))
        assert err < COEFF_TOL, err


@pytest.mark.parametrize("ns,B", [(4, 2), (1, 1)])
def test_plain_matches_jax_chain(ns, B):
    """``chi2_from_orbit_exact`` on CPU tensors (its plain version) against
    the JAX chain per target (C = 256 draws each; B = 2 targets on curves
    of their own in one call): lnL p99 < 0.05, max < 1.0, lnZ within 1e-2
    nats per target; no kernel launched."""
    per = [_draws(seed=40 + b, window=0.15 + 0.05 * b) for b in range(B)]
    offs, wgts = _nodes(ns)
    before = _counts()
    got = chi2_core.chi2_from_orbit_exact(
        *_port_args(per), offs=offs, wgts=wgts,
        ns=ns).numpy().astype(np.float64)
    assert _counts() == before
    C = per[0][2].size
    for b, a in enumerate(per):
        _gate(got[b * C:(b + 1) * C], _jax_chain(a, ns), C)


def test_route():
    """``lightcurve.in_kernel_coeffs`` for every (device, dtype, backend,
    schedule): on a CUDA device "tab" wherever the coefficients are
    tabulated (backend "tab", or "auto" with float32 draws), "exact" for
    float32 draws under "exact" on v2; None (the torch coefficient stage)
    otherwise, and always on the CPU."""
    for device in ("cpu", "cuda"):
        for dtype in ("float32", "float64"):
            for backend in ("auto", "tab", "exact"):
                for schedule in ("2", "3"):
                    want = None
                    if device == "cuda":
                        if backend == "tab" or (backend == "auto"
                                                and dtype == "float32"):
                            want = "tab"
                        elif (backend == "exact" and dtype == "float32"
                              and schedule == "2"):
                            want = "exact"
                    got = tlc.in_kernel_coeffs(
                        torch.device(device), getattr(torch, dtype),
                        backend, schedule)
                    assert got == want, (device, dtype, backend, schedule)


def test_plain_group_rule():
    """``chi2_supersampled_plain`` with ``group``, the v2 kernels' skip
    rule, against the rule spelled out run by run: each run of ``group``
    points of a draw (from t = 0; the last one short) adds its points'
    chi^2 terms only if one of its points is in front with z^2 < zmax^2 at
    an exposure node; obs^2 counts at every point. With every run seen it
    equals the every-point default."""
    a = _draws(N=64, n_t=70, seed=70)
    time, obs, k, P, aR, inc, e, w, u1, u2, g = map(torch.as_tensor, a)
    offs, wgts = _nodes(4)
    cA, cB1, cB2, *segs = tfc.cheb_deficit_coeffs(k, u1, u2)
    seg = torch.stack(segs, 1)
    planes = chi2_core.orbit_planes(time, P, aR, inc, e, w, 4)
    rest = (cA, cB1, cB2, seg, g[:, None], obs[None, :])
    kw = dict(offs=offs, wgts=wgts)
    got = chi2_core.chi2_supersampled_plain(*planes, *rest, group=32, **kw)
    zmax2 = (segs[1] + 1.0 / segs[4]) ** 2
    obs2 = float(torch.sum(obs * obs))
    want = np.full(64, obs2)
    n_seen = 0
    for c in range(64):
        for t0 in range(0, 70, 32):
            cols = slice(t0, min(t0 + 32, 70))
            q0, q1, q2, fr = (x[c:c + 1, cols] for x in planes)
            seen = any(bool(((q0 + q1 * d + q2 * (d * d) < zmax2[c])
                             & (fr > 0)).any()) for d in offs)
            if seen:
                n_seen += 1
                one = chi2_core.chi2_supersampled_plain(
                    q0, q1, q2, fr, *(x[c:c + 1] for x in rest[:5]),
                    rest[5][:, cols], **kw)
                want[c] += float(one) - float(
                    torch.sum(obs[cols] * obs[cols]))
    assert 0 < n_seen < 64 * 3
    np.testing.assert_allclose(got.double().numpy(), want, rtol=2e-6,
                               atol=1e-9)
    front = torch.ones_like(planes[3])
    every = chi2_core.chi2_supersampled_plain(*planes[:3], front, *rest,
                                              **kw)
    inside = (torch.zeros_like(planes[0]),) * 3 + (front,)
    assert torch.equal(
        chi2_core.chi2_supersampled_plain(*inside, *rest, group=32, **kw),
        chi2_core.chi2_supersampled_plain(*inside, *rest, **kw))
    assert not torch.equal(
        chi2_core.chi2_supersampled_plain(*planes[:3], front, *rest,
                                          group=32, **kw), every)


def test_fused_cpu_route_under_exact(monkeypatch):
    """On CPU tensors under "exact" ``_chi2_fused`` keeps its route, the
    torch exact stage into the orbit plain version: exactly
    ``chi2_from_orbit_exact``'s plain version, no launch."""
    monkeypatch.setattr(tfc, "COEFFS_BACKEND", "exact")
    a = _draws(n_t=24)
    time, obs, k, P, aR, inc, e, w, u1, u2, g = map(torch.as_tensor, a)
    offs, wgts = _nodes(20)
    want = chi2_core.chi2_from_orbit_exact_plain(
        *_port_args([a]), offs=offs, wgts=wgts, ns=20)
    before = _counts()
    got = tlc._chi2_fused(time, EXPTIME, obs, k, P, aR, inc, e, w, u1, u2,
                          g, 24, 20)
    assert _counts() == before
    assert torch.equal(got, want)


def test_wrappers_on_cpu():
    """``chi2_from_orbit_exact`` checks dtype, shape, the draw multiple of
    256 and ns = 1's one node before anything runs, and on the CPU is the
    torch exact stage into ``chi2_from_orbit_plain``;
    ``deficit_coeffs_exact`` on the CPU is ``fastcore.cheb_deficit_coeffs``
    and checks its inputs; neither launches."""
    a = _draws(n_t=24)
    args = _port_args([a])
    offs, wgts = _nodes(20)
    kw = dict(offs=offs, wgts=wgts, ns=20)
    fn = chi2_core.chi2_from_orbit_exact
    before = _counts()
    with pytest.raises(TypeError, match="float32"):
        fn(*args[:6], args[6].double(), *args[7:], **kw)
    with pytest.raises(ValueError, match="shape"):
        fn(*args[:7], args[7][:128], *args[8:], **kw)
    short = (args[0], *(x[:128] for x in args[1:10]), args[10])
    with pytest.raises(ValueError, match="multiple of 256"):
        fn(*short, **kw)
    with pytest.raises(ValueError, match="ns = 1"):
        fn(*args, offs=offs, wgts=wgts, ns=1)
    got = fn(*args, offs=(0.0,), wgts=(1.0,), ns=1)
    time, P, aR, inc, e, w, k, u1, u2, g, obs = args
    want_c = tfc.cheb_deficit_coeffs(k, u1, u2)
    cA, cB1, cB2, *segs = want_c
    want = chi2_core.chi2_from_orbit_plain(
        time, P, aR, inc, e, w, cA, cB1, cB2, torch.stack(segs, 1),
        g[:, None], obs, offs=(0.0,), wgts=(1.0,), ns=1)
    assert torch.equal(got, want)
    for x, y in zip(chi2_core.deficit_coeffs_exact(k, u1, u2), want_c):
        assert torch.equal(x, y)
    with pytest.raises(TypeError, match="float32"):
        chi2_core.deficit_coeffs_exact(k.double(), u1, u2)
    with pytest.raises(ValueError, match="C >= 1"):
        chi2_core.deficit_coeffs_exact(k[:0], u1[:0], u2[:0])
    assert _counts() == before


def test_targets_on_cpu():
    """B = 3 targets in one call give each target's draws what a call on
    that target alone gives."""
    per = [_draws(n_t=24, seed=50 + b) for b in range(3)]
    offs, wgts = _nodes(20)
    kw = dict(offs=offs, wgts=wgts, ns=20)
    got = chi2_core.chi2_from_orbit_exact(*_port_args(per), **kw)
    alone = torch.cat([chi2_core.chi2_from_orbit_exact(*_port_args([a]),
                                                       **kw) for a in per])
    np.testing.assert_allclose(got.numpy(), alone.numpy(), rtol=1e-6, atol=0)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")


def _plus(counts, name):
    return {**counts, name: counts[name] + 1}


@pytest.mark.cuda
@pytest.mark.parametrize("n_t,ns", [(100, 20), (137, 1), (2000, 20)])
def test_kernel_matches_plain_on_card(n_t, ns):
    """On the card: the exact kernel against its plain version under the v2
    skip rule (``group=V2_GROUP``) on the same CUDA tensors (C = 8192, k
    over all eight k-segments) with the lnL gates on every draw, at n_t =
    2000 on the draws within 50 of the best lnL (f32 summation order moves
    the far-off draws' |lnL| ~ 1e4 by O(1)), and lnZ within 1e-2."""
    _card()
    a = _draws(N=8192, n_t=n_t, seed=9)
    args = _port_args([a], lambda x: torch.as_tensor(x, device="cuda"))
    offs, wgts = _nodes(ns)
    before = _counts()
    kern = chi2_core.chi2_from_orbit_exact(*args, offs=offs, wgts=wgts,
                                           ns=ns)
    assert _counts() == _plus(before, "launch.chi2_from_orbit_exact")
    plain = chi2_core.chi2_from_orbit_exact_plain(
        *args, offs=offs, wgts=wgts, ns=ns, group=chi2_core.V2_GROUP)
    inv = 1.0 / (2 * SIGMA ** 2)
    lnL_k = (-kern.double() * inv).cpu().numpy()
    lnL_p = (-plain.double() * inv).cpu().numpy()
    d = np.abs(lnL_k - lnL_p)
    near = lnL_p > lnL_p.max() - 50.0 if n_t > 1000 else np.ones_like(
        d, bool)
    assert np.quantile(d[near], 0.99) < 0.05 and d[near].max() < 1.0
    dz = abs(float(log_mean_exp_torch(torch.as_tensor(lnL_k), 8192))
             - float(log_mean_exp_torch(torch.as_tensor(lnL_p), 8192)))
    assert dz < 1e-2, dz


@pytest.mark.cuda
@pytest.mark.parametrize("n_t,ns", [(100, 20), (2000, 20)])
def test_kernel_matches_copy_stage_on_card(n_t, ns):
    """On the card: the exact kernel against its yardstick, orbit v2
    (``chi2_from_orbit``, the copy stage) on the torch exact coefficients
    of the same draws, with the lnL gates on the draws within 50 of the
    best lnL."""
    _card()
    a = _draws(N=8192, n_t=n_t, seed=9)
    args = _port_args([a], lambda x: torch.as_tensor(x, device="cuda"))
    offs, wgts = _nodes(ns)
    kw = dict(offs=offs, wgts=wgts, ns=ns)
    kern = chi2_core.chi2_from_orbit_exact(*args, **kw)
    time, P, aR, inc, e, w, k, u1, u2, g, obs = args
    cA, cB1, cB2, *segs = tfc.cheb_deficit_coeffs(k, u1, u2)
    copy = chi2_core.chi2_from_orbit(
        time, P, aR, inc, e, w, cA.contiguous(), cB1.contiguous(),
        cB2.contiguous(), torch.stack(segs, 1), g[:, None].contiguous(), obs,
        **kw)
    inv = 1.0 / (2 * SIGMA ** 2)
    lnL_c = (-copy.double() * inv).cpu().numpy()
    d = ((kern - copy).abs().double() * inv).cpu().numpy()
    near = lnL_c > lnL_c.max() - 50.0
    assert np.quantile(d[near], 0.99) < 0.05 and d[near].max() < 1.0


@pytest.mark.cuda
def test_coeffs_match_cpu_on_card():
    """On the card, under set_float32_matmul_precision("high"): the
    kernel's own exact coefficient function within 3e-6 of the CPU's
    ``cheb_deficit_coeffs`` over all eight k-segments, the breaks and
    values outside them."""
    _card()
    cpu = [torch.as_tensor(x) for x in _kud(np.random.default_rng(17),
                                            32768)]
    want = tfc.cheb_deficit_coeffs(*cpu)
    before = _counts()
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        got = chi2_core.deficit_coeffs_exact(*(x.cuda() for x in cpu))
        torch.cuda.synchronize()
    finally:
        torch.set_float32_matmul_precision(prev)
    assert _counts() == _plus(before, "launch.deficit_coeffs_exact")
    for x, y in zip(got, want):
        assert float((x.cpu() - y).abs().max()) < COEFF_TOL


@pytest.mark.cuda
def test_targets_in_one_launch_on_card():
    """On the card: one launch over B = 4 targets (each its own curve)
    equals four one-target launches draw for draw."""
    _card()
    per = [_draws(N=4096, n_t=100, seed=60 + b, window=0.15 + 0.03 * b)
           for b in range(4)]

    def cuda(x):
        return torch.as_tensor(x, device="cuda")

    offs, wgts = _nodes(20)
    kw = dict(offs=offs, wgts=wgts, ns=20)
    before = _counts()
    kern = chi2_core.chi2_from_orbit_exact(*_port_args(per, cuda), **kw)
    assert _counts() == _plus(before, "launch.chi2_from_orbit_exact")
    singles = torch.cat([chi2_core.chi2_from_orbit_exact(
        *_port_args([a], cuda), **kw) for a in per])
    torch.testing.assert_close(kern, singles, rtol=0, atol=0)


@pytest.mark.cuda
def test_fused_route_on_card(monkeypatch):
    """On the card under "exact" on v2, ``_chi2_fused`` launches the exact
    kernel and nothing else; under v3 the torch exact stage feeds orbit
    v3."""
    _card()
    monkeypatch.setattr(tfc, "COEFFS_BACKEND", "exact")
    a = _draws(N=4096, n_t=100)
    time, obs, k, P, aR, inc, e, w, u1, u2, g = (
        torch.as_tensor(x, device="cuda") for x in a)
    for sched, counter in (("2", "launch.chi2_from_orbit_exact"),
                           ("3", "launch.chi2_from_orbit_v3")):
        monkeypatch.setattr(tlc, "CHI2_SCHEDULE", sched)
        before = _counts()
        tlc._chi2_fused(time, EXPTIME, obs, k, P, aR, inc, e, w, u1, u2, g,
                        100, 20)
        assert _counts() == _plus(before, counter)
