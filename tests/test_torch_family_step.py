"""The batched family programs of the multi-target path: one likelihood core
per scenario row over all of a rank's targets, down to the orbit kernels'
target axis.

* ``batch_fpp_full`` over three targets (different sigma, P and R_s, one
  with a nearby star and a contrast curve) against the same targets run
  one at a time (B = 1 batches, the same seeds): every row within 1e-5
  nats, -inf matched, also with dropped rows and with MOLUSC on;
* the batched cores (``lnL_planet``, ``lnL_eb``) per draw against each
  target alone, on the CPU route and on the grouped route the card takes
  (targets sharing one orbit-kernel step);
* ``chi2_from_orbit`` / ``_v3`` on (B, n_t) inputs (their plain version on
  the CPU) against ``jax.vmap`` of the JAX package's fused step
  ``lightcurve._chi2_pallas`` with the Pallas kernel in interpret mode,
  with the gates of tests/test_torch_chi2_core.py: lnL p99 < 0.05, max <
  1.0, lnZ within 1e-2 nats;
* the wrappers' rejections, and on the card the batched kernels against
  their plain version and against one launch per target.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from triceratops_tpu.core.numerics import log_mean_exp_jax
from triceratops_tpu.ops import lightcurve as jlc
from triceratops_tpu.populations.synthetic import make_synthetic_trilegal
from triceratops_tpu_torch.core.numerics import log_mean_exp_torch
from triceratops_tpu_torch.ops import chi2_core
from triceratops_tpu_torch.ops import lightcurve as tlc
from triceratops_tpu_torch.parallel import sharding as tsh

from test_sharding import _transit_lc
from test_torch_chi2_core import ORBIT, _counts, _inputs, _orbit_args
from test_torch_companions import molusc_file  # noqa: F401

N = 4096
N_T = 24
NS = 2
SIGMA = 5e-4
# per target: (P [d], planet radius [Re], sigma, R_s)
TARGETS = ((3.0, 3.0, 5e-4, 1.0), (2.1, 2.0, 3e-4, 0.8),
           (4.5, 4.0, 8e-4, 1.3))


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def entries(tmp_path_factory):
    """Three targets on their own curves and one field; the first with a
    nearby star and a contrast curve (the others have a padding slot)."""
    tri = make_synthetic_trilegal(
        str(tmp_path_factory.mktemp("family") / "trilegal.csv"),
        Tmag_target=10.0, seed=1)
    out = []
    for i, (P, rp, sigma, R_s) in enumerate(TARGETS):
        time, flux, _, _ = _transit_lc(n_t=N_T, seed=20 + i, P=P, rp_re=rp,
                                       sigma=sigma)
        out.append(dict(time=time, flux=flux, sigma=sigma, P_orb=P, M_s=1.0,
                        R_s=R_s, Teff=5800.0, Z=0.0, plx=10.0, Tmag=10.0,
                        Jmag=9.3, Hmag=9.1, Kmag=9.0, trilegal_fname=tri,
                        key=31 + i))
    out[0]["nearby"] = [dict(mass=0.8, rad=0.8, Teff=5000.0, Z=0.0,
                             fluxratio=0.01, tdepth=0.5)]
    out[0]["contrast_curve"] = (np.array([0.1, 0.5, 1.0, 2.0]),
                                np.array([2.0, 5.0, 6.5, 7.5]))
    return out


def _run(entries, **kw):
    batch, n_t, has_cc = tsh.prepare_target_batch(entries, device="cpu")
    return tsh.batch_fpp_full(None, batch, N=N, n_t=n_t, ns=NS, chunk=1024,
                              has_cc=has_cc, cc_filt="TESS", device="cpu",
                              **kw)


@pytest.mark.parametrize("case", ["analytic", "molusc_dropped"])
def test_batch_equals_one_target_at_a_time(entries, case, molusc_file,
                                           monkeypatch):
    """The batched family step against each target alone (the same keys,
    so the same streams): per-row lnZ within 1e-5 nats, -inf matched, and
    one likelihood core per computed row over the batch. The second case
    reads a MOLUSC file and drops a whole family (PEB), one branch of a
    pair (SEBx2P) and a planet row (DTP)."""
    drop = ("PEB", "PEBx2P", "SEBx2P", "DTP") if case != "analytic" else ()
    ents = ([dict(e, molusc_file=molusc_file) for e in entries]
            if case != "analytic" else entries)
    cores = []
    for name in ("lnL_planet", "lnL_eb"):
        real = getattr(tsh, name)
        monkeypatch.setattr(tsh, name, lambda *a, _f=real, **k: (
            cores.append(1), _f(*a, **k))[1])
    fpp, nfpp, lnZ = _run(ents, drop_scenario=drop)
    assert len(cores) == 15 - len(drop) + 3
    assert lnZ.shape == (3, 18)
    dropped = [i for i, s in enumerate(tsh.FULL_SCENARIOS) if s in drop]
    assert np.all(np.isneginf(lnZ[:, dropped]))
    assert np.all(np.isneginf(lnZ[1:, 15:]))
    for i, e in enumerate(ents):
        f1, n1, z1 = _run([e], drop_scenario=drop)
        n = z1.shape[1]
        np.testing.assert_array_equal(np.isneginf(lnZ[i, :n]),
                                      np.isneginf(z1[0]))
        fin = np.isfinite(z1[0])
        assert fin.sum() == n - len(drop)
        d = np.abs(lnZ[i, :n][fin] - z1[0][fin])
        assert d.max() < 1e-5, (i, d.max())
        assert abs(fpp[i] - f1[0]) < 1e-6 and abs(nfpp[i] - n1[0]) < 1e-6


def _core_inputs(B=3, N_per=640, seed=12):
    """B targets' curves (time, obs (B, n_t), sigma (B,)) and B * N_per
    planet and EB draws, target-major."""
    rng = np.random.default_rng(seed)
    arrs = [_inputs(N=N_per, n_t=40, seed=seed + b) for b in range(B)]
    time = torch.as_tensor(np.stack([a[0] * (1 + 0.1 * b)
                                     for b, a in enumerate(arrs)]))
    obs = torch.as_tensor(np.stack([a[1] for a in arrs]))
    sigma = np.asarray([5e-4, 3e-4, 9e-4][:B], np.float32)
    draws = [torch.as_tensor(np.concatenate([a[i] for a in arrs]))
             for i in range(2, 11)]
    mask = torch.as_tensor(rng.uniform(size=B * N_per) > 0.1)
    k = draws[0]
    k_eb = torch.clamp(k * 8.0, 0.05, 0.9)
    g = torch.as_tensor(10 ** rng.uniform(-4.0, -2.0, B * N_per),
                        dtype=torch.float32)
    return time, obs, sigma, draws, mask, k_eb, g


@pytest.mark.parametrize("grouped", [False, True], ids=["cpu", "grouped"])
def test_batched_cores_equal_each_target_alone(grouped, monkeypatch):
    """lnL_planet and lnL_eb (veto on, each target's own 1.5 sigma depth)
    over three targets equal each target's own call draw for draw. The
    grouped case takes the card's route on the CPU: the targets share
    orbit-kernel steps (one step of all three at the default cap, two
    at a cap of two targets), the plain version standing in for the
    kernel."""
    time, obs, sigma, draws, mask, k_eb, g = _core_inputs()
    # the CPU route in chunks of 256 (three per target), the grouped one
    # at the card's orbit_chunk (one per target)
    kw = dict(exptime=0.00139, n_t=40, ns=20,
              chunk=None if grouped else 256)
    N_per = draws[0].shape[0] // 3
    if grouped:
        monkeypatch.setattr(tlc, "_grouped", lambda *a: True)
    caps = (tlc.DRAW_CAP, 2 * tlc.orbit_chunk(N_per)) if grouped else (None,)
    for cap in caps:
        if cap:
            monkeypatch.setattr(tlc, "DRAW_CAP", cap)
        got_p = tlc.lnL_planet(time, obs, sigma, *draws, mask, **kw)
        got_e = tlc.lnL_eb(time, obs, sigma, k_eb, 1.0 / k_eb,
                           *draws[1:8], g, g, mask, **kw)
        for b in range(3):
            s = slice(b * N_per, (b + 1) * N_per)
            one = [x[s] for x in draws]
            want_p = tlc.lnL_planet(time[b], obs[b], sigma[b], *one, mask[s],
                                    **kw)
            want_e = tlc.lnL_eb(time[b], obs[b], sigma[b], k_eb[s],
                                1.0 / k_eb[s], *one[1:8], g[s], g[s],
                                mask[s], **kw)
            torch.testing.assert_close(got_p[s], want_p, rtol=0, atol=0)
            torch.testing.assert_close(got_e[s], want_e, rtol=0, atol=0)
            assert 0 < int(torch.isinf(want_e).sum()) < N_per


def test_launch_groups():
    """Whole targets share a step while their chunks fit DRAW_CAP; a target
    of several chunks runs one chunk per step; the CPU route one chunk
    per step."""
    c = tlc.orbit_chunk(10**6)
    assert list(tlc._launch_groups(8, 1, c, True)) == [
        (slice(0, 8), slice(0, 8 * c))]
    assert list(tlc._launch_groups(9, 1, c, True)) == [
        (slice(0, 8), slice(0, 8 * c)), (slice(8, 9), slice(8 * c, 9 * c))]
    assert list(tlc._launch_groups(2, 2, 512, True)) == [
        (slice(b, b + 1), slice(p * 512, (p + 1) * 512))
        for p, b in enumerate((0, 0, 1, 1))]
    assert [g for g, _ in tlc._launch_groups(3, 1, 512, False)] == [
        slice(0, 1), slice(1, 2), slice(2, 3)]


def _orbit_batch(B, Cb, ns, seed=14, to=torch.as_tensor):
    """B targets' orbit-kernel arguments: each target its own curve (time
    window and noise) and Cb draws, target-major; and the numpy inputs."""
    arrs = [_inputs(N=Cb, n_t=40, seed=seed + b) for b in range(B)]
    for b, a in enumerate(arrs):
        a[0] = (a[0] * (1.0 + 0.2 * b)).astype(np.float32)
    per = [_orbit_args(a, ns, to) for a in arrs]
    offs, wgts = per[0][1:]
    args = [torch.stack([p[0][0] for p in per])]
    args += [torch.cat([p[0][i] for p in per]) for i in range(1, 11)]
    args.append(torch.cat([p[0][11] for p in per]))
    return args, offs, wgts, arrs


@pytest.mark.parametrize("ns", [4, 1])
@pytest.mark.parametrize("schedule", ["2", "3"])
def test_plain_matches_vmapped_jax_chi2_pallas(schedule, ns, monkeypatch):
    """The orbit wrapper at B = 3 on CPU tensors (its plain version)
    against jax.vmap of the JAX package's ``_chi2_pallas`` (the Pallas
    kernel of the same schedule in interpret mode) over the targets, on
    the same f32 draws: per target lnL p99 < 0.05, max < 1.0, lnZ within
    1e-2 nats."""
    monkeypatch.setattr(jlc, "PALLAS_V", schedule)
    B, Cb = 3, 256
    args, offs, wgts, arrs = _orbit_batch(B, Cb, ns)
    cols = [jnp.asarray(np.stack([a[i] for a in arrs])) for i in range(11)]
    time, obs, k, P, aR, inc, e, w, u1, u2, g = cols
    want = np.asarray(jax.vmap(
        lambda t, o, *d: jlc._chi2_pallas(t, 0.00139, o, *d, 40, ns, True))(
            time, obs, k, P, aR, inc, e, w, u1, u2, g), np.float64)
    name, _ = ORBIT[schedule]
    before = _counts()
    got = getattr(chi2_core, name)(*args, offs=offs, wgts=wgts, ns=ns)
    assert _counts() == before
    got = got.numpy().astype(np.float64).reshape(B, Cb)
    inv = 1.0 / (2 * SIGMA ** 2)
    for b in range(B):
        d = np.abs(got[b] - want[b]) * inv
        assert np.quantile(d, 0.99) < 0.05 and d.max() < 1.0, (b, d.max())
        dz = abs(float(log_mean_exp_torch(torch.as_tensor(-got[b] * inv),
                                          Cb))
                 - float(log_mean_exp_jax(jnp.asarray(-want[b] * inv), Cb)))
        assert dz < 1e-2, (b, dz)


@pytest.mark.parametrize("schedule", ["2", "3"])
def test_wrapper_rejects_bad_target_layouts(schedule):
    """Draws per target not a multiple of the tile, a draw total that is
    not B x Cb, and time / obs_dev row counts that differ, before anything
    runs; B = 3 on the CPU gives the plain result."""
    fn = getattr(chi2_core, ORBIT[schedule][0])
    tile = chi2_core.DRAW_TILE if schedule == "2" else chi2_core.DRAW_LANES
    args, offs, wgts, _ = _orbit_batch(3, tile, 4)
    kw = dict(offs=offs, wgts=wgts, ns=20)
    torch.testing.assert_close(
        fn(*args, **kw), chi2_core.chi2_from_orbit_plain(*args, **kw),
        rtol=0, atol=0)
    with pytest.raises(ValueError, match=f"multiple of {tile}"):
        fn(args[0][:2], *(x[:tile] for x in args[1:11]), args[11][:2], **kw)
    with pytest.raises(ValueError, match="not B x Cb"):
        fn(args[0][:2], *(x[:2 * tile + 1] for x in args[1:11]),
           args[11][:2], **kw)
    with pytest.raises(ValueError, match="obs_dev has shape"):
        fn(*args[:11], args[11][:2], **kw)
    with pytest.raises(ValueError, match="obs_dev has shape"):
        fn(args[0][0], *args[1:], **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("n_t,ns", [(100, 20), (137, 1)])
@pytest.mark.parametrize("schedule", ["2", "3"])
def test_batched_kernel_on_card(schedule, n_t, ns):
    """On the card: one launch over three targets against the plain version
    (the lnL-scale gates above) and, draw for draw, against one launch per
    target."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    B, Cb = 3, 4096
    arrs = [_inputs(N=Cb, n_t=n_t, seed=40 + b) for b in range(B)]
    for b, a in enumerate(arrs):
        a[0] = (a[0] * (1.0 + 0.2 * b)).astype(np.float32)
    per = [_orbit_args(a, ns, lambda x: torch.as_tensor(x, device="cuda"))
           for a in arrs]
    offs, wgts = per[0][1:]
    args = ([torch.stack([p[0][0] for p in per])]
            + [torch.cat([p[0][i] for p in per]) for i in range(1, 12)])
    name, counter = ORBIT[schedule]
    fn = getattr(chi2_core, name)
    before = _counts()
    kern = fn(*args, offs=offs, wgts=wgts, ns=ns)
    assert _counts() == {**before, counter: before[counter] + 1}
    plain = chi2_core.chi2_from_orbit_plain(*args, offs=offs, wgts=wgts,
                                            ns=ns)
    inv = 1.0 / (2 * SIGMA ** 2)
    d = ((kern - plain).abs().double() * inv).cpu().numpy()
    assert np.quantile(d, 0.99) < 0.05 and d.max() < 1.0
    singles = torch.cat([fn(*p[0], offs=offs, wgts=wgts, ns=ns)
                         for p in per])
    torch.testing.assert_close(kern, singles, rtol=0, atol=0)
