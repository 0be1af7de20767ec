"""Port vs JAX reference for the multi-target batch path
(parallel/sharding.py) in one process, and its error cases; the process
grid and the catalog replay are in test_torch_grid.py.

On shared numpy uniforms and star indices (``test_torch_shared``) the port's
``batch_fpp_full`` holds the JAX package's per-row lnZ within 1e-2 nats,
the port's evidence gate (tests/test_pallas_core.py), and FPP / NFPP
within 1e-3. N_local = 8192: at 4096 a MOLUSC twin row drifted 0.027 nats
(one draw's f32 rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import triceratops_tpu.parallel.sharding as jsh
import triceratops_tpu.scenarios.engine as jeng
from triceratops_tpu.populations.synthetic import make_synthetic_trilegal
from triceratops_tpu_torch.parallel import sharding as tsh

from test_sharding import _transit_lc
from test_torch_shared import shared_uniforms, uniforms_np  # noqa: F401
from test_torch_companions import molusc_file  # noqa: F401

N_LOCAL = 8192
N_T = 24
NS = 2
CC_FILT = "K"
# the families that read no MOLUSC row, dropped in the MOLUSC case
NO_MOLUSC = ("TP", "EB", "EBx2P", "DTP", "DEB", "DEBx2P", "BTP", "BEB",
             "BEBx2P")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _lattice_strat_unfolded(u, axes, n, key):
    """test_torch_shared._jax_lattice_strat with its permutation uniforms
    behind an optimization barrier."""
    del key
    out = list(u)
    dt = out[axes[0]].dtype
    out[axes[0]] = (jnp.arange(n, dtype=dt) + out[axes[0]]) / n
    rest = axes[1:]
    if rest:
        r = jax.lax.optimization_barrier(
            jnp.asarray(np.stack(uniforms_np(len(rest), n))))
        perms = jnp.argsort(r, axis=1)
        for j, ax in enumerate(rest):
            out[ax] = (perms[j].astype(dt) + out[ax]) / n
    return out


@pytest.fixture
def unfolded_uniforms(shared_uniforms, monkeypatch):
    """shared_uniforms with the JAX side's uniform constants behind an
    optimization barrier: the same numbers, but XLA does not fold the
    samplers' work on them (the Latin-hypercube argsorts) while it
    compiles, which takes 10-40 % off each family program's compile."""
    bar = jax.lax.optimization_barrier
    monkeypatch.setattr(jeng, "_uniforms", lambda key, n, N: [
        bar(jnp.asarray(a)) for a in uniforms_np(n, N)])
    monkeypatch.setattr(jeng, "_lattice_strat", _lattice_strat_unfolded)


@pytest.fixture(scope="module")
def targets(tmp_path_factory):
    """Two targets on one curve and field: the first with a nearby star
    and a contrast curve (in K, the band of its background delta-mags),
    the second with neither (a padding nearby slot)."""
    tri = make_synthetic_trilegal(
        str(tmp_path_factory.mktemp("shard") / "trilegal.csv"),
        Tmag_target=10.0, seed=1)
    time, flux, sigma, P = _transit_lc(n_t=N_T)
    base = dict(time=time, flux=flux, sigma=sigma, P_orb=P, M_s=1.0,
                R_s=1.0, Teff=5800.0, Z=0.0, plx=10.0, Tmag=10.0, Jmag=9.3,
                Hmag=9.1, Kmag=9.0, trilegal_fname=tri, filt=CC_FILT)
    first = dict(base, nearby=[dict(mass=0.8, rad=0.8, Teff=5000.0, Z=0.0,
                                    fluxratio=0.01, tdepth=0.5)],
                 contrast_curve=(np.array([0.1, 0.5, 1.0, 2.0]),
                                 np.array([2.0, 5.0, 6.5, 7.5])))
    return [first, dict(base)]


def _jax_run(targets, n_target_shards, n_draws, drop=()):
    """The JAX package's batch_fpp_full on a (targets x draws) CPU mesh at
    N = N_LOCAL per draw shard; its family programs are traced afresh and
    dropped after, so none traced with threefry draws, or with the patched
    ones, is reused."""
    jsh._build_family_step.cache_clear()
    try:
        jt = [dict(t, key=jax.random.key(11 + i))
              for i, t in enumerate(targets)]
        batch, n_t, has_cc = jsh.prepare_target_batch(jt)
        n = n_target_shards * n_draws
        mesh = jsh.make_mesh(n, n_target_shards=n_target_shards,
                             devices=jax.devices("cpu")[:n])
        out = jsh.batch_fpp_full(mesh, batch, N=N_LOCAL * n_draws, n_t=n_t,
                                 ns=NS, chunk=1024, has_cc=has_cc,
                                 cc_filt=CC_FILT, drop_scenario=drop)
        return tuple(np.asarray(a, np.float64) for a in out)
    finally:
        jsh._build_family_step.cache_clear()


def _port_kw(targets):
    batch, n_t, has_cc = tsh.prepare_target_batch(targets, device="cpu")
    return batch, dict(n_t=n_t, ns=NS, has_cc=has_cc, cc_filt=CC_FILT,
                       device="cpu")


def _assert_parity(got, want):
    fpp, nfpp, lnZ = got
    jfpp, jnfpp, jlnZ = want
    assert lnZ.shape == jlnZ.shape
    np.testing.assert_array_equal(np.isneginf(lnZ), np.isneginf(jlnZ))
    fin = np.isfinite(jlnZ)
    d = np.abs(lnZ[fin] - jlnZ[fin])
    assert d.max() < 1e-2, np.round(lnZ - jlnZ, 4)
    assert np.all(np.abs(fpp - jfpp) < 1e-3), (fpp, jfpp)
    assert np.all(np.abs(nfpp - jnfpp) < 1e-3), (nfpp, jnfpp)


@pytest.mark.parametrize("molusc", [False, True], ids=["analytic", "molusc"])
def test_batch_matches_jax_one_process(targets, molusc, molusc_file,
                                       unfolded_uniforms, monkeypatch):
    """mesh=None against the JAX 1 x 1 mesh: B = 2, a nearby star and a
    contrast curve. The MOLUSC case drops the nine rows that read no
    MOLUSC row (their families run no sampler and no core there), so it
    also checks drop_scenario: dropped rows read -inf and the rows left
    run one likelihood core each over both targets (padding nearby slots
    none)."""
    tg = [dict(t, molusc_file=molusc_file) for t in targets] if molusc \
        else targets
    drop = NO_MOLUSC if molusc else ()
    want = _jax_run(tg, 1, 1, drop)
    cores = []
    for name in ("lnL_planet", "lnL_eb"):
        real = getattr(tsh, name)
        monkeypatch.setattr(tsh, name, lambda *a, _f=real, **k: (
            cores.append(1), _f(*a, **k))[1])
    batch, kw = _port_kw(tg)
    assert ("molusc_qs" in batch) == molusc
    got = tsh.batch_fpp_full(None, batch, N=N_LOCAL, drop_scenario=drop,
                             **kw)
    _assert_parity(got, want)
    lnZ = got[2]
    assert lnZ.shape == (2, 18)
    assert np.all(np.isneginf(lnZ[1, 15:])) and got[1][1] == 0.0
    kept = 15 - len(drop)
    assert len(cores) == kept + 3
    dropped = [i for i, s in enumerate(tsh.FULL_SCENARIOS) if s in drop]
    assert np.all(np.isneginf(lnZ[:, dropped]))
    assert np.isfinite(lnZ[0]).sum() == kept + 3


class TestErrors:
    """The JAX package's error cases (tests/test_sharding.py:286-308) and
    the grid's own."""

    def test_drop_scenario_rejects_nearby_and_unknown(self, targets):
        batch, kw = _port_kw(targets)
        with pytest.raises(ValueError, match="nearby-star"):
            tsh.batch_fpp_full(None, batch, N=1024, drop_scenario=("NEB",),
                               **kw)
        with pytest.raises(ValueError, match="unknown"):
            tsh.batch_fpp_full(None, batch, N=1024, drop_scenario=("NOPE",),
                               **kw)

    def test_mixed_molusc_batch_rejected(self, targets, molusc_file):
        with pytest.raises(ValueError, match="batch-wide"):
            tsh.prepare_target_batch(
                [dict(targets[0], molusc_file=molusc_file), targets[1]],
                device="cpu")

    def test_mixed_n_t_rejected(self, targets):
        short = dict(targets[1], time=targets[1]["time"][:-1],
                     flux=targets[1]["flux"][:-1])
        with pytest.raises(ValueError, match="one n_t"):
            tsh.prepare_target_batch([targets[0], short], device="cpu")

    def test_grid_divisibility(self, targets):
        """N % n_draws and B % n_targets are checked before any work."""
        batch, kw = _port_kw(targets)
        mesh = tsh.Mesh(shape={"targets": 1, "draws": 2}, rank=0, t_idx=0,
                        d_idx=0)
        with pytest.raises(ValueError, match="draws axis"):
            tsh.batch_fpp_full(mesh, batch, N=1025, **kw)
        mesh = tsh.Mesh(shape={"targets": 3, "draws": 1}, rank=0, t_idx=0,
                        d_idx=0)
        with pytest.raises(ValueError, match="targets axis"):
            tsh.batch_fpp_full(mesh, batch, N=1024, **kw)

    def test_mesh_needs_ranks(self):
        assert tsh.make_mesh().shape == {"targets": 1, "draws": 1}
        with pytest.raises(ValueError, match="target shards"):
            tsh.make_mesh(n_target_shards=2)
