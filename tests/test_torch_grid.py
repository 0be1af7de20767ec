"""The port's process grid and catalog replay against the JAX package.

Four gloo ranks on a 2 x 2 (targets x draws) grid, started by
torch.multiprocessing with a file store, hold the JAX package's 2 x 2
mesh within the one-process gates of test_torch_sharding.py. The patched
uniforms ignore the key, so both draw shards see the same draws on both
sides, and the gates check the draws-axis reduction and the targets
gather exactly. batch_fpp_tp_eb holds the JAX one in one process, and the
catalog replay runs on the CPU in both modes.
"""

import os
import time
from datetime import timedelta

import jax
import numpy as np
import pandas as pd
import pytest
import torch

import triceratops_tpu.parallel.sharding as jsh
from triceratops_tpu_torch.parallel import sharding as tsh
from triceratops_tpu_torch.scenarios import engine as teng

from test_sharding import _transit_lc
from test_torch_shared import (  # noqa: F401
    shared_uniforms, uniforms_np, _torch_randint)
from test_torch_sharding import (  # noqa: F401
    N_LOCAL, N_T, NS, _assert_parity, _jax_run, _one_thread, _port_kw,
    targets, unfolded_uniforms)

# the grid case keeps TP, EB, EBx2P, DTP, BTP and the nearby rows: a plain
# and a twin denominator, a background table and a padding slot, for a
# third of the reference's compile time
GRID_DROP = ("PTP", "PEB", "PEBx2P", "STP", "SEB", "SEBx2P", "DEB", "DEBx2P",
             "BEB", "BEBx2P")
REPLAY_COLUMNS = ["TOI", "TICID", "Rp", "Porb", "FPP", "NFPP", "FPP_paper",
                  "NFPP_paper", "Classification"]


def _grid_rank(rank, store, targets, out_dir):
    """One of four gloo ranks of a 2 x 2 grid, with the shared uniforms
    installed in this process."""
    torch.set_num_threads(1)
    teng._uniforms = lambda gen, n, N: [torch.as_tensor(a)
                                        for a in uniforms_np(n, N)]
    teng._randint = _torch_randint
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{store}", world_size=4, rank=rank,
        timeout=timedelta(seconds=120))
    try:
        mesh = tsh.make_mesh(4, n_target_shards=2)
        assert (mesh.t_idx, mesh.d_idx) == divmod(rank, 2)
        batch, kw = _port_kw(targets)
        out = tsh.batch_fpp_full(mesh, batch, N=2 * N_LOCAL,
                                 drop_scenario=GRID_DROP, **kw)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), *out)
    finally:
        torch.distributed.destroy_process_group()


def test_four_rank_grid_matches_jax_mesh(targets, unfolded_uniforms,
                                         tmp_path):
    """Four gloo ranks (2 target shards x 2 draw shards, one target each)
    against the JAX 2 x 2 mesh: every rank returns the whole batch, equal
    to the JAX one within the 1e-2 nats gate."""
    import torch.multiprocessing as mp

    want = _jax_run(targets, 2, 2, GRID_DROP)
    ranks = mp.spawn(_grid_rank, args=(str(tmp_path / "store"), targets,
                                       str(tmp_path)), nprocs=4, join=False)
    deadline = time.monotonic() + 300
    while not ranks.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ranks.processes:
                p.kill()
            pytest.fail("the four gloo ranks did not finish in 300 s")
    outs = [np.load(tmp_path / f"rank{r}.npz") for r in range(4)]
    got = tuple(outs[0][f"arr_{i}"].astype(np.float64) for i in range(3))
    for o in outs[1:]:
        for i in range(3):
            np.testing.assert_array_equal(o[f"arr_{i}"], outs[0][f"arr_{i}"])
    _assert_parity(got, want)


def test_tp_eb_batch_matches_jax(unfolded_uniforms):
    """batch_fpp_tp_eb (TP, EB, EBx2P) against the JAX one on a 1 x 1
    mesh."""
    B = 2
    time, flux, sigma, P = _transit_lc(n_t=N_T)
    rng = np.random.default_rng(0)
    obs = np.stack([flux - 1.0, rng.normal(0, sigma, N_T)]).astype(np.float32)
    times = np.tile(time.astype(np.float32), (B, 1))
    scal = [np.full(B, v, np.float32)
            for v in (sigma, P, 1.0, 1.0, 5800.0, 0.4, 0.2)]
    mesh = jsh.make_mesh(1, devices=jax.devices("cpu")[:1])
    jfpp, jlnZ = jsh.batch_fpp_tp_eb(
        mesh, jax.random.split(jax.random.key(0), B), times, obs, *scal,
        N=N_LOCAL, n_t=N_T, ns=NS, chunk=1024)
    fpp, lnZ = tsh.batch_fpp_tp_eb(None, [0, 1], times, obs, *scal,
                                   N=N_LOCAL, n_t=N_T, ns=NS, device="cpu")
    assert lnZ.shape == (B, 3)
    assert np.abs(lnZ - np.asarray(jlnZ)).max() < 1e-2
    assert np.abs(fpp - np.asarray(jfpp)).max() < 1e-3


def test_target_entry_batch_equals_calc_probs(shared_uniforms, tmp_path):
    """On shared draws the batch path of a frontend target with two nearby
    stars (target_entry) gives calc_probs' 21 rows: the target rows to f32
    round-off, the nearby rows within 1e-3 nats (their curve is the
    renormalized one over fr / fr0, not the raw one over fr)."""
    from triceratops_tpu_torch import target
    from triceratops_tpu_torch.populations.synthetic import (
        make_synthetic_trilegal)
    from test_torch_slice import _curve, _stars

    tri = make_synthetic_trilegal(tmp_path / "tri.csv", Tmag_target=10.0,
                                  seed=1)
    time, flux, sigma = _curve(n_t=N_T)
    t = target.from_stars(_stars(), trilegal_fname=tri)
    t.calc_depths(tdepth=0.005)
    t.calc_probs(time, flux, sigma, P_orb=3.0, N=4096, nsamples=NS,
                 verbose=0, device="cpu")
    entry = tsh.target_entry(t, time, flux, sigma, 3.0)
    assert len(entry["nearby"]) == 2 and entry["nearby"][0]["fluxratio"] < 1
    batch, kw = _port_kw([entry])
    fpp, nfpp, lnZ = tsh.batch_fpp_full(None, batch, N=4096, **kw)
    assert lnZ.shape == (1, 21)
    np.testing.assert_allclose(lnZ[0, :15], t.lnZ[:15], rtol=0, atol=1e-4)
    np.testing.assert_allclose(lnZ[0, 15:], t.lnZ[15:], rtol=0, atol=1e-3)
    assert abs(fpp[0] - t.FPP) < 1e-4 and abs(nfpp[0] - t.NFPP) < 1e-4


@pytest.mark.parametrize("sharded", [False, True], ids=["serial", "sharded"])
def test_catalog_replay(sharded, tmp_path, monkeypatch):
    """Both modes of the replay on the CPU write the JAX tool's csv
    columns (the serial one adds its wall_s), finite FPPs in [0, 1]."""
    from triceratops_tpu_torch.tools import catalog_replay

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    out = tmp_path / "replay.csv"
    kw = dict(n_targets=2, N=4096, out_csv=str(out), n_t=N_T, ns=NS,
              device="cpu", workdir=str(tmp_path))
    (catalog_replay.main_sharded if sharded else catalog_replay.main)(**kw)
    df = pd.read_csv(out)
    want = REPLAY_COLUMNS if sharded else REPLAY_COLUMNS + ["wall_s"]
    assert list(df.columns) == want
    assert len(df) == 2
    assert np.all((df["FPP"] >= 0) & (df["FPP"] <= 1))
