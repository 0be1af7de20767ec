"""Catalog replay driver: batch FPP vetting over many TOIs on the port.

Counterpart of the JAX package's ``tools/catalog_replay.py``, the
practical form of the paper's batch-vetting sweep (a 384-TOI catalog
replay at 1e6 draws per scenario). Results go to a csv beside the
published catalog's columns (``populations/catalogs.py``).

Two modes:

* serial (``--serial``; the default with one process): the frontend path,
  one ``target.calc_probs`` per TOI;
* sharded (``--sharded``; the default under a multi-process launch): TOIs
  stream in fixed-size batches through ``parallel.sharding.batch_fpp_full``
  on a ('targets', 'draws') process grid. The grid comes from the
  launcher's ``WORLD_SIZE`` / ``RANK`` / ``LOCAL_RANK``: rank r runs on
  ``cuda:LOCAL_RANK`` over NCCL, or on the CPU over gloo with ``--cpu``;
  one process runs the batch path alone. Only rank 0 writes the csv.

With only synthetic data offline, the sweep runs on light curves
synthesized from the catalog's (Rp, Porb) rows; swap ``build_target`` for
real per-TOI fields and folded curves to reproduce the paper's tables.

Usage:
    python -m triceratops_tpu_torch.tools.catalog_replay [n_targets] \\
        [N_draws] [--serial|--sharded] [--cpu] [--out CSV]
    torchrun --nproc-per-node=G -m triceratops_tpu_torch.tools.catalog_replay \\
        16 1000000 --sharded
"""

from __future__ import annotations

import os
import sys
import tempfile
import time as _time

import numpy as np
import pandas as pd
import torch
import torch.distributed as dist


def _synth_lc(row, n_t=100, sigma=4e-4, device="cuda"):
    """Synthetic folded light curve from a catalog (Rp, Porb) row: the
    transit deficit in float32 on ``device``, noise from a seed of the
    TOI number. Returns (time, flux, sigma, P, depth)."""
    from ..constants import G, MSUN, RSUN, REARTH
    from ..core.kepler import projected_z
    from ..ops.occult import occult_quad_deficit

    P = float(np.clip(row["Porb"], 0.8, 20.0))
    rp = float(np.clip(row["Rp"], 1.0, 16.0))
    time = np.linspace(-0.15, 0.15, n_t)
    a = ((G * MSUN) / (4 * np.pi**2) * (P * 86400) ** 2) ** (1 / 3)

    def f(v):
        return torch.as_tensor(np.asarray(v, np.float32), device=device)

    z, front = projected_z(f(time), 0.0, f(P), f(a / RSUN),
                           f(np.deg2rad(89.3)), f(0.0), f(0.0))
    D = (occult_quad_deficit(f(rp * REARTH / RSUN), z, f(0.35), f(0.25))
         * front).cpu().numpy()
    rng = np.random.default_rng(int(row["TOI"] * 100) % 2**31)
    return time, 1.0 - D + rng.normal(0, sigma, n_t), sigma, P, float(D.max())


def build_target(row, trilegal, n_t=100, sigma=4e-4, device="cuda"):
    """A one-star target of the row's synthetic curve, its depths set."""
    from ..frontend.target import target

    time, flux, sigma, P, depth = _synth_lc(row, n_t=n_t, sigma=sigma,
                                            device=device)
    stars = pd.DataFrame([dict(
        ID=str(int(row["TICID"])), Tmag=10.0, Jmag=9.3, Hmag=9.1,
        Kmag=9.0, ra=90.0, dec=-60.0, mass=1.0, rad=1.0, Teff=5800.0,
        plx=10.0, **{"sep (arcsec)": 0.0, "PA (E of N)": 0.0})])
    t = target.from_stars(stars, ID=int(row["TICID"]), sectors=[1],
                          trilegal_fname=trilegal)
    t.calc_depths(tdepth=depth)
    return t, time, flux, sigma, P


def _catalog_rows(n_targets):
    from ..populations.catalogs import vetting_catalog

    return list(vetting_catalog().sample(n_targets, random_state=0)
                .iterrows())


def _trilegal(workdir, rank=0):
    """The offline TRILEGAL field of the replay (one file per rank, so
    ranks never race on one path)."""
    from ..populations.synthetic import make_synthetic_trilegal

    return make_synthetic_trilegal(
        os.path.join(workdir, f"replay_trilegal_{rank}.csv"),
        Tmag_target=10.0, seed=1)


def _result_row(row, fpp, nfpp, **extra):
    return dict(TOI=row["TOI"], TICID=row["TICID"], Rp=row["Rp"],
                Porb=row["Porb"], FPP=float(fpp), NFPP=float(nfpp),
                FPP_paper=row["FPP"], NFPP_paper=row["NFPP"],
                Classification=row["Classification"], **extra)


def _process_grid(device):
    """(world, rank, device, started): this process's place from the
    launcher's environment; a multi-process launch joins the default
    group (NCCL on cards, gloo on the CPU)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if device is None:
        device = f"cuda:{local}" if world > 1 else "cuda"
    if world == 1 or dist.is_initialized():
        return world, rank, device, False
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group("nccl" if on_card else "gloo",
                            init_method="env://", world_size=world, rank=rank)
    return world, rank, device, True


def main_sharded(n_targets=8, N=1000000, out_csv="catalog_replay.csv",
                 n_t=100, ns=20, batch_B=8, device=None, workdir=None):
    """Grid replay: TOIs stream through ``batch_fpp_full`` in batches of
    ``batch_B`` (the last one padded with copies of its last target, whose
    rows are not written). ``device`` defaults to ``cuda:LOCAL_RANK``."""
    from ..parallel.sharding import (
        make_mesh, batch_fpp_full, prepare_target_batch)

    world, rank, device, started = _process_grid(device)
    try:
        batch_B = min(batch_B, n_targets)
        nts = 1
        for cand in range(min(world, batch_B), 0, -1):
            if world % cand == 0 and batch_B % cand == 0:
                nts = cand
                break
        mesh = make_mesh(world, n_target_shards=nts) if world > 1 else None
        nd = mesh.shape["draws"] if mesh is not None else 1
        N = -(-N // nd) * nd
        if rank == 0:
            print(f"grid {mesh.shape if mesh else {'targets': 1, 'draws': 1}}"
                  f" on {device}; {n_targets} targets x {N} draws, batches "
                  f"of {batch_B}")
        cat_rows = _catalog_rows(n_targets)
        trilegal = _trilegal(workdir or tempfile.gettempdir(), rank)
        all_targets = []
        for i, (_, row) in enumerate(cat_rows):
            time, flux, sigma, P, _depth = _synth_lc(row, n_t=n_t,
                                                     device=device)
            all_targets.append(dict(
                time=time, flux=flux, sigma=sigma, P_orb=P, M_s=1.0,
                R_s=1.0, Teff=5800.0, Z=0.0, plx=10.0, Tmag=10.0, Jmag=9.3,
                Hmag=9.1, Kmag=9.0, trilegal_fname=trilegal, key=i))

        rows, walls = [], []
        t_start = _time.time()
        for start in range(0, n_targets, batch_B):
            group = all_targets[start:start + batch_B]
            pad = batch_B - len(group)
            group = group + [dict(group[-1]) for _ in range(pad)]
            t0 = _time.time()
            batch, _, has_cc = prepare_target_batch(group, device=device)
            fpp, nfpp, _lnZ = batch_fpp_full(mesh, batch, N=N, n_t=n_t,
                                             ns=ns, has_cc=has_cc,
                                             device=device)
            walls.append(_time.time() - t0)
            for j in range(batch_B - pad):
                rows.append(_result_row(cat_rows[start + j][1], fpp[j],
                                        nfpp[j]))
            if rank == 0:
                print(f"  batch {start // batch_B}: {walls[-1]:.1f}s "
                      f"({walls[-1] / batch_B:.2f}s/target)")
        total = _time.time() - t_start
        if rank == 0:
            pd.DataFrame(rows).to_csv(out_csv, index=False)
            steady = (np.mean(walls[1:]) if len(walls) > 1
                      else walls[0]) / batch_B
            print(f"wrote {out_csv}; {n_targets} targets in {total:.1f}s "
                  f"(steady-state {steady:.2f}s/target)")
    finally:
        if started:
            dist.destroy_process_group()


def main(n_targets=8, N=1000000, out_csv="catalog_replay.csv", n_t=100,
         ns=20, device="cuda", workdir=None):
    """Serial replay: one ``target.calc_probs`` per TOI (seed i)."""
    cat_rows = _catalog_rows(n_targets)
    trilegal = _trilegal(workdir or tempfile.gettempdir())
    rows = []
    t_start = _time.time()
    for i, (_, row) in enumerate(cat_rows):
        t, time, flux, sigma, P = build_target(row, trilegal, n_t=n_t,
                                               device=device)
        t0 = _time.time()
        t.calc_probs(time, flux, sigma, P_orb=P, N=N, nsamples=ns,
                     verbose=0, key=i, device=device)
        wall = _time.time() - t0
        rows.append(_result_row(row, t.FPP, t.NFPP, wall_s=round(wall, 2)))
        print(f"[{i+1}/{n_targets}] TOI {row['TOI']}: FPP={t.FPP:.3g} "
              f"({wall:.1f}s)")
    pd.DataFrame(rows).to_csv(out_csv, index=False)
    total = _time.time() - t_start
    print(f"\nwrote {out_csv}; {n_targets} targets in {total:.0f}s "
          f"({total/n_targets:.1f}s/target incl. first call)")


if __name__ == "__main__":
    argv = sys.argv[1:]
    out = argv[argv.index("--out") + 1] if "--out" in argv else \
        "catalog_replay.csv"
    args = [a for a in argv if not a.startswith("--") and a != out]
    n = int(args[0]) if len(args) > 0 else 8
    N = int(args[1]) if len(args) > 1 else 1000000
    cpu = "--cpu" in argv
    sharded = ("--sharded" in argv or (
        "--serial" not in argv and int(os.environ.get("WORLD_SIZE", "1")) > 1))
    if sharded:
        main_sharded(n, N, out, device="cpu" if cpu else None)
    else:
        main(n, N, out, device="cpu" if cpu else "cuda")
