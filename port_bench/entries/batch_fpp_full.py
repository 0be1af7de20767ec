"""Catalog sweep: per call, ``from_stars``, ``calc_depths`` and
``target_entry`` for each of B targets, ``prepare_target_batch``, then
``batch_fpp_full`` with ``mesh=None`` (one process on one card)."""

from __future__ import annotations

import numpy as np


class Entry:
    """Drives ``triceratops_tpu_torch.parallel.sharding.batch_fpp_full`` on
    a catalog mix, ``per_call`` targets a call."""

    def __init__(self, cfg, traffic, trilegal, device):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.trilegal = trilegal
        self.candidates_per_call = cfg["per_call"]

    @staticmethod
    def wrap_points():
        from triceratops_tpu_torch.parallel import sharding
        from triceratops_tpu_torch.scenarios import engine

        from port_bench.capture import sampler_points

        return [(sharding, "lnL_planet", "core"), (sharding, "lnL_eb", "core"),
                (sharding, "_local_lnZ_parts", "finalize_parts"),
                *sampler_points(engine)]

    def call(self, i, key):
        """Call i: builds its targets from their rows and runs the batch;
        returns lnZ (B, R), FPP (B,), NFPP (B,) on the host."""
        from triceratops_tpu_torch.frontend.target import target
        from triceratops_tpu_torch.parallel import sharding

        c = self.cfg
        entries = []
        for j, tg in enumerate(self.traffic.candidates(i)):
            t = target.from_stars(tg.stars, ID=int(tg.stars.ID[0]),
                                  sectors=[1], mission=c["mission"],
                                  trilegal_fname=self.trilegal)
            t.calc_depths(tdepth=tg.tdepth)
            e = sharding.target_entry(t, tg.time, tg.flux, tg.sigma, tg.P,
                                      key=(int(key) + j) % 2**31)
            if tg.molusc is not None:
                e["molusc_file"] = tg.molusc
            entries.append(e)
        batch, n_t, has_cc = sharding.prepare_target_batch(
            entries, mission=c["mission"], device=self.device)
        fpp, nfpp, lnZ = sharding.batch_fpp_full(
            None, batch, N=c["N"], n_t=n_t, ns=c["nsamples"],
            exptime=c["exptime"], has_cc=has_cc, device=self.device)
        return dict(lnZ=np.asarray(lnZ, np.float64),
                    FPP=np.asarray(fpp, np.float64),
                    NFPP=np.asarray(nfpp, np.float64), probs=None)
