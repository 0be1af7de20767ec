"""Single-candidate vetting: ``target.from_stars`` and ``calc_depths`` at
set-up, then one ``target.calc_probs`` per call (upstream's entry)."""

from __future__ import annotations

import numpy as np


class Entry:
    """Drives ``triceratops_tpu_torch.frontend.target.target.calc_probs``
    on a field mix: every call vets its one candidate with its own key."""

    candidates_per_call = 1

    def __init__(self, cfg, traffic, trilegal, device):
        from triceratops_tpu_torch.frontend.target import target

        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.t = target.from_stars(traffic.stars, ID=int(traffic.stars.ID[0]),
                                   sectors=[1], mission=cfg["mission"],
                                   trilegal_fname=trilegal)
        self.t.calc_depths(tdepth=traffic.tdepth)

    @staticmethod
    def wrap_points():
        """(module, attribute, kind) of every call into the likelihood
        cores and the evidence reduction on this entry's path."""
        from triceratops_tpu_torch.scenarios import api, engine

        from port_bench.capture import sampler_points

        return [(api, "lnL_planet", "core"), (api, "lnL_eb", "core"),
                (engine, "run_finalize", "finalize"),
                *sampler_points(engine)]

    def call(self, i, key):
        """Call i: one calc_probs; returns its rows' lnZ, FPP, NFPP and
        probabilities (1, ...)-shaped, on the host."""
        c, tr = self.cfg, self.traffic
        self.t.calc_probs(tr.time, tr.flux, tr.sigma, P_orb=tr.P, N=c["N"],
                          nsamples=c["nsamples"], exptime=c["exptime"],
                          filt=c["filt"], verbose=0, key=int(key),
                          molusc_file=tr.molusc, device=self.device)
        return dict(lnZ=np.array(self.t.lnZ, np.float64)[None],
                    FPP=np.array([self.t.FPP]), NFPP=np.array([self.t.NFPP]),
                    probs=self.t.probs["prob"].to_numpy(np.float64)[None])
