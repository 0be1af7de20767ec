"""The ``target`` user-facing class.

Counterpart of the JAX package's ``frontend/target.py``: offline
construction (``from_stars``), PSF dilution depths (``calc_depths``) and
scenario orchestration into FPP/NFPP (``calc_probs``). ``calc_probs`` runs
the target's 15 rows (TP, EB, EBx2P, the bound-companion PTP, PEB, PEBx2P,
STP, SEB, SEBx2P and the background DTP, DEB, DEBx2P, BTP, BEB, BEBx2P)
and every nearby star's NTP, NEB and NEBx2P rows on the device. Dropped
rows get lnZ = -inf; without a TRILEGAL file the background rows get zero
weight, as in the reference.
"""

from __future__ import annotations

import warnings

import numpy as np
import pandas as pd
import torch
from scipy.special import ndtr

from ..core.numerics import normalize_probabilities
from ..funcs import renorm_flux
from ..scenarios import api as sc

_RES_FIELDS = ["M_s", "R_s", "u1", "u2", "P_orb", "inc", "b", "R_p", "ecc",
               "argp", "M_EB", "R_EB", "fluxratio_EB", "fluxratio_comp"]

class target:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "Online target construction (TIC/TessCut queries) is not "
            "ported; build the target with target.from_stars(...).")

    @classmethod
    def from_stars(cls, stars: pd.DataFrame, ID: int = 0, sectors=(1,),
                   mission: str = "TESS", search_radius: int = 10,
                   pix_coords=None, trilegal_fname=None):
        """Offline constructor from a prepared stars table with the
        reference's TIC columns (ID, Tmag, Jmag, Hmag, Kmag, ra, dec, mass,
        rad, Teff, plx). ``pix_coords`` is a list (one per sector) of
        (n_stars, 2) pixel coordinates; a centered grid offset by the
        optional "sep (arcsec)" / "PA (E of N)" columns is used when
        omitted."""
        if mission not in ("TESS", "Kepler", "K2"):
            raise ValueError("Introduced invalid mission: " + mission)
        self = cls.__new__(cls)
        self.ID = ID
        self.mission = mission
        self.sectors = np.atleast_1d(sectors)
        self.search_radius = search_radius
        self.N_pix = 2 * search_radius + 2
        self.stars = stars.reset_index(drop=True).copy()
        self.trilegal_fname = trilegal_fname
        n = len(stars)
        if pix_coords is None:
            center = self.N_pix / 2.0
            pc = np.full((n, 2), center)
            if {"sep (arcsec)", "PA (E of N)"} <= set(stars.columns):
                px = 20.25 if mission == "TESS" else 4.0
                sep_pix = stars["sep (arcsec)"].values / px
                pa = np.deg2rad(stars["PA (E of N)"].values)
                off = np.c_[sep_pix * np.sin(pa), sep_pix * np.cos(pa)]
                # PA is undefined (NaN) for the target row itself
                pc = pc + np.where(np.isfinite(off), off, 0.0)
            pix_coords = [pc for _ in self.sectors]
        self.pix_coords = [np.asarray(p, dtype=float) for p in pix_coords]
        return self

    def calc_depths(self, tdepth: float, all_ap_pixels=None):
        """Required transit depth per star from the analytic Gaussian-PSF
        (sigma = 0.75 px) aperture integral (reference
        triceratops.py:559-671)."""
        if all_ap_pixels is None:
            print("No apertures provided, assuming 5x5 centered on target.")
            all_ap_pixels = []
            for i in range(len(self.pix_coords)):
                tp = np.round(self.pix_coords[i][0])
                all_ap_pixels.append(np.array([
                    np.repeat(np.arange(tp[0] - 2, tp[0] + 3, 1), 5),
                    np.tile(np.arange(tp[1] - 2, tp[1] + 3, 1), 5),
                ]).T)
        n_ap, n_star = len(all_ap_pixels), len(self.stars)
        flux_ratio = np.zeros([n_ap, n_star])
        sigma = 0.75
        amp = 10 ** ((np.min(self.stars.Tmag.values)
                      - self.stars.Tmag.values) / 2.5)
        for k in range(n_ap):
            pixels = np.asarray(all_ap_pixels[k], float)
            mu = np.asarray(self.pix_coords[k], float)
            dx = (ndtr((pixels[None, :, 0] + 0.5 - mu[:, 0, None]) / sigma)
                  - ndtr((pixels[None, :, 0] - 0.5 - mu[:, 0, None]) / sigma))
            dy = (ndtr((pixels[None, :, 1] + 0.5 - mu[:, 1, None]) / sigma)
                  - ndtr((pixels[None, :, 1] - 0.5 - mu[:, 1, None]) / sigma))
            rel = amp * np.sum(dx * dy, axis=1)
            flux_ratio[k] = rel / np.sum(rel)
        flux_ratios = np.mean(flux_ratio, axis=0)
        self.stars["fluxratio"] = flux_ratios
        tdepths = np.where(flux_ratios != 0,
                           1 - (flux_ratios - tdepth)
                           / np.where(flux_ratios != 0, flux_ratios, 1.0),
                           0.0)
        tdepths[tdepths > 1] = 0
        self.stars["tdepth"] = tdepths

        filtered = self.stars[self.stars["tdepth"] > 0]
        for i, ID in enumerate(filtered["ID"].values):
            vals = filtered.iloc[i]
            missing = (np.isnan(vals["mass"]) or np.isnan(vals["rad"])
                       or np.isnan(vals["Teff"]))
            if i == 0 and (missing or np.isnan(vals["plx"])):
                print(f"WARNING: {ID} is missing stellar properties required "
                      "for validation. Please ensure a stellar mass (in "
                      "M_Sun), radius (in R_Sun), Teff (in K), and plx (in "
                      "mas) are provided in the .stars dataframe.")
            elif i > 0 and missing:
                print(f"WARNING: {ID} is missing stellar properties. If a "
                      "mass (in M_Sun), radius (in R_Sun), and/or Teff "
                      "(in K) are not added to the .stars dataframe, Solar "
                      "values will be assumed.")

    def calc_probs(self, time: np.ndarray, flux_0: np.ndarray,
                   flux_err_0: float, P_orb, contrast_curve_file: str = None,
                   filt: str = "TESS", N: int = 1000000,
                   parallel: bool = False, drop_scenario: list = (),
                   verbose: int = 1, flatpriors: bool = False,
                   exptime: float = 0.00139, nsamples: int = 20,
                   molusc_file: str = None, key=None,
                   importance_sampling: bool = True,
                   lc_window: float = None, device="cuda",
                   backend: str = "auto"):
        """Scenario probabilities, FPP and NFPP (reference
        triceratops.py:673-1485).

        ``contrast_curve_file`` / ``filt``: a 2-column (arcsec, delta mag)
        csv and its band, which bound the companion and background priors.
        ``molusc_file``: a MOLUSC posterior replacing the analytic
        companion draw of PTP, PEB, STP and SEB.
        ``key``: None, an int seed, or a ``torch.Generator`` on ``device``.
        ``device``: where the Monte-Carlo work runs (default "cuda").
        ``backend``: likelihood path, "auto" (the fused chi^2 kernel on
        CUDA) or "torch" (plain torch). ``lc_window`` (days) crops the
        folded curve to |time| <= lc_window."""
        if "tdepth" not in self.stars.columns:
            raise RuntimeError(
                "calc_depths(tdepth, ...) must be called before "
                "calc_probs so each star's flux ratio and required "
                "transit depth are known.")
        mask = ~np.isnan(time) & ~np.isnan(flux_0)
        if lc_window is not None:
            mask &= np.abs(np.asarray(time)) <= float(lc_window)
        time = np.asarray(time)[mask]
        flux_0 = np.asarray(flux_0)[mask]

        filtered = self.stars[self.stars["tdepth"] > 0]
        N_scenarios = 3 * len(filtered) + 12
        cols = {f: np.zeros(N_scenarios) for f in _RES_FIELDS}
        lnZ = np.zeros(N_scenarios)
        targets = np.zeros(N_scenarios, dtype=np.int64)
        star_num = np.zeros(N_scenarios, dtype=np.int64)
        scenarios = np.zeros(N_scenarios, dtype="U6")

        if isinstance(key, torch.Generator):
            gen = key
        else:
            gen = torch.Generator(device=device)
            gen.manual_seed(int(np.random.randint(0, 2**31 - 1))
                            if key is None else int(key))
        trilegal_ok = bool(self.trilegal_fname)
        if not trilegal_ok and verbose:
            print("No TRILEGAL results available: DTP, DEB, DEBx2P, BTP, "
                  "BEB, and BEBx2P get zero weight.")

        deferred = []

        def put(j, ID, name, snum, res=None):
            targets[j] = int(ID)
            star_num[j] = snum
            scenarios[j] = name
            if res is None:
                lnZ[j] = -np.inf
            else:
                deferred.append((j, res))

        for i, ID in enumerate(filtered["ID"].values):
            flux, flux_err = renorm_flux(
                flux_0, flux_err_0, filtered["fluxratio"].values[i])
            M_s = filtered["mass"].values[i]
            R_s = filtered["rad"].values[i]
            Teff = filtered["Teff"].values[i]
            plx = filtered["plx"].values[i]
            Tmag, Jmag, Hmag, Kmag = (filtered[c].values[i] for c in
                                      ("Tmag", "Jmag", "Hmag", "Kmag"))
            Z = 0.0
            base = dict(N=N, parallel=parallel, mission=self.mission,
                        flatpriors=flatpriors, exptime=exptime,
                        nsamples=nsamples,
                        importance_sampling=importance_sampling,
                        gen=gen, device=device, backend=backend)
            cc = dict(contrast_curve_file=contrast_curve_file, filt=filt)
            mol = dict(molusc_file=molusc_file)
            bg = (Tmag, Jmag, Hmag, Kmag, self.trilegal_fname)
            if i == 0:
                if (np.isnan(M_s) or np.isnan(R_s) or np.isnan(Teff)
                        or np.isnan(plx)):
                    print(f"Insufficient information to validate {ID}. "
                          "Please ensure a stellar mass (in M_Sun), radius "
                          "(in R_Sun), Teff (in K), and plx (in mas) are "
                          "provided in the .stars dataframe.")
                    break

                def log(name):
                    if verbose == 1:
                        print(f"Calculating {name} scenario probabilities "
                              f"for {ID}.")

                # (drop name, rows it fills, first row, star_num, needs a
                # TRILEGAL file, evidence call)
                rows = (
                    ("TP", ("TP",), 0, 1, False, lambda: sc.lnZ_TTP(
                        time, flux, flux_err, P_orb, M_s, R_s, Teff, Z,
                        **base)),
                    ("EB", ("EB", "EBx2P"), 1, 1, False, lambda: sc.lnZ_TEB(
                        time, flux, flux_err, P_orb, M_s, R_s, Teff, Z,
                        **base)),
                    ("PTP", ("PTP",), 3, 1, False, lambda: sc.lnZ_PTP(
                        time, flux, flux_err, P_orb, M_s, R_s, Teff, Z, plx,
                        **cc, **base, **mol)),
                    ("PEB", ("PEB", "PEBx2P"), 4, 1, False, lambda: sc.lnZ_PEB(
                        time, flux, flux_err, P_orb, M_s, R_s, Teff, Z, plx,
                        **cc, **base, **mol)),
                    ("STP", ("STP",), 6, 2, False, lambda: sc.lnZ_STP(
                        time, flux, flux_err, P_orb, M_s, R_s, Teff, Z, plx,
                        **cc, **base, **mol)),
                    ("SEB", ("SEB", "SEBx2P"), 7, 2, False, lambda: sc.lnZ_SEB(
                        time, flux, flux_err, P_orb, M_s, R_s, Teff, Z, plx,
                        **cc, **base, **mol)),
                    ("DTP", ("DTP",), 9, 1, True, lambda: sc.lnZ_DTP(
                        time, flux, flux_err, P_orb, M_s, R_s, Teff, Z, *bg,
                        **cc, **base)),
                    ("DEB", ("DEB", "DEBx2P"), 10, 1, True, lambda: sc.lnZ_DEB(
                        time, flux, flux_err, P_orb, M_s, R_s, Teff, Z, *bg,
                        **cc, **base)),
                    ("BTP", ("BTP",), 12, 2, True, lambda: sc.lnZ_BTP(
                        time, flux, flux_err, P_orb, M_s, R_s, Teff, *bg,
                        **cc, **base)),
                    ("BEB", ("BEB", "BEBx2P"), 13, 2, True, lambda: sc.lnZ_BEB(
                        time, flux, flux_err, P_orb, M_s, R_s, Teff, *bg,
                        **cc, **base)),
                )
                for name, names, j, snum, needs_tri, run in rows:
                    if name in drop_scenario or (needs_tri
                                                 and not trilegal_ok):
                        for off, row in enumerate(names):
                            put(j + off, ID, row, snum)
                        continue
                    log(" and ".join(names))
                    res = run()
                    for off, row in enumerate(names):
                        put(j + off, ID, row, snum,
                            res if len(names) == 1 else res[off])
            else:
                # nearby stars: solar fallbacks for missing properties
                # (reference triceratops.py:1344-1363)
                if np.isnan(Teff):
                    Teff = 5777.0
                if np.isnan(M_s):
                    M_s = 1.0
                if np.isnan(R_s):
                    R_s = 1.0
                if verbose == 1:
                    print("Calculating NTP, NEB, and NEB2xP scenario "
                          f"probabilities for {ID}.")
                put(15 + 3 * (i - 1), ID, "NTP", 1, sc.lnZ_TTP(
                    time, flux, flux_err, P_orb, M_s, R_s, Teff, Z, **base))
                res, res_t = sc.lnZ_TEB(time, flux, flux_err, P_orb, M_s,
                                        R_s, Teff, Z, **base)
                put(16 + 3 * (i - 1), ID, "NEB", 1, res)
                put(17 + 3 * (i - 1), ID, "NEBx2P", 1, res_t)

        # one device -> host transfer for every deferred result: only the
        # best-fit (first) element of each field is needed
        if deferred:
            nf = 1 + len(_RES_FIELDS)
            vals = np.empty((len(deferred), nf))
            dev_leaves, dev_slots = [], []
            for i, (_, res) in enumerate(deferred):
                for fi, f in enumerate(("lnZ",) + tuple(_RES_FIELDS)):
                    v = res[f]
                    if isinstance(v, torch.Tensor):
                        dev_slots.append((i, fi))
                        dev_leaves.append(v.reshape(-1)[0].to(torch.float32))
                    else:
                        vals[i, fi] = float(np.atleast_1d(np.asarray(v))[0])
            if dev_leaves:
                flat = torch.stack(dev_leaves).cpu().numpy()
                for (i, fi), x in zip(dev_slots, flat):
                    vals[i, fi] = float(x)
            for i, (j, _) in enumerate(deferred):
                lnZ[j] = vals[i, 0]
                for fi, f in enumerate(_RES_FIELDS):
                    cols[f][j] = vals[i, 1 + fi]

        relative_probs, status = normalize_probabilities(lnZ)
        if status == "anomaly":
            warnings.warn(
                "Unexpected NaN or +inf in scenario log-evidences. This "
                "indicates a numerical anomaly unrelated to geometric "
                "exclusions. Inspect self.lnZ for diagnostics.",
                RuntimeWarning, stacklevel=2)
        elif status == "all_neginf":
            warnings.warn(
                "All scenario log-evidences are -inf: every MC draw was "
                "geometrically invalid. FPP=1.0 reflects a failed "
                "computation, not a confident false positive. Inspect "
                "self.lnZ for diagnostics.",
                RuntimeWarning, stacklevel=2)
        self.FPP_degenerate = status != "ok"

        self.probs = pd.DataFrame({
            "ID": targets, "scenario": scenarios,
            "M_s": cols["M_s"], "R_s": cols["R_s"], "P_orb": cols["P_orb"],
            "inc": cols["inc"], "b": cols["b"], "ecc": cols["ecc"],
            "w": cols["argp"], "R_p": cols["R_p"], "M_EB": cols["M_EB"],
            "R_EB": cols["R_EB"], "prob": relative_probs,
        })
        self.lnZ = lnZ
        self.star_num = star_num
        self.u1 = cols["u1"]
        self.u2 = cols["u2"]
        self.fluxratio_EB = cols["fluxratio_EB"]
        self.fluxratio_comp = cols["fluxratio_comp"]
        # clip the f32 rounding residue when the planet rows carry ~all
        # probability (1 - sum can land at -1e-15)
        self.FPP = max(1 - (relative_probs[0] + relative_probs[3]
                            + relative_probs[9]), 0.0)
        self.NFPP = (float(np.sum(relative_probs[15:]))
                     if len(relative_probs) > 15 else 0.0)
