"""The ``target`` user-facing class.

Counterpart of the JAX package's ``frontend/target.py`` (reference
triceratops/triceratops.py:41-1638): the online constructor (TIC and
FFI-cutout queries) and the offline one (``from_stars``), star edits, PSF
dilution depths (``calc_depths``), scenario orchestration into FPP/NFPP
(``calc_probs``, ``calc_probs_ensemble``) and plots. ``calc_probs`` runs
the target's 15 rows (TP, EB, EBx2P, the bound-companion PTP, PEB, PEBx2P,
STP, SEB, SEBx2P and the background DTP, DEB, DEBx2P, BTP, BEB, BEBx2P)
and every nearby star's NTP, NEB and NEBx2P rows on the device. Dropped
rows get lnZ = -inf; without a TRILEGAL file the background rows get zero
weight, as in the reference.

The online constructor needs lightkurve, astroquery and astropy, and the
plots matplotlib; each is imported only where it is used.
"""

from __future__ import annotations

import warnings

import numpy as np
import pandas as pd
import torch
from scipy.special import ndtr

from ..core.numerics import normalize_probabilities
from ..funcs import renorm_flux, save_trilegal, query_TRILEGAL, get_aperture
from ..scenarios import api as sc
from ..utils import profiling

_RES_FIELDS = ["M_s", "R_s", "u1", "u2", "P_orb", "inc", "b", "R_p", "ecc",
               "argp", "M_EB", "R_EB", "fluxratio_EB", "fluxratio_comp"]


def ensemble_seed(key: int, i: int) -> int:
    """The seed of run i of ``calc_probs_ensemble(key=key)``: the first
    32-bit word of ``np.random.SeedSequence([key, i])``.
    ``calc_probs(key=ensemble_seed(key, i))`` reproduces that run."""
    return int(np.random.SeedSequence([int(key), int(i)])
               .generate_state(1)[0])


class target:
    def __init__(self, ID: int, sectors, search_radius: int = 10,
                 mission: str = "TESS", lightkurve_cache_dir=None,
                 trilegal_fname=None, ra: float = None, dec: float = None,
                 verify_ssl: bool = True):
        """Query TIC for the sources around the target and the FFI cutouts
        (TESS) or target pixel files (Kepler, K2) of each sector
        (reference triceratops.py:42-263). Needs lightkurve, astroquery
        and astropy; ``target.from_stars`` builds a target offline.
        Without ``trilegal_fname`` the TRILEGAL service is queried here
        and its result saved by the first ``calc_probs``."""
        if mission not in ("TESS", "Kepler", "K2"):
            raise ValueError("Introduced invalid mission: " + mission)
        try:
            import lightkurve  # noqa: F401
            from astroquery.mast import Catalogs
            from astropy.coordinates import SkyCoord
            import astropy.units as u
        except ImportError as e:
            raise ImportError(
                "Online target construction needs lightkurve/astroquery/"
                "astropy. Build offline with target.from_stars(...) instead."
            ) from e

        self.ID = ID
        self.mission = mission
        self.sectors = sectors
        self.search_radius = search_radius
        self.N_pix = 2 * search_radius + 2
        pixel_size = (20.25 if mission == "TESS" else 4.0) * u.arcsec

        if mission == "TESS":
            ticid = ID
        else:
            from astroquery.vizier import Vizier
            if ra is None or dec is None:
                if mission == "Kepler":
                    result = (Vizier(columns=["_RA", "_DE"])
                              .query_constraints(
                                  KIC=str(ID),
                                  catalog="J/ApJS/229/30/catalog")[0]
                              .as_array())
                    ra, dec = result[0]["_RA"], result[0]["_DE"]
                else:
                    result = (Vizier(columns=["RAJ2000", "DEJ2000"])
                              .query_constraints(ID=str(ID),
                                                 catalog="IV/34/epic")[0]
                              .as_array())
                    ra, dec = result[0]["RAJ2000"], result[0]["DEJ2000"]
            ticid = Catalogs.query_region(
                SkyCoord(ra, dec, unit="deg"),
                radius=search_radius * pixel_size, catalog="TIC")[0]["ID"]
        df = Catalogs.query_object("TIC" + str(ticid),
                                   radius=search_radius * pixel_size,
                                   catalog="TIC")
        stars = df["ID", "Tmag", "Jmag", "Hmag", "Kmag", "ra", "dec", "mass",
                   "rad", "Teff", "plx", "disposition",
                   "duplicate_id"].to_pandas()

        if trilegal_fname is None:
            self.trilegal_url = query_TRILEGAL(
                stars["ra"].values[0], stars["dec"].values[0], verbose=0,
                verify_ssl=verify_ssl)
            self.trilegal_fname = None
        else:
            self.trilegal_fname = trilegal_fname
            self.trilegal_url = None

        self._fetch_cutouts(stars, lightkurve_cache_dir)
        self._finish_init(stars)

    @classmethod
    @profiling.span("tri.frontend.from_stars")
    def from_stars(cls, stars: pd.DataFrame, ID: int = 0, sectors=(1,),
                   mission: str = "TESS", search_radius: int = 10,
                   pix_coords=None, trilegal_fname=None):
        """Offline constructor from a prepared stars table with the
        reference's TIC columns (ID, Tmag, Jmag, Hmag, Kmag, ra, dec, mass,
        rad, Teff, plx). ``pix_coords`` is a list (one per sector) of
        (n_stars, 2) pixel coordinates; a centered grid offset by the
        optional "sep (arcsec)" / "PA (E of N)" columns is used when
        omitted. The images are blank (zeros) with their origin at pixel
        (0, 0)."""
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
        self.trilegal_url = None
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
        self.TESS_images = [np.zeros((self.N_pix, self.N_pix))
                            for _ in self.sectors]
        self.col0s = [0 for _ in self.sectors]
        self.row0s = [0 for _ in self.sectors]
        return self

    def _fetch_cutouts(self, stars, lightkurve_cache_dir):
        """Per-sector mean image, image origin and the stars' pixel
        coordinates through the cutout's WCS; a sector whose download
        fails is reported and skipped (reference triceratops.py:148-226).
        Kepler / K2 pixel files are NaN-padded, centred, to N_pix."""
        import traceback
        import lightkurve
        from astropy.coordinates import SkyCoord
        from astropy.wcs import WCS

        TESS_images, col0s, row0s, pix_coords = [], [], [], []
        ra = stars["ra"].values
        dec = stars["dec"].values
        cutout_coord = SkyCoord(ra[0], dec[0], unit="deg")
        for sector in self.sectors:
            try:
                if self.mission == "TESS":
                    print(f"Getting TessCut for sector {sector}")
                    cuts = lightkurve.search_tesscut(
                        target=cutout_coord, sector=sector).download_all(
                        cutout_size=(self.N_pix, self.N_pix))
                    hdu = cuts[0].hdu
                    wcs = WCS(hdu[2].header)
                    TESS_images.append(np.nanmean(hdu[1].data["FLUX"], axis=0))
                    col0 = hdu[1].header["1CRV4P"]
                    row0 = hdu[1].header["2CRV4P"]
                    nrb = ncb = 0
                else:
                    print(f"Getting TPF for sector {sector}")
                    prefix = "KIC " if self.mission == "Kepler" else "EPIC "
                    kw = ({"quarter": sector} if self.mission == "Kepler"
                          else {"campaign": sector})
                    tpf = lightkurve.search_targetpixelfile(
                        prefix + str(self.ID), mission=self.mission,
                        **kw).download_all(download_dir=lightkurve_cache_dir)
                    hdu = tpf[0].hdu
                    wcs = WCS(hdu[2].header)
                    image = np.nanmean(hdu[1].data["FLUX"], axis=0)
                    nrb = (self.N_pix - image.shape[0]) // 2
                    nra = (self.N_pix - image.shape[0]) - nrb
                    ncb = (self.N_pix - image.shape[1]) // 2
                    nca = (self.N_pix - image.shape[1]) - ncb
                    image = np.pad(image, ((nrb, nra), (ncb, nca)),
                                   mode="constant", constant_values=np.nan)
                    TESS_images.append(image)
                    col0 = hdu[1].header["1CRV4P"] - ncb
                    row0 = hdu[1].header["2CRV4P"] - nrb
            except Exception:
                print(f"Sector {sector} raised exception. "
                      "Ignoring for validation.")
                print(traceback.format_exc())
                continue
            col0s.append(col0)
            row0s.append(row0)
            pc = np.zeros([len(ra), 2])
            for i in range(len(ra)):
                pix = wcs.all_world2pix(ra[i], dec[i], 0)
                pc[i, 0] = col0 + pix[0].item() + ncb
                pc[i, 1] = row0 + pix[1].item() + nrb
            pix_coords.append(pc)
        self.TESS_images = TESS_images
        self.col0s = col0s
        self.row0s = row0s
        self.pix_coords = pix_coords

    def _finish_init(self, stars):
        """Each star's separation from the target [arcsec] and position
        angle [deg E of N], rounded to 3 decimals (reference
        triceratops.py:230-256)."""
        from astropy.coordinates import SkyCoord
        import astropy.units as u

        sep, pa = [0], [0]
        c_t = SkyCoord(stars["ra"].values[0], stars["dec"].values[0],
                       unit="deg")
        for i in range(1, len(stars)):
            c_s = SkyCoord(stars["ra"].values[i], stars["dec"].values[i],
                           unit="deg")
            sep.append(np.round(c_t.separation(c_s).to(u.arcsec).value, 3))
            pa.append(np.round(c_t.position_angle(c_s).to(u.deg).value, 3))
        stars["sep (arcsec)"] = sep
        stars["PA (E of N)"] = pa
        self.stars = stars

    # star-table edits (reference triceratops.py:265-335)
    def add_star(self, ID: int, Tmag: float, bound: bool):
        """Add an unresolved star at the target's position; a bound one
        takes the target's parallax."""
        if bound:
            plx = self.stars["plx"].values[0]
            new_star = pd.DataFrame([[str(ID), Tmag, plx]],
                                    columns=["ID", "Tmag", "plx"])
        else:
            new_star = pd.DataFrame([[str(ID), Tmag]], columns=["ID", "Tmag"])
        self.stars = pd.concat([self.stars, new_star]).reset_index(drop=True)
        self.pix_coords = [np.vstack([p, p[:1]]) for p in self.pix_coords]

    def remove_star(self, drop_stars):
        """Drop stars (by ID) from the analysis."""
        if np.isscalar(drop_stars):
            drop_stars = [drop_stars]
        drop_stars = [str(s) for s in drop_stars]
        self.stars = self.stars[~self.stars["ID"].astype(str).isin(drop_stars)]

    def update_star(self, ID: int, param: str, value: float):
        """Set one parameter of one star."""
        idx = self.stars[self.stars.ID.astype(str) == str(ID)].index
        self.stars.loc[idx, [param]] = value

    def get_spoc_apertures(self):
        """The SPOC aperture of each sector, or [] with a notice when one
        cannot be fetched (reference triceratops.py:337-356)."""
        aps = []
        try:
            for sector in self.sectors:
                aps.append(get_aperture(self.ID, sector))
        except Exception:
            print("No SPOC apertures available.")
        return aps

    @profiling.span("tri.frontend.calc_depths")
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

    @profiling.span("tri.call")
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
        A TRILEGAL query made by the online constructor is saved on the
        first call (``<ID>_TRILEGAL.csv``) and reused after.
        ``device``: where the Monte-Carlo work runs (default "cuda").
        ``backend``: likelihood path, "auto" (the fused chi^2 kernel on
        CUDA) or "torch" (plain torch). ``lc_window`` (days) crops the
        folded curve to |time| <= lc_window.

        Spans (``utils/profiling.py``): the call in ``tri.call``, each
        evidence call in ``tri.row.<row>`` (TP, EB, ..., NTP and NEB of
        each nearby star) and the one device-to-host read of the results
        in ``tri.gather``."""
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
        # the TRILEGAL result, saved once (reference triceratops.py:755-764)
        if self.trilegal_fname is None and self.trilegal_url is not None:
            fname = save_trilegal(self.trilegal_url, self.ID)
            self.trilegal_fname = fname if fname else None
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
                    with profiling.span(f"tri.row.{name}"):
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
                with profiling.span("tri.row.NTP"):
                    res = sc.lnZ_TTP(time, flux, flux_err, P_orb, M_s, R_s,
                                     Teff, Z, **base)
                put(15 + 3 * (i - 1), ID, "NTP", 1, res)
                with profiling.span("tri.row.NEB"):
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
                with profiling.span("tri.gather"):
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

    def calc_probs_ensemble(self, time, flux_0, flux_err_0, P_orb,
                            n_runs: int = 20, key=None, **kwargs):
        """``calc_probs`` over ``n_runs`` independent generators, averaged.

        The reference measures Monte-Carlo scatter by re-running the
        analysis ~20 times by hand (examples/example.ipynb cell 14). Run i
        seeds its own ``torch.Generator`` on the device with
        ``ensemble_seed(key, i)``, the first 32-bit word of
        ``np.random.SeedSequence([key, i])``, so
        ``calc_probs(key=ensemble_seed(key, i))`` reproduces it; ``key``
        is an int, or None for one drawn from numpy's global RNG.
        ``kwargs`` go to ``calc_probs``. Sets ``FPP`` / ``NFPP`` to the
        means over the runs, ``FPP_std`` / ``NFPP_std`` and ``FPP_runs`` /
        ``NFPP_runs``; ``probs`` and the rest hold the last run's."""
        if key is None:
            key = int(np.random.randint(0, 2**31 - 1))
        fpps, nfpps = [], []
        for i in range(n_runs):
            self.calc_probs(time, flux_0, flux_err_0, P_orb,
                            key=ensemble_seed(key, i), **kwargs)
            fpps.append(self.FPP)
            nfpps.append(self.NFPP)
        self.FPP_runs = np.array(fpps)
        self.NFPP_runs = np.array(nfpps)
        self.FPP = float(self.FPP_runs.mean())
        self.NFPP = float(self.NFPP_runs.mean())
        self.FPP_std = float(self.FPP_runs.std())
        self.NFPP_std = float(self.NFPP_runs.std())

    def plot_field(self, sector: int = None, ap_pixels=None,
                   ap_color: str = "red", save: bool = False,
                   fname: str = None):
        """Field plot: star positions and the mean image (reference
        triceratops.py:358-557). Needs matplotlib."""
        from .plotting import plot_field
        return plot_field(self, sector=sector, ap_pixels=ap_pixels,
                          ap_color=ap_color, save=save, fname=fname)

    def plot_fits(self, time: np.ndarray, flux_0: np.ndarray,
                  flux_err_0: float, save: bool = False, fname: str = None,
                  device="cuda"):
        """Best-fit light curve of every row (reference
        triceratops.py:1487-1638), the models computed on ``device``.
        Needs matplotlib."""
        from .plotting import plot_fits
        return plot_fits(self, time, flux_0, flux_err_0, save=save,
                         fname=fname, device=device)
