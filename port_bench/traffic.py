"""The benchmark's one traffic generator: it reads a mix file
(``traffic/<name>.json``) and makes the cell's inputs from ``--seed``.

Frozen copies, rewritten so that they call nothing of the program:

* ``transit_flux``: ``chip_smoke.py::planet_flux`` and
  ``tools/catalog_replay.py::_synth_lc`` (a point-sampled quadratic
  limb-darkened transit plus seeded normal noise), on this folder's
  ``reference.projected_z`` / ``occult_deficit`` in float64;
* the curves' time grids: ``chip_smoke.py::toi465_field``'s 100 points
  over |t| <= 0.15 d and ``bench_longlc.py``'s window shape (centres
  uniform in |t| < 0.4 d, sorted) as ``chip_smoke.py::phase_long`` makes
  it;
* ``synthetic_trilegal``: ``populations/synthetic.py::
  make_synthetic_trilegal`` with its stellar-relation nodes
  (``tables.py``, upstream funcs.py:19-119);
* ``data/tab7.csv``: the (TOI, TICID, Rp, Porb, NumNFP) columns of
  Giacalone et al. 2021 (AJ 161, 24), Table 7, as the repository keeps it
  in ``triceratops_tpu/data/catalog_tab7.parquet``.

A mix is one of two kinds. "field": one target star with its nearby stars
and one curve, every call the same target (``Field``). "catalog": the
rows of a catalog in one fixed permutation, cycled, each a target on its
own synthetic curve with as many of the mix's nearby stars as its row
counts (``Catalog``). Either may carry a ``molusc`` block: a synthetic
MOLUSC posterior of bound companions, made from the seed at set-up and
handed to every target (``molusc_posterior``). A mix may name a ``base``
mix whose parameters it takes.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pandas as pd
import torch

from . import reference as ref

HERE = Path(__file__).resolve().parent

# CGS constants (IAU 2015 nominal / CODATA 2018, as astropy gives them)
MSUN = 1.988409870698051e33
RSUN = 6.957e10
REARTH = 6.3781e8
G = 6.6743e-8

# stellar relations (upstream funcs.py:19-51, 81-119)
MASS_TORRES = [0.26, 0.47, 0.59, 0.69, 0.87, 0.98, 1.085, 1.4, 1.65, 2.0,
               2.5, 3.0, 4.4, 15.0, 40.0]
TEFF_TORRES = [3170, 3520, 3840, 4410, 5150, 5560, 5940, 6650, 7300, 8180,
               9790, 11400, 15200, 30000, 42000]
RAD_TORRES = [0.28, 0.47, 0.60, 0.72, 0.9, 1.05, 1.2, 1.55, 1.8, 2.1, 2.4,
              2.6, 3.0, 6.2, 11.0]
MASS_CDWRF = [0.1, 0.135, 0.2, 0.35, 0.48, 0.58, 0.63]
TEFF_CDWRF = [2800, 3000, 3200, 3400, 3600, 3800, 4000]
RAD_CDWRF = [0.12, 0.165, 0.23, 0.36, 0.48, 0.585, 0.6]
FLUX_NODES = {
    "TESS": ([0.1, 0.15, 0.23, 0.4, 0.58, 0.7, 0.9, 1.15, 1.45, 2.2, 2.8],
             [-3, -2.5, -2, -1.5, -1, -0.5, 0, 0.5, 1, 1.5, 2]),
    "J": ([0.1, 0.2, 0.5, 0.75, 1.0, 1.5, 2.0, 2.5, 3],
          [v / 2.5 for v in (-5.7, -3.8, -1.6, 0, 1.2, 2.9, 3.3, 4, 6)]),
    "H": ([0.1, 0.23, 0.5, 0.75, 1.0, 1.5, 2.0, 2.5, 3],
          [v / 2.5 for v in (-4.9, -2.8, -0.9, 0.6, 1.5, 3, 3.3, 4, 6)]),
    "K": ([0.1, 0.2, 0.35, 0.5, 0.75, 1.0, 1.5, 2.0, 2.5, 3],
          [v / 2.5 for v in (-4.7, -2.9, -1.7, -0.7, 0.6, 1.6, 3, 3.3, 4,
                             6)]),
}
M_SUN_TESS = 4.63

STAR_COLUMNS = ("ID", "Tmag", "Jmag", "Hmag", "Kmag", "ra", "dec", "mass",
                "rad", "Teff", "plx", "sep (arcsec)", "PA (E of N)")


def load_mix(name):
    """A mix's parameters; a mix that names a ``base`` mix takes the
    base's and sets its own beside them."""
    mix = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    if "base" in mix:
        base = load_mix(mix.pop("base"))
        base.update(mix)
        mix = base
    return mix


def sub_seed(seed, *stream):
    """A 31-bit seed of the run's seed and a stream, for numpy and torch."""
    ss = np.random.SeedSequence([int(seed) % 2**63, *stream])
    return int(ss.generate_state(1)[0] & 0x7FFFFFFF)


def semimajor_rstar(P_days, M_sun, R_sun):
    """a / R_star of a circular orbit of period P about a star of M, R."""
    a = ((G * M_sun * MSUN) / (4 * np.pi**2) * (P_days * 86400.0) ** 2) ** (
        1 / 3)
    return a / (R_sun * RSUN)


def transit_flux(time, planet, seed):
    """1 - D at the exposure centres ``time`` (days from mid-transit) of a
    circular planet (P, M_s, R_s, Rp [Re], inc_deg, u1, u2), plus seeded
    normal noise of ``planet['sigma']``; and the noise-free depth."""
    f = lambda v: torch.tensor(v, dtype=torch.float64)  # noqa: E731
    z, front = ref.projected_z(
        torch.as_tensor(np.asarray(time, np.float64)), f(planet["P"]),
        f(semimajor_rstar(planet["P"], planet["M_s"], planet["R_s"])),
        f(np.deg2rad(planet["inc_deg"])), f(0.0), f(0.0))
    k = planet["Rp"] * REARTH / (planet["R_s"] * RSUN)
    D = (ref.occult_deficit(f(k), z, f(planet["u1"]), f(planet["u2"]))
         * front).numpy()
    rng = np.random.default_rng(seed)
    return 1.0 - D + rng.normal(0, planet["sigma"], len(time)), float(D.max())


def time_grid(curve):
    """Exposure centres: "linspace" over |t| <= half_width, or "uniform"
    in |t| < half_width, sorted, from the mix's own grid seed: the same
    grid on every run seed."""
    h, n = curve["half_width"], curve["n"]
    if curve["kind"] == "linspace":
        return np.linspace(-h, h, n)
    return np.sort(np.random.default_rng(curve["grid_seed"]).uniform(-h, h, n))


def _spline(x, y):
    from scipy.interpolate import InterpolatedUnivariateSpline
    return InterpolatedUnivariateSpline(np.asarray(x, float),
                                        np.asarray(y, float))


def synthetic_trilegal(path, Tmag_target, n_stars, seed, mag_limit=21.0):
    """A TRILEGAL-style background population csv (the program's offline
    field generator, frozen): masses log-uniform over [0.1, 1.6] Msun on
    the stellar relations, a volume-weighted distance modulus in [6, 16],
    stars fainter than the target kept."""
    rng = np.random.default_rng(seed)
    n = int(n_stars * 2.5)
    mass = 10 ** rng.uniform(np.log10(0.1), np.log10(1.6), n)
    hot = mass > 0.63
    radius = np.maximum(np.where(hot, _spline(MASS_TORRES, RAD_TORRES)(mass),
                                 _spline(MASS_CDWRF, RAD_CDWRF)(mass)), 0.1)
    teff = np.maximum(np.where(hot, _spline(MASS_TORRES, TEFF_TORRES)(mass),
                               _spline(MASS_CDWRF, TEFF_CDWRF)(mass)), 2800.0)
    logg = np.log10(G * mass * MSUN / (radius * RSUN) ** 2)
    mh = np.clip(rng.normal(-0.1, 0.25, n), -1.0, 0.4)

    def flux(filt, m):
        return 10.0 ** _spline(*FLUX_NODES[filt])(m)

    absmag = {f: M_SUN_TESS - 2.5 * np.log10(flux(f, mass))
              for f in ("TESS", "J", "H", "K")}
    u = rng.uniform(0, 1, n)
    mu = (6 ** 3 + u * (16 ** 3 - 6 ** 3)) ** (1 / 3)
    tmag = absmag["TESS"] + mu
    keep = (tmag >= Tmag_target) & (tmag <= mag_limit)
    idx = np.flatnonzero(keep)[:n_stars]
    if idx.size < n_stars:
        idx = np.concatenate([idx,
                              np.flatnonzero(~keep)[: n_stars - idx.size]])
    sel = np.concatenate([idx, idx[:2]])  # 2 rows the parser drops
    m = len(sel)
    pd.DataFrame({
        "Gc": np.ones(m, int), "logAge": np.full(m, 9.3), "[M/H]": mh[sel],
        "m_ini": mass[sel], "Mact": mass[sel],
        "logL": np.log10(np.maximum(flux("TESS", mass[sel]), 1e-6)),
        "logTe": np.log10(teff[sel]), "logg": logg[sel], "m-M0": mu[sel],
        "Av": np.zeros(m), "TESS": (absmag["TESS"] + mu)[sel],
        "J": (absmag["J"] + mu)[sel], "H": (absmag["H"] + mu)[sel],
        "Ks": (absmag["K"] + mu)[sel],
    }).to_csv(path)
    return str(path)


def molusc_posterior(path, spec, N, seed):
    """A MOLUSC-style posterior of surviving bound companions (Wood et al.
    2021), written as MOLUSC writes it: ``spec['rows_per_draw']`` x N rows,
    semi-major axes log-uniform over ``a_au``, eccentricities uniform on
    [0, ``e_max``], mass ratios uniform over ``q``."""
    rng = np.random.default_rng(seed)
    n = max(1, int(round(spec["rows_per_draw"] * N)))
    lo, hi = np.log10(spec["a_au"])
    pd.DataFrame({
        "semi-major axis(AU)": 10 ** rng.uniform(lo, hi, n),
        "eccentricity": rng.uniform(0.0, spec["e_max"], n),
        "mass ratio": rng.uniform(*spec["q"], n),
    }).to_csv(path, index=False)
    return str(path)


class Field:
    """One target with its nearby stars on one curve; every call vets
    the same candidate, with its own Monte-Carlo key."""

    def __init__(self, mix, seed):
        self.mix = mix
        self.planet = mix["planet"]
        self.stars = pd.DataFrame(mix["stars"], columns=STAR_COLUMNS)
        self.time = time_grid(mix["curve"])
        self.flux, _ = transit_flux(self.time, self.planet, sub_seed(seed, 2))
        self.sigma = self.planet["sigma"]
        self.P = self.planet["P"]
        self.tdepth = mix["tdepth"]

    def candidates(self, i):
        """The target(s) of call i: here always the one field."""
        return [self]


class CatalogTarget:
    """A target of a catalog row on its synthetic curve: the mix's host
    star and the first min(row's ``nearby_count`` column, the mix's
    ``nearby`` stars) of the mix's nearby stars."""

    def __init__(self, row, mix, seed, index):
        star = dict(mix["star"])
        P = float(np.clip(row["Porb"], *mix["P_clip"]))
        rp = float(np.clip(row["Rp"], *mix["Rp_clip"]))
        self.planet = dict(P=P, Rp=rp, M_s=star["mass"], R_s=star["rad"],
                           inc_deg=mix["inc_deg"], u1=mix["u1"], u2=mix["u2"],
                           sigma=mix["sigma"])
        self.time = time_grid(mix["curve"])
        self.flux, self.tdepth = transit_flux(self.time, self.planet,
                                              sub_seed(seed, 3, index))
        self.sigma, self.P = mix["sigma"], P
        tic = int(row["TICID"])
        star.update(ID=str(tic))
        star.setdefault("sep (arcsec)", 0.0)
        star.setdefault("PA (E of N)", 0.0)
        near = mix.get("nearby", [])
        k = min(int(row[mix["nearby_count"]]), len(near)) if near else 0
        stars = [star] + [dict(s, ID=str(tic * 10 + j + 1))
                          for j, s in enumerate(near[:k])]
        self.stars = pd.DataFrame(stars, columns=STAR_COLUMNS)
        self.toi = float(row["TOI"])


class Catalog:
    """A catalog's rows in one fixed permutation, cycled: call i vets the
    next ``per_call`` of them."""

    def __init__(self, mix, seed, per_call):
        rows = pd.read_csv(HERE / mix["catalog"])
        order = np.random.default_rng(mix["permutation_seed"]).permutation(
            len(rows))
        self.targets = [CatalogTarget(rows.iloc[j], mix, seed, n)
                        for n, j in enumerate(order)]
        self.per_call = per_call

    def candidates(self, i):
        n = len(self.targets)
        return [self.targets[(i * self.per_call + j) % n]
                for j in range(self.per_call)]


def make(mix_name, seed, per_call, N=None, workdir=None):
    """The mix's inputs for ``seed``; a mix with a ``molusc`` block writes
    its posterior of N draws' size into ``workdir``, and every target
    carries its path as ``molusc``."""
    mix = load_mix(mix_name)
    out = (Field(mix, seed) if mix["kind"] == "field"
           else Catalog(mix, seed, per_call))
    path = None
    if "molusc" in mix:
        path = molusc_posterior(Path(workdir) / "molusc.csv", mix["molusc"],
                                N, sub_seed(seed, 8))
    for t in ([out] if mix["kind"] == "field" else out.targets):
        t.molusc = path
    return out
