"""K-seed FPP / lnZ statistics of the JAX package on two in-repo fixtures.

The reference side of the end-to-end parity check between the JAX package
(``triceratops_tpu``) and its PyTorch port. For each fixture it runs the
JAX package's ``target.calc_probs`` over K keys and writes, per fixture,
the curve (made once in float64 numpy, so both packages read identical
``time`` / ``flux`` / ``sigma``), the star rows, the keys, every key's
per-row lnZ, FPP and NFPP, the jax version, N, nsamples, the host's CPU
model and the seconds per call. ``parity_port.py`` reads the record back
and runs the port on the same inputs; neither script imports the other
package.

Fixtures:

* F1: bench.py's TOI-465-like target (P = 3.18 d, 5.5 Re, a 100-point
  curve, sigma = 4e-4) plus two nearby stars: 21 rows.
* F2: a one-star target as tools/catalog_replay.build_target makes it
  (Tmag 10, M = R = 1, Teff 5800) with the first (Rp, P) draw of
  ``np.random.default_rng(10)`` over (1.5, 12) Re and (1, 15) d: an
  11.5 Re planet at 3.91 d, 15 rows.

Both use a 3000-star synthetic TRILEGAL field (seed 42); its csv's
sha256 goes into the record so the port can check it builds the same
field.

Run on the CPU only (a jax GPU backend would route the cores to the
TPU-only Pallas kernel):

    JAX_PLATFORMS=cpu python parity_ref.py [--K 20] [--N 1000000]
        [--fixtures F1,F2] [--out parity/jax_ref.json]

At N = 1e6 one call takes 2-5 min on an 8-core x86 host; the record is
rewritten after every key, and keys run interleaved across fixtures so a
cut run still holds the same K for each.

Row mode (``--rows TP,DTP``) runs only the named rows' scenario functions
(``lnZ_TTP``, ``lnZ_DTP``) on F1's target, with the inputs and the keys
calc_probs gives them, over many more keys than a whole call allows
(~10 s per TP key at N = 1e6), and writes ``parity/jax_rows.json``: per
row the keys and lnZ. Its keys continue F1's sequence, so its first
values are the main record's. ``parity_port.py`` reads the rows' JAX
spread from it, and ``parity_port.py --rows`` holds the port's to it:

    JAX_PLATFORMS=cpu python parity_ref.py --rows TP,DTP --K 100
"""

import argparse
import hashlib
import json
import os
import platform
import sys
import tempfile
import time

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")
HERE = os.path.dirname(os.path.abspath(__file__))
# the JAX package's persistent compile cache stays inside the checkout
os.environ.setdefault("TRICERATOPS_TPU_CACHE",
                      os.path.join(HERE, "parity", ".jax_cache"))

SCHEMA = 1
N_DRAWS = 1_000_000
NSAMPLES = 20
K_DEFAULT = 20
SIGMA = 4e-4
N_T = 100
# the synthetic TRILEGAL field of chip_smoke.py and bench.py
TRILEGAL = dict(Tmag_target=9.7, n_stars=3000, seed=42)
# F2: chip_smoke phase 10's seed over the ranges of the batch run whose
# STP row scattered by ~2 nats between the batch path and calc_probs
F2_SEED, F2_RP, F2_P = 10, (1.5, 12.0), (1.0, 15.0)
# key offsets per fixture: JAX keys k0 + i, the port's seeds p0 + i
KEYS = {"F1": (100, 1100), "F2": (200, 1200)}
# row mode: the rows' scenario functions, their fixture, and the index
# calc_probs folds into its key for each row (its subkey count on F1,
# every row computed), so that key k gives the row the lnZ that
# calc_probs(key=k) gives it: the row record extends the fixture's key
# sequence, its first keys reproducing the main record's values
ROW_FNS = {"TP": "lnZ_TTP", "DTP": "lnZ_DTP"}
ROW_FIXTURE = "F1"
ROW_SUBKEY = {"TP": 1, "DTP": 7}


def _star(ID, Tmag, Jmag, Hmag, Kmag, ra, dec, mass, rad, Teff, plx, sep,
          pa):
    return dict(ID=ID, Tmag=Tmag, Jmag=Jmag, Hmag=Hmag, Kmag=Kmag, ra=ra,
                dec=dec, mass=mass, rad=rad, Teff=Teff, plx=plx,
                **{"sep (arcsec)": sep, "PA (E of N)": pa})


def _deficit(time_, P, M_s, R_s, rp, inc_deg, u1, u2):
    """Transit deficit of a circular orbit with mid-transit at t = 0, in
    float64: projected separation from the mean anomaly, the quadratic
    limb-darkened deficit by radial quadrature
    (triceratops_tpu.ops.occult.occult_quad_deficit_reference)."""
    from triceratops_tpu.constants import G, MSUN, RSUN, REARTH
    from triceratops_tpu.ops.occult import occult_quad_deficit_reference

    a = ((G * M_s * MSUN) / (4 * np.pi**2) * (P * 86400.0) ** 2) ** (1 / 3)
    aR = a / (R_s * RSUN)
    phi = 2.0 * np.pi * time_ / P
    z = aR * np.sqrt(np.sin(phi) ** 2
                     + np.cos(np.deg2rad(inc_deg)) ** 2 * np.cos(phi) ** 2)
    k = rp * REARTH / (R_s * RSUN)
    D = np.array([occult_quad_deficit_reference(k, zi, u1, u2) for zi in z])
    return np.where(np.cos(phi) > 0, D, 0.0)


def fixtures():
    """{name: fixture}: star rows, target ID, the depth passed to
    calc_depths, the float64 curve and its period."""
    time_ = np.linspace(-0.15, 0.15, N_T)
    # F1: chip_smoke.toi465_field (bench.py's target, two nearby stars)
    D1 = _deficit(time_, 3.18, 1.09, 1.06, 5.5, 89.0, 0.35, 0.25)
    flux1 = 1.0 - D1 + np.random.default_rng(42).normal(0, SIGMA, N_T)
    f1 = dict(
        stars=[_star("465", 9.7, 8.9, 8.7, 8.6, 90.0, -60.0, 1.09, 1.06,
                     5950.0, 11.0, 0.0, 0.0),
               _star("4651", 13.2, 12.4, 12.1, 12.0, 90.001, -60.001, 0.8,
                     0.8, 5000.0, 4.0, 25.0, 45.0),
               _star("4652", 14.2, 13.3, 13.0, 12.9, 89.999, -60.002, 0.6,
                     0.6, 4000.0, 3.0, 35.0, 135.0)],
        ID=465, tdepth=0.0026, P_orb=3.18, time=time_, flux=flux1)
    # F2: tools/catalog_replay.build_target / _synth_lc on the first row
    rng = np.random.default_rng(F2_SEED)
    row = {"TOI": 9001.01, "TICID": 900001, "Rp": rng.uniform(*F2_RP),
           "Porb": rng.uniform(*F2_P)}
    D2 = _deficit(time_, row["Porb"], 1.0, 1.0, row["Rp"], 89.3, 0.35, 0.25)
    noise = np.random.default_rng(int(row["TOI"] * 100) % 2**31)
    flux2 = 1.0 - D2 + noise.normal(0, SIGMA, N_T)
    f2 = dict(
        stars=[_star(str(row["TICID"]), 10.0, 9.3, 9.1, 9.0, 90.0, -60.0,
                     1.0, 1.0, 5800.0, 10.0, 0.0, 0.0)],
        ID=row["TICID"], tdepth=float(D2.max()), P_orb=row["Porb"],
        time=time_, flux=flux2, row=row)
    for f in (f1, f2):
        f["sigma"] = SIGMA
    return {"F1": f1, "F2": f2}


def _cpu_model():
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def _sha256(path):
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def new_record(names, K, N, nsamples):
    """The record before any key has run: every fixture's inputs and empty
    per-key lists."""
    import jax

    fx = fixtures()
    rec = dict(schema=SCHEMA, package="triceratops_tpu",
               jax_version=jax.__version__, N=N, nsamples=nsamples,
               cpu=_cpu_model(), cpu_count=os.cpu_count(),
               platform=jax.default_backend(), trilegal=TRILEGAL,
               fixtures={})
    for name in names:
        f = fx[name]
        k0, p0 = KEYS[name]
        rec["fixtures"][name] = dict(
            stars=f["stars"], ID=f["ID"], tdepth=f["tdepth"],
            P_orb=f["P_orb"], sigma=f["sigma"], time=f["time"].tolist(),
            flux=f["flux"].tolist(), row=f.get("row"),
            keys=[k0 + i for i in range(K)],
            port_seeds=[p0 + i for i in range(K)],
            scenarios=None, lnZ=[], FPP=[], NFPP=[], seconds=[])
    return rec


def write_record(rec, path):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp"
    with open(tmp, "w") as fh:
        json.dump(rec, fh, indent=1)
    os.replace(tmp, path)


def read_record(path):
    with open(path) as fh:
        rec = json.load(fh)
    if rec.get("schema") != SCHEMA:
        raise ValueError(f"{path}: schema {rec.get('schema')}, expected "
                         f"{SCHEMA}")
    return rec


def _targets(rec, workdir):
    """One JAX target per fixture of the record, its depths set."""
    import pandas as pd
    from triceratops_tpu import target
    from triceratops_tpu.populations.synthetic import make_synthetic_trilegal

    tri = make_synthetic_trilegal(f"{workdir}/trilegal.csv", **TRILEGAL)
    rec["trilegal_sha256"] = _sha256(tri)
    out = {}
    for name, f in rec["fixtures"].items():
        t = target.from_stars(pd.DataFrame(f["stars"]), ID=f["ID"],
                              sectors=[1], trilegal_fname=tri)
        t.calc_depths(tdepth=f["tdepth"])
        out[name] = t
    return out


def run_reference(names=("F1", "F2"), K=K_DEFAULT, N=N_DRAWS,
                  nsamples=NSAMPLES, out=None, verbose=True):
    """Run the JAX package's calc_probs on each fixture over K keys
    (interleaved: key i of every fixture before key i + 1). Returns the
    record; writes it to ``out`` after every key when given."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    # no persistent cache: XLA:CPU's executable (de)serialization has
    # crashed long runs (tests/conftest.py)
    jax.config.update("jax_enable_compilation_cache", False)
    rec = new_record(names, K, N, nsamples)
    with tempfile.TemporaryDirectory() as workdir:
        targets = _targets(rec, workdir)
        for i in range(K):
            for name in names:
                f, t = rec["fixtures"][name], targets[name]
                t0 = time.perf_counter()
                t.calc_probs(np.asarray(f["time"]), np.asarray(f["flux"]),
                             f["sigma"], P_orb=f["P_orb"], N=N,
                             nsamples=nsamples, verbose=0,
                             key=jax.random.key(f["keys"][i]))
                dt = time.perf_counter() - t0
                f["scenarios"] = t.probs["scenario"].tolist()
                f["lnZ"].append([float(v) for v in t.lnZ])
                f["FPP"].append(float(t.FPP))
                f["NFPP"].append(float(t.NFPP))
                f["seconds"].append(dt)
                if verbose:
                    print(f"{name} key {f['keys'][i]}: FPP {t.FPP:.6g} NFPP "
                          f"{t.NFPP:.6g} ({dt:.1f} s)", flush=True)
            if out:
                write_record(rec, out)
    return rec


def row_inputs(t, f, trilegal, renorm_flux):
    """{row: positional arguments of its scenario function} for the
    target row of fixture ``f``, as calc_probs passes them (the flux
    renormalized by the target's flux ratio, Z = 0)."""
    s = t.stars[t.stars["tdepth"] > 0].iloc[0]
    flux, sigma = renorm_flux(np.asarray(f["flux"]), f["sigma"],
                              s["fluxratio"])
    tp = (np.asarray(f["time"]), flux, sigma, f["P_orb"], s["mass"],
          s["rad"], s["Teff"], 0.0)
    return {"TP": tp, "DTP": tp + (s["Tmag"], s["Jmag"], s["Hmag"],
                                   s["Kmag"], trilegal)}


def run_rows(rows=("TP", "DTP"), K=K_DEFAULT, N=N_DRAWS, nsamples=NSAMPLES,
             out=None, verbose=True):
    """Row mode: the JAX package's scenario function of each row on the
    row fixture's target over K keys (interleaved across rows). Returns
    the row record; writes it to ``out`` after every key when given."""
    import jax
    from triceratops_tpu.funcs import renorm_flux
    from triceratops_tpu.scenarios import api

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_compilation_cache", False)
    k0, p0 = KEYS[ROW_FIXTURE]
    rec = dict(schema=SCHEMA, package="triceratops_tpu",
               jax_version=jax.__version__, N=N, nsamples=nsamples,
               cpu=_cpu_model(), cpu_count=os.cpu_count(),
               fixture=ROW_FIXTURE, trilegal=TRILEGAL,
               rows={r: dict(fn=ROW_FNS[r], keys=[k0 + i for i in range(K)],
                             port_seeds=[p0 + i for i in range(K)], lnZ=[],
                             seconds=[]) for r in rows})
    fx = new_record((ROW_FIXTURE,), 0, N, nsamples)
    f = fx["fixtures"][ROW_FIXTURE]
    with tempfile.TemporaryDirectory() as workdir:
        t = _targets(fx, workdir)[ROW_FIXTURE]
        rec["trilegal_sha256"] = fx["trilegal_sha256"]
        args = row_inputs(t, f, t.trilegal_fname, renorm_flux)
        for i in range(K):
            for r in rows:
                row = rec["rows"][r]
                t0 = time.perf_counter()
                key = jax.random.fold_in(jax.random.key(row["keys"][i]),
                                         ROW_SUBKEY[r])
                res = getattr(api, ROW_FNS[r])(*args[r], N=N,
                                               nsamples=nsamples, key=key)
                lnZ = float(res["lnZ"])
                row["seconds"].append(time.perf_counter() - t0)
                row["lnZ"].append(lnZ)
                if verbose:
                    print(f"{r} key {row['keys'][i]}: lnZ {lnZ:.6f} "
                          f"({row['seconds'][-1]:.1f} s)", flush=True)
            if out:
                write_record(rec, out)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--K", type=int, default=K_DEFAULT)
    ap.add_argument("--N", type=int, default=N_DRAWS)
    ap.add_argument("--nsamples", type=int, default=NSAMPLES)
    ap.add_argument("--fixtures", default="F1,F2")
    ap.add_argument("--rows", default=None,
                    help="row mode: comma-separated rows of "
                         f"{sorted(ROW_FNS)} on {ROW_FIXTURE}")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.rows:
        run_rows(rows=tuple(args.rows.split(",")), K=args.K, N=args.N,
                 nsamples=args.nsamples,
                 out=args.out or os.path.join(HERE, "parity",
                                              "jax_rows.json"))
        return 0
    run_reference(names=tuple(args.fixtures.split(",")), K=args.K,
                  N=args.N, nsamples=args.nsamples,
                  out=args.out or os.path.join(HERE, "parity",
                                               "jax_ref.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
