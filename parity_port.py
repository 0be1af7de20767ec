"""K-seed FPP / lnZ statistics of the PyTorch port against the JAX package's.

The card side of the end-to-end parity check. It reads the record that
``parity_ref.py`` wrote with the JAX package on the CPU
(``parity/jax_ref.json``: per fixture the star rows, the float64 curve,
and every key's per-row lnZ, FPP and NFPP), runs the port's
``target.calc_probs`` on the same inputs over K seeds on the card
(``device="cuda"``, ``backend="auto"``: the orbit v2 kernel, one launch
per likelihood core), and holds the two samples to these gates:

* FPP and NFPP: the difference of the two means within
  3 x sqrt(s_port^2 / K_port + s_jax^2 / K_jax), each side's own K; where
  both means are below 1e-2 the limit is at least 1e-3 (said in the
  output). Also on log10 FPP and log10 NFPP, with no floor: the
  difference of the mean logs within 3 x their combined s.e. (F1's NFPP,
  ~1e-7, is the nearby-star rows' total, which the floored gate cannot
  see); a quantity that is 0 in every run on both sides passes, one that
  is 0 in some runs only is not gated on the log.
* Rows gated unless more than 5 nats below the winner in both sides'
  means (chip_smoke.py's statistical rule): the difference of mean lnZ
  within max(0.05, 3 x the combined standard error) nats, and the ratio
  of the two per-row standard deviations in [0.5, 2].
* Deeper rows are printed, not gated; a row is -inf on one side only if
  it is -inf on the other (a row's mean is -inf when any run is).
* Importance sampling against plain rejection (F1, the port only, as
  bench_scripts/bias_audit.py does): ``importance_sampling=False`` at
  10 x N over K_plain seeds; the gated rows' mean lnZ within
  max(0.05, 3 x combined s.e.) of the importance-sampled means.

It imports the port, numpy and json only (no jax, nothing of the JAX
package). Writes ``parity/port_h100.json`` (both samples, the gates, the
card's name and power limit, the torch and CUDA versions) and prints a
markdown table of both sides' per-row means +- s.d., FPP and NFPP.

Run on the card from the repository root:

    python3 parity_port.py [--K 20] [--K-plain 10] [--out parity/port_h100.json]

Exits 1 if a gate fails. ``chip_smoke.py`` phase 11 runs ``check`` with
K = 16 and no plain-rejection runs.

Row mode (``--rows``) reads ``parity/jax_rows.json`` (``parity_ref.py
--rows``: the JAX package's TP and DTP scenario functions on F1's target
over many keys), runs the port's on the card over K seeds, applies the
live-row gates to each row, and prints the s.d. ratio with a bootstrap
95 % interval and the Brown-Forsythe test's p-value; writes
``parity/port_rows_h100.json``:

    python3 parity_port.py --rows [--K 200] [--uniforms numpy]
        [--device cpu]

``--uniforms numpy`` draws the port's uniforms and indices with numpy's
PCG64 seeded per seed (``numpy_streams``), so that a seed gives the same
draws on the card and, with ``--device cpu``, on the CPU.
"""

import argparse
import contextlib
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REF = os.path.join(HERE, "parity", "jax_ref.json")
OUT = os.path.join(HERE, "parity", "port_h100.json")
SCHEMA = 1
K_DEFAULT = 20
K_PLAIN = 10
PLAIN_N_FACTOR = 10
# rows more than this many nats below the winner on both sides are deep
LIVE_NATS = 5.0
# live rows: |d mean lnZ| <= max(MEAN_FLOOR, SE_MULT x combined s.e.)
MEAN_FLOOR = 0.05
SE_MULT = 3.0
SPREAD_RATIO = (0.5, 2.0)
# FPP / NFPP: absolute floor of the limit where both means are below
SCALAR_FLOOR, SCALAR_FLOOR_BELOW = 1e-3, 1e-2
# seed offsets of the plain-rejection runs past the record's port seeds
PLAIN_SEED_OFFSET = 1000
# row mode: the row record, the output, the rows' scenario functions
ROWS_REF = os.path.join(HERE, "parity", "jax_rows.json")
ROWS_OUT = os.path.join(HERE, "parity", "port_rows_h100.json")
ROW_FNS = {"TP": "lnZ_TTP", "DTP": "lnZ_DTP"}
ROWS_K = 200
N_BOOT = 10_000
# (K_port, K_ref) pairs whose s.d.-ratio false-rejection rate row mode
# reads off the JAX sample: phase 11 as issued, as run, and the record
FALSE_RATE_SIZES = ((8, 20), (16, 20), (20, 20), (16, 100))


def read_record(path):
    with open(path) as fh:
        rec = json.load(fh)
    if rec.get("schema") != SCHEMA:
        raise ValueError(f"{path}: schema {rec.get('schema')}, expected "
                         f"{SCHEMA}")
    return rec


def _sha256(path):
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def build_targets(rec, workdir, device="cuda"):
    """{fixture: port target} on the record's star rows and TRILEGAL field
    (checked against the record's sha256 of the JAX package's csv), with
    the record's depths set."""
    import pandas as pd
    from triceratops_tpu_torch import target
    from triceratops_tpu_torch.populations.synthetic import (
        make_synthetic_trilegal)

    tri = make_synthetic_trilegal(f"{workdir}/trilegal.csv",
                                  **rec["trilegal"])
    if _sha256(tri) != rec["trilegal_sha256"]:
        raise ValueError("the port's synthetic TRILEGAL field differs from "
                         "the one the JAX package read")
    out = {}
    for name, f in rec["fixtures"].items():
        t = target.from_stars(pd.DataFrame(f["stars"]), ID=f["ID"],
                              sectors=[1], trilegal_fname=tri)
        t.calc_depths(tdepth=f["tdepth"])
        out[name] = t
    return out


def run_port(rec, targets, K, *, N=None, device="cuda", backend="auto",
             importance_sampling=True, seed_offset=0, verbose=True):
    """The port's calc_probs on every fixture over K seeds (the record's
    port seeds plus ``seed_offset``). Returns {fixture: {seeds, lnZ, FPP,
    NFPP, seconds, scenarios}}; ``seconds`` is each call's host wall,
    which ends in a device-to-host copy."""
    N = rec["N"] if N is None else N
    out = {}
    for name, t in targets.items():
        f = rec["fixtures"][name]
        seeds = [f["port_seeds"][0] + seed_offset + i for i in range(K)]
        run = dict(seeds=seeds, lnZ=[], FPP=[], NFPP=[], seconds=[])
        for s in seeds:
            t0 = time.perf_counter()
            t.calc_probs(np.asarray(f["time"]), np.asarray(f["flux"]),
                         f["sigma"], P_orb=f["P_orb"], N=N,
                         nsamples=rec["nsamples"], verbose=0, key=s,
                         device=device, backend=backend,
                         importance_sampling=importance_sampling)
            run["seconds"].append(time.perf_counter() - t0)
            run["lnZ"].append([float(v) for v in t.lnZ])
            run["FPP"].append(float(t.FPP))
            run["NFPP"].append(float(t.NFPP))
        run["scenarios"] = t.probs["scenario"].tolist()
        if verbose:
            print(f"parity: port {name} N={N} IS={importance_sampling} "
                  f"K={K}: {np.mean(run['seconds']):.4f} s per call, FPP "
                  f"{np.mean(run['FPP']):.6g}", flush=True)
        out[name] = run
    return out


def _mean_sd(x):
    x = np.asarray(x, float)
    return float(x.mean()), float(x.std(ddof=1)) if len(x) > 1 else 0.0


def gate_scalar(port, ref):
    """FPP or NFPP: |mean_port - mean_ref| <= 3 x combined s.e., at least
    1e-3 where both means are below 1e-2."""
    mp, sp = _mean_sd(port)
    mj, sj = _mean_sd(ref)
    limit = SE_MULT * np.sqrt(sp**2 / len(port) + sj**2 / len(ref))
    floor = mp < SCALAR_FLOOR_BELOW and mj < SCALAR_FLOOR_BELOW
    if floor:
        limit = max(limit, SCALAR_FLOOR)
    d = abs(mp - mj)
    return dict(mean_port=mp, sd_port=sp, mean_ref=mj, sd_ref=sj, diff=d,
                limit=float(limit), floor=floor, ok=bool(d <= limit))


def gate_log(port, ref):
    """log10 of FPP or NFPP: |d mean| <= 3 x combined s.e., no floor.
    Where a run is 0 (kind "zero", no log): 0 in every run on both sides
    passes, 0 in every run on one side only fails, anything else is not
    gated."""
    p, r = np.asarray(port, float), np.asarray(ref, float)
    if not (p > 0).all() or not (r > 0).all():
        if not p.any() and not r.any():
            return dict(kind="zero", ok=True, why="0 in every run")
        if not p.any() or not r.any():
            return dict(kind="zero", ok=False,
                        why="0 in every run on one side only")
        return dict(kind="zero", ok=True, why="0 in some runs: not gated")
    mp, sp = _mean_sd(np.log10(p))
    mj, sj = _mean_sd(np.log10(r))
    limit = SE_MULT * np.sqrt(sp**2 / len(p) + sj**2 / len(r))
    d = abs(mp - mj)
    return dict(kind="log10", mean_port=mp, sd_port=sp, mean_ref=mj,
                sd_ref=sj, diff=d, limit=float(limit), ok=bool(d <= limit))


def row_stats(lnZ):
    """Per-row mean and s.d. over runs of a (K, rows) array; a row with a
    -inf run has mean -inf and s.d. nan."""
    a = np.asarray(lnZ, float)
    inf = np.isneginf(a).any(axis=0)
    fin = np.where(np.isneginf(a), 0.0, a)
    mean = np.where(inf, -np.inf, fin.mean(axis=0))
    sd = (np.where(inf, np.nan, fin.std(axis=0, ddof=1)) if len(a) > 1
          else np.zeros(a.shape[1]))
    return mean, sd


def gate_rows(lnZ_port, lnZ_ref, names, spread=True, ref_rows=None):
    """Per-row gates between two K-run samples (K, rows). Returns one dict
    per row: kind "live" (gated: means and, with ``spread``, the s.d.
    ratio), "deep" (more than LIVE_NATS below the winner on both sides:
    printed only) or "-inf" (on both sides); a row -inf on one side only
    fails. ``ref_rows`` ({row index: runs}) replaces those rows'
    reference samples by longer ones."""
    mp, sp = row_stats(lnZ_port)
    mj, sj = row_stats(lnZ_ref)
    kp = len(lnZ_port)
    kj = np.full(len(names), len(lnZ_ref))
    for i, runs in (ref_rows or {}).items():
        (mj[i],), (sj[i],) = row_stats(np.asarray(runs, float)[:, None])
        kj[i] = len(runs)
    deep = (mp < np.max(mp) - LIVE_NATS) & (mj < np.max(mj) - LIVE_NATS)
    rows = []
    for i, name in enumerate(names):
        r = dict(row=name, mean_port=float(mp[i]), sd_port=float(sp[i]),
                 mean_ref=float(mj[i]), sd_ref=float(sj[i]), ok=True,
                 K_ref=int(kj[i]))
        inf_p, inf_j = np.isneginf(mp[i]), np.isneginf(mj[i])
        if inf_p or inf_j:
            r["kind"] = "-inf"
            r["ok"] = bool(inf_p and inf_j)
            if not r["ok"]:
                r["why"] = "-inf on one side only"
        elif deep[i]:
            r["kind"] = "deep"
        else:
            r["kind"] = "live"
            d = abs(mp[i] - mj[i])
            lim = max(MEAN_FLOOR, SE_MULT * np.sqrt(sp[i]**2 / kp
                                                    + sj[i]**2 / kj[i]))
            r.update(diff=float(d), limit=float(lim))
            why = []
            if not d <= lim:
                why.append(f"|d mean| {d:.4f} > {lim:.4f}")
            if spread:
                ratio = (1.0 if sp[i] == sj[i] else
                         float(sp[i] / sj[i]) if sj[i] > 0 else np.inf)
                r["sd_ratio"] = ratio
                if not SPREAD_RATIO[0] <= ratio <= SPREAD_RATIO[1]:
                    why.append(f"s.d. ratio {ratio:.3f} outside "
                               f"{list(SPREAD_RATIO)}")
            r["ok"] = not why
            if why:
                r["why"] = "; ".join(why)
        rows.append(r)
    return rows


def spread_false_rate(k_port, k_ref):
    """Chance that the s.d.-ratio gate rejects two samples of these sizes
    drawn from one normal distribution: F(k_port - 1, k_ref - 1) outside
    [0.5^2, 2^2]."""
    from scipy.stats import f

    dof = (k_port - 1, k_ref - 1)
    return float(f.cdf(SPREAD_RATIO[0] ** 2, *dof)
                 + f.sf(SPREAD_RATIO[1] ** 2, *dof))


def spread_false_rate_resampled(runs, k_port, k_ref, n=20_000, seed=0):
    """Chance that the s.d.-ratio gate rejects two samples of these sizes
    drawn (with replacement) from one measured sample ``runs``: the
    false-rejection rate under the row's own, heavy-tailed, spread."""
    a = np.asarray(runs, float)
    rng = np.random.default_rng(seed)
    sp = a[rng.integers(0, len(a), (n, k_port))].std(axis=1, ddof=1)
    sr = a[rng.integers(0, len(a), (n, k_ref))].std(axis=1, ddof=1)
    keep = sr > 0
    ratio = sp[keep] / sr[keep]
    return float(np.mean((ratio < SPREAD_RATIO[0])
                         | (ratio > SPREAD_RATIO[1])))


def row_reference(rec, rows_rec):
    """{fixture: {row index: runs}}: the row record's longer JAX samples,
    which replace the main record's for those rows. Checks that both
    records hold the same configuration and that the row record's first
    keys are the main record's keys with the same lnZ."""
    name = rows_rec["fixture"]
    f = rec["fixtures"][name]
    for k in ("N", "nsamples", "trilegal_sha256"):
        if rows_rec[k] != rec[k]:
            raise ValueError(f"the row record's {k} {rows_rec[k]!r} is not "
                             f"the main record's {rec[k]!r}")
    out = {}
    if not f["lnZ"]:
        return {name: out}
    for row, r in rows_rec["rows"].items():
        i = f["scenarios"].index(row)
        k = min(len(f["keys"]), len(r["keys"]))
        if (r["keys"][:k] != f["keys"][:k]
                or r["lnZ"][:k] != [v[i] for v in f["lnZ"][:k]]):
            raise ValueError(f"the row record's {row} runs do not start "
                             f"with the main record's keys and values")
        out[i] = r["lnZ"]
    return {name: out}


def gate_fixture(port, ref, ref_rows=None):
    """Every gate of one fixture: port run and the record's fixture;
    ``ref_rows`` as in gate_rows."""
    names = ref["scenarios"]
    rows = gate_rows(port["lnZ"], ref["lnZ"], names, ref_rows=ref_rows)
    res = dict(K_port=len(port["lnZ"]), K_ref=len(ref["lnZ"]),
               s_port=float(np.mean(port["seconds"])),
               s_ref=float(np.mean(ref["seconds"])),
               FPP=gate_scalar(port["FPP"], ref["FPP"]),
               NFPP=gate_scalar(port["NFPP"], ref["NFPP"]),
               logFPP=gate_log(port["FPP"], ref["FPP"]),
               logNFPP=gate_log(port["NFPP"], ref["NFPP"]), rows=rows)
    res["failures"] = (
        [f"{k}: |d mean| {res[k]['diff']:.4g} > {res[k]['limit']:.4g}"
         for k in ("FPP", "NFPP") if not res[k]["ok"]]
        + [f"{k}: " + (f"|d mean log10| {res[k]['diff']:.4g} > "
                       f"{res[k]['limit']:.4g}" if res[k]["kind"] == "log10"
                       else res[k]["why"])
           for k in ("logFPP", "logNFPP") if not res[k]["ok"]]
        + [f"{r['row']} (row {i}): {r['why']}" for i, r in enumerate(rows)
           if not r["ok"]])
    res["ok"] = not res["failures"]
    return res


def gate_plain(is_run, plain_run, names):
    """IS against plain rejection on the port: the gated rows' means (no
    spread gate: the two estimators' spreads differ by design)."""
    rows = gate_rows(plain_run["lnZ"], is_run["lnZ"], names, spread=False)
    fails = [f"{r['row']} (row {i}): {r['why']}" for i, r in enumerate(rows)
             if not r["ok"]]
    return dict(K_plain=len(plain_run["lnZ"]), K_is=len(is_run["lnZ"]),
                rows=rows, failures=fails, ok=not fails)


def _fmt(m, s):
    return "-inf" if np.isneginf(m) else f"{m:.4f} ± {s:.4f}"


def table(results, card):
    """Markdown: per fixture, per row both sides' mean ± s.d., the gate's
    verdict; then FPP and NFPP."""
    lines = [f"Card: {card['smi']}; torch {card['torch']}, CUDA "
             f"{card['cuda']}."]
    for name, res in results.items():
        lines += ["", f"{name}: port K = {res['K_port']} "
                  f"({res['s_port']:.4f} s per call), JAX K = "
                  f"{res['K_ref']} ({res['s_ref']:.1f} s per call); the "
                  f"s.d.-ratio gate rejects equal normal samples of these "
                  f"sizes with probability "
                  f"{spread_false_rate(res['K_port'], res['K_ref']):.4f} "
                  f"per row", "",
                  "| row | port lnZ | JAX lnZ | kind | gate |",
                  "|---|---|---|---|---|"]
        for r in res["rows"]:
            gate = ("pass" if r["ok"] else f"FAIL: {r['why']}")
            if r["kind"] == "live":
                gate += (f" (|d| {r['diff']:.4f} <= {r['limit']:.4f}"
                         + (f", s.d. ratio {r['sd_ratio']:.3f}"
                            if "sd_ratio" in r else "")
                         + (f", JAX K = {r['K_ref']}"
                            if r["K_ref"] != res["K_ref"] else "") + ")")
            lines.append(f"| {r['row']} | {_fmt(r['mean_port'], r['sd_port'])}"
                         f" | {_fmt(r['mean_ref'], r['sd_ref'])} | "
                         f"{r['kind']} | {gate} |")
        for k in ("FPP", "NFPP"):
            g = res[k]
            lines.append(f"| {k} | {g['mean_port']:.6g} ± {g['sd_port']:.3g}"
                         f" | {g['mean_ref']:.6g} ± {g['sd_ref']:.3g} | | "
                         f"{'pass' if g['ok'] else 'FAIL'} (|d| "
                         f"{g['diff']:.3g} <= {g['limit']:.3g}"
                         f"{', 1e-3 floor' if g['floor'] else ''}) |")
        for k in ("logFPP", "logNFPP"):
            g = res[k]
            if g["kind"] == "zero":
                lines.append(f"| log10 {k[3:]} | | | | "
                             f"{'pass' if g['ok'] else 'FAIL'} "
                             f"({g['why']}) |")
                continue
            lines.append(f"| log10 {k[3:]} | "
                         f"{_fmt(g['mean_port'], g['sd_port'])} | "
                         f"{_fmt(g['mean_ref'], g['sd_ref'])} | | "
                         f"{'pass' if g['ok'] else 'FAIL'} (|d| "
                         f"{g['diff']:.3g} <= {g['limit']:.3g}) |")
    return "\n".join(lines)


def card_info(device):
    """The card's name and power limit as nvidia-smi gives them, torch and
    CUDA versions; "cpu" in their place for a CPU run."""
    import torch

    info = dict(torch=torch.__version__, cuda=torch.version.cuda)
    if not str(device).startswith("cuda"):
        return dict(info, smi="cpu", device="cpu")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return dict(info, smi=smi.stdout.strip().splitlines()[0]
                if smi.returncode == 0 else "not read",
                device=torch.cuda.get_device_name(0))


def row_inputs(t, f, trilegal):
    """{row: positional arguments of its scenario function} for the
    target row of fixture ``f``, as calc_probs passes them (the flux
    renormalized by the target's flux ratio, Z = 0)."""
    from triceratops_tpu_torch.funcs import renorm_flux

    s = t.stars[t.stars["tdepth"] > 0].iloc[0]
    flux, sigma = renorm_flux(np.asarray(f["flux"]), f["sigma"],
                              s["fluxratio"])
    tp = (np.asarray(f["time"]), flux, sigma, f["P_orb"], s["mass"],
          s["rad"], s["Teff"], 0.0)
    return {"TP": tp, "DTP": tp + (s["Tmag"], s["Jmag"], s["Hmag"],
                                   s["Kmag"], trilegal)}


def spread_stats(port, ref, n_boot=N_BOOT, seed=0):
    """s.d. ratio port / ref with a percentile-bootstrap 95 % interval
    (both samples resampled), and the Brown-Forsythe test's p-value for
    equal spreads (Levene's test about the medians: no normality
    assumed)."""
    from scipy.stats import levene

    p, r = np.asarray(port, float), np.asarray(ref, float)
    rng = np.random.default_rng(seed)
    bp = p[rng.integers(0, len(p), (n_boot, len(p)))].std(axis=1, ddof=1)
    br = r[rng.integers(0, len(r), (n_boot, len(r)))].std(axis=1, ddof=1)
    keep = br > 0
    lo, hi = np.percentile(bp[keep] / br[keep], [2.5, 97.5])
    return dict(sd_ratio=float(p.std(ddof=1) / r.std(ddof=1)),
                ci95=[float(lo), float(hi)],
                p_brown_forsythe=float(levene(p, r, center="median").pvalue))


@contextlib.contextmanager
def numpy_streams(seed):
    """For the block, the port's samplers draw their uniforms and indices
    from numpy's PCG64 seeded with ``seed`` (made on the host, copied to
    the generator's device) instead of from torch's generator: the same
    seed gives the same draws on the card and on the CPU."""
    import torch
    from triceratops_tpu_torch.scenarios import engine

    rng = np.random.default_rng(seed)
    saved = engine._uniforms, engine._randint
    engine._uniforms = lambda gen, n, N: [
        torch.as_tensor(rng.random(N, dtype=np.float32), device=gen.device)
        for _ in range(n)]
    engine._randint = lambda gen, n, hi: torch.as_tensor(
        rng.integers(0, int(hi), n), device=gen.device)
    try:
        yield
    finally:
        engine._uniforms, engine._randint = saved


def check_rows(rows_path=ROWS_REF, ref_path=REF, K=ROWS_K, device="cuda",
               backend="auto", verbose=True, uniforms="torch"):
    """Row mode: the port's TP and DTP scenario functions on the row
    record's fixture over K seeds against the JAX package's keys; with
    ``uniforms="numpy"`` the port's draws come from ``numpy_streams``.
    Returns (summary, ok): the samples, each row's live-row gates and
    spread statistics, and a markdown table."""
    import torch
    from triceratops_tpu_torch.scenarios import api

    rows_rec, rec = read_record(rows_path), read_record(ref_path)
    name = rows_rec["fixture"]
    f = rec["fixtures"][name]
    row_reference(rec, rows_rec)
    with tempfile.TemporaryDirectory() as workdir:
        t = build_targets(rec, workdir, device)[name]
        args = row_inputs(t, f, t.trilegal_fname)
        runs = {}
        for row, r in rows_rec["rows"].items():
            seeds = [r["port_seeds"][0] + i for i in range(K)]
            lnZ, seconds = [], []
            for s in seeds:
                gen = torch.Generator(device=device)
                gen.manual_seed(s)
                streams = (numpy_streams(s) if uniforms == "numpy"
                           else contextlib.nullcontext())
                t0 = time.perf_counter()
                with streams:
                    res = getattr(api, ROW_FNS[row])(
                        *args[row], N=rows_rec["N"],
                        nsamples=rows_rec["nsamples"], gen=gen,
                        device=device, backend=backend)
                lnZ.append(float(res["lnZ"]))
                seconds.append(time.perf_counter() - t0)
            runs[row] = dict(seeds=seeds, lnZ=lnZ, seconds=seconds)
            if verbose:
                print(f"parity: port {name} {row} N={rows_rec['N']} K={K}: "
                      f"{np.mean(seconds):.4f} s per call", flush=True)
    gates = {}
    for row, run in runs.items():
        ref = rows_rec["rows"][row]["lnZ"]
        g = gate_rows(np.asarray(run["lnZ"])[:, None],
                      np.asarray(ref)[:, None], [row])[0]
        g.update(spread_stats(run["lnZ"], ref), K_port=len(run["lnZ"]),
                 false_rates={f"{kp}v{kr}": spread_false_rate_resampled(
                     ref, kp, kr) for kp, kr in FALSE_RATE_SIZES})
        gates[row] = g
    card = card_info(device)
    ok = all(g["ok"] for g in gates.values())
    lines = [f"Card: {card['smi']}; torch {card['torch']}, CUDA "
             f"{card['cuda']}. {name}, N = {rows_rec['N']}, the port's "
             f"uniforms from {uniforms}; JAX {rows_rec['jax_version']} on "
             f"{rows_rec['cpu']}.", "",
             "| row | port lnZ (K) | JAX lnZ (K) | |d| <= limit | s.d. "
             "ratio [95 % CI] | Brown-Forsythe p | gate |",
             "|---|---|---|---|---|---|---|"]
    for row, g in gates.items():
        d = (f"{g['diff']:.4f} <= {g['limit']:.4f}" if "diff" in g
             else g["kind"])
        lines.append(
            f"| {row} | {_fmt(g['mean_port'], g['sd_port'])} ({g['K_port']})"
            f" | {_fmt(g['mean_ref'], g['sd_ref'])} ({g['K_ref']}) | "
            f"{d} | {g['sd_ratio']:.3f} "
            f"[{g['ci95'][0]:.3f}, {g['ci95'][1]:.3f}] | "
            f"{g['p_brown_forsythe']:.3g} | "
            f"{'pass' if g['ok'] else 'FAIL: ' + g['why']} |")
    lines += ["", "The s.d.-ratio gate's false-rejection rate on resamples "
              "of the JAX sample (K_port v K_ref: rate; normal samples in "
              "[]):"]
    for row, g in gates.items():
        lines.append(f"- {row}: " + ", ".join(
            f"{k} {v:.4f} [{spread_false_rate(*map(int, k.split('v'))):.4f}]"
            for k, v in g["false_rates"].items()))
    summary = dict(schema=SCHEMA, card=card,
                   ref=os.path.relpath(rows_path, HERE),
                   ref_jax_version=rows_rec["jax_version"],
                   ref_cpu=rows_rec["cpu"], fixture=name, N=rows_rec["N"],
                   nsamples=rows_rec["nsamples"], K=K, uniforms=uniforms,
                   device=str(device), runs=runs,
                   gates=gates, ok=ok, table="\n".join(lines))
    return summary, ok


def check(ref_path=REF, K=K_DEFAULT, K_plain=K_PLAIN, device="cuda",
          verbose=True, rows_path=ROWS_REF):
    """Run the port against the record and apply every gate. Returns
    (summary, ok); the summary holds the samples, the gates and a
    markdown table. With ``rows_path`` (the row record, when the file
    exists) its rows are gated against its longer JAX samples."""
    rec = read_record(ref_path)
    ref_rows = (row_reference(rec, read_record(rows_path))
                if rows_path and os.path.exists(rows_path) else {})
    with tempfile.TemporaryDirectory() as workdir:
        targets = build_targets(rec, workdir, device)
        t0 = time.perf_counter()
        runs = run_port(rec, targets, K, device=device, verbose=verbose)
        results = {name: gate_fixture(runs[name], rec["fixtures"][name],
                                      ref_rows.get(name))
                   for name in runs}
        plain = None
        if K_plain and "F1" in targets:
            N_plain = PLAIN_N_FACTOR * rec["N"]
            pr = run_port(rec, {"F1": targets["F1"]}, K_plain, N=N_plain,
                          device=device, importance_sampling=False,
                          seed_offset=PLAIN_SEED_OFFSET, verbose=verbose)
            plain = dict(N=N_plain, run=pr["F1"],
                         gate=gate_plain(runs["F1"], pr["F1"],
                                         rec["fixtures"]["F1"]["scenarios"]))
        wall = time.perf_counter() - t0
    card = card_info(device)
    ok = all(r["ok"] for r in results.values()) and (
        plain is None or plain["gate"]["ok"])
    summary = dict(schema=SCHEMA, card=card, ref=os.path.relpath(ref_path,
                                                                 HERE),
                   ref_rows=(os.path.relpath(rows_path, HERE)
                             if ref_rows else None),
                   ref_jax_version=rec["jax_version"], ref_cpu=rec["cpu"],
                   N=rec["N"], nsamples=rec["nsamples"],
                   K=K, wall_s=wall, runs=runs, gates=results, plain=plain,
                   ok=ok)
    summary["table"] = table(results, card)
    return summary, ok


def print_summary(summary):
    print(summary["table"])
    p = summary["plain"]
    if p is not None:
        g = p["gate"]
        print(f"\nF1 plain rejection at N = {p['N']} (K = {g['K_plain']}) "
              f"vs IS (K = {g['K_is']}):")
        for r in g["rows"]:
            if r["kind"] == "live":
                print(f"  {r['row']}: plain {_fmt(r['mean_port'], r['sd_port'])}"
                      f", IS {_fmt(r['mean_ref'], r['sd_ref'])}, |d| "
                      f"{r['diff']:.4f} <= {r['limit']:.4f}: "
                      f"{'pass' if r['ok'] else 'FAIL'}")
    for name, res in summary["gates"].items():
        floors = [k for k in ("FPP", "NFPP") if res[k]["floor"]]
        if floors:
            print(f"{name}: {', '.join(floors)} both below 1e-2: limit "
                  f"floored at 1e-3")
        for f in res["failures"]:
            print(f"{name} FAILED: {f}")
    if p is not None:
        for f in p["gate"]["failures"]:
            print(f"F1 plain vs IS FAILED: {f}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--K", type=int, default=None,
                    help=f"seeds per fixture ({K_DEFAULT}; {ROWS_K} per "
                         f"row with --rows)")
    ap.add_argument("--K-plain", type=int, default=K_PLAIN)
    ap.add_argument("--rows", action="store_true",
                    help="row mode: TP and DTP against parity/jax_rows.json")
    ap.add_argument("--uniforms", choices=("torch", "numpy"),
                    default="torch",
                    help="row mode: the port's random streams")
    ap.add_argument("--device", default="cuda",
                    help="row mode: cuda, or cpu to rerun a few seeds")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("parity_port: no CUDA card", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    if args.rows:
        out = args.out or ROWS_OUT
        summary, ok = check_rows(K=args.K or ROWS_K, device=args.device,
                                 uniforms=args.uniforms)
    else:
        out = args.out or OUT
        summary, ok = check(K=args.K or K_DEFAULT, K_plain=args.K_plain)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as fh:
        json.dump(summary, fh, indent=1)
    if args.rows:
        print(summary["table"])
    else:
        print_summary(summary)
    print(f"parity_port: {'all gates pass' if ok else 'FAILED'} in "
          f"{time.perf_counter() - t0:.1f} s; wrote {out}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
