"""Whether what the timed path produced is correct: the program held to
``reference.py`` and ``samplers.py`` stage by stage, on calls of the
window.

The Monte-Carlo state is the program's random numbers, so the reference
starts from them: after the window, each call of a seeded sample of the
window's calls is run again with the same key, under
``capture.Capture``; the rerun has to give the timed call's results
exactly, so what is captured is the timed call's work. What a call has to
compute (its targets, their stars past the depth gate, its rows, the
draws of each) comes from the benchmark's inputs alone (``Layout``).
Then:

* ``replay_mismatch``: values of (lnZ, FPP, NFPP) in which the rerun
  differs from the timed call (limit 0);
* the work: ``work_mismatch``, rows, targets, draws of each core call and
  reduction, sampler branch sizes and candidates returned that differ from
  what the call has to compute; ``target_mismatch``, sampler calls handed
  another star or period than the inputs give, missing or extra (limits
  0);
* the samplers and priors, on ``SAMPLER_DRAWS`` seeded draws of every
  sampler branch: the reference sampler from the same uniforms and drawn
  star rows (``samplers.branch``): ``draw_rel_gap``, the widest gap of a
  drawn quantity (the cores' inputs among them); ``prior_gap``, the widest
  gap of the log weight, ln prior plus the importance weight, over max(1,
  |reference|); ``mask_mismatch``, draws counted on one side only (limit
  0); ``weight_mismatch``, reductions whose log weights are not the
  samplers' bit for bit (limit 0);
* the likelihood cores, on the ``top`` draws of highest lnL and ``rand``
  seeded random draws of every core call and target: the reference's
  float64 lnL from the same draw parameters, on the curve the reference
  derives itself (each star's flux share, the renormalized curve):
  ``lnl_gap``, the widest |lnL - lnL_ref| over the draws within
  ``NEAR_NATS`` of the best of the target's rows (the draws that carry
  its evidence);
  ``lnl_rel_gap``, the widest |lnL - lnL_ref| / max(1, |lnL_ref|) over all
  finite draws; ``veto_mismatch``, draws finite on one side only, leaving
  out those whose secondary depth lies within ``VETO_AMBIGUOUS`` of the
  veto's threshold (limit 0);
* the evidence reduction: ``lnz_rel_gap``, the widest |lnZ - lnZ_ref| /
  max(1, |lnZ_ref|) of every row, lnZ_ref the reference's float64
  log-mean-exp of the program's lnL + log weight over the draws the row
  has to average; ``neginf_mismatch``, rows -inf on one side only (limit
  0);
* the probabilities, on every call of the window: ``prob_gap``, the widest
  gap of the row probabilities, FPP and NFPP from the reference's
  normalization of the call's own lnZ.

The control puts the reference computed in bfloat16 in the program's
place, stage by stage from the same inputs (``control=True``).
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

from . import reference as ref
from . import samplers

HERE = Path(__file__).resolve().parent
# calls of the window rerun, and draws of each core call and target held
# to the reference: the highest-lnL ones and seeded random ones; draws of
# each sampler branch held to the reference sampler
CALLS = 2
TOP_DRAWS = 128
RANDOM_DRAWS = 128
SAMPLER_DRAWS = 512
NEAR_NATS = 50.0
VETO_AMBIGUOUS = 1e-4
TARGET_ROWS = 15
# the rows of the 15 target-star scenarios that run on the program's
# conditioned twin draw sets, and the share of N each takes
# (EBx2P, PEBx2P, DEBx2P, BEBx2P: N // 4; SEBx2P: N // 2); a nearby
# star's NEBx2P row takes N // 4
TWIN_DIV = {2: 4, 5: 4, 8: 2, 11: 4, 14: 4}
NEARBY_TWIN_DIV = 4
# the row of each target-star family's first scenario
FAMILY_ROW = {"TP": 0, "EB": 1, "PTP": 3, "PEB": 4, "STP": 6, "SEB": 7,
              "DTP": 9, "DEB": 10, "BTP": 12, "BEB": 13}
# the scale under which a draw's gap is taken as absolute: angles in
# degrees or radians, everything else relative
ABS_SCALE = {"argps": 1.0, "incs": 1.0, "inc_rad": 1.0, "w_rad": 1.0}
REL_FLOOR = 1e-6


def load_limits(cell):
    return json.loads((HERE / "limits" / f"{cell}.json").read_text())


class Layout:
    """What one call of the window has to compute, from the benchmark's
    inputs alone: per target the stars that pass the depth gate (the
    target first), the curve each sees, the rows, and which targets each
    row covers."""

    def __init__(self, targets, mission, N):
        self.targets, self.N = targets, N
        self.kept, self.curves = [], []
        for t in targets:
            st = t.stars
            fr = ref.flux_ratios(st["Tmag"].to_numpy(float),
                                 st["sep (arcsec)"].to_numpy(float),
                                 st["PA (E of N)"].to_numpy(float), mission)
            keep = np.flatnonzero(ref.required_depths(fr, t.tdepth) > 0)
            self.kept.append(keep)
            self.curves.append([ref.renorm(t.flux, t.sigma, fr[j])
                                for j in keep])
        self.rows = TARGET_ROWS + 3 * max(len(k) - 1 for k in self.kept)

    def covers(self, row):
        """The targets a row covers, in order."""
        if row < TARGET_ROWS:
            return list(range(len(self.targets)))
        slot = (row - TARGET_ROWS) // 3
        return [b for b, k in enumerate(self.kept) if len(k) - 1 > slot]

    def draws(self, row):
        """The draws a row's evidence averages over."""
        if row < TARGET_ROWS:
            div = TWIN_DIV.get(row, 1)
        else:
            div = NEARBY_TWIN_DIV if (row - TARGET_ROWS) % 3 == 2 else 1
        return max(self.N // div, 1) if div > 1 else self.N

    def star(self, b, row):
        """The star of target b that a row's scenario is about, as the
        benchmark's inputs give it."""
        t = self.targets[b]
        s = t.stars.iloc[self.kept[b][row_star(row)]]
        return dict(P=float(t.P), M_s=float(s["mass"]), R_s=float(s["rad"]),
                    Teff=float(s["Teff"]), plx=float(s["plx"]))


def row_star(row):
    return 0 if row < TARGET_ROWS else 1 + (row - TARGET_ROWS) // 3


def _max(xs):
    xs = [x for x in xs if np.isfinite(x)]
    return float(max(xs)) if xs else 0.0


def core_numbers(cap, lay, cfg, control):
    """lnl_gap, lnl_rel_gap and veto_mismatch over the captured cores.
    lnl_gap counts the draws that carry a target's evidence: within
    ``NEAR_NATS`` of the best reference lnL of any of its rows."""
    rel, mismatch, pairs = [], 0, []
    best = [-np.inf] * len(lay.targets)
    for row, core in enumerate(cap.cores[:lay.rows]):
        for b, tg in zip(lay.covers(row), core["targets"]):
            flux, sigma = lay.curves[b][row_star(row)]
            kw = dict(exptime=cfg["exptime"], nsamples=cfg["nsamples"],
                      veto=core["veto"])
            time = lay.targets[b].time
            want, ratio = ref.lnL(time, flux, sigma, tg["draws"],
                                  dtype=torch.float64, **kw)
            want = want.cpu().numpy()
            got = tg["lnL"].numpy()
            if control:
                got = ref.lnL(time, flux, sigma, tg["draws"],
                              dtype=torch.bfloat16, **kw)[0].double()
                got = got.cpu().numpy()
            fin_g, fin_w = np.isfinite(got), np.isfinite(want)
            clear = np.ones_like(fin_g)
            if ratio is not None:
                clear = np.abs(ratio.double().cpu().numpy() - 1.0) \
                    >= VETO_AMBIGUOUS
            mismatch += int(((fin_g != fin_w) & clear).sum())
            both = fin_g & fin_w
            if not both.any():
                continue
            d = np.abs(np.where(both, got, 0.0) - np.where(both, want, 0.0))
            rel.append((d[both] / np.maximum(1.0, np.abs(want[both]))).max())
            best[b] = max(best[b], want[both].max())
            pairs.append((b, want[both], d[both]))
    gaps = [d[w >= best[b] - NEAR_NATS].max(initial=0.0)
            for b, w, d in pairs]
    return dict(lnl_gap=_max(gaps), lnl_rel_gap=_max(rel),
                veto_mismatch=mismatch)


def work_numbers(cap, lay, out, per_call):
    """work_mismatch: rows, targets, draws and candidates that differ from
    what the call has to compute (each core call's per-target draws, each
    reduction's draws, each sampler branch's size, the rows and candidates
    returned); weight_mismatch: reductions whose log weights are not the
    samplers' bit for bit; target_mismatch: sampler calls handed another
    star or period than the benchmark's inputs give, or missing, or
    extra."""
    bad = abs(len(cap.cores) - lay.rows) + abs(len(cap.reductions) - lay.rows)
    for row, core in enumerate(cap.cores[:lay.rows]):
        bad += abs(len(core["targets"]) - len(lay.covers(row)))
        bad += sum(n != lay.draws(row) for n in core["n"])
    for row, red in enumerate(cap.reductions[:lay.rows]):
        bad += int(red["n"] != lay.draws(row))
    lnZ = np.asarray(out["lnZ"])
    bad += int(len(out["FPP"]) != per_call) + int(len(out["NFPP"]) != per_call)
    bad += int(lnZ.shape != (per_call, lay.rows))
    weight_bad = sum(not r["weights_ok"] for r in cap.reductions)
    expected = {}
    for row in range(lay.rows):
        fams = ([k for k, r in FAMILY_ROW.items() if r == row]
                if row < TARGET_ROWS else
                (["TP", "EB"] if (row - TARGET_ROWS) % 3 == 0 else []))
        for fam in fams:
            expected[(row, fam)] = lay.covers(row)
    seen, target_bad = {}, 0
    for rec in cap.samplers:
        row = rec["row"]
        key = (row, rec["kind"])
        if row >= TARGET_ROWS and (row - TARGET_ROWS) % 3 == 1 \
                and rec["kind"] == "EB":
            key = (row - 1, "EB")  # one target: NEB after NTP's core
        j = seen.get(key, 0)
        seen[key] = j + 1
        if key not in expected or j >= len(expected[key]):
            target_bad += 1
            continue
        rec["target"], rec["star_row"] = expected[key][j], key[0]
        want = lay.star(rec["target"], key[0])
        got = rec["star"]
        pairs = [(want["P"], got["P_lo"]), (want["P"], got["P_hi"]),
                 (want["M_s"], got["M_s"]), (want["R_s"], got["R_s"])]
        pairs += [(want[k], got[k]) for k in ("Teff", "plx") if k in got]
        target_bad += int(any(np.float32(a) != np.float32(b)
                              for a, b in pairs))
        for br in rec["branches"]:
            div = (2 if rec["kind"] == "SEB" else 4) if br["twin"] else 1
            bad += int(br["n"] != (max(lay.N // div, 1) if div > 1
                                   else lay.N))
    target_bad += sum(len(v) for v in expected.values()) - sum(
        min(seen.get(k, 0), len(v)) for k, v in expected.items())
    return dict(work_mismatch=bad, weight_mismatch=weight_bad,
                target_mismatch=target_bad)


def sampler_numbers(cap, lay, trilegal, control):
    """The samplers held to ``samplers.branch`` from the same uniforms, on
    ``SAMPLER_DRAWS`` seeded draws of every branch: draw_rel_gap, the
    widest gap of a drawn quantity (relative; absolute for angles);
    prior_gap, the widest gap of the log weight (ln prior + importance
    weight) over max(1, |reference|); mask_mismatch, draws counted on one
    side only (or with a finite weight on one side only), leaving out those
    within ``samplers.AMBIGUOUS`` of a threshold where the result jumps."""
    f64 = samplers.Ops(torch.float64)
    low = samplers.Ops(torch.bfloat16) if control else None
    gaps, pgaps, mismatch = [], [], 0
    for rec in cap.samplers:
        if "target" not in rec:
            continue
        b = rec["target"]
        star = lay.star(b, rec["star_row"])
        bg = None
        if rec["kind"] in samplers.BACKGROUND:
            bg = samplers.background_table(
                str(trilegal), float(lay.targets[b].stars["Tmag"].iloc[0]))
        molusc = None
        if rec["molusc"]:
            kept = samplers.molusc_kept(lay.targets[b].molusc, star["M_s"])
            # the batch path first draws each target's posterior rows
            # (its seam's draws outside any sampler, one a target)
            rows_of = (cap.free_ints[b] if len(cap.free_ints) == len(
                lay.targets) else None)
        for br in rec["branches"]:
            if br["pos"] is not None:
                pos = br["pos"] if rows_of is None else rows_of[br["pos"]]
                molusc = (kept, pos)
            args = (rec["kind"], br["twin"], star, br["u"], br["rows"], bg)
            want, w_mask, w_wt, amb = samplers.branch(*args, f64, molusc)
            if control:
                got, g_mask, g_wt, _ = samplers.branch(*args, low, molusc)
                got = {k: v.double() for k, v in got.items()}
                g_wt = g_wt.double()
            else:
                got, g_mask, g_wt = br["draws"], br["mask"], br["weight"]
            ok = ~amb
            mismatch += int(((g_mask != w_mask) & ok).sum())
            live = ok & w_mask & g_mask
            fin = torch.isfinite(w_wt) & torch.isfinite(g_wt)
            mismatch += int((live & (torch.isfinite(w_wt)
                                     != torch.isfinite(g_wt))).sum())
            both = live & fin
            if both.any():
                pgaps.append(float((torch.abs(g_wt - w_wt)[both]
                                    / torch.clamp_min(w_wt.abs()[both],
                                                      1.0)).max()))
            for f, g in got.items():
                if f not in want or not live.any():
                    continue
                w = want[f].double()
                scale = (torch.full_like(w, ABS_SCALE[f]) if f in ABS_SCALE
                         else torch.clamp_min(w.abs(), REL_FLOOR))
                d = (torch.abs(g - w) / scale)[live]
                gaps.append(float(torch.nan_to_num(d, nan=np.inf).max()))
    return dict(draw_rel_gap=_max(gaps) if gaps else 0.0,
                prior_gap=_max(pgaps), mask_mismatch=mismatch)


def evidence_numbers(cap, lay, lnZ, control):
    """lnz_rel_gap and neginf_mismatch of one call's rows, lnZ (B, R):
    each row's evidence against the reference's float64 log-mean-exp of
    the program's lnL + log weight over the draws the row has to average
    (``Layout.draws``); rows a target does not have must read -inf."""
    ev = cap.evidence_control if control else None
    rel, mismatch = [], 0
    if len(cap.evidence) != lnZ.shape[1] or lnZ.shape[1] != lay.rows:
        return dict(lnz_rel_gap=math.inf, neginf_mismatch=lnZ.size)
    for row, refs in enumerate(cap.evidence):
        covers = lay.covers(row)
        shift = (math.log(cap.reductions[row]["n"])
                 - math.log(lay.draws(row)))
        for b, want in zip(covers, refs):
            got = ev[row][covers.index(b)] + shift if control else lnZ[b, row]
            want = want + shift
            if np.isfinite(got) != np.isfinite(want):
                mismatch += 1
            elif np.isfinite(want):
                rel.append(abs(got - want) / max(1.0, abs(want)))
        if not control:
            mismatch += sum(lnZ[b, row] != -np.inf
                            for b in range(lnZ.shape[0]) if b not in covers)
    return dict(lnz_rel_gap=_max(rel), neginf_mismatch=int(mismatch))


def prob_gap(out, control=False):
    """Widest gap of one call's probabilities, FPP and NFPP from the
    reference's normalization of its lnZ."""
    worst = 0.0
    for b in range(out["lnZ"].shape[0]):
        p, fpp, nfpp = ref.probabilities(out["lnZ"][b])
        if control:
            got_p, got_f, got_n = ref.probabilities(out["lnZ"][b],
                                                    torch.bfloat16)
        else:
            got_p = None if out["probs"] is None else out["probs"][b]
            got_f, got_n = out["FPP"][b], out["NFPP"][b]
        gaps = [abs(got_f - fpp), abs(got_n - nfpp)]
        if got_p is not None:
            gaps.append(np.abs(np.asarray(got_p) - p).max())
        worst = max(worst, *gaps)
    return float(worst)


def replay_mismatch(timed, again):
    n = 0
    for key in ("lnZ", "FPP", "NFPP"):
        a, b = np.asarray(timed[key]), np.asarray(again[key])
        n += int(np.sum(~((a == b) | (np.isnan(a) & np.isnan(b)))))
    return n


def merge(numbers):
    """The worst of each number over several calls."""
    out = {}
    for nums in numbers:
        for k, v in nums.items():
            out[k] = max(out.get(k, v), v)
    return out


def judge(numbers, limits):
    """(correct, [(name, value, limit)]): each number within its limit."""
    rows = [(k, numbers[k], limits[k]) for k in limits]
    missing = [k for k in limits if k not in numbers]
    ok = not missing and all(v <= lim for _, v, lim in rows)
    return ok, rows
