"""The least time one H100 could take for the chi^2 work of a likelihood
core's inputs: the yardstick of ``lnl_core_roofline``.

Frozen from ``chip_smoke.py`` (its ``FLOPS_*`` constants and
``window_bound``'s count) and from the tabulated coefficients' segment
breaks and degrees (``triceratops_tpu/data/cheb_k_tables.npz``), and
rewritten so that the count reads the inputs only, never the program:

* per draw that counts (``mask``: a masked draw's lnL is -inf whatever
  its chi^2), its orbit constants and its transit window;
* the Kepler solve and the exposure z^2 model only at the (draw,
  exposure) pairs that lie in transit, i.e. with some exposure node in
  front of the star at z < 1 + k (the least a windowed schedule solves;
  ``chip_smoke.py``'s ``tab_bound`` solves at every point instead);
* the per-node deficit at those same pairs;
* the tabulated coefficient stage per draw, at its k-segment's degree.

The pairs in transit are counted on a fixed-seed sample of draws per
target (``SAMPLE_ELEMS`` (draw, exposure, node) triples, at least
``SAMPLE_MIN`` draws) (this folder's ``reference.projected_z`` at
the Gauss-Legendre exposure nodes, in float32) and scaled to all draws.
Bytes: time and the observed curve, the mask of every draw and the nine
inputs of each draw that counts read once, the coefficient table once,
one lnL per draw written. The EB veto is not
counted. The bound is the larger of bytes / 3.35 TB/s and operations /
67 TFLOP/s (NVIDIA's H100 SXM data sheet, FP32 outside the tensor cores,
at the 700 W limit).
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import projected_z

PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
# one operation per + - * / and per IEEE function call (a floor)
FLOPS_NODE_POINT = 73
FLOPS_POINT = 6
FLOPS_KEPLER = 91
FLOPS_ORBIT_POINT = {True: FLOPS_KEPLER + 24, False: FLOPS_KEPLER + 73}
FLOPS_ORBIT_DRAW = 38
FLOPS_TAB_TERM = 2 * 162 + 2
FLOPS_TAB_DRAW = 54 * 5 + 10 + 6 + 14
FLOPS_WINDOW_DRAW = 40 + 10 + 6 + 7 * 7 + 6 + 4 * 10 + 12
# the tabulated coefficients: k-segment breaks, degree per segment, and
# the table's size (rows x 162 float32 values)
TAB_BREAKS = np.array([1e-3, 0.05, 0.35, 0.857142857142857,
                       0.9966666666666667, 1.0, 1.0033333333333334,
                       1.1666666666666667, 2.0])
TAB_DEGS = np.array([20, 20, 20, 24, 12, 12, 24, 20])
TAB_VALUES = 152 * 162
# the exposure rule of the configuration: Gauss-Legendre with min(ns, 4)
# nodes over each exposure
GL_MAX = 4
SAMPLE_ELEMS = 1 << 27
SAMPLE_MIN = 4096


def exposure_nodes(exptime, ns):
    if ns <= 1:
        return np.zeros(1)
    x, _ = np.polynomial.legendre.leggauss(min(ns, GL_MAX))
    return exptime / 2.0 * x


def tab_flops(k):
    kc = np.clip(k, TAB_BREAKS[0], TAB_BREAKS[-1])
    seg = np.clip(np.searchsorted(TAB_BREAKS, kc, side="right") - 1, 0, 7)
    return int(TAB_DEGS[seg].sum()) * FLOPS_TAB_TERM + kc.size * FLOPS_TAB_DRAW


def pairs_in_transit(time, d, offs, gen):
    """(draw, exposure) pairs of one target's draws ``d`` with a node in
    front at z < 1 + k, estimated on a sample of the draws."""
    C = d["k"].shape[0]
    m = max(SAMPLE_MIN, SAMPLE_ELEMS // (time.shape[-1] * len(offs)))
    idx = (torch.randperm(C, generator=gen)[:m]).to(d["k"].device)
    f = {n: d[n][idx].float()[:, None, None] for n in
         ("k", "P", "a_R", "inc", "e", "w")}
    t = (time.float()[:, None] + torch.as_tensor(
        offs, dtype=torch.float32, device=time.device)[None, :])[None]
    hit = torch.zeros((idx.numel(), time.shape[-1]), dtype=torch.bool,
                      device=time.device)
    step = max(1, (1 << 24) // (t.numel()))
    for i in range(0, idx.numel(), step):
        s = slice(i, i + step)
        z, front = projected_z(t, f["P"][s], f["a_R"][s], f["inc"][s],
                               f["e"][s], f["w"][s])
        hit[s] = (front & (z < 1.0 + f["k"][s])).any(-1)
    return float(hit.sum()) * C / idx.numel()


def core_work(time, draws, kw, seed=0):
    """(bytes, operations) of one core call: B targets (time (B, n_t) or
    (n_t,)), each its share of the draws; only the draws its ``mask``
    keeps (all without one) need chi^2 work."""
    gen = torch.Generator().manual_seed(seed)
    times = time if time.dim() == 2 else time[None]
    B, n_t = times.shape
    C = draws["k"].shape[0]
    N = C // B
    ns = kw["ns"]
    offs = exposure_nodes(kw["exptime"], ns)
    keep = (draws["mask"].bool() if "mask" in draws else
            torch.ones(C, dtype=torch.bool, device=draws["k"].device))
    live = int(keep.sum())
    active = 0.0
    for b in range(B):
        kb = keep[b * N:(b + 1) * N]
        if kb.any():
            active += pairs_in_transit(
                times[b], {n: v[b * N:(b + 1) * N][kb]
                           for n, v in draws.items()}, offs, gen)
    flops = (live * (FLOPS_ORBIT_DRAW + FLOPS_WINDOW_DRAW)
             + active * (FLOPS_ORBIT_POINT[ns == 1]
                         + len(offs) * FLOPS_NODE_POINT + FLOPS_POINT)
             + 2 * n_t * B
             + tab_flops(draws["k"][keep].double().cpu().numpy()))
    nbytes = 4 * (2 * B * n_t + 9 * live + 2 * C + TAB_VALUES)
    return nbytes, flops


def bound_s(nbytes, flops):
    return max(nbytes / PEAK_BYTES_S, flops / PEAK_FP32_S)
