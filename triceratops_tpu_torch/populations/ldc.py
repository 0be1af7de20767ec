"""Limb-darkening coefficient lookups.

Counterpart of the JAX package's ``populations/ldc.py``. The quadratic LDC
grids (Claret 2017 TESS / Claret & Bloemen 2011 Kepler) are read from the
JAX package's ``data/ldc_grids.npz`` by path (``tables.ldc_grids``). Three
lookups reproduce the reference's per-scenario semantics:

* ``lookup_target`` (host): independent nearest Z, Teff and logg, then the
  unique row (reference marginal_likelihoods.py:90-98);
* ``grid_at_Z`` (host) + ``round_index_comp`` (device): the dense
  (logg x Teff) table at the nearest-Z slice, indexed per draw by clamped
  rounding for the STP/SEB companions (reference ml.py:938-972,
  :1176-1187);
* ``lookup_stars`` (host): the per-star two-stage lookup for TRILEGAL
  populations in BTP/BEB (reference ml.py:1912-1924), in one vectorized
  pass.
"""

from __future__ import annotations

import numpy as np
import torch

from ..tables import ldc_grids

LOGG_GRID = np.array([3.5, 4.0, 4.5, 5.0])
TEFF_MIN, TEFF_STEP = 3500, 250


def lookup_target(Z: float, Teff: float, logg: float, mission: str = "TESS"):
    """Target-star (u1, u2): independent nearest Z, Teff and logg, then the
    unique row matching all three (reference
    marginal_likelihoods.py:90-98)."""
    g = ldc_grids(mission)
    this_Z = g["Z"][np.argmin(np.abs(g["Z"] - Z))]
    this_Teff = g["Teff"][np.argmin(np.abs(g["Teff"] - Teff))]
    this_logg = g["logg"][np.argmin(np.abs(g["logg"] - logg))]
    mask = (g["Z"] == this_Z) & (g["Teff"] == this_Teff) & (g["logg"] == this_logg)
    idx = np.flatnonzero(mask)
    if idx.size != 1:
        raise ValueError(
            f"LDC lookup for Z={Z}, Teff={Teff}, logg={logg} matched "
            f"{idx.size} rows (expected 1)."
        )
    return float(g["u1"][idx[0]]), float(g["u2"][idx[0]])


def grid_at_Z(Z: float, mission: str = "TESS", teff_max: int = 10000):
    """Dense (u1, u2) tables of shape (4, n_teff) over logg in
    {3.5 .. 5.0 step 0.5} x Teff in {3500 .. teff_max step 250} at the
    nearest-Z slice; teff_max is clamped to the table's maximum Teff."""
    g = ldc_grids(mission)
    this_Z = g["Z"][np.argmin(np.abs(g["Z"] - Z))]
    sl = g["Z"] == this_Z
    teffs, loggs = g["Teff"][sl], g["logg"][sl]
    u1s, u2s = g["u1"][sl], g["u2"][sl]
    teff_max = int(min(teff_max, teffs.max()))
    teff_vals = np.arange(TEFF_MIN, teff_max + 1, TEFF_STEP)
    u1_tab = np.zeros((len(LOGG_GRID), len(teff_vals)))
    u2_tab = np.zeros_like(u1_tab)
    for i, gg in enumerate(LOGG_GRID):
        for j, tt in enumerate(teff_vals):
            k = np.flatnonzero((teffs == tt) & (loggs == gg))
            if k.size != 1:
                raise ValueError(
                    f"LDC slice Z={this_Z} missing unique (logg={gg}, "
                    f"Teff={tt}) row ({k.size} matches)."
                )
            u1_tab[i, j] = u1s[k[0]]
            u2_tab[i, j] = u2s[k[0]]
    return u1_tab, u2_tab


def round_index_comp(loggs, teffs, n_teff):
    """(i_logg, i_teff) int64 tensors into grid_at_Z tables: logg ->
    round(logg / 0.5) clamped to the 3.5..5.0 rows, Teff ->
    round(Teff / 250) clamped to the table's columns (reference
    ml.py:961-966). ``torch.round`` rounds half to even, as numpy and
    ``jnp.round`` do."""
    i_logg = torch.clamp(torch.round(loggs / 0.5).to(torch.int32) - 7, 0, 3)
    i_teff = torch.clamp(torch.round(teffs / 250.0).to(torch.int32) - 14,
                         0, n_teff - 1)
    return i_logg.long(), i_teff.long()


def lookup_stars(Teffs: np.ndarray, loggs: np.ndarray, Zs: np.ndarray,
                 mission: str = "TESS"):
    """Per-star (u1, u2): nearest Teff and nearest logg over the full
    columns, then the nearest Z within that (Teff, logg) slice."""
    g = ldc_grids(mission)
    teff_col, logg_col, z_col = g["Teff"], g["logg"], g["Z"]
    u1_col, u2_col = g["u1"], g["u2"]
    uT = np.unique(teff_col)
    uG = np.unique(logg_col)
    tsel = uT[np.argmin(np.abs(uT[None, :] - np.asarray(Teffs)[:, None]), axis=1)]
    gsel = uG[np.argmin(np.abs(uG[None, :] - np.asarray(loggs)[:, None]), axis=1)]
    n = len(tsel)
    u1 = np.zeros(n)
    u2 = np.zeros(n)
    # group the stars by (Teff, logg) cell: one slice scan per cell
    cell = tsel * 100 + (gsel * 10).astype(np.int64)
    order = np.argsort(cell, kind="stable")
    cell_sorted = cell[order]
    starts = np.flatnonzero(np.r_[True, cell_sorted[1:] != cell_sorted[:-1]])
    for s, e in zip(starts, np.r_[starts[1:], n]):
        rows = order[s:e]
        tt, gg = tsel[rows[0]], gsel[rows[0]]
        m = (teff_col == tt) & (logg_col == gg)
        zs_slice = z_col[m]
        zi = np.argmin(np.abs(zs_slice[None, :]
                              - np.asarray(Zs)[rows][:, None]), axis=1)
        u1[rows] = u1_col[m][zi]
        u2[rows] = u2_col[m][zi]
    return u1, u2
