"""Field and best-fit plots with matplotlib, on the host (reference
triceratops.py:358-557 plot_field, :1487-1638 plot_fits).

Counterpart of the JAX package's ``frontend/plotting.py``; the best-fit
models come from the port's ``likelihoods.simulate_*`` on ``device``.
Only ``target.plot_field`` / ``target.plot_fits`` import this module.
"""

from __future__ import annotations

from math import floor, ceil

import numpy as np
import matplotlib.pyplot as plt
from matplotlib import cm, ticker

from ..constants import G, MSUN, PI
from ..funcs import renorm_flux
from ..likelihoods import simulate_TP_transit, simulate_EB_transit


def _draw_aperture(ax, ap_pixels, ap_color, zorder):
    for i in range(len(ap_pixels)):
        x, y = ap_pixels[i][0], ap_pixels[i][1]
        for seg in ([[x - .5, x + .5], [y - .5, y - .5]],
                    [[x - .5, x + .5], [y + .5, y + .5]],
                    [[x - .5, x - .5], [y - .5, y + .5]],
                    [[x + .5, x + .5], [y - .5, y + .5]]):
            ax.plot(seg[0], seg[1], color=ap_color, zorder=zorder)


def _pixel_grid(ax, col0, row0, corners):
    """Light pixel-boundary grid behind the star markers."""
    for i in corners:
        ax.plot(np.full_like(corners, col0 + i), row0 + corners,
                "k-", lw=0.5, zorder=0)
        ax.plot(col0 + corners, np.full_like(corners, row0 + i),
                "k-", lw=0.5, zorder=0)


def _search_circle(ax, center, radius):
    th = np.linspace(0, 2 * PI, 100)
    ax.plot(center[0] + radius * np.cos(th), center[1] + radius * np.sin(th),
            "k--", alpha=0.5, zorder=0)


def _compass(ax, t, idx):
    """N/E direction arrows rotated by the field's on-sky orientation.

    The rotation is derived from the first nearby star: the angle of its
    pixel-offset vector from the +row axis minus its catalog position
    angle E of N (reference triceratops.py:433-459). Returns the artist
    (None when the field has a single star and no orientation is
    defined)."""
    from mpl_toolkits.axes_grid1.anchored_artists import (
        AnchoredDirectionArrows)

    pc = np.asarray(t.pix_coords[idx])
    if len(pc) < 2:
        return None
    v2 = pc[1] - pc[0]
    norm = np.hypot(v2[0], v2[1])
    if norm == 0:
        return None
    angle_pix = np.sign(v2[0]) * np.degrees(np.arccos(v2[1] / norm))
    rot = angle_pix - t.stars["PA (E of N)"].values[1]
    arrows = AnchoredDirectionArrows(
        ax.transAxes, "E", "N", loc="upper left", color="k", angle=-rot,
        length=0.1, fontsize=0.05, back_length=0, head_length=5,
        head_width=5, tail_width=1)
    arrows.compass_rotation_deg = -rot  # introspectable (tests)
    ax.add_artist(arrows)
    return arrows


def _star_markers(fig, ax, t, idx):
    tmags = t.stars["Tmag"].values
    vmin, vmax = floor(np.nanmin(tmags)), ceil(np.nanmax(tmags))
    style = dict(edgecolors="k", cmap=cm.viridis_r, vmin=vmin, vmax=vmax,
                 zorder=2)
    sc = ax.scatter(t.pix_coords[idx][1:, 0], t.pix_coords[idx][1:, 1],
                    c=tmags[1:], s=75, rasterized=True, **style)
    ax.scatter([t.pix_coords[idx][0, 0]], [t.pix_coords[idx][0, 1]],
               c=[tmags[0]], s=250, marker="*", **style)
    cb = fig.colorbar(sc, ax=ax, pad=0.02)
    cb.ax.set_ylabel("TESS mag", rotation=270, fontsize=12, labelpad=18)


def _mean_image(fig, ax, t, idx, corners):
    im = ax.imshow(t.TESS_images[idx],
                   extent=[min(t.col0s[idx] + corners),
                           max(t.col0s[idx] + corners),
                           max(t.row0s[idx] + corners),
                           min(t.row0s[idx] + corners)])
    cb = fig.colorbar(im, ax=ax, pad=0.02)
    cb.ax.set_ylabel("flux [e$^-$ s$^{-1}$]", rotation=270, fontsize=12,
                     labelpad=18)


def plot_field(t, sector=None, ap_pixels=None, ap_color="red", save=False,
               fname=None):
    """Star field + mean image plot (reference triceratops.py:358-557),
    including the WCS-oriented N/E compass (:433-459)."""
    if len(t.sectors) > 1:
        idx = int(np.argwhere(np.asarray(t.sectors) == sector)[0, 0])
    else:
        idx = 0
    corners = np.arange(-0.5, t.N_pix + 0.5, 1)
    centers = np.arange(0, t.N_pix, 1)
    fig, ax = plt.subplots(1, 2, figsize=(13, 5.5))
    plt.subplots_adjust(right=0.9)
    if ap_pixels is not None:
        _draw_aperture(ax[0], ap_pixels, ap_color, 1)
    _pixel_grid(ax[0], t.col0s[idx], t.row0s[idx], corners)
    _search_circle(ax[0], t.pix_coords[idx][0], t.search_radius)
    _compass(ax[0], t, idx)
    _star_markers(fig, ax[0], t, idx)
    for a in ax:
        a.set_ylim([min(t.row0s[idx] + corners), max(t.row0s[idx] + corners)])
        a.set_xlim([min(t.col0s[idx] + corners), max(t.col0s[idx] + corners)])
        a.set_yticks(t.row0s[idx] + centers)
        a.set_xticks(t.col0s[idx] + centers)
        a.tick_params(width=0)
        a.tick_params(axis="x", labelrotation=90)
        a.set_ylabel("pixel row number", fontsize=12)
        a.set_xlabel("pixel column number", fontsize=12)
    _mean_image(fig, ax[1], t, idx, corners)
    if ap_pixels is not None:
        _draw_aperture(ax[1], ap_pixels, ap_color, 2)
    plt.tight_layout()
    if save is False:
        plt.show()
    elif fname is None:
        plt.savefig(f"TIC{t.stars.ID.values[0]}_sector{sector}.pdf")
    else:
        plt.savefig(fname + ".pdf")
    return fig


def plot_fits(t, time, flux_0, flux_err_0, save=False, fname=None,
              device="cuda"):
    """Best-fit light curve per scenario in a len/3 x 3 grid
    (reference triceratops.py:1487-1638); the models run on ``device``."""
    df = t.probs[t.probs["ID"] != 0]
    star_num = t.star_num[t.probs["ID"] != 0]
    u1s = t.u1[t.probs["ID"] != 0]
    u2s = t.u2[t.probs["ID"] != 0]
    fluxratios_EB = t.fluxratio_EB[t.probs["ID"] != 0]
    fluxratios_comp = t.fluxratio_comp[t.probs["ID"] != 0]

    model_time = np.linspace(min(time), max(time), 100)
    f, ax = plt.subplots(len(df) // 3, 3,
                         figsize=(12, len(df) // 3 * 4), sharex=True)
    ax = np.atleast_2d(ax)
    for i in range(len(df) // 3):
        for j in range(3):
            k = j if i == 0 else 3 * i + j
            idx = np.argwhere(
                t.stars["ID"].astype(str).values
                == str(df["ID"].values[k]))[0, 0]
            flux, flux_err = renorm_flux(
                flux_0, flux_err_0, t.stars["fluxratio"].values[idx])
            comp = star_num[k] != 1
            skipped = df["M_s"].values[k] == 0.0
            if j == 0:
                a = ((G * df["M_s"].values[k] * MSUN) / (4 * PI**2)
                     * (df["P_orb"].values[k] * 86400) ** 2) ** (1 / 3)
                best_model = (np.ones(len(model_time)) if skipped else
                              simulate_TP_transit(
                                  model_time, df["R_p"].values[k],
                                  df["P_orb"].values[k], df["inc"].values[k],
                                  a, df["R_s"].values[k], u1s[k], u2s[k],
                                  df["ecc"].values[k], df["w"].values[k],
                                  fluxratios_comp[k], comp, device=device))
            else:
                mass = df["M_s"].values[k] + df["M_EB"].values[k]
                a = ((G * mass * MSUN) / (4 * PI**2)
                     * (df["P_orb"].values[k] * 86400) ** 2) ** (1 / 3)
                best_model = (np.ones(len(model_time)) if skipped else
                              simulate_EB_transit(
                                  model_time, df["R_EB"].values[k],
                                  fluxratios_EB[k], df["P_orb"].values[k],
                                  df["inc"].values[k], a,
                                  df["R_s"].values[k], u1s[k], u2s[k],
                                  df["ecc"].values[k], df["w"].values[k],
                                  fluxratios_comp[k], comp,
                                  device=device)[0])
            y_formatter = ticker.ScalarFormatter(useOffset=False)
            ax[i, j].yaxis.set_major_formatter(y_formatter)
            ax[i, j].errorbar(time, flux, flux_err, fmt=".", color="blue",
                              alpha=0.25, zorder=0, rasterized=True)
            ax[i, j].plot(model_time, best_model, "k-", lw=3, zorder=2)
            ax[i, j].set_ylabel("normalized flux", fontsize=12)
            ax[i, j].annotate(str(df["ID"].values[k]), xy=(0.05, 0.92),
                              xycoords="axes fraction", fontsize=12)
            ax[i, j].annotate(str(df["scenario"].values[k]), xy=(0.05, 0.05),
                              xycoords="axes fraction", fontsize=12)
    for j in range(3):
        ax[len(df) // 3 - 1, j].set_xlabel("days from transit center",
                                           fontsize=12)
    plt.tight_layout()
    if save is False:
        plt.show()
    elif fname is None:
        plt.savefig(f"TIC{t.stars.ID.values[0]}_fits.pdf")
    else:
        plt.savefig(fname + ".pdf")
    return f
