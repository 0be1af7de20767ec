"""triceratops_tpu_torch: the PyTorch / CUDA port of the JAX package.

Bayesian vetting of transiting-planet candidates (TRICERATOPS, Giacalone
et al. 2021, AJ 161, 24) on an NVIDIA GPU. This package ports the
target's TP, EB and EBx2P rows and every nearby star's NTP, NEB and
NEBx2P rows; the JAX package beside it is the reference it is
tested against. It imports torch, numpy and scipy, never jax.

Usage::

    import triceratops_tpu_torch.triceratops as tr
    t = tr.target.from_stars(stars_df)
    t.calc_depths(tdepth)
    t.calc_probs(time, flux, flux_err, P_orb, drop_scenario=[...],
                 device="cuda")
    t.FPP, t.NFPP
"""

from .frontend.target import target  # noqa: F401
from .scenarios.api import lnZ_TTP, lnZ_TEB  # noqa: F401

__version__ = "0.1.0"
