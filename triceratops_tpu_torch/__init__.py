"""triceratops_tpu_torch: the PyTorch / CUDA port of the JAX package.

Bayesian vetting of transiting-planet candidates (TRICERATOPS, Giacalone
et al. 2021, AJ 161, 24) on an NVIDIA GPU. This package answers the JAX
package's whole single-target surface: every row of ``calc_probs`` (the
target's 15 planet, eclipsing-binary, bound-companion and TRILEGAL
background scenarios and every nearby star's NTP, NEB and NEBx2P), the
14 ``lnZ_*`` functions, ``calc_probs_ensemble``, the ``likelihoods``
simulators and the plots; the JAX package beside it is the reference it
is tested against. It imports torch, numpy, scipy and pandas, never jax.

Usage::

    import triceratops_tpu_torch.triceratops as tr
    t = tr.target.from_stars(stars_df, trilegal_fname=trilegal_csv)
    t.calc_depths(tdepth)
    t.calc_probs(time, flux, flux_err, P_orb, device="cuda")
    t.FPP, t.NFPP
"""

from .frontend.target import target  # noqa: F401
from .scenarios.api import *  # noqa: F401,F403
from .likelihoods import (  # noqa: F401
    simulate_TP_transit, simulate_EB_transit,
    simulate_TP_transit_p, simulate_EB_transit_p,
    lnL_TP, lnL_EB, lnL_EB_twin, lnL_TP_p, lnL_EB_p, lnL_EB_twin_p,
)

__version__ = "0.1.0"
