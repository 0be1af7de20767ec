"""User entry point: ``import triceratops_tpu_torch.triceratops as tr``.
Re-exports the ``target`` class, the 14 scenario functions and the
``likelihoods`` functions, as the JAX package's ``triceratops`` module
does."""

from .frontend.target import target  # noqa: F401
from .scenarios.api import *  # noqa: F401,F403
from .likelihoods import (  # noqa: F401
    simulate_TP_transit, simulate_EB_transit,
    simulate_TP_transit_p, simulate_EB_transit_p,
    lnL_TP, lnL_EB, lnL_EB_twin, lnL_TP_p, lnL_EB_p, lnL_EB_twin_p,
)
from .core.numerics import (  # noqa: F401
    log_mean_exp as _log_mean_exp,
    normalize_probabilities as _normalize_probabilities,
)
