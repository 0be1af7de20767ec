"""User entry point: ``import triceratops_tpu_torch.triceratops as tr``.
Re-exports the ``target`` class and the scenario functions, as the JAX
package's ``triceratops`` module does."""

from .frontend.target import target  # noqa: F401
from .scenarios.api import (  # noqa: F401
    lnZ_TTP, lnZ_TEB, lnZ_PTP, lnZ_PEB, lnZ_STP, lnZ_SEB, lnZ_DTP, lnZ_DEB,
    lnZ_BTP, lnZ_BEB,
)
from .core.numerics import (  # noqa: F401
    log_mean_exp as _log_mean_exp,
    normalize_probabilities as _normalize_probabilities,
)
