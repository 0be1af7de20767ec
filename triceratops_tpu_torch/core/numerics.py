"""Numerically stable reductions used by the scenario-evidence engine.

Same semantics as the JAX package's ``core/numerics.py`` (reference
``triceratops/_numerics.py:12-76``):

* ``log_mean_exp(logw, N_total)``: log(mean(exp(logw))) where -inf/NaN
  entries contribute zero weight but still count in the denominator and
  +inf propagates.
* ``normalize_probabilities(lnZ)``: softmax over finite evidences with
  degenerate-status reporting ('ok' | 'all_neginf' | 'anomaly').

The host versions use numpy; ``log_mean_exp_torch`` runs on the device so
the N-draw weight vector never leaves it.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from scipy.special import logsumexp as _logsumexp


def log_mean_exp(logw: np.ndarray, *, N_total: int) -> float:
    """Numerically stable log(mean(exp(logw))) (host path). Raises
    ValueError when N_total does not equal len(logw)."""
    logw = np.asarray(logw)
    if N_total != logw.size:
        raise ValueError(
            f"N_total ({N_total}) must equal len(logw) ({logw.size}). "
            "Passing len(lnL[finite]) instead of len(lnL) would silently "
            "overestimate evidence for scenarios with geometric exclusions."
        )
    if np.any(np.isposinf(logw)):
        return np.inf
    finite = np.isfinite(logw)
    if not np.any(finite):
        return -np.inf
    return float(_logsumexp(logw[finite]) - np.log(N_total))


def normalize_probabilities(lnZ: np.ndarray):
    """Normalize scenario log-evidences to a probability vector (host).
    Returns (probs, status)."""
    lnZ = np.asarray(lnZ)
    if np.any(np.isnan(lnZ)) or np.any(np.isposinf(lnZ)):
        return np.zeros(len(lnZ)), "anomaly"
    if np.all(np.isneginf(lnZ)):
        return np.zeros(len(lnZ)), "all_neginf"
    return np.exp(lnZ - _logsumexp(lnZ)), "ok"


def log_mean_exp_torch(logw: torch.Tensor, N_total: int) -> torch.Tensor:
    """On-device log(mean(exp(logw))) with the reference -inf/NaN/+inf
    rules, as a 0-d tensor (no host sync). NaNs and -inf get zero weight,
    N_total stays in the denominator, and a +inf anywhere gives +inf."""
    finite = torch.isfinite(logw)
    any_posinf = torch.any(torch.isposinf(logw))
    any_finite = torch.any(finite)
    neg_inf = torch.full_like(logw, -math.inf)
    safe = torch.where(finite, logw, neg_inf)
    m = torch.max(safe)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    sumexp = torch.sum(torch.where(finite, torch.exp(safe - m_safe),
                                   torch.zeros_like(logw)))
    out = m_safe + torch.log(sumexp) - math.log(N_total)
    out = torch.where(any_finite, out, torch.full_like(out, -math.inf))
    return torch.where(any_posinf, torch.full_like(out, math.inf), out)
