"""Per-update learner health for A2C (port of the in-update helpers of
``repro.obs.traindiag``).

Pure functions of tensors the update already computes:

- **explained_var**: 1 - Var[R - V]/Var[R]; 0 means the critic is a
  constant, 1 a perfect fit, negative worse than predicting the mean.
  Variances are population variances (ddof 0), as ``jnp.var``.
- **approx_kl**: mean(logp_old - logp_new) over the update's batch.

``DIAG_KEYS`` names the per-update series a diagnosed training history
carries.
"""
from __future__ import annotations

import torch

DIAG_KEYS = ("entropy", "approx_kl", "grad_norm", "explained_var",
             "adv_mean", "adv_std")


def explained_variance(returns: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """1 - Var[R - V] / Var[R]; 0 when the return batch is constant."""
    var_r = torch.var(returns, correction=0)
    ev = 1.0 - torch.var(returns - values, correction=0) / (var_r + 1e-12)
    return torch.where(var_r > 0.0, ev, torch.zeros_like(ev))


def approx_kl(logp_old: torch.Tensor, logp_new: torch.Tensor) -> torch.Tensor:
    """mean(logp_old - logp_new): the first-order KL(old || new) estimate."""
    return torch.mean(logp_old - logp_new)
