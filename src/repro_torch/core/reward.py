"""Reward function (paper Eqs. 8-11) + stability score; port of
``repro.core.reward``.

R = mean_k( w1*A + w2*L + w3*E ), sum(w) = 1.
A: sigmoid-normalized accuracy; L/E: 1 - cost / all-local cost.
``stability_score`` saturates to 1 when the device+link can absorb the
offered load and to 0 when it cannot; ``w_stab = 0`` (the default) keeps
the paper's exact reward.

The per-request score formulas live in ``repro_torch.core.pricing`` and
are re-exported here; this module keeps the weights and the Eq. 8
aggregation.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.pricing import (accuracy_score, energy_score,
                                      latency_score, stability_score)

__all__ = ["RewardWeights", "accuracy_score", "latency_score",
           "energy_score", "stability_score", "reward"]


@dataclasses.dataclass(frozen=True)
class RewardWeights:
    w_acc: float = 1 / 3
    w_lat: float = 1 / 3
    w_energy: float = 1 / 3
    w_stab: float = 0.0     # SLO/stability-aware shaping
    # Eq. 9 sigmoid shape
    p: float = 20.0
    q: float = 0.72
    # stability sigmoid sharpness (score = sigmoid(p_stab * (1 - u)))
    p_stab: float = 8.0

    def normalized(self) -> "RewardWeights":
        s = self.w_acc + self.w_lat + self.w_energy + self.w_stab
        return dataclasses.replace(self, w_acc=self.w_acc / s,
                                   w_lat=self.w_lat / s,
                                   w_energy=self.w_energy / s,
                                   w_stab=self.w_stab / s)


def reward(w: RewardWeights, acc_s, lat_s, energy_s, stab_s=None,
           mask=None):
    """Eq. 8: per-UAV weighted sum averaged over the (active) UAVs, the last
    axis (leading axes are a batch of envs); the stability term only
    contributes when w_stab > 0."""
    r = w.w_acc * acc_s + w.w_lat * lat_s + w.w_energy * energy_s
    if stab_s is not None:
        r = r + w.w_stab * stab_s
    if mask is not None:
        denom = torch.clamp(torch.sum(mask, -1), min=1.0)
        return torch.sum(r * mask, -1) / denom
    return torch.mean(r, -1)
