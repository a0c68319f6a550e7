"""Drift detection + adaptation metrics for the closed-loop fleet (port
of ``repro.online.monitor``, numpy).

``DriftMonitor`` watches the per-epoch reward stream (EWMA residual +
a Page-Hinkley decrease test) and raises a trigger when the world's
physics have drifted away from what the controller was tuned for: the
gate that starts an adaptation burst in ``repro_torch.online.adapt``.

``AdaptationTracker`` scores the whole run against the per-regime
greedy oracle: each epoch it re-solves the (V, K) grid under the
*current* regime's EnvConfig with the numpy pricing core (the
``pricing.price_actions`` that ``baselines.greedy_oracle`` scores with
in torch), accumulates per-regime regret, and reports the recovery
time: epochs from each regime boundary until the policy's smoothed
reward is back within 10% of the per-regime oracle's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch import obs
from repro_torch.core import pricing


class PageHinkley:
    """Page-Hinkley test for a downward shift in a signal's mean.

    Maintains m_t = sum(x_i - mean_i + delta); a drop makes m_t fall
    away from its running max M_t, and M_t - m_t > lambda_ triggers.
    ``delta`` absorbs magnitude-delta noise; ``lambda_`` sets the
    detection threshold. Reset after each trigger.
    """

    def __init__(self, delta: float = 0.005, lambda_: float = 0.05,
                 min_samples: int = 8):
        self.delta = float(delta)
        self.lambda_ = float(lambda_)
        self.min_samples = int(min_samples)
        self.reset()

    def reset(self):
        self._n = 0
        self._mean = 0.0
        self._m = 0.0
        self._max = 0.0

    def update(self, x: float) -> bool:
        self._n += 1
        self._mean += (x - self._mean) / self._n
        self._m += x - self._mean + self.delta
        self._max = max(self._max, self._m)
        if self._n >= self.min_samples and \
                (self._max - self._m) > self.lambda_:
            self.reset()
            return True
        return False


class DriftMonitor:
    """EWMA reward residual + Page-Hinkley trigger.

    ``update(reward)`` returns True on the epoch a drift is declared.
    The EWMA tracks the recent operating level; Page-Hinkley runs on the
    raw rewards, so a sharp regime shift triggers within a few epochs
    while slow seasonal wander (diurnal) stays below ``ph_lambda``.
    """

    def __init__(self, ewma: float = 0.2, ph_delta: float = 0.005,
                 ph_lambda: float = 0.05):
        self.alpha = float(ewma)
        self.level: Optional[float] = None
        self.residual: float = 0.0
        self._ph = PageHinkley(delta=ph_delta, lambda_=ph_lambda)
        self.triggers = 0

    def update(self, reward: float) -> bool:
        r = float(reward)
        if self.level is None:
            self.level = r
        self.residual = r - self.level
        self.level += self.alpha * (r - self.level)
        fired = self._ph.update(r)
        if fired:
            self.triggers += 1
            obs.event("drift.trigger", level=self.level,
                      residual=self.residual, n=self.triggers)
        return fired


def oracle_reward(env_cfg, np_tables, view: pricing.StateView,
                  alive: np.ndarray) -> float:
    """Per-epoch greedy-oracle reward re-solved under ``env_cfg``: score
    every (version, cut) pair for every device through the numpy pricing
    core and average each alive device's best weighted score — exactly
    ``baselines.greedy_oracle``'s objective (Eq. 8 argmax), under
    whatever regime config the schedule has installed. Cluster-mode
    envs widen the grid to every (version, cut, server) triple."""
    V, K = np_tables.n_versions, np_tables.n_cuts
    if env_cfg.cluster is None:
        jj, kk = np.meshgrid(np.arange(V), np.arange(K), indexing="ij")
        pairs = np.stack([jj.ravel(), kk.ravel()], -1).astype(np.int32)
    else:
        S = env_cfg.cluster.n_servers
        jj, kk, ss = np.meshgrid(np.arange(V), np.arange(K),
                                 np.arange(S), indexing="ij")
        pairs = np.stack([jj.ravel(), kk.ravel(), ss.ravel()],
                         -1).astype(np.int32)
    n = np.asarray(view.model_id).shape[0]
    actions = np.broadcast_to(pairs[:, None, :],
                              (pairs.shape[0], n, pairs.shape[1]))
    br = pricing.price_actions(env_cfg, np_tables, view, actions, xp=np)
    w = env_cfg.weights
    s = (w.w_acc * br.acc_score + w.w_lat * br.lat_score
         + w.w_energy * br.energy_score + w.w_stab * br.stab_score)
    valid = np_tables.version_valid[np.asarray(view.model_id)[None, :],
                                    pairs[:, 0][:, None]] > 0   # (VK, n)
    s = np.where(valid, s, -np.inf)
    best = s.max(axis=0)                                     # (n,)
    mask = np.asarray(alive, dtype=np.float64)
    denom = max(float(mask.sum()), 1.0)
    return float(np.sum(best * mask) / denom)


@dataclasses.dataclass
class _RegimeStats:
    index: int
    name: str
    start_epoch: int
    rewards: List[float] = dataclasses.field(default_factory=list)
    oracle: List[float] = dataclasses.field(default_factory=list)
    degraded: bool = False
    recovery_epochs: Optional[int] = None


class AdaptationTracker:
    """Per-regime regret + recovery-time accumulator.

    ``record(epoch, regime, reward, oracle_r)`` per epoch; recovery is
    the first epoch offset within a regime at which the EWMA-smoothed
    policy reward is back within ``recover_frac`` (default 10%) of the
    EWMA-smoothed per-regime oracle reward, *after* the regime has
    pushed it outside that band at least once (a regime that never
    degrades the policy reports recovery 0). Both EWMAs restart at each
    boundary, so early-regime transients count against recovery.
    """

    def __init__(self, ewma: float = 0.2, recover_frac: float = 0.1):
        self.alpha = float(ewma)
        self.recover_frac = float(recover_frac)
        self._regimes: List[_RegimeStats] = []
        self._cur: Optional[_RegimeStats] = None
        self._r_ewma = self._o_ewma = None

    def record(self, epoch: int, regime: int, regime_name: str,
               reward: float, oracle_r: float):
        if self._cur is None or self._cur.index != regime:
            self._cur = _RegimeStats(index=regime, name=regime_name,
                                     start_epoch=epoch)
            self._regimes.append(self._cur)
            self._r_ewma = self._o_ewma = None
            obs.event("drift.regime_enter", epoch=epoch, regime=regime,
                      name=regime_name)
        st = self._cur
        st.rewards.append(float(reward))
        st.oracle.append(float(oracle_r))
        if self._r_ewma is None:
            self._r_ewma, self._o_ewma = float(reward), float(oracle_r)
        else:
            self._r_ewma += self.alpha * (float(reward) - self._r_ewma)
            self._o_ewma += self.alpha * (float(oracle_r) - self._o_ewma)
        if st.recovery_epochs is None:
            gap = self._o_ewma - self._r_ewma
            tol = self.recover_frac * max(abs(self._o_ewma), 1e-9)
            if gap > tol:
                st.degraded = True
            elif st.degraded:
                st.recovery_epochs = epoch - st.start_epoch

    def summary(self, include_series: bool = False) -> Dict:
        regimes = []
        for st in self._regimes:
            r, o = np.asarray(st.rewards), np.asarray(st.oracle)
            entry = {
                "regime": st.index, "name": st.name,
                "start_epoch": st.start_epoch, "epochs": int(r.size),
                "mean_reward": float(r.mean()) if r.size else 0.0,
                "oracle_reward": float(o.mean()) if o.size else 0.0,
                "regret": float((o - r).mean()) if r.size else 0.0,
                # 0 = the regime never degraded the policy past the
                # tolerance band; None = degraded and never recovered
                "recovery_epochs": st.recovery_epochs
                if (st.recovery_epochs is not None or st.degraded)
                else 0,
            }
            if include_series:
                entry["rewards"] = [float(x) for x in st.rewards]
                entry["oracle"] = [float(x) for x in st.oracle]
            regimes.append(entry)
        all_r = np.concatenate([np.asarray(s.rewards)
                                for s in self._regimes]) \
            if self._regimes else np.zeros(0)
        all_o = np.concatenate([np.asarray(s.oracle)
                                for s in self._regimes]) \
            if self._regimes else np.zeros(0)
        return {
            "regimes": regimes,
            "mean_reward": float(all_r.mean()) if all_r.size else 0.0,
            "oracle_reward": float(all_o.mean()) if all_o.size else 0.0,
            "regret": float((all_o - all_r).mean()) if all_r.size else 0.0,
        }
