"""AutoScale-style server-side autoscaling over measured queue depth
(port of ``repro.cluster.autoscale``; numpy only, copied).

The fleet's servers trade *replica energy* against *queue wait*: every
active replica draws ``p_replica_w * dvfs^3`` watts continuously
(metered into ``ServerPool.energy_j`` and the run summary), while more
replicas / higher DVFS drain both the background queue and the
fleet-induced tail backlog faster. The ``Autoscaler`` closes that loop
per decision epoch from the same measured per-server queue depth the
controller observes:

- ``policy="threshold"``: react every epoch: scale a server up when
  its queue exceeds ``up_queue`` jobs, down when below ``down_queue``.
- ``policy="hysteresis"``: AutoScale's conservative variant, acting only
  after ``patience`` *consecutive* breaches and hold a ``cooldown`` of
  epochs after every action, so transient bursts don't thrash replicas.

Scaling up prefers capacity in-place first (step the DVFS ladder to the
top) then adds a replica; scaling down retires replicas before slowing
the survivors, mirroring AutoScale's "run wide and slow" energy
ordering in reverse. The autoscaler consumes no randomness, so runs
stay bit-reproducible and paired seeds stay paired.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


@dataclasses.dataclass(frozen=True)
class AutoscalerConfig:
    policy: str = "hysteresis"     # "threshold" | "hysteresis"
    up_queue: float = 8.0          # jobs; scale up above this
    down_queue: float = 2.0        # jobs; scale down below this
    patience: int = 3              # consecutive breaches (hysteresis)
    cooldown: int = 8              # epochs held after an action

    def __post_init__(self):
        if self.policy not in ("threshold", "hysteresis"):
            raise ValueError(
                f"unknown autoscaler policy {self.policy!r}; valid "
                "policies: threshold, hysteresis")
        if self.down_queue >= self.up_queue:
            raise ValueError(
                f"down_queue ({self.down_queue}) must be below up_queue "
                f"({self.up_queue}) or the autoscaler oscillates")


class Autoscaler:
    """Per-server threshold/hysteresis state for one ServerPool."""

    def __init__(self, cfg: AutoscalerConfig, n_servers: int):
        self.cfg = cfg
        self._up_streak = np.zeros(n_servers, dtype=np.int64)
        self._down_streak = np.zeros(n_servers, dtype=np.int64)
        self._hold = np.zeros(n_servers, dtype=np.int64)

    def step(self, pool, queue_jobs: np.ndarray) -> List[Dict]:
        """Advance one epoch on measured queue depth; mutates the pool's
        ``replicas``/``dvfs_idx`` in place and returns one decision dict
        per server that moved: the action taken plus the measured depth
        that triggered it (the fleet's ``autoscale.decision`` events)."""
        cfg = self.cfg
        c = pool.cluster
        decisions: List[Dict] = []
        over = queue_jobs > cfg.up_queue
        under = queue_jobs < cfg.down_queue
        self._up_streak = np.where(over, self._up_streak + 1, 0)
        self._down_streak = np.where(under, self._down_streak + 1, 0)
        for s in range(c.n_servers):
            if self._hold[s] > 0:
                self._hold[s] -= 1
                continue
            if cfg.policy == "threshold":
                go_up, go_down = over[s], under[s]
            else:
                go_up = self._up_streak[s] >= cfg.patience
                go_down = self._down_streak[s] >= cfg.patience
            if go_up:
                if pool.dvfs_idx[s] < len(c.dvfs[s]) - 1:
                    pool.dvfs_idx[s] += 1
                    action = "dvfs_up"
                elif pool.replicas[s] < c.max_replicas[s]:
                    pool.replicas[s] += 1
                    action = "replica_up"
                else:
                    continue          # already at full capacity
            elif go_down:
                if pool.replicas[s] > 1:
                    pool.replicas[s] -= 1
                    action = "replica_down"
                elif pool.dvfs_idx[s] > 0:
                    pool.dvfs_idx[s] -= 1
                    action = "dvfs_down"
                else:
                    continue          # already at the floor
            else:
                continue
            decisions.append({"server": s, "action": action,
                              "queue": float(queue_jobs[s])})
            self._hold[s] = cfg.cooldown if cfg.policy == "hysteresis" \
                else 0
            self._up_streak[s] = self._down_streak[s] = 0
        return decisions
