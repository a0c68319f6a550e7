"""repro_torch.online: nonstationary worlds + closed-loop controller
adaptation under drift (port of ``repro.online``).

- ``drift``   — regime-switching world model: timed ``EnvPatch``es over
  EnvConfig (bandwidth brownout, battery cliff, server slowdown,
  flash-crowd rate shifts, device churn) compiled into per-regime
  records; named schedule factories behind ``get_schedule``.
- ``adapt``   — windowed replay of measured transitions captured inside
  the fleet loop, an incremental update step (A2C and PPO on the shared
  ``core.actor_critic`` machinery, autograd + AdamW on the policy's
  device), and policy hot-swap through ``TrainablePolicy.set_params``.
- ``monitor`` — EWMA + Page-Hinkley drift detection gating adaptation
  bursts, and per-regime adaptation metrics: regret vs the greedy
  oracle re-solved per regime, and recovery time to within 10% of it.
"""
from repro_torch.online.adapt import OnlineConfig, OnlineLearner, ReplayWindow
from repro_torch.online.drift import (EnvPatch, Regime, WorldSchedule,
                                      apply_env_patch, get_schedule,
                                      scale_counts, schedule_names)
from repro_torch.online.monitor import (AdaptationTracker, DriftMonitor,
                                        PageHinkley, oracle_reward)

__all__ = [
    "EnvPatch", "Regime", "WorldSchedule", "apply_env_patch",
    "get_schedule", "schedule_names", "scale_counts",
    "OnlineConfig", "OnlineLearner", "ReplayWindow",
    "AdaptationTracker", "DriftMonitor", "PageHinkley", "oracle_reward",
]
