"""SRE-style error budgets over the fleet's SLO series (port of
``repro.obs.slo``; numpy only, copied).

The scenario declares an SLO attainment *target* (e.g. 0.95: at most 5%
of offered requests may miss the latency deadline or be dropped). The
complement ``budget = 1 - target`` is the error budget; this module
turns the timeline's per-epoch (arrivals, slo_hits) series into:

- **burn rate**: the windowed miss fraction divided by the budget. A
  burn of 1.0 spends the budget exactly at the sustainable pace; 10x
  exhausts it in a tenth of the time.
- **multi-window alerts**: the Google SRE multi-window multi-burn rule:
  page only when *both* a fast window (is it happening right now?) and
  a slow window (is it material, not a blip?) exceed their thresholds;
  the alert clears when the fast window recovers. Fast-window
  confirmation keeps a long-past incident from paging forever; the
  slow-window condition keeps one bad epoch from paging at all.
- **remaining budget / time-to-exhaustion**: the fraction of the
  run's total allowed misses still unspent, and how many epochs the
  current slow-window miss rate would take to spend the rest.

``compute`` is pure numpy over recorded series (cumulative sums, O(T))
and runs after the simulation: it reads no live state and changes no
results. ``emit_events`` mirrors alerts into the active obs recorder as
``slo.*`` events (null-recorder no-op), which ``obsview`` (``python -m repro_torch.launch.obsview``) folds
into the run timeline.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch import obs


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Error-budget policy: target attainment + alert windows.

    Defaults follow the SRE playbook shape scaled to epoch units: the
    fast window is ~minutes-equivalent (8 epochs), the slow window
    ~an hour-equivalent (32 epochs); page at a 4x slow burn confirmed
    by an 8x fast burn.
    """
    target: float = 0.95          # SLO attainment objective in [0, 1)
    fast_window: int = 8          # epochs; "is it happening right now?"
    slow_window: int = 32         # epochs; "is it material?"
    fast_burn: float = 8.0        # page threshold on the fast window
    slow_burn: float = 4.0        # page threshold on the slow window

    def __post_init__(self):
        if not 0.0 <= self.target < 1.0:
            raise ValueError(f"target must be in [0, 1), got "
                             f"{self.target}")
        if self.fast_window < 1 or self.slow_window < self.fast_window:
            raise ValueError("windows must satisfy 1 <= fast_window <= "
                             f"slow_window, got {self.fast_window}/"
                             f"{self.slow_window}")

    @property
    def budget(self) -> float:
        return 1.0 - self.target


def _windowed_rate(cum: np.ndarray, window: int) -> np.ndarray:
    """Trailing-window sum / epoch count from a cumulative series; the
    first ``window`` epochs use the partial window actually observed."""
    T = cum.shape[0]
    lo = np.maximum(np.arange(T) - window + 1, 0)
    prev = np.where(lo > 0, cum[lo - 1], 0.0)
    return cum - prev, np.arange(T) - lo + 1


def _burn(cum_miss, cum_off, window, budget):
    miss_w, _ = _windowed_rate(cum_miss, window)
    off_w, _ = _windowed_rate(cum_off, window)
    with np.errstate(invalid="ignore", divide="ignore"):
        rate = np.where(off_w > 0, miss_w / np.maximum(off_w, 1e-12), 0.0)
    return rate / budget


@dataclasses.dataclass
class SLOReport:
    """Error-budget outcome for one run's timeline."""
    cfg: SLOConfig
    epochs: int
    offered: int                  # total requests offered
    misses: int                   # SLO misses + drops
    budget_remaining: float       # fraction of allowed misses unspent
    time_to_exhaustion: Optional[float]   # epochs; None = never
    burn_fast: np.ndarray         # per-epoch fast-window burn rate
    burn_slow: np.ndarray         # per-epoch slow-window burn rate
    alerts: List[Dict]            # fired pages: start/end/peak burns
    epoch: np.ndarray             # the epoch axis the burns index

    @property
    def attainment(self) -> float:
        return 1.0 - self.misses / self.offered if self.offered else 1.0

    def summary(self) -> Dict:
        """The scalar slice ComparisonReport folds per policy/seed."""
        return {
            "target": self.cfg.target,
            "attainment": self.attainment,
            "budget_remaining": self.budget_remaining,
            "time_to_exhaustion_epochs": self.time_to_exhaustion,
            "alerts": len(self.alerts),
            "page_epochs": int(sum(
                (a["end"] if a["end"] is not None else self.epochs)
                - a["start"] for a in self.alerts)),
            "max_burn_fast": float(self.burn_fast.max())
            if self.burn_fast.size else 0.0,
            "max_burn_slow": float(self.burn_slow.max())
            if self.burn_slow.size else 0.0,
        }

    def to_json(self) -> Dict:
        return {**self.summary(),
                "fast_window": self.cfg.fast_window,
                "slow_window": self.cfg.slow_window,
                "fast_burn": self.cfg.fast_burn,
                "slow_burn": self.cfg.slow_burn,
                "alerts_detail": list(self.alerts),
                "burn_fast": [round(float(v), 4) for v in self.burn_fast],
                "burn_slow": [round(float(v), 4) for v in self.burn_slow],
                "epoch": [int(e) for e in self.epoch]}


def compute(epoch, arrivals, slo_hits,
            cfg: Optional[SLOConfig] = None) -> SLOReport:
    """Error budgets from per-epoch series: ``arrivals`` are offered
    requests (drops included), ``slo_hits`` the requests that met the
    deadline: misses are their difference, so drops burn budget."""
    cfg = cfg if cfg is not None else SLOConfig()
    epoch = np.asarray(epoch, np.int64)
    off = np.asarray(arrivals, np.float64)
    miss = off - np.asarray(slo_hits, np.float64)
    T = epoch.shape[0]
    cum_off, cum_miss = np.cumsum(off), np.cumsum(miss)
    burn_fast = _burn(cum_miss, cum_off, cfg.fast_window, cfg.budget)
    burn_slow = _burn(cum_miss, cum_off, cfg.slow_window, cfg.budget)

    # multi-window page state machine: fire when both windows breach,
    # clear when the fast window recovers
    alerts: List[Dict] = []
    active: Optional[Dict] = None
    for i in range(T):
        firing = (burn_fast[i] > cfg.fast_burn
                  and burn_slow[i] > cfg.slow_burn)
        if active is None and firing:
            active = {"start": int(epoch[i]), "end": None,
                      "peak_burn_fast": float(burn_fast[i]),
                      "peak_burn_slow": float(burn_slow[i])}
            alerts.append(active)
        elif active is not None:
            if burn_fast[i] <= cfg.fast_burn:
                active["end"] = int(epoch[i])
                active = None
            else:
                active["peak_burn_fast"] = max(active["peak_burn_fast"],
                                               float(burn_fast[i]))
                active["peak_burn_slow"] = max(active["peak_burn_slow"],
                                               float(burn_slow[i]))

    total_off = float(cum_off[-1]) if T else 0.0
    total_miss = float(cum_miss[-1]) if T else 0.0
    allowed = cfg.budget * total_off
    remaining = max(0.0, 1.0 - total_miss / allowed) if allowed > 0 \
        else 1.0
    # exhaustion horizon at the current slow-window miss pace
    tte: Optional[float] = None
    if T and remaining > 0.0:
        miss_w, n_w = _windowed_rate(cum_miss, cfg.slow_window)
        recent = miss_w[-1] / max(n_w[-1], 1)
        if recent > 0:
            tte = remaining * allowed / recent
    elif remaining == 0.0:
        tte = 0.0
    return SLOReport(cfg=cfg, epochs=T, offered=int(total_off),
                     misses=int(total_miss), budget_remaining=remaining,
                     time_to_exhaustion=tte, burn_fast=burn_fast,
                     burn_slow=burn_slow, alerts=alerts, epoch=epoch)


def emit_events(report: SLOReport) -> None:
    """Mirror the report into the active obs recorder (no-op when
    recording is off): one ``slo.burn_alert``/``slo.burn_clear`` pair
    per page plus a final ``slo.budget`` summary event."""
    for a in report.alerts:
        obs.event("slo.burn_alert", epoch=a["start"],
                  burn_fast=a["peak_burn_fast"],
                  burn_slow=a["peak_burn_slow"])
        if a["end"] is not None:
            obs.event("slo.burn_clear", epoch=a["end"])
    obs.event("slo.budget", target=report.cfg.target,
              attainment=report.attainment,
              remaining=report.budget_remaining,
              alerts=len(report.alerts),
              time_to_exhaustion=report.time_to_exhaustion)
