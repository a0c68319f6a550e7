"""Per-request latency summaries (copy of ``summarize_latencies`` and
``LATENCY_SCHEMA`` from ``repro.sim.metrics``, numpy only).

The fleet simulator and the continuous-batching scheduler
(``serving.scheduler.ServerStats``) report through this schema, so a
latency table means the same thing whether the numbers came from the
analytical pricer or from wall-clock decode steps.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

# Keys every latency report carries (values are floats; "unit" is the
# only string: "s" for the simulator, "steps" for the scheduler).
LATENCY_SCHEMA = ("count", "mean", "p50", "p95", "p99", "max",
                  "slo", "slo_attainment", "goodput")


def summarize_latencies(latencies, *, slo: Optional[float] = None,
                        duration: Optional[float] = None,
                        unit: str = "s") -> Dict:
    """Percentiles + SLO attainment + goodput for a latency array.

    ``slo``: deadline in the same unit; attainment is the fraction of
    requests at or under it. ``duration``: wall span of the measurement
    window; goodput is SLO-met requests per unit duration (falls back
    to all completed requests when no SLO is given).
    """
    lat = np.asarray(latencies, dtype=np.float64).ravel()
    out = {k: 0.0 for k in LATENCY_SCHEMA}
    out["unit"] = unit
    out["count"] = float(lat.size)
    out["slo"] = float(slo) if slo is not None else float("nan")
    if lat.size == 0:
        out["slo_attainment"] = float("nan")
        return out
    out["mean"] = float(np.mean(lat))
    p50, p95, p99 = np.percentile(lat, [50.0, 95.0, 99.0])
    out["p50"], out["p95"], out["p99"] = float(p50), float(p95), float(p99)
    out["max"] = float(np.max(lat))
    good = float(np.sum(lat <= slo)) if slo is not None else float(lat.size)
    out["slo_attainment"] = good / lat.size if slo is not None \
        else float("nan")
    out["goodput"] = good / duration if duration else 0.0
    return out
