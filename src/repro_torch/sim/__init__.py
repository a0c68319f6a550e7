"""repro_torch.sim: trace-driven fleet simulator closing the loop between
the EdgeRL controller and the executable serving stack (port of
``repro.sim``).

- ``traces``    — pluggable per-device request arrival generators
  (Poisson, MMPP bursty, diurnal sinusoid, replay-from-array, uniform).
- ``metrics``   — per-request latency percentiles, SLO attainment,
  goodput and energy (schema shared with ``serving.ServerStats``).
- ``backends``  — request pricing: a fast analytical backend over the
  numpy pricing core, and an execute backend that cross-checks a sampled
  subset through ``SplitServingEngine`` (on the card, its kernels).
- ``fleet``     — the discrete-event loop: each decision epoch the
  controller picks (version, cut) per device from *measured* state.
- ``megafleet`` — the engines behind ``FleetConfig(engine=...)``: the
  whole epoch as fused (devices,)-array ops in numpy (bit-identical to
  the loop oracle) or, in ``simulate_scan``, as one epoch loop of torch
  ops on the tables' device (the card), float32, state and accumulators
  kept there until the loop ends: 100k+ devices per card.
"""
from repro_torch.sim.traces import (DiurnalTrace, MMPPTrace, PoissonTrace,
                                    RandomRateTrace, ReplayTrace, Trace,
                                    get_trace, presample_counts, trace_names)
from repro_torch.sim.metrics import (EpochLog, FleetMetrics, LATENCY_SCHEMA,
                                     summarize_latencies)
from repro_torch.sim.backends import AnalyticalBackend, ExecuteBackend
from repro_torch.sim.fleet import ENGINES, FleetConfig, SimResult, simulate
from repro_torch.sim.megafleet import lindley_core, simulate_scan

__all__ = [
    "Trace", "PoissonTrace", "MMPPTrace", "DiurnalTrace", "ReplayTrace",
    "RandomRateTrace",
    "get_trace", "trace_names", "presample_counts",
    "EpochLog", "FleetMetrics", "LATENCY_SCHEMA", "summarize_latencies",
    "AnalyticalBackend", "ExecuteBackend", "FleetConfig", "SimResult",
    "simulate", "ENGINES", "lindley_core", "simulate_scan",
]
