"""Latency parameters for the end-to-end model (paper Eqs. 4-5); port of
``repro.core.latency``.

The formulas themselves live in ``repro_torch.core.pricing``, the single
cost core, and are re-exported here. Throughputs are effective (not peak)
FLOP/s for the paper's TX2 / PowerEdge regime.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.pricing import (local_time, remote_time, total_time,
                                      transmit_time)

__all__ = ["LatencyParams", "local_time", "transmit_time", "remote_time",
           "total_time"]


@dataclasses.dataclass(frozen=True)
class LatencyParams:
    device_flops: float = 0.25e12     # Jetson TX2 effective
    server_flops: float = 0.8e12      # 16-core 3.2 GHz PowerEdge effective
    job_service_s: float = 0.05       # mean service time of a queued job
    bw_min_bps: float = 16e6          # 2 MB/s
    bw_max_bps: float = 320e6         # 40 MB/s
