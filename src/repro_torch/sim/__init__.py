"""Fleet metrics (port in progress): the latency schema the scheduler
reports through."""
from repro_torch.sim.metrics import LATENCY_SCHEMA, summarize_latencies

__all__ = ["LATENCY_SCHEMA", "summarize_latencies"]
