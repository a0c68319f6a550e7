"""Serving (port in progress): prefill + decode (``ServingEngine``),
continuous batching (``ContinuousBatchingServer``) and EdgeRL split
serving (``SplitServingEngine``)."""
from repro_torch.serving.engine import ServeConfig, ServingEngine, SplitServingEngine
from repro_torch.serving.scheduler import ContinuousBatchingServer, Request, ServerStats

__all__ = ["ServeConfig", "ServingEngine", "SplitServingEngine",
           "ContinuousBatchingServer", "Request", "ServerStats"]
