"""Serving (port in progress): EdgeRL split serving."""
from repro_torch.serving.engine import SplitServingEngine

__all__ = ["SplitServingEngine"]
