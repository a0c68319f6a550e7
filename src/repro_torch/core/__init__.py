"""EdgeRL core (port in progress): cut-point partitioning of the models."""
from repro_torch.core import partition

__all__ = ["partition"]
