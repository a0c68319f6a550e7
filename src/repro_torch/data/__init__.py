"""Synthetic data (port of ``repro.data``)."""
from repro_torch.data.pipeline import (DataConfig, SyntheticLMDataset, make_train_iterator,
                                       to_device)

__all__ = ["DataConfig", "SyntheticLMDataset", "make_train_iterator", "to_device"]
