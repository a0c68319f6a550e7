"""Device resolution shared by the port's entry points.

Entry points run on the CUDA card unless the caller names another device.
Without a card and without a named device they raise: nothing drops to the
CPU silently.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the current CUDA card (raises without one); a named
    device is returned as given, with a bare ``cuda`` pinned to the current
    card's index so that devices compare equal."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
