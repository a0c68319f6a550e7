"""QuantVersion registry (port of ``repro.quant.versions``): the model-version
axis of the EdgeRL action space.

  bf16 — full-precision baseline (no quantization; qwen2-0.5b runs in f32,
         so the name is a label only)
  w8   — w8a8: int8 weights + dynamic int8 activations, run by the int8
         matmul kernel; ships int8 cut activations
  w4   — int4-packed weight-only: 4x smaller weights, full-precision math
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

from torch import nn

from repro_torch.quant.quantize import quantize_tree


@dataclasses.dataclass(frozen=True)
class QuantVersion:
    name: str
    weight_bits: int = 16
    act_bits: int = 0           # 0 = activations stay in compute dtype

    @property
    def mode(self) -> Optional[str]:
        """quantize_tree mode; None = leave the model untouched."""
        if self.weight_bits >= 16:
            return None
        if self.weight_bits == 4:
            return "w4"
        return "w8a8" if self.act_bits == 8 else "w8wo"


_REGISTRY: Dict[str, QuantVersion] = {
    "bf16": QuantVersion("bf16", weight_bits=16, act_bits=0),
    "w8": QuantVersion("w8", weight_bits=8, act_bits=8),
    "w4": QuantVersion("w4", weight_bits=4, act_bits=0),
}

DEFAULT_VERSIONS = ("bf16", "w8", "w4")


def get_version(name: str) -> QuantVersion:
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown quant version {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def build_version_params(cfg, model: nn.Module,
                         versions: Sequence[str] = DEFAULT_VERSIONS) -> Dict:
    """{version_name: model}: bf16 is ``model`` itself, quantized versions
    are copies with fresh QTensor leaves that share every other parameter."""
    out = {}
    for name in versions:
        qv = get_version(name)
        out[name] = model if qv.mode is None else quantize_tree(model, qv.mode)
    return out
