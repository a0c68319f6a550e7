"""QuantVersion registry (port of ``repro.quant.versions``): the model-version
axis of the EdgeRL action space.

  bf16 — full-precision baseline (no quantization; qwen2-0.5b runs in f32,
         so the name is a label only)
  w8   — w8a8: int8 weights + dynamic int8 activations, run by the int8
         matmul kernel; ships int8 cut activations
  w4   — int4-packed weight-only: 4x smaller weights, full-precision math

Everything the env's ProfileTables needs per version is derived here: the
accuracy proxy from the quantization error of a probe layer, the FLOP cost
scale, the activation itemsize and the weight bytes from the code width.
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

    @property
    def bytes_per_param(self) -> float:
        """Nominal wire width of the quantized weight codes, per param.

        Only meaningful for quantized versions: profiles price
        full-precision leaves (and the whole tree when mode is None) at
        the config's param dtype width (cfg.pdtype.itemsize)."""
        return self.weight_bits / 8.0

    @property
    def act_itemsize(self) -> int:
        """Nominal link width of the cut activation: 1 for int8-shipping
        versions, else 2 (bf16 serving); profiles override the latter with
        the config's compute dtype width (cfg.cdtype.itemsize)."""
        return 1 if self.act_bits == 8 else 2

    @property
    def matmul_cost_scale(self) -> float:
        """Effective FLOP cost multiplier of the env's tables: a w8a8 MAC
        is priced at half a bf16 MAC (the reference env's int8 rate)."""
        return 0.5 if (self.weight_bits <= 8 and self.act_bits == 8) else 1.0


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


def list_versions() -> Dict[str, QuantVersion]:
    return dict(_REGISTRY)


# The reference measures a version's error on a probe drawn from
# jax.random.key(seed), which torch cannot redraw: its two results at the
# default probe (d = f = 512, rows = 32, seed = 0), recomputed from the
# reference and compared with == by tests/test_torch_pricing.py.
_PROBE_DEFAULTS = {"d": 512, "f": 512, "rows": 32, "seed": 0}
_PROBE_ERRORS = {(8, 8): 0.010585645213723183,    # w8 (w8a8)
                 (4, 0): 0.09722431004047394}     # w4 (weight-only)


def relative_quant_error(weight_bits: int, act_bits: int, *, d: int = 512,
                         f: int = 512, rows: int = 32, seed: int = 0) -> float:
    """Relative output error ||y - y_q|| / ||y|| of one quantized dense
    projection (a fan-in-scaled gaussian weight against gaussian
    activations), as the reference measured it; 0.0 for a version that
    quantizes nothing. Raises for any probe the reference's two numbers do
    not cover."""
    if QuantVersion("probe", weight_bits, act_bits).mode is None:
        return 0.0
    probe = {"d": d, "f": f, "rows": rows, "seed": seed}
    key = (int(weight_bits), int(act_bits))
    if probe != _PROBE_DEFAULTS or key not in _PROBE_ERRORS:
        raise ValueError(
            f"no probe error for weight_bits={weight_bits}, act_bits={act_bits} "
            f"at {probe}: only {sorted(_PROBE_ERRORS)} at {_PROBE_DEFAULTS} "
            "are known (the probe is drawn by the reference's jax.random)")
    return _PROBE_ERRORS[key]


def accuracy_proxy(qv: QuantVersion, base_acc: float = 0.75,
                   dense_frac: float = 1.0) -> float:
    """Version accuracy for the env tables: baseline accuracy degraded by
    the probe's quantization error, charged on the ``dense_frac`` of the
    model's compute that runs through quantized dense projections."""
    err = relative_quant_error(qv.weight_bits, qv.act_bits) * dense_frac
    return base_acc * (1.0 - err)


def build_version_params(cfg, model: nn.Module,
                         versions: Sequence[str] = DEFAULT_VERSIONS) -> Dict:
    """{version_name: model}: bf16 is ``model`` itself, quantized versions
    are copies with fresh QTensor leaves that share every other parameter."""
    out = {}
    for name in versions:
        qv = get_version(name)
        out[name] = model if qv.mode is None else quantize_tree(model, qv.mode)
    return out
