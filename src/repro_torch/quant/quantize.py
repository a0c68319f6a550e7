"""Symmetric per-channel weight quantization (port of ``repro.quant.quantize``).

A quantized weight is a ``QTensor``: integer codes ``q`` and f32 ``scale``
per output channel. Every dense weight is laid out ``(in, out)`` as in the
JAX package, so codes and scales compare bit for bit across the packages.

Modes:
  "w8wo" — int8 weight-only (activations stay in compute dtype)
  "w4"   — int4 weight-only, two codes packed per uint8 along the
           contraction axis (axis -2), low nibble = even row
  "w8a8" — int8 weights + dynamic per-row int8 activations; dispatched to
           the int8 matmul kernel (kernels/quant_matmul.py) through
           models/layers.py::dense -> kernels/ops.py::quantized_dense
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Dict, FrozenSet, Tuple

import torch
from torch import nn

MODES = ("w8wo", "w4", "w8a8")
_QMAX = {8: 127, 4: 7}
W4_GROUP = 32   # contraction-axis scale-group size for int4

# dense-projection leaves consumed through layers.dense (``x @ w`` with w of
# shape (in, out)); embeddings and everything else stay full precision
DENSE_WEIGHTS: FrozenSet[str] = frozenset(
    {"wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down", "lm_head"})


@dataclasses.dataclass
class QTensor:
    """Quantized weight: ``q`` int8 (w8wo/w8a8) or uint8 nibble-packed (w4,
    contraction axis halved); ``scale`` f32 of shape (..., G, out) with G
    scale groups along the contraction axis (1 for the int8 modes)."""
    q: torch.Tensor
    scale: torch.Tensor
    bits: int = 8
    act_bits: int = 0

    @property
    def nbytes(self) -> int:
        return (self.q.numel() * self.q.element_size()
                + self.scale.numel() * self.scale.element_size())

    def dequantize(self) -> torch.Tensor:
        q = _unpack_int4(self.q) if self.bits == 4 else self.q
        d, n = q.shape[-2], q.shape[-1]
        groups = self.scale.shape[-2]
        qg = q.to(torch.float32).reshape(*q.shape[:-2], groups, d // groups, n)
        out = qg * self.scale[..., :, None, :]
        return out.reshape(*q.shape[:-2], d, n)


# the divisors of _true_div, one device scalar per (device, dtype, value):
# made once, since copying a host value to the card waits for the stream
# (and cannot happen inside a CUDA graph capture)
_DIVISORS: Dict[Tuple[torch.device, torch.dtype, float], torch.Tensor] = {}


def _true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` correctly rounded on every device. PyTorch's CUDA division
    by a Python scalar multiplies by the reciprocal, which can be one ulp
    off; a scale one ulp off moves codes that sit at a rounding boundary,
    so the card would quantize otherwise than the CPU and the reference."""
    key = (x.device, x.dtype, d)
    divisor = _DIVISORS.get(key)
    if divisor is None:
        divisor = _DIVISORS[key] = torch.tensor(d, dtype=x.dtype, device=x.device)
    return x / divisor


def _pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int8 codes in [-8, 7], (..., d, n) -> uint8 nibbles (..., d//2, n)."""
    u = q.to(torch.int32) & 0xF
    lo, hi = u[..., 0::2, :], u[..., 1::2, :]
    return (lo | (hi << 4)).to(torch.uint8)


def _unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """uint8 nibbles (..., d2, n) -> sign-extended int8 codes (..., d2*2, n)."""
    p = packed.to(torch.int32)
    lo, hi = p & 0xF, (p >> 4) & 0xF
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    pair = torch.stack([lo, hi], dim=-2)                 # (..., d2, 2, n)
    out = pair.reshape(*packed.shape[:-2], packed.shape[-2] * 2,
                       packed.shape[-1])
    return out.to(torch.int8)


def quantize(w: torch.Tensor, mode: str) -> QTensor:
    """Symmetric quantization of one (..., in, out) weight: scales per
    output channel, w4 additionally in groups of W4_GROUP rows."""
    if mode not in MODES:
        raise ValueError(f"unknown quant mode {mode!r}; known: {MODES}")
    bits = 4 if mode == "w4" else 8
    act_bits = 8 if mode == "w8a8" else 0
    qmax = _QMAX[bits]
    d, n = w.shape[-2], w.shape[-1]
    g = W4_GROUP if (bits == 4 and d % W4_GROUP == 0) else d
    wf = w.to(torch.float32).reshape(*w.shape[:-2], d // g, g, n)
    amax = wf.abs().amax(dim=-2, keepdim=True)
    scale = _true_div(amax.clamp_min(1e-8), qmax)        # (..., G, 1, n)
    q = torch.clamp(torch.round(wf / scale), -qmax, qmax).to(torch.int8)
    q = q.reshape(*w.shape[:-2], d, n)
    scale = scale[..., 0, :]                             # (..., G, n)
    if bits == 4:
        if d % 2:
            raise ValueError(f"w4 needs an even contraction dim, got {tuple(w.shape)}")
        q = _pack_int4(q)
    return QTensor(q, scale, bits, act_bits)


def quantize_act(x: torch.Tensor):
    """Dynamic per-row int8 activation quantization (contraction = last
    axis). Returns (q int8, scale f32 with the last axis reduced to 1)."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = _true_div(amax.clamp_min(1e-8), 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_tree(model: nn.Module, mode: str,
                  names: FrozenSet[str] = DENSE_WEIGHTS) -> nn.Module:
    """A copy of ``model`` whose ``Dense`` leaves named in ``names`` hold a
    ``QTensor``. Every other parameter is shared with ``model``, not
    copied; ``model`` itself is left as it was. A module named ``moe`` is
    left whole, as the reference leaves its ``moe`` subtree: the routed
    experts reuse the MLP's leaf names but run through the dispatch
    einsums, and its shared experts stay with them."""
    from repro_torch.models.layers import Dense

    if mode not in MODES:
        raise ValueError(f"unknown quant mode {mode!r}; known: {MODES}")

    def rec(module: nn.Module, name: str) -> nn.Module:
        if name == "moe":
            return module
        if isinstance(module, Dense):
            if name in names and isinstance(module.w, torch.Tensor):
                return Dense(quantize(module.w, mode))
            return module
        clone = copy.copy(module)
        clone._parameters = dict(module._parameters)
        clone._buffers = dict(module._buffers)
        clone._modules = {k: rec(c, k) for k, c in module._modules.items()}
        return clone

    return rec(model, "")
