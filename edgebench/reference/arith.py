"""The reference's arithmetic: f32 contractions with TF32 off, and a frozen
copy of the w8a8 and w4 quantization (symmetric, per output channel for
weights, per row for activations, int4 in groups of 32 rows of the
contraction axis), worked out again from the same f32 inputs.

The controls (``CONTROLS``) are the same arithmetic one precision lower.
``control``: every f32 contraction takes its operands rounded to TF32 (10
mantissa bits, to nearest even), and the int8 codes of w8a8 and of the link
become int4 codes (the nearest precision below each that the configuration
states). ``control_tf32``: the TF32 operands alone, the int8 codes kept, so
that the f32 part of a w8 path is read on its own. ``control_attn_tf32``:
TF32 operands in the attention's two products alone, as a one-pass TF32
attention kernel would take them. The TF32 rounding is written out, so a
control reads the same on the CPU and on the card.
"""
from __future__ import annotations

import torch

W4_GROUP = 32
CONTROLS = {"control": {"tf32": True, "int8": 7},
            "control_tf32": {"tf32": True, "int8": 127},
            "control_attn_tf32": {"attn_tf32": True, "int8": 127}}


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x (f32) rounded to TF32's 10 mantissa bits, to nearest even."""
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    return ((i + 0xFFF + lsb) & -0x2000).view(torch.float32)


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d correctly rounded (a tensor divisor: a Python scalar divisor is
    a multiply by the reciprocal on the card)."""
    return x / torch.tensor(d, dtype=x.dtype, device=x.device)


def quantize_rows(x: torch.Tensor, qmax: int):
    """Per-row symmetric codes of x (..., K): (codes f32, scales (..., 1))."""
    xf = x.to(torch.float32)
    scale = _div(xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8), float(qmax))
    return torch.clamp(torch.round(xf / scale), -qmax, qmax), scale


def quantize_cols(w: torch.Tensor, qmax: int, group: int):
    """Symmetric codes of w (K, N) per output column, in groups of ``group``
    rows of K: (codes (K, N) f32, scales (K // group, N))."""
    K, N = w.shape
    wg = w.to(torch.float32).reshape(K // group, group, N)
    scale = _div(wg.abs().amax(dim=1, keepdim=True).clamp_min(1e-8), float(qmax))
    q = torch.clamp(torch.round(wg / scale), -qmax, qmax)
    return q.reshape(K, N), scale[:, 0, :]


class Arith:
    def __init__(self, control: str = None):
        """``control``: None (the reference) or a name of ``CONTROLS``."""
        spec = {"tf32": False, "attn_tf32": False, "int8": 127,
                **(CONTROLS[control] if control else {})}
        self.tf32, self.int8 = spec["tf32"], spec["int8"]
        self.attn_tf32 = spec["tf32"] or spec["attn_tf32"]

    def r(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of an f32 contraction."""
        return tf32_round(x) if self.tf32 else x

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (..., K) @ w (K, N) in f32."""
        return self.r(x) @ self.r(w)

    def einsum(self, spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """One of the attention's two products, in f32."""
        if self.attn_tf32:
            a, b = tf32_round(a), tf32_round(b)
        return torch.einsum(spec, a, b)

    def w8a8(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """The int8 x int8 product, exact in f64, rescaled in f32."""
        lead = x.shape[:-1]
        xq, xs = quantize_rows(x.reshape(-1, x.shape[-1]), self.int8)
        wq, ws = quantize_cols(w, self.int8, w.shape[0])
        acc = (xq.to(torch.float64) @ wq.to(torch.float64)).to(torch.float32)
        return (acc * xs * ws).reshape(*lead, w.shape[1])

    def w4(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x against the int4 weight dequantized to f32."""
        K, N = w.shape
        group = W4_GROUP if K % W4_GROUP == 0 else K
        q, s = quantize_cols(w, 7, group)
        deq = (q.reshape(K // group, group, N) * s[:, None, :]).reshape(K, N)
        return self.mm(x, deq)

    def proj(self, x: torch.Tensor, w: torch.Tensor, version: str) -> torch.Tensor:
        """A projection the version quantizes (a Dense leaf of the port)."""
        if version == "w8":
            return self.w8a8(x, w)
        if version == "w4":
            return self.w4(x, w)
        return self.mm(x, w)

    def link(self, x: torch.Tensor) -> torch.Tensor:
        """The w8 link: int8 codes and row scales, back to f32."""
        q, s = quantize_rows(x, self.int8)
        return q * s
