"""Shared primitive layers (port of ``repro.models.layers``): the dense
projection, RMSNorm and LayerNorm, the gated MLP (SwiGLU, GeGLU) and the
plain gelu MLP with its biases, rotary embeddings, whisper's sinusoidal
positions and the causal depthwise convolution of the Mamba and RG-LRU
mixers."""
from __future__ import annotations

from typing import Dict, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops, sharded
from repro_torch.quant.quantize import QTensor


def dense(x: torch.Tensor, w: Union[torch.Tensor, QTensor]) -> torch.Tensor:
    """``x @ w`` with w (in, out); a ``QTensor`` goes to
    ``ops.quantized_dense``."""
    if isinstance(w, QTensor):
        return ops.quantized_dense(x, w)
    if sharded.is_dtensor(w):
        return sharded.dense(x, w)
    return x @ w


class Dense(nn.Module):
    """A dense projection holding either a float weight (in, out) or a
    ``QTensor`` (its codes and scales as buffers). A w8a8 leaf holds its
    codes (in, out) in K-major order, as the transpose of an (out, in)
    tensor: the order the int8 kernel reads, laid out once here, when the
    version is built, so no call copies the weight. Shape, values and
    size stay those of the JAX layout."""

    def __init__(self, w: Union[torch.Tensor, QTensor]):
        super().__init__()
        if isinstance(w, QTensor):
            self.register_parameter("weight", None)
            q = w.q
            if w.bits == 8 and w.act_bits == 8 and not q.t().is_contiguous():
                q = q.t().contiguous().t()
            self.register_buffer("q", q)
            self.register_buffer("scale", w.scale)
            self.bits, self.act_bits = w.bits, w.act_bits
        else:
            self.weight = nn.Parameter(w, requires_grad=False)

    @property
    def w(self) -> Union[torch.Tensor, QTensor]:
        if self.weight is not None:
            return self.weight
        return QTensor(self.q, self.scale, self.bits, self.act_bits)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.w)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def apply_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """RMSNorm over the last dim in f32, cast back to x's dtype. Over a
    head's trailing head_dim it is the reference's ``rms_norm_headwise``
    (qwen3's q and k norms): the same formula."""
    xf = x.to(torch.float32)
    ms = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + eps) * scale.to(torch.float32)
    return y.to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, scale: torch.Tensor):
        super().__init__()
        self.scale = nn.Parameter(scale, requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_norm(x, self.scale)


class LayerNorm(nn.Module):
    """LayerNorm in f32 as the reference computes it (the mean, then the
    mean square of the centred values; its eps of 1e-6 for every model),
    cast back to x's dtype."""

    def __init__(self, scale: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        self.scale = nn.Parameter(scale, requires_grad=False)
        self.bias = nn.Parameter(bias, requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-6)
        y = y * self.scale.to(torch.float32) + self.bias.to(torch.float32)
        return y.to(x.dtype)


def build_norm(p: Dict[str, torch.Tensor], prefix: str) -> nn.Module:
    """The norm whose leaves are ``<prefix>/scale`` and, for a layernorm,
    ``<prefix>/bias``: as in the reference, the bias leaf tells them apart."""
    bias = p.get(f"{prefix}/bias")
    scale = p[f"{prefix}/scale"]
    return RMSNorm(scale) if bias is None else LayerNorm(scale, bias)


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------

def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` with its default ``approximate=True``: the tanh form,
    not torch's default erf form."""
    return F.gelu(x, approximate="tanh")


_GATE_ACTS = {"swiglu": F.silu, "geglu": gelu}


def _bias(b: Optional[torch.Tensor]) -> Optional[nn.Parameter]:
    return None if b is None else nn.Parameter(b, requires_grad=False)


class MLP(nn.Module):
    """Gated MLP: w_down(act(w_gate(x)) * w_up(x)), act = SiLU (SwiGLU) or
    tanh GeLU (GeGLU); or, for ``act="gelu"`` (no w_gate), the plain MLP
    w_down(gelu(w_up(x) + b_up)). ``b_down`` is added after w_down where
    given. As in the reference, ``b_up`` enters the plain MLP only."""

    def __init__(self, w_gate, w_up, w_down, act: str = "swiglu",
                 b_up: Optional[torch.Tensor] = None, b_down: Optional[torch.Tensor] = None):
        super().__init__()
        if act not in _GATE_ACTS and act != "gelu":
            raise ValueError(f"MLP: act {act!r} not in {sorted(_GATE_ACTS) + ['gelu']}")
        if (w_gate is None) != (act == "gelu"):
            raise ValueError(f"MLP: act {act!r} {'takes no' if act == 'gelu' else 'needs a'} w_gate")
        self.act = _GATE_ACTS.get(act, gelu)
        self.w_gate = None if w_gate is None else Dense(w_gate)
        self.w_up, self.w_down = Dense(w_up), Dense(w_down)
        self.b_up, self.b_down = _bias(b_up), _bias(b_down)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.w_gate is not None:
            h = self.act(self.w_gate(x)) * self.w_up(x)
        else:
            h = self.w_up(x)
            if self.b_up is not None:
                h = h + self.b_up
            h = self.act(h)
        y = self.w_down(h)
        return y if self.b_down is None else y + self.b_down


# --------------------------------------------------------------------------
# positions
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Half-split rotary embedding. x: (..., S, H, D); positions: (S,)."""
    half = x.shape[-1] // 2
    inv = rope_freqs(x.shape[-1], theta, device=x.device)        # (half,)
    ang = positions.to(torch.float32)[:, None] * inv[None]       # (S, half)
    cos = torch.cos(ang)[..., None, :]                           # (S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n: int, d: int, offset: int = 0, device=None) -> torch.Tensor:
    """Whisper's absolute positions ``offset .. offset + n - 1``: (n, d) f32,
    sines in the first half, cosines in the second, frequencies
    10000 ** (-i / max(half - 1, 1)), in the reference's f32 arithmetic."""
    f32 = dict(dtype=torch.float32, device=device)
    pos = (torch.arange(n, **f32) + offset)[:, None]
    half = d // 2
    freq = torch.exp(-torch.log(torch.tensor(10_000.0, **f32))
                     * torch.arange(half, **f32) / max(half - 1, 1))
    ang = pos * freq[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# --------------------------------------------------------------------------
# causal depthwise conv (mamba, rg-lru), as shifted adds in the reference's order
# --------------------------------------------------------------------------

def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """x: (B, S, C); w: (K, C) depthwise causal kernel; returns (B, S, C).

    Written as the reference's shifted adds, not ``F.conv1d``, so the sums
    run in the same order."""
    K, S = w.shape[0], x.shape[1]
    y = x * w[K - 1]
    for i in range(1, K):
        shifted = F.pad(x, (0, 0, i, 0))[:, :S]
        y = y + shifted * w[K - 1 - i]
    if b is not None:
        y = y + b
    return y


def causal_conv1d_step(x_t: torch.Tensor, conv_state: torch.Tensor,
                       w: torch.Tensor, b=None):
    """One decode step. x_t: (B, C); conv_state: (B, K-1, C) holding the
    previous K-1 inputs (oldest first). Returns (y_t, new_conv_state), both
    new tensors."""
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)        # (B, K, C)
    y = torch.einsum("bkc,kc->bc", window.to(torch.float32),
                     w.to(torch.float32)).to(x_t.dtype)
    if b is not None:
        y = y + b
    return y, window[:, 1:]
