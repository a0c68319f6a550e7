"""Plain PyTorch layers that the architectures' references share, in f32,
as the port declares them (see each configuration file's ``departures``)."""
from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch

from edgebench.reference.arith import Arith

Spec = Tuple[Tuple[int, ...], tuple]   # (per-layer shape, init): see weights.make_leaf

NEG_INF = -1e30
EPS = 1e-6


def layernorm(x, scale, bias):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + EPS) * scale + bias


def rmsnorm(x, scale):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + EPS) * scale


def norm_leaves(m: Mapping, name: str) -> Dict[str, Spec]:
    """A norm's leaves: a scale around 1, and a bias for a layernorm."""
    out = {f"{name}/scale": ((m["d_model"],), ("around", 1.0, 0.1))}
    if m["norm"] == "layernorm":
        out[f"{name}/bias"] = ((m["d_model"],), ("normal", 0.1))
    return out


def norm(x, w: Mapping[str, torch.Tensor], name: str):
    bias = w.get(f"{name}/bias")
    return rmsnorm(x, w[f"{name}/scale"]) if bias is None else layernorm(x, w[f"{name}/scale"], bias)


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def silu(x):
    return x * torch.sigmoid(x)


def softplus(x):
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def rope(x, theta: float):
    """Half-split rotary embedding at positions 0..S-1; x (B, S, H, D)."""
    S, D = x.shape[1], x.shape[-1]
    half = D // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv[None]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, window, ar: Arith):
    """Causal GQA attention, query head h on kv head h % HK, keys within
    ``window`` positions. q (B, S, H, D); k, v (B, S, HK, D)."""
    B, S, H, D = q.shape
    HK = k.shape[2]
    qg = q.reshape(B, S, H // HK, HK, D)
    scores = ar.einsum("bqghd,bkhd->bghqk", qg, k) * D ** -0.5
    pos = torch.arange(S, device=q.device)
    diff = pos[:, None] - pos[None, :]
    mask = diff >= 0
    if window is not None:
        mask = mask & (diff < window)
    probs = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1)
    out = ar.einsum("bghqk,bkhd->bqghd", probs, v)
    return out.reshape(B, S, H * D)


def selective_scan(u, dt, Bm, Cm, A, chunk: int = 128):
    """h_t = exp(dt_t A) h_{t-1} + (dt_t u_t) B_t from h = 0; y_t = sum_n h_t C_t.
    u, dt (B, S, DI); Bm, Cm (B, S, N); A (DI, N). Elementwise in f32; the
    sum over N is a plain reduction."""
    Bsz, S, DI = u.shape
    h = torch.zeros((Bsz, DI, A.shape[1]), dtype=torch.float32, device=u.device)
    y = torch.empty((Bsz, S, DI), dtype=torch.float32, device=u.device)
    for c0 in range(0, S, chunk):
        c1 = min(S, c0 + chunk)
        dA = torch.exp(dt[:, c0:c1, :, None] * A)
        dBu = (dt[:, c0:c1] * u[:, c0:c1])[..., None] * Bm[:, c0:c1, None, :]
        hs = torch.empty_like(dA)
        for t in range(c1 - c0):
            h = torch.addcmul(dBu[:, t], dA[:, t], h, out=hs[:, t])
        y[:, c0:c1] = (hs * Cm[:, c0:c1, None, :]).sum(dim=-1)
    return y


def causal_conv(x, w, b):
    """Depthwise causal conv over S; x (B, S, C), w (K, C)."""
    K, S = w.shape[0], x.shape[1]
    y = x * w[K - 1]
    for i in range(1, K):
        y = y + torch.nn.functional.pad(x, (0, 0, i, 0))[:, :S] * w[K - 1 - i]
    return y + b
