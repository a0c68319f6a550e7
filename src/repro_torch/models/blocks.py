"""Blocks (port of ``repro.models.blocks``): the ``attn`` kind, pre-norm
self-attention (GQA, or MLA under ``use_mla``) plus pre-norm MLP (with biases under ``attn_bias``) or, in
an MoE layer, the pre-norm mixture of experts, each with a residual; the
``enc`` kind, the same with bidirectional attention (the whisper encoder);
the ``dec`` kind, causal self-attention, cross-attention and MLP, each
pre-norm with a residual (the whisper decoder); the ``xattn`` kind,
cross-attention and MLP each behind a ``tanh`` gate (llama-3.2-vision's
image layers); the ``ssm`` kind, a pre-norm Mamba mixer with a residual;
the ``rec`` kind, a pre-norm RG-LRU mixer plus pre-norm MLP, each with a
residual. The norms are RMSNorm or LayerNorm, as the plan's leaves say.
Every kind has the same ``forward(x, *, pos0, mode, cache, cache_len,
kv_src) -> (x, new_cache)``; ``kv_src`` (the encoder or media states) is
read by the cross-attention kinds only. ``forward_aux`` takes the same
arguments and returns (x, new_cache, aux) as the reference's ``apply_block``
does: aux is the MoE layer's weighted load-balance loss (a 0-d f32 tensor),
0.0 for every other block."""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import CrossAttention, MLAttention, SelfAttention
from repro_torch.models.layers import MLP, build_norm
from repro_torch.models.moe import MoE
from repro_torch.models.rglru import RecMixer
from repro_torch.models.ssm import SSMMixer


def _sub(p: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in p.items() if k.startswith(prefix)}


def _mlp(cfg: ModelConfig, p: Dict[str, torch.Tensor], prefix: str = "mlp/") -> MLP:
    """The MLP whose leaves are under ``prefix``: gated, or plain gelu; with
    ``b_up`` and ``b_down`` where the plan holds them (an ``attn`` block of
    a config with ``attn_bias``, as in the reference)."""
    return MLP(p.get(f"{prefix}w_gate"), p[f"{prefix}w_up"], p[f"{prefix}w_down"],
               act=cfg.mlp_act, b_up=p.get(f"{prefix}b_up"), b_down=p.get(f"{prefix}b_down"))


class _Block(nn.Module):
    """What every block kind shares: ``forward_aux``, ``forward`` with the
    aux loss of 0.0 alongside."""

    def forward_aux(self, x: torch.Tensor, **kw):
        """(x, new_cache, aux): ``forward``'s result and the block's aux loss."""
        x, new_cache = self(x, **kw)
        return x, new_cache, 0.0


def _moe(cfg: ModelConfig, p: Dict[str, torch.Tensor]) -> MoE:
    """The MoE whose leaves are under ``moe/``, its shared experts' MLP
    under ``moe/shared/``."""
    shared = _mlp(cfg, p, "moe/shared/") if cfg.n_shared_experts else None
    return MoE(cfg, _sub(p, "moe/"), shared=shared)


class Block(_Block):
    """``p`` holds one layer's tensors keyed as in the reference's block
    plan: norm1/..., attn/..., norm2/..., then mlp/... or, for an MoE layer
    (``moe``), moe/... ``forward`` drops the MoE's aux loss, as the
    reference's serving paths do; ``forward_aux`` returns it (the train
    loss adds it). ``causal=False`` makes it the ``enc`` kind."""

    def __init__(self, cfg: ModelConfig, p: Dict[str, torch.Tensor],
                 window: Optional[int] = None, moe: bool = False, causal: bool = True):
        super().__init__()
        self.norm1 = build_norm(p, "norm1")
        if cfg.use_mla:
            self.attn = MLAttention(cfg, _sub(p, "attn/"), window=window)
        else:
            self.attn = SelfAttention(cfg, _sub(p, "attn/"), window=window, causal=causal)
        self.norm2 = build_norm(p, "norm2")
        self.moe = _moe(cfg, p) if moe else None
        self.mlp = None if moe else _mlp(cfg, p)

    def forward(self, x: torch.Tensor, *, pos0: int = 0, mode: str = "train",
                cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_len: Optional[int] = None, kv_src: Optional[torch.Tensor] = None):
        """Returns (x, new_cache); see ``SelfAttention.forward``."""
        x, new_cache, _ = self.forward_aux(x, pos0=pos0, mode=mode, cache=cache,
                                           cache_len=cache_len, kv_src=kv_src)
        return x, new_cache

    def forward_aux(self, x: torch.Tensor, *, pos0: int = 0, mode: str = "train",
                    cache: Optional[Dict[str, torch.Tensor]] = None,
                    cache_len: Optional[int] = None, kv_src: Optional[torch.Tensor] = None):
        """Returns (x, new_cache, aux): aux the MoE's weighted load-balance
        loss, 0.0 without experts."""
        h, new_cache = self.attn(self.norm1(x), pos0=pos0, mode=mode,
                                 cache=cache, cache_len=cache_len)
        x = x + h
        y = self.norm2(x)
        if self.moe is None:
            return x + self.mlp(y), new_cache, 0.0
        y, aux = self.moe(y)
        return x + y, new_cache, aux


class SSMBlock(_Block):
    """``x + mixer(norm(x))``. ``p`` holds one layer's tensors keyed as in
    the reference's block plan: norm/..., ssm/..."""

    def __init__(self, cfg: ModelConfig, p: Dict[str, torch.Tensor]):
        super().__init__()
        self.norm = build_norm(p, "norm")
        self.ssm = SSMMixer(cfg, _sub(p, "ssm/"))

    def forward(self, x: torch.Tensor, *, pos0: int = 0, mode: str = "train",
                cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_len: Optional[int] = None, kv_src: Optional[torch.Tensor] = None):
        """Returns (x, new_cache); see ``SSMMixer.forward``. ``pos0`` and
        ``cache_len`` do not apply to a recurrent state."""
        h, new_cache = self.ssm(self.norm(x), mode=mode, cache=cache)
        return x + h, new_cache


class RecBlock(_Block):
    """``x + rec(norm1(x))``, then ``+ mlp(norm2(x))``. ``p`` holds one
    layer's tensors keyed as in the reference's block plan: norm1/...,
    rec/..., norm2/..., mlp/..."""

    def __init__(self, cfg: ModelConfig, p: Dict[str, torch.Tensor]):
        super().__init__()
        self.norm1 = build_norm(p, "norm1")
        self.rec = RecMixer(cfg, _sub(p, "rec/"))
        self.norm2 = build_norm(p, "norm2")
        self.mlp = _mlp(cfg, p)

    def forward(self, x: torch.Tensor, *, pos0: int = 0, mode: str = "train",
                cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_len: Optional[int] = None, kv_src: Optional[torch.Tensor] = None):
        """Returns (x, new_cache); see ``RecMixer.forward``. ``pos0`` and
        ``cache_len`` do not apply to a recurrent state."""
        h, new_cache = self.rec(self.norm1(x), mode=mode, cache=cache)
        x = x + h
        return x + self.mlp(self.norm2(x)), new_cache


class DecBlock(_Block):
    """The whisper decoder's block: ``x + attn(norm1(x))`` (causal), then
    ``+ xattn(norm2(x), kv_src)``, then ``+ mlp(norm3(x))``. ``p`` holds
    one layer's tensors keyed as in the reference's block plan: norm1/...,
    attn/..., norm2/..., xattn/..., norm3/..., mlp/... Its cache is one
    dict {"k", "v", "xk", "xv"}: the self-attention's rings and the
    cross-attention's keys and values."""

    def __init__(self, cfg: ModelConfig, p: Dict[str, torch.Tensor],
                 window: Optional[int] = None):
        super().__init__()
        self.norm1 = build_norm(p, "norm1")
        self.attn = SelfAttention(cfg, _sub(p, "attn/"), window=window)
        self.norm2 = build_norm(p, "norm2")
        self.xattn = CrossAttention(cfg, _sub(p, "xattn/"))
        self.norm3 = build_norm(p, "norm3")
        self.mlp = _mlp(cfg, p)

    def forward(self, x: torch.Tensor, *, pos0: int = 0, mode: str = "train",
                cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_len: Optional[int] = None, kv_src: Optional[torch.Tensor] = None):
        """Returns (x, new_cache); new_cache is None in train mode."""
        self_cache = cross_cache = None
        if cache is not None:
            self_cache = {"k": cache["k"], "v": cache["v"]}
            cross_cache = {"xk": cache["xk"], "xv": cache["xv"]}
        h, nc_self = self.attn(self.norm1(x), pos0=pos0, mode=mode, cache=self_cache,
                               cache_len=cache_len)
        x = x + h
        h, nc_cross = self.xattn(self.norm2(x), kv_src=kv_src, cache=cross_cache, mode=mode)
        x = x + h
        x = x + self.mlp(self.norm3(x))
        return x, (None if mode == "train" else {**nc_self, **nc_cross})


class XAttnBlock(_Block):
    """llama-3.2-vision's image layer: ``x + tanh(gate_attn) *
    xattn(norm1(x), kv_src)``, then ``+ tanh(gate_mlp) * mlp(norm2(x))``.
    The gates are f32 (1,) leaves, cast to x's dtype after the tanh, as in
    the reference. ``p`` holds one layer's tensors keyed as in its block
    plan: norm1/..., xattn/..., gate_attn, norm2/..., mlp/..., gate_mlp.
    The cache is the cross-attention's {"xk", "xv"}."""

    def __init__(self, cfg: ModelConfig, p: Dict[str, torch.Tensor]):
        super().__init__()
        self.norm1 = build_norm(p, "norm1")
        self.xattn = CrossAttention(cfg, _sub(p, "xattn/"))
        self.gate_attn = nn.Parameter(p["gate_attn"], requires_grad=False)
        self.norm2 = build_norm(p, "norm2")
        self.mlp = _mlp(cfg, p)
        self.gate_mlp = nn.Parameter(p["gate_mlp"], requires_grad=False)

    def forward(self, x: torch.Tensor, *, pos0: int = 0, mode: str = "train",
                cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_len: Optional[int] = None, kv_src: Optional[torch.Tensor] = None):
        """Returns (x, new_cache); new_cache is None in train mode. ``pos0``
        and ``cache_len`` do not apply to cross-attention."""
        h, nc = self.xattn(self.norm1(x), kv_src=kv_src, cache=cache, mode=mode)
        x = x + torch.tanh(self.gate_attn).to(x.dtype) * h
        h = self.mlp(self.norm2(x))
        x = x + torch.tanh(self.gate_mlp).to(x.dtype) * h
        return x, (None if mode == "train" else nc)


def build_block(cfg: ModelConfig, kind: str, p: Dict[str, torch.Tensor],
                window: Optional[int] = None, moe: bool = False) -> nn.Module:
    """The block of one layer of ``kind`` from its tensors ``p``; ``moe``
    puts the mixture of experts in place of an ``attn`` block's MLP."""
    if kind in ("attn", "enc"):
        return Block(cfg, p, window=window, moe=moe, causal=kind == "attn")
    if kind == "dec":
        return DecBlock(cfg, p, window=window)
    if kind == "xattn":
        return XAttnBlock(cfg, p)
    if kind == "ssm":
        return SSMBlock(cfg, p)
    if kind == "rec":
        return RecBlock(cfg, p)
    raise ValueError(f"unknown block kind {kind!r}")
