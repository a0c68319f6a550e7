"""Blocks (port of ``repro.models.blocks``): the ``attn`` kind, pre-norm
self-attention (GQA, or MLA under ``use_mla``) plus pre-norm MLP (with biases under ``attn_bias``) or, in
an MoE layer, the pre-norm mixture of experts, each with a residual; the
``ssm`` kind, a pre-norm Mamba mixer with a residual; the ``rec`` kind,
a pre-norm RG-LRU mixer plus pre-norm MLP, each with a residual. The
norms are RMSNorm or LayerNorm, as the plan's leaves say. Every kind has
the same ``forward(x, *, pos0, mode, cache, cache_len) ->
(x, new_cache)``."""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import MLAttention, SelfAttention
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


def _moe(cfg: ModelConfig, p: Dict[str, torch.Tensor]) -> MoE:
    """The MoE whose leaves are under ``moe/``, its shared experts' MLP
    under ``moe/shared/``."""
    shared = _mlp(cfg, p, "moe/shared/") if cfg.n_shared_experts else None
    return MoE(cfg, _sub(p, "moe/"), shared=shared)


class Block(nn.Module):
    """``p`` holds one layer's tensors keyed as in the reference's block
    plan: norm1/..., attn/..., norm2/..., then mlp/... or, for an MoE layer
    (``moe``), moe/... The serving paths drop the MoE's aux loss, as the
    reference's do."""

    def __init__(self, cfg: ModelConfig, p: Dict[str, torch.Tensor],
                 window: Optional[int] = None, moe: bool = False):
        super().__init__()
        self.norm1 = build_norm(p, "norm1")
        attn = MLAttention if cfg.use_mla else SelfAttention
        self.attn = attn(cfg, _sub(p, "attn/"), window=window)
        self.norm2 = build_norm(p, "norm2")
        self.moe = _moe(cfg, p) if moe else None
        self.mlp = None if moe else _mlp(cfg, p)

    def forward(self, x: torch.Tensor, *, pos0: int = 0, mode: str = "train",
                cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_len: Optional[int] = None):
        """Returns (x, new_cache); see ``SelfAttention.forward``."""
        h, new_cache = self.attn(self.norm1(x), pos0=pos0, mode=mode,
                                 cache=cache, cache_len=cache_len)
        x = x + h
        y = self.norm2(x)
        return x + (self.mlp(y) if self.moe is None else self.moe(y)[0]), new_cache


class SSMBlock(nn.Module):
    """``x + mixer(norm(x))``. ``p`` holds one layer's tensors keyed as in
    the reference's block plan: norm/..., ssm/..."""

    def __init__(self, cfg: ModelConfig, p: Dict[str, torch.Tensor]):
        super().__init__()
        self.norm = build_norm(p, "norm")
        self.ssm = SSMMixer(cfg, _sub(p, "ssm/"))

    def forward(self, x: torch.Tensor, *, pos0: int = 0, mode: str = "train",
                cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_len: Optional[int] = None):
        """Returns (x, new_cache); see ``SSMMixer.forward``. ``pos0`` and
        ``cache_len`` do not apply to a recurrent state."""
        h, new_cache = self.ssm(self.norm(x), mode=mode, cache=cache)
        return x + h, new_cache


class RecBlock(nn.Module):
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
                cache_len: Optional[int] = None):
        """Returns (x, new_cache); see ``RecMixer.forward``. ``pos0`` and
        ``cache_len`` do not apply to a recurrent state."""
        h, new_cache = self.rec(self.norm1(x), mode=mode, cache=cache)
        x = x + h
        return x + self.mlp(self.norm2(x)), new_cache


def build_block(cfg: ModelConfig, kind: str, p: Dict[str, torch.Tensor],
                window: Optional[int] = None, moe: bool = False) -> nn.Module:
    """The block of one layer of ``kind`` from its tensors ``p``; ``moe``
    puts the mixture of experts in place of an ``attn`` block's MLP."""
    if kind == "attn":
        return Block(cfg, p, window=window, moe=moe)
    if kind == "ssm":
        return SSMBlock(cfg, p)
    if kind == "rec":
        return RecBlock(cfg, p)
    raise ValueError(f"unknown block kind {kind!r}")
