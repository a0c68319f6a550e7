"""Model assembly (port of ``repro.models.model``) for the dense family.

``DenseLM`` holds the embedding, one ``nn.ModuleList`` of ``Block``s per
stack (dense models have one stack, ``main``) and the final norm. It is
built from a flat mapping of tensors in the JAX package's layout — leaf
paths ``tok_embed``, ``final_norm/scale``, ``stacks/main/blk/attn/wq``, ...,
stacked leaves with the layer on dim 0 — so one constructor serves both
``params.init`` and ``params.load_jax_params``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.blocks import Block
from repro_torch.models.layers import RMSNorm


@dataclasses.dataclass(frozen=True)
class Sub:
    name: str
    kind: str
    repeat: int = 1


@dataclasses.dataclass(frozen=True)
class StackDef:
    name: str
    length: int
    subs: Tuple[Sub, ...]


def check_ported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError unless ``cfg`` is a dense model whose every
    feature the port runs (qwen2-0.5b's: GQA, QKV bias, RoPE, RMSNorm,
    SwiGLU, tied embeddings, optional sliding window)."""
    families = (("moe", cfg.moe), ("ssm", cfg.ssm),
                ("hybrid", bool(cfg.block_pattern)),
                ("vlm", bool(cfg.cross_attn_every)), ("audio", cfg.enc_dec),
                ("MLA", cfg.use_mla))
    missing = [name for name, on in families if on]
    if cfg.family != "dense":
        missing.insert(0, cfg.family)
    features = (("qk_norm", cfg.qk_norm), ("attn_bias", cfg.attn_bias),
                ("norm=" + cfg.norm, cfg.norm != "rmsnorm"),
                ("mlp_act=" + cfg.mlp_act, cfg.mlp_act != "swiglu"),
                ("untied lm_head", not cfg.tie_embeddings),
                ("use_rope=False", not cfg.use_rope))
    missing += [name for name, on in features if on]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: not ported to repro_torch yet: {', '.join(missing)}")


def stack_defs(cfg: ModelConfig) -> Tuple[StackDef, ...]:
    """Decoder trunk stacks, in execution order (dense: one ``main``)."""
    check_ported(cfg)
    return (StackDef("main", cfg.n_layers, (Sub("blk", "attn"),)),)


def _sub_window(cfg: ModelConfig, sub: Sub) -> Optional[int]:
    return cfg.sliding_window if sub.kind == "attn" else None


class DenseLM(nn.Module):
    def __init__(self, cfg: ModelConfig, flat: Dict[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        self.tok_embed = nn.Parameter(flat["tok_embed"], requires_grad=False)
        self.final_norm = RMSNorm(flat["final_norm/scale"])
        self.stacks = nn.ModuleDict()
        for s in stack_defs(cfg):
            (sub,) = s.subs
            prefix = f"stacks/{s.name}/{sub.name}/"
            leaves = {k[len(prefix):]: v for k, v in flat.items()
                      if k.startswith(prefix)}
            self.stacks[s.name] = nn.ModuleList(
                Block(cfg, {k: v[i] for k, v in leaves.items()},
                      window=_sub_window(cfg, sub))
                for i in range(s.length))

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens, self.tok_embed).to(self.cfg.cdtype)

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """Tied head: ``h @ tok_embed.T`` (a plain matmul, as the JAX package
        leaves this einsum to XLA)."""
        return h @ self.tok_embed.to(h.dtype).T

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed(tokens)
        for s in stack_defs(self.cfg):
            for blk in self.stacks[s.name]:
                x = blk(x)
        return self.head(self.final_norm(x))


def forward_logits(cfg: ModelConfig, model: DenseLM, batch) -> torch.Tensor:
    """Full-sequence logits. batch: {"tokens": (B, S) int}."""
    return model(batch["tokens"])
