"""GQA self-attention (port of ``repro.models.attention``, the dense
``mode="train"`` path: whole sequences, no cache)."""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention_core as ac
from repro_torch.models.layers import Dense, apply_rope


class SelfAttention(nn.Module):
    """q/k/v projections (+ QKV bias), head split, RoPE, attention, wo.

    ``p`` holds one layer's tensors under the reference's leaf names
    (wq, wk, wv, wo and, with ``cfg.qkv_bias``, bq, bk, bv)."""

    def __init__(self, cfg: ModelConfig, p: Dict[str, torch.Tensor],
                 window: Optional[int] = None):
        super().__init__()
        self.n_heads, self.n_kv_heads = cfg.n_heads, cfg.n_kv_heads
        self.head_dim = cfg.resolved_head_dim
        self.rope_theta = cfg.rope_theta
        self.window = window
        self.wq, self.wk, self.wv, self.wo = (Dense(p[n]) for n in ("wq", "wk", "wv", "wo"))
        if cfg.qkv_bias:
            self.bq = nn.Parameter(p["bq"], requires_grad=False)
            self.bk = nn.Parameter(p["bk"], requires_grad=False)
            self.bv = nn.Parameter(p["bv"], requires_grad=False)
        else:
            self.bq = self.bk = self.bv = None

    def forward(self, x: torch.Tensor, pos0: int = 0) -> torch.Tensor:
        B, S, _ = x.shape
        H, HK, Dh = self.n_heads, self.n_kv_heads, self.head_dim
        q, k, v = self.wq(x), self.wk(x), self.wv(x)
        if self.bq is not None:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        q, k, v = q.view(B, S, H, Dh), k.view(B, S, HK, Dh), v.view(B, S, HK, Dh)
        positions = pos0 + torch.arange(S, device=x.device)
        q = apply_rope(q, positions, self.rope_theta)
        k = apply_rope(k, positions, self.rope_theta)
        out = ac.attention(q, k, v, q_positions=positions,
                           kv_positions=positions, causal=True,
                           window=self.window)
        return self.wo(out.reshape(B, S, H * Dh))
