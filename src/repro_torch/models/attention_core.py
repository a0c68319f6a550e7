"""Attention math (port of ``repro.models.attention_core``).

Conventions: q (B, Sq, H, Dh); k, v (B, Skv, HK, Dh) with H % HK == 0
(GQA). Query head h = g * HK + hk reads kv head hk = h % HK: q is grouped
as (B, Sq, G, HK, Dh), as in the reference. Positions are absolute token
indices; masking is positional.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops, sharded

NEG_INF = -1e30


def _mask(qp, kp, *, causal: bool, window: Optional[int]):
    """qp: (Sq,), kp: (Skv,) absolute positions; kp < 0 marks invalid slots."""
    m = (kp[None, :] >= 0).expand(qp.shape[0], kp.shape[0])
    if causal:
        m = m & (kp[None, :] <= qp[:, None])
    if window is not None:
        m = m & ((qp[:, None] - kp[None, :]) < window)
    return m  # (Sq, Skv)


def plain_attention(q, k, v, *, q_positions, kv_positions, causal=True,
                    window=None, logit_scale=None):
    if sharded.is_dtensor(q):
        # on local shards, heads on dim 1 as the kernels take them
        qp, kp = (p.full_tensor() if sharded.is_dtensor(p) else p
                  for p in (q_positions, kv_positions))
        return sharded.attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            lambda ql, kl, vl: plain_attention(
                ql.transpose(1, 2), kl.transpose(1, 2), vl.transpose(1, 2), q_positions=qp,
                kv_positions=kp, causal=causal, window=window,
                logit_scale=logit_scale).transpose(1, 2)).transpose(1, 2)
    B, Sq, H, Dh = q.shape
    HK = k.shape[2]
    G = H // HK
    scale = logit_scale if logit_scale is not None else Dh ** -0.5
    qg = q.reshape(B, Sq, G, HK, Dh)
    scores = torch.einsum("bqghd,bkhd->bghqk", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    mask = _mask(q_positions, kv_positions, causal=causal, window=window)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bghqk,bkhd->bqghd", probs, v.to(torch.float32))
    return out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def attention(q, k, v, *, q_positions, kv_positions, causal=True, window=None,
              logit_scale=None):
    """Self-attention (Sq == Skv) goes through ``ops.attention_bhsd``: the
    flash kernel on CUDA, its plain version on the CPU. Both place query i
    and key j at positions i and j, which is what self-attention over a
    whole sequence passes (masks depend only on position differences).
    Unmasked attention with Sq != Skv (cross-attention: no causal mask, no
    window, so positions do not matter) also takes the flash kernel on
    CUDA; on the CPU it takes the plain path. A causal or windowed mask
    with Sq != Skv has no kernel, so a CUDA tensor raises there."""
    same = q.shape[1] == k.shape[1]
    if same or (q.is_cuda and not causal and window is None):
        out = ops.attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=causal,
                                 window=window, logit_scale=logit_scale)
        return out.transpose(1, 2)
    if q.is_cuda:
        raise NotImplementedError(
            "causal or windowed attention with Sq != Skv has no CUDA kernel in the port")
    return plain_attention(q, k, v, q_positions=q_positions,
                           kv_positions=kv_positions, causal=causal,
                           window=window, logit_scale=logit_scale)
