"""Attention math (port of ``repro.models.attention_core``): plain masked
attention, and chunked (flash-style) attention for long sequences on the
CPU, which keeps live score blocks at (B, G, HK, q_chunk, kv_chunk) so a
long prefill never holds (Sq, Skv) scores.

Conventions: q (B, Sq, H, Dh); k, v (B, Skv, HK, Dh) with H % HK == 0
(GQA). Query head h = g * HK + hk reads kv head hk = h % HK: q is grouped
as (B, Sq, G, HK, Dh), as in the reference. Positions are absolute token
indices; masking is positional. DTensor operands (a sharded model) run
each of these on their local shards (``kernels.sharded.attention``).
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


def _on_shards(fn, q, k, v, *, q_positions, kv_positions, **kw):
    """``fn`` on the local shards of DTensor q, k, v (B, S, H, D), heads on
    dim 1 as the kernels take them; positions whole."""
    qp, kp = (p.full_tensor() if sharded.is_dtensor(p) else p
              for p in (q_positions, kv_positions))
    return sharded.attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        lambda ql, kl, vl: fn(ql.transpose(1, 2), kl.transpose(1, 2), vl.transpose(1, 2),
                              q_positions=qp, kv_positions=kp, **kw).transpose(1, 2)
    ).transpose(1, 2)


def plain_attention(q, k, v, *, q_positions, kv_positions, causal=True,
                    window=None, logit_scale=None):
    if sharded.is_dtensor(q):
        return _on_shards(plain_attention, q, k, v, q_positions=q_positions,
                          kv_positions=kv_positions, causal=causal, window=window,
                          logit_scale=logit_scale)
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


def _pad_to(x, n, dim, value=0):
    """x padded with ``value`` along ``dim`` to a multiple of n."""
    pad = (-x.shape[dim]) % n
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_full(shape, value)], dim)


def chunked_attention(q, k, v, *, q_positions, kv_positions, causal=True,
                      window=None, q_chunk=512, kv_chunk=1024, logit_scale=None):
    """Flash-style online-softmax attention over q and kv chunks: a loop
    over kv chunks carrying an f32 (running max, running sum, output) state
    for every q chunk at once. The reference scans the q chunks too, but
    they carry nothing from one to the next, so here they are one batch
    dim of each step: the live scores are (B, NQ, G, HK, q_chunk, kv_chunk),
    Sq x kv_chunk a head, and a step is a few ops whatever Sq is (the dry
    run counts 32k-token prefills op by op). The products and their FLOPs
    are the reference's. Sequences are padded to whole chunks: padded keys
    sit at position -1 (masked), padded query rows are dropped."""
    if sharded.is_dtensor(q):
        return _on_shards(chunked_attention, q, k, v, q_positions=q_positions,
                          kv_positions=kv_positions, causal=causal, window=window,
                          q_chunk=q_chunk, kv_chunk=kv_chunk, logit_scale=logit_scale)
    B, Sq, H, Dh = q.shape
    Skv, HK = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // HK
    scale = logit_scale if logit_scale is not None else Dh ** -0.5
    f32 = torch.float32

    q_chunk, kv_chunk = min(q_chunk, Sq), min(kv_chunk, Skv)
    qp = _pad_to(q_positions, q_chunk, 0)
    kp = _pad_to(kv_positions, kv_chunk, 0, value=-1)      # padded kv = invalid
    q_, k_, v_ = _pad_to(q, q_chunk, 1), _pad_to(k, kv_chunk, 1), _pad_to(v, kv_chunk, 1)
    NQ, NK = q_.shape[1] // q_chunk, k_.shape[1] // kv_chunk
    qb = q_.reshape(B, NQ, q_chunk, G, HK, Dh).to(f32)
    kb = k_.reshape(B, NK, kv_chunk, HK, Dh).to(f32)
    vb = v_.reshape(B, NK, kv_chunk, HK, Dv).to(f32)

    m_run = q.new_full((B, NQ, G, HK, q_chunk), NEG_INF, dtype=f32)
    l_run = q.new_zeros((B, NQ, G, HK, q_chunk), dtype=f32)
    o_run = q.new_zeros((B, NQ, G, HK, q_chunk, Dv), dtype=f32)
    for j in range(NK):
        s = torch.einsum("bnqghd,bkhd->bnghqk", qb, kb[:, j]) * scale
        mask = _mask(qp, kp[j * kv_chunk:(j + 1) * kv_chunk], causal=causal, window=window)
        s = torch.where(mask.reshape(NQ, 1, 1, q_chunk, kv_chunk), s, NEG_INF)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        alpha = torch.exp(m_run - m_new)
        p = torch.exp(s - m_new[..., None])
        l_run = l_run * alpha + p.sum(dim=-1)
        o_run = o_run * alpha[..., None] + torch.einsum("bnghqk,bkhd->bnghqd", p, vb[:, j])
        m_run = m_new
    out = o_run / torch.clamp(l_run, min=1e-30)[..., None]     # (B, NQ, G, HK, qc, Dv)
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(B, NQ * q_chunk, H, Dv)
    return out[:, :Sq].to(q.dtype)


def chunked_attention_causal_skip(q, k, v, *, q_positions, kv_positions,
                                  window=None, logit_scale=None,
                                  q_chunk=512, kv_chunk=1024):
    """Causal chunked attention that only computes the kv prefix each q
    chunk can see: q chunk i attends over keys [0, its last row], so about
    half the masked-full loop's products. Self-attention only (Sq ==
    Skv)."""
    if sharded.is_dtensor(q):
        return _on_shards(chunked_attention_causal_skip, q, k, v, q_positions=q_positions,
                          kv_positions=kv_positions, window=window,
                          logit_scale=logit_scale, q_chunk=q_chunk, kv_chunk=kv_chunk)
    Sq = q.shape[1]
    if Sq != k.shape[1]:
        raise ValueError(f"causal_skip needs self-attention, Sq {Sq} != Skv {k.shape[1]}")
    q_chunk = min(q_chunk, Sq)
    outs = []
    for lo in range(0, Sq, q_chunk):
        hi = min(lo + q_chunk, Sq)          # causal: this chunk sees keys < hi
        outs.append(chunked_attention(
            q[:, lo:hi], k[:, :hi], v[:, :hi], q_positions=q_positions[lo:hi],
            kv_positions=kv_positions[:hi], causal=True, window=window,
            logit_scale=logit_scale, q_chunk=q_chunk, kv_chunk=kv_chunk))
    return torch.cat(outs, dim=1)


def attention(q, k, v, *, q_positions, kv_positions, causal=True, window=None,
              logit_scale=None, chunked_threshold=2048, q_chunk=512, kv_chunk=1024,
              causal_skip=False):
    """CUDA tensors go to the flash kernel (``ops.attention_bhsd``):
    self-attention (Sq == Skv; the kernel places query i and key j at
    positions i and j, which is what self-attention over a whole sequence
    passes, masks depending only on position differences) and unmasked
    attention at Sq != Skv (cross-attention: no causal mask, no window, so
    positions do not matter). A causal or windowed mask with Sq != Skv has
    no kernel, so a CUDA tensor raises there.

    CPU tensors take the reference's branches in its order:
    ``chunked_attention_causal_skip`` when ``causal_skip`` is set, the mask
    is causal and Sq == Skv > ``q_chunk``; ``chunked_attention`` when Sq x
    Skv > ``chunked_threshold`` squared; else the kernel's plain version
    for self-attention and ``plain_attention`` otherwise."""
    same = q.shape[1] == k.shape[1]
    if not q.is_cuda:
        kw = dict(q_positions=q_positions, kv_positions=kv_positions, window=window,
                  logit_scale=logit_scale)
        if causal_skip and causal and same and q.shape[1] > q_chunk:
            return chunked_attention_causal_skip(q, k, v, q_chunk=q_chunk, kv_chunk=kv_chunk,
                                                 **kw)
        if q.shape[1] * k.shape[1] > chunked_threshold ** 2:
            return chunked_attention(q, k, v, causal=causal, q_chunk=q_chunk,
                                     kv_chunk=kv_chunk, **kw)
        if not same:
            return plain_attention(q, k, v, causal=causal, **kw)
    elif not (same or (not causal and window is None)):
        raise NotImplementedError(
            "causal or windowed attention with Sq != Skv has no CUDA kernel in the port")
    out = ops.attention_bhsd(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                             causal=causal, window=window, logit_scale=logit_scale)
    return out.transpose(1, 2)
