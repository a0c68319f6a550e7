"""The reference of a dense GQA decoder (starcoder2-3b): pre-norm attention
with RoPE, a causal window and QKV and o biases, and a pre-norm gelu MLP with
biases, each with a residual; every projection a Dense leaf of the port,
which the w8 and w4 versions quantize."""
from __future__ import annotations

from typing import Dict, Mapping

import torch

from edgebench.reference.arith import Arith
from edgebench.reference.layers import Spec, attention, gelu_tanh, norm, norm_leaves, rope


def block_leaves(m: Mapping) -> Dict[str, Spec]:
    """{leaf name inside a block: (per-layer shape, init)}, the port's names."""
    d, H, HK, Dh, f = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"], m["d_ff"]
    leaves = {**norm_leaves(m, "norm1"), **norm_leaves(m, "norm2"),
              "attn/wq": ((d, H * Dh), ("fan_in",)),
              "attn/wk": ((d, HK * Dh), ("fan_in",)),
              "attn/wv": ((d, HK * Dh), ("fan_in",)),
              "attn/wo": ((H * Dh, d), ("fan_in",)),
              "mlp/w_up": ((d, f), ("fan_in",)),
              "mlp/w_down": ((f, d), ("fan_in",))}
    if m["qkv_bias"]:
        leaves.update({"attn/bq": ((H * Dh,), ("normal", 0.1)),
                       "attn/bk": ((HK * Dh,), ("normal", 0.1)),
                       "attn/bv": ((HK * Dh,), ("normal", 0.1))})
    if m["attn_bias"]:
        leaves.update({"attn/bo": ((d,), ("normal", 0.1)),
                       "mlp/b_up": ((f,), ("normal", 0.1)),
                       "mlp/b_down": ((d,), ("normal", 0.1))})
    return leaves


def block(x, w: Dict[str, torch.Tensor], m: Mapping, version: str, ar: Arith):
    """Pre-norm attention and gelu MLP with biases, each with a residual."""
    B, S, _ = x.shape
    H, HK, D = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    h = norm(x, w, "norm1")
    q = ar.proj(h, w["attn/wq"], version) + w["attn/bq"]
    k = ar.proj(h, w["attn/wk"], version) + w["attn/bk"]
    v = ar.proj(h, w["attn/wv"], version) + w["attn/bv"]
    q = rope(q.reshape(B, S, H, D), m["rope_theta"])
    k = rope(k.reshape(B, S, HK, D), m["rope_theta"])
    a = attention(q, k, v.reshape(B, S, HK, D), m["sliding_window"], ar)
    x = x + ar.proj(a, w["attn/wo"], version) + w["attn/bo"]
    h = norm(x, w, "norm2")
    up = gelu_tanh(ar.proj(h, w["mlp/w_up"], version) + w["mlp/b_up"])
    return x + ar.proj(up, w["mlp/w_down"], version) + w["mlp/b_down"]
