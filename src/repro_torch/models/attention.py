"""GQA self-attention (port of ``repro.models.attention``, the dense path,
with QKV and o biases, qwen3's per-head q/k norm and RoPE):
whole sequences (train), prompt plus ring cache (prefill), and one token
against the ring cache (decode).

Cache layout: {"k", "v"}: (B, C, HK, Dh) ring buffers indexed by
``pos % C``, so sliding-window decode works with C == window. Slot validity
is recovered positionally: slot s holds absolute position
``pos - ((pos - s) mod C)`` (negative => empty). Decode writes the ring in
place, where the reference returns a new buffer.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import attention_core as ac
from repro_torch.models.layers import Dense, apply_norm, apply_rope

MODES = ("train", "prefill", "decode")


# --------------------------------------------------------------------------
# ring-buffer cache helpers
# --------------------------------------------------------------------------

def slot_positions(pos: int, cache_len: int, device=None) -> torch.Tensor:
    """Absolute position held by each ring slot after ``pos+1`` tokens
    (current token at ``pos`` already written). Negative => empty slot."""
    s = torch.arange(cache_len, device=device)
    return pos - torch.remainder(pos - s, cache_len)


def ring_write_step(buf: torch.Tensor, val: torch.Tensor, pos: int) -> torch.Tensor:
    """Write one timestep val (B, ...) at slot pos % C of buf (B, C, ...),
    in place; returns buf."""
    buf[:, pos % buf.shape[1]] = val
    return buf


def ring_from_prefill(seq_vals: torch.Tensor, cache_len: int) -> torch.Tensor:
    """Build a ring buffer from prefill values (B, S, ...): keep the last
    ``cache_len`` positions, placed at their ``p % cache_len`` slots. A new
    tensor in every case."""
    S = seq_vals.shape[1]
    if S <= cache_len:
        pad = [0, 0] * (seq_vals.dim() - 2) + [0, cache_len - S]
        return F.pad(seq_vals, pad)
    last = seq_vals[:, S - cache_len:]            # positions S-C .. S-1
    # position p sits at slot p % C; last[0] is position S-C
    return torch.roll(last, (S - cache_len) % cache_len, dims=1)


class SelfAttention(nn.Module):
    """q/k/v projections (+ QKV bias), head split, per-head q/k RMSNorm
    (qwen3's qk_norm), RoPE, attention, wo (+ o bias).

    ``p`` holds one layer's tensors under the reference's leaf names: wq,
    wk, wv, wo; with ``cfg.qkv_bias`` bq, bk, bv; with ``cfg.attn_bias``
    bo; with ``cfg.qk_norm`` q_norm and k_norm, each (head_dim,). The
    heads may be narrower or wider than d_model / n_heads: wq is (d_model,
    H * Dh) and wo (H * Dh, d_model)."""

    def __init__(self, cfg: ModelConfig, p: Dict[str, torch.Tensor],
                 window: Optional[int] = None):
        super().__init__()
        self.n_heads, self.n_kv_heads = cfg.n_heads, cfg.n_kv_heads
        self.head_dim = cfg.resolved_head_dim
        self.rope_theta = cfg.rope_theta if cfg.use_rope else None
        self.window = window
        self.wq, self.wk, self.wv, self.wo = (Dense(p[n]) for n in ("wq", "wk", "wv", "wo"))
        for names, on in ((("bq", "bk", "bv"), cfg.qkv_bias), (("bo",), cfg.attn_bias),
                          (("q_norm", "k_norm"), cfg.qk_norm)):
            for n in names:
                setattr(self, n, nn.Parameter(p[n], requires_grad=False) if on else None)

    def forward(self, x: torch.Tensor, pos0: int = 0, mode: str = "train",
                cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_len: Optional[int] = None):
        """Returns (out, new_cache); new_cache is None in train mode.

        prefill: attention over the whole prompt, and rings of ``cache_len``
        slots (default S) built from its k and v. decode (S == 1): k and v
        are written in place at slot ``pos0 % C`` of ``cache``, which is
        returned, then the query attends over the ring. ``pos0`` is a host
        int. The rings hold k after its norm and RoPE, as the reference's."""
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} not in {MODES}")
        B, S, _ = x.shape
        H, HK, Dh = self.n_heads, self.n_kv_heads, self.head_dim
        q, k, v = self.wq(x), self.wk(x), self.wv(x)
        if self.bq is not None:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        q, k, v = q.view(B, S, H, Dh), k.view(B, S, HK, Dh), v.view(B, S, HK, Dh)
        if self.q_norm is not None:
            q, k = apply_norm(q, self.q_norm), apply_norm(k, self.k_norm)
        positions = pos0 + torch.arange(S, device=x.device)
        if self.rope_theta is not None:
            q = apply_rope(q, positions, self.rope_theta)
            k = apply_rope(k, positions, self.rope_theta)

        new_cache = None
        if mode == "decode":
            kc = ring_write_step(cache["k"], k[:, 0], pos0)
            vc = ring_write_step(cache["v"], v[:, 0], pos0)
            new_cache = {"k": kc, "v": vc}
            out = ops.decode_attention(q[:, 0], kc.transpose(1, 2),
                                       vc.transpose(1, 2), pos0,
                                       window=self.window)[:, None]
        else:
            out = ac.attention(q, k, v, q_positions=positions,
                               kv_positions=positions, causal=True,
                               window=self.window)
            if mode == "prefill":
                C = cache_len if cache_len is not None else S
                new_cache = {"k": ring_from_prefill(k, C),
                             "v": ring_from_prefill(v, C)}
        out = self.wo(out.reshape(B, S, H * Dh))
        return (out if self.bo is None else out + self.bo), new_cache
