"""Attention (port of ``repro.models.attention``): GQA self-attention with
QKV and o biases, qwen3's per-head q/k norm and RoPE, causal or not (the
whisper encoder's); DeepSeek-V2's MLA (multi-head latent attention, a
compressed KV cache); and cross-attention (the whisper decoder's and
llama-3.2-vision's image layers) over encoder or media states. Whole
sequences (train), prompt plus ring cache (prefill), and one token against
the ring cache (decode).

Cache layout: {"k", "v"}: (B, C, HK, Dh) ring buffers indexed by
``pos % C``, so sliding-window decode works with C == window; MLA's
{"ckv": (B, C, R), "krope": (B, C, rope)} holds the compressed latent and
the shared RoPE key instead. Slot validity is recovered positionally: slot
s holds absolute position ``pos - ((pos - s) mod C)`` (negative => empty).
Decode writes the ring in place, where the reference returns a new buffer.
Cross-attention caches {"xk", "xv"}: (B, Skv, HK, Dh), the projected
encoder or media states, which decode reads and never writes.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, sharded
from repro_torch.models import attention_core as ac
from repro_torch.models.layers import Dense, apply_norm, apply_rope, dense

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
    in place; returns buf. A sharded ring is written shard by shard."""
    if sharded.is_dtensor(buf):
        return sharded.ring_write(buf, val, pos % buf.shape[1])
    buf[:, pos % buf.shape[1]] = val
    return buf


def ring_from_prefill(seq_vals: torch.Tensor, cache_len: int) -> torch.Tensor:
    """Build a ring buffer from prefill values (B, S, ...): keep the last
    ``cache_len`` positions, placed at their ``p % cache_len`` slots. A new
    tensor in every case. A sharded one is built shard by shard."""
    if sharded.is_dtensor(seq_vals):
        return sharded.along_dim1(seq_vals, lambda t: ring_from_prefill(t, cache_len))
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
    H * Dh) and wo (H * Dh, d_model). ``causal=False`` is the whisper
    encoder's bidirectional attention (train mode only, as the reference
    runs the encoder)."""

    def __init__(self, cfg: ModelConfig, p: Dict[str, torch.Tensor],
                 window: Optional[int] = None, causal: bool = True):
        super().__init__()
        self.n_heads, self.n_kv_heads = cfg.n_heads, cfg.n_kv_heads
        self.head_dim = cfg.resolved_head_dim
        self.rope_theta = cfg.rope_theta if cfg.use_rope else None
        self.window = window
        self.causal = causal
        # the CPU path's chunked attention (the reference's perf knobs)
        self.chunks = dict(q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk,
                           causal_skip=cfg.attn_causal_skip)
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
        q, k, v = (sharded.split_last(t, n, Dh) for t, n in ((q, H), (k, HK), (v, HK)))
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
                               kv_positions=positions, causal=self.causal,
                               window=self.window, **self.chunks)
            if mode == "prefill":
                C = cache_len if cache_len is not None else S
                new_cache = {"k": ring_from_prefill(k, C),
                             "v": ring_from_prefill(v, C)}
        out = self.wo(out.reshape(B, S, H * Dh))
        return (out if self.bo is None else out + self.bo), new_cache


class CrossAttention(nn.Module):
    """Cross-attention (port of ``apply_cross_attn``): queries from x, keys
    and values from the encoder or media states ``kv_src`` (B, Skv, d),
    non-causal, no RoPE. q = wq(x) (+ bq), k = wk(kv_src) with no bias, v =
    wv(kv_src) (+ bv), out = wo (+ bo); the biases under ``cfg.attn_bias``
    (whisper). Every projection is a ``Dense`` leaf, which w8 and w4
    quantize.

    With ``kv_src`` the layer projects k and v and returns them as the cache
    {"xk", "xv"}; without it (decode) it reads them from ``cache``. Train
    and prefill attend through ``ac.attention``: the flash kernel on CUDA
    (non-causal, Sq != Skv), on the CPU the plain path (chunked past the
    reference's threshold). A decode step (one
    query) attends through ``ops.decode_attention`` with the cache read as a
    full ring: ``pos = Skv - 1`` over C = Skv slots puts position s in slot
    s and leaves every slot visible, so the flash decode kernel computes
    the same unmasked softmax, and splits the key arc across blocks when B
    x HK is small. The cache goes in as a (B, HK, Skv, Dh) view, as the self
    attention's rings do."""

    def __init__(self, cfg: ModelConfig, p: Dict[str, torch.Tensor]):
        super().__init__()
        self.n_heads, self.n_kv_heads = cfg.n_heads, cfg.n_kv_heads
        self.head_dim = cfg.resolved_head_dim
        self.wq, self.wk, self.wv, self.wo = (Dense(p[n]) for n in ("wq", "wk", "wv", "wo"))
        for n in ("bq", "bv", "bo"):
            setattr(self, n, nn.Parameter(p[n], requires_grad=False) if cfg.attn_bias else None)

    def forward(self, x: torch.Tensor, kv_src: Optional[torch.Tensor] = None,
                cache: Optional[Dict[str, torch.Tensor]] = None, mode: str = "train"):
        """Returns (out, {"xk", "xv"}): the cache projected from ``kv_src``,
        or ``cache`` itself when there is no ``kv_src``."""
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} not in {MODES}")
        B, S, _ = x.shape
        H, HK, Dh = self.n_heads, self.n_kv_heads, self.head_dim
        q = self.wq(x)
        if self.bq is not None:
            q = q + self.bq
        q = sharded.split_last(q, H, Dh)
        if kv_src is None:
            if cache is None:
                raise ValueError("cross-attention needs kv_src or a cache of xk, xv")
            k, v = cache["xk"], cache["xv"]
        else:
            k = sharded.split_last(self.wk(kv_src), HK, Dh)
            v = self.wv(kv_src)
            if self.bv is not None:
                v = v + self.bv
            v = sharded.split_last(v, HK, Dh)
            cache = {"xk": k, "xv": v}
        Skv = k.shape[1]
        if mode == "decode":
            out = ops.decode_attention(q[:, 0], k.transpose(1, 2), v.transpose(1, 2),
                                       Skv - 1)[:, None]
        else:
            # no mask: every position 0, as the reference passes them
            out = ac.attention(q, k, v, q_positions=x.new_zeros(S, dtype=torch.long),
                               kv_positions=x.new_zeros(Skv, dtype=torch.long),
                               causal=False, window=None)
        out = self.wo(out.reshape(B, S, H * Dh))
        return (out if self.bo is None else out + self.bo), cache


class MLAttention(nn.Module):
    """DeepSeek-V2's multi-head latent attention (port of ``_apply_mla``).

    q comes from one projection, ``wq`` (d, H * (nope + rope)), with RoPE on
    its last ``rope`` columns of each head. k and v are expanded from a
    compressed latent: ``dkv = x @ w_dkv`` (d, R + rope) splits into ``ckv``
    (its first R columns, RMS-normed by ``kv_norm``) and one RoPE key of
    ``rope`` columns shared by every head; k = [ckv @ w_uk per head, that
    key], v = ckv @ w_uv per head. The cache holds ckv and the RoPE key
    only. ``wq`` and ``wo`` (H * vd, d) are ``Dense`` leaves, which w8 and
    w4 quantize; ``w_dkv``, ``w_uk`` (R, H * nope) and ``w_uv`` (R, H * vd)
    stay float and are multiplied with ``@``, as in the reference.

    Train and prefill attend through ``ac.attention`` at head dims (nope +
    rope, vd): the flash kernel on CUDA. Decode re-expands k and v from the
    whole ring each step and runs ``plain_attention`` (the expanded form),
    or, with ``absorb`` (``cfg.mla_absorb``), scores q's latent ``q_nope @
    w_uk`` and its RoPE part against [ckv, key] as one kv head and maps
    ``probs @ ckv`` through ``w_uv`` (the absorbed form); both are plain
    attention, as in the reference. ``absorb`` is an attribute, so one
    model serves both forms."""

    def __init__(self, cfg: ModelConfig, p: Dict[str, torch.Tensor],
                 window: Optional[int] = None):
        super().__init__()
        self.n_heads = cfg.n_heads
        self.nope, self.rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        self.v_dim, self.rank = cfg.v_head_dim, cfg.kv_lora_rank
        self.rope_theta = cfg.rope_theta
        self.window = window
        self.absorb = cfg.mla_absorb
        # the CPU path's chunked attention; the reference's MLA takes no
        # causal_skip
        self.chunks = dict(q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk)
        self.wq, self.wo = Dense(p["wq"]), Dense(p["wo"])
        for n in ("w_dkv", "kv_norm", "w_uk", "w_uv"):
            setattr(self, n, nn.Parameter(p[n], requires_grad=False))

    def _expand(self, ckv: torch.Tensor, krope: torch.Tensor):
        """Per-head k (..., H, nope + rope) and v (..., H, vd) from the latent
        ckv (..., R) and the shared key krope (..., 1, rope)."""
        H, lead = self.n_heads, ckv.shape[:-1]
        k_nope = sharded.split_last(dense(ckv, self.w_uk), H, self.nope)
        v = sharded.split_last(dense(ckv, self.w_uv), H, self.v_dim)
        k = torch.cat([k_nope, krope.expand(*lead, H, self.rope)], dim=-1)
        return k, v

    def forward(self, x: torch.Tensor, pos0: int = 0, mode: str = "train",
                cache: Optional[Dict[str, torch.Tensor]] = None,
                cache_len: Optional[int] = None):
        """Returns (out, new_cache); new_cache is None in train mode.

        prefill: attention over the whole prompt, and rings of ``cache_len``
        slots (default S) of ckv and the RoPE key. decode (S == 1): both are
        written in place at slot ``pos0 % C`` of ``cache``, which is
        returned, then the query attends over the ring. ``pos0`` is a host
        int."""
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} not in {MODES}")
        B, S, _ = x.shape
        H, nope, rope, vd, R = self.n_heads, self.nope, self.rope, self.v_dim, self.rank
        positions = pos0 + torch.arange(S, device=x.device)

        q = sharded.split_last(self.wq(x), H, nope + rope)
        q_nope = q[..., :nope]
        q_rope = apply_rope(q[..., nope:], positions, self.rope_theta)
        q = torch.cat([q_nope, q_rope], dim=-1)

        dkv = dense(x, self.w_dkv)                               # (B, S, R + rope)
        ckv = apply_norm(dkv[..., :R], self.kv_norm)
        krope = apply_rope(dkv[..., R:][:, :, None, :], positions,
                           self.rope_theta)                      # (B, S, 1, rope)

        scale = (nope + rope) ** -0.5
        new_cache = None
        if mode == "decode":
            ckv_c = ring_write_step(cache["ckv"], ckv[:, 0], pos0)
            kr_c = ring_write_step(cache["krope"], krope[:, 0, 0], pos0)
            new_cache = {"ckv": ckv_c, "krope": kr_c}
            kv_pos = slot_positions(pos0, ckv_c.shape[1], device=x.device)
            if self.absorb:
                q_lat = torch.einsum("bqhn,rhn->bqhr", q_nope,
                                     sharded.split_last(self.w_uk, H, nope))
                q_cat = torch.cat([q_lat, q_rope], dim=-1)          # (B, 1, H, R + rope)
                k_cat = torch.cat([ckv_c, kr_c], dim=-1)[:, :, None, :]   # (B, C, 1, R + rope)
                out_lat = ac.plain_attention(
                    q_cat, k_cat, ckv_c[:, :, None, :], q_positions=positions,
                    kv_positions=kv_pos, causal=True, window=self.window,
                    logit_scale=scale)                              # (B, 1, H, R)
                out = torch.einsum("bqhr,rhv->bqhv", out_lat, sharded.split_last(self.w_uv, H, vd))
            else:
                k, v = self._expand(ckv_c, kr_c[:, :, None, :])
                out = ac.plain_attention(q, k, v, q_positions=positions,
                                         kv_positions=kv_pos, causal=True,
                                         window=self.window, logit_scale=scale)
        else:
            k, v = self._expand(ckv, krope)
            out = ac.attention(q, k, v, q_positions=positions, kv_positions=positions,
                               causal=True, window=self.window, logit_scale=scale,
                               **self.chunks)
            if mode == "prefill":
                C = cache_len if cache_len is not None else S
                new_cache = {"ckv": ring_from_prefill(ckv, C),
                             "krope": ring_from_prefill(krope[:, :, 0], C)}
        return self.wo(out.reshape(B, S, H * vd)), new_cache
