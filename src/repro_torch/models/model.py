"""Model assembly (port of ``repro.models.model``) for the dense family.

``DenseLM`` holds the embedding, one ``nn.ModuleList`` of ``Block``s per
stack (dense models have one stack, ``main``) and the final norm. It is
built from a flat mapping of tensors in the JAX package's layout — leaf
paths ``tok_embed``, ``final_norm/scale``, ``stacks/main/blk/attn/wq``, ...,
stacked leaves with the layer on dim 0 — so one constructor serves both
``params.init`` and ``params.load_jax_params``.

Serving runs ``prefill`` (the prompt, building one ring KV cache per
layer) and then ``decode_step`` per token. The cache tree mirrors the
reference's: {stack: {sub: {"k", "v": (layers, B, C, HK, Dh)}}}.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
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

    def _trunk(self, x: torch.Tensor, *, mode: str, pos0: int = 0,
               caches=None, total_len: Optional[int] = None):
        """Every block in order, then the final norm. Returns (h, caches):
        None in train mode, the rings built in prefill, the (in place
        updated) ``caches`` in decode."""
        new_caches = {"train": None, "prefill": {}, "decode": caches}[mode]
        for s in stack_defs(self.cfg):
            (sub,) = s.subs
            window = _sub_window(self.cfg, sub)
            clen = None
            if mode == "prefill" and total_len is not None:
                clen = min(total_len, window) if window else total_len
            stack_cache = None if caches is None else caches[s.name][sub.name]
            layers = []
            for i, blk in enumerate(self.stacks[s.name]):
                c = None if stack_cache is None else {n: t[i] for n, t in stack_cache.items()}
                x, nc = blk(x, pos0=pos0, mode=mode, cache=c, cache_len=clen)
                layers.append(nc)
            if mode == "prefill":
                new_caches[s.name] = {sub.name: {
                    n: torch.stack([c[n] for c in layers]) for n in ("k", "v")}}
        return self.final_norm(x), new_caches

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.head(self._trunk(self.embed(tokens), mode="train")[0])

    def prefill(self, tokens: torch.Tensor, total_len: Optional[int] = None):
        """tokens (B, S) -> (logits of the last position (B, V), caches).
        Each stack's rings hold ``min(total_len, window)`` slots (or
        ``total_len``, default S) for the decode steps that follow."""
        total = total_len if total_len is not None else tokens.shape[1]
        h, caches = self._trunk(self.embed(tokens), mode="prefill",
                                total_len=total)
        return self.head(h[:, -1]), caches

    def decode_step(self, caches, token: torch.Tensor, pos: int):
        """token (B,) at position ``pos`` (a host int: the number of tokens
        already cached) -> (logits (B, V), caches). The rings of ``caches``
        are written in place, and the same tree is returned: a caller that
        wants to keep the cache it passed clones it first."""
        pos = int(pos)
        h, caches = self._trunk(self.embed(token[:, None]), mode="decode",
                                pos0=pos, caches=caches)
        return self.head(h[:, 0]), caches


def forward_logits(cfg: ModelConfig, model: DenseLM, batch) -> torch.Tensor:
    """Full-sequence logits. batch: {"tokens": (B, S) int}."""
    return model(batch["tokens"])


def prefill(cfg: ModelConfig, model: DenseLM, batch, total_len: Optional[int] = None):
    """batch: {"tokens": (B, S) int} -> (last-position logits (B, V), caches);
    see ``DenseLM.prefill``."""
    return model.prefill(batch["tokens"], total_len)


def decode_step(cfg: ModelConfig, model: DenseLM, caches, token, pos):
    """token: (B,) int; pos: host int (tokens already cached). Writes the
    rings of ``caches`` in place; see ``DenseLM.decode_step``."""
    return model.decode_step(caches, token, pos)


# --------------------------------------------------------------------------
# cache trees: {stack: {sub: {"k", "v": (layers, B, C, HK, Dh)}}}
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, B: int, seq_len: int, dtype=None,
               device: DeviceLike = None):
    """Zero rings (every slot empty) for ``seq_len`` positions, windowed
    stacks capped at their window."""
    dev = resolve_device(device)
    dtype = dtype if dtype is not None else cfg.cdtype
    Dh, HK = cfg.resolved_head_dim, cfg.n_kv_heads
    caches = {}
    for s in stack_defs(cfg):
        (sub,) = s.subs
        window = _sub_window(cfg, sub)
        C = min(window, seq_len) if window else seq_len
        caches[s.name] = {sub.name: {
            n: torch.zeros((s.length, B, C, HK, Dh), dtype=dtype, device=dev)
            for n in ("k", "v")}}
    return caches


def cache_axes(cfg: ModelConfig):
    """Logical axis names of every cache leaf, in ``init_cache``'s tree."""
    axes = ("layers", "batch", "kv_cache_seq", "kv_heads", None)
    return {s.name: {sub.name: {"k": axes, "v": axes} for sub in s.subs}
            for s in stack_defs(cfg)}
