"""Model assembly (port of ``repro.models.model``) for the dense and the
Mamba-1 SSM families.

``CausalLM`` holds the embedding, one ``nn.ModuleList`` of blocks per stack
(both families have one stack, ``main``: ``attn`` blocks for dense models,
``ssm`` blocks for falcon-mamba), the final norm and, for an untied head,
the ``lm_head`` projection. It is built from a flat mapping of tensors in
the JAX package's layout — leaf paths ``tok_embed``, ``final_norm/scale``,
``stacks/main/blk/attn/wq``, ..., stacked leaves with the layer on dim 0 —
so one constructor serves both ``params.init`` and
``params.load_jax_params``. ``DenseLM`` is the same class under the name it
had while only dense models ran.

Serving runs ``prefill`` (the prompt, building one cache per layer) and
then ``decode_step`` per token. The cache tree mirrors the reference's:
{stack: {sub: {"k", "v": (layers, B, C, HK, Dh)}}} for attention rings,
{stack: {sub: {"conv": (layers, B, K-1, di), "ssm": (layers, B, di, N)}}}
for the recurrent state. Decode updates either in place.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.blocks import build_block
from repro_torch.models.layers import Dense, RMSNorm


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
    """Raise NotImplementedError unless the port runs every feature of
    ``cfg``: a dense model with qwen2-0.5b's features (GQA, QKV bias, RoPE,
    RMSNorm, SwiGLU, tied embeddings, optional sliding window), or a
    Mamba-1 model with falcon-mamba's (RMSNorm, no attention, no RoPE, no
    MLP, tied or untied head)."""
    families = (("moe", cfg.moe), ("hybrid", bool(cfg.block_pattern)),
                ("vlm", bool(cfg.cross_attn_every)), ("audio", cfg.enc_dec),
                ("MLA", cfg.use_mla))
    missing = [name for name, on in families if on]
    if cfg.family not in ("dense", "ssm"):
        missing.insert(0, cfg.family)
    elif cfg.ssm != (cfg.family == "ssm"):
        missing.insert(0, f"family={cfg.family} with ssm={cfg.ssm}")
    features = [("norm=" + cfg.norm, cfg.norm != "rmsnorm")]
    if not cfg.ssm:
        features += [("qk_norm", cfg.qk_norm), ("attn_bias", cfg.attn_bias),
                     ("mlp_act=" + cfg.mlp_act, cfg.mlp_act != "swiglu"),
                     ("untied lm_head", not cfg.tie_embeddings),
                     ("use_rope=False", not cfg.use_rope)]
    missing += [name for name, on in features if on]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: not ported to repro_torch yet: {', '.join(missing)}")


def stack_defs(cfg: ModelConfig) -> Tuple[StackDef, ...]:
    """Decoder trunk stacks, in execution order (one ``main`` stack)."""
    check_ported(cfg)
    kind = "ssm" if cfg.ssm else "attn"
    return (StackDef("main", cfg.n_layers, (Sub("blk", kind),)),)


def _sub_window(cfg: ModelConfig, sub: Sub) -> Optional[int]:
    return cfg.sliding_window if sub.kind == "attn" else None


class CausalLM(nn.Module):
    def __init__(self, cfg: ModelConfig, flat: Dict[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        self.tok_embed = nn.Parameter(flat["tok_embed"], requires_grad=False)
        self.final_norm = RMSNorm(flat["final_norm/scale"])
        self.lm_head = None if cfg.tie_embeddings else Dense(flat["lm_head"])
        self.stacks = nn.ModuleDict()
        for s in stack_defs(cfg):
            (sub,) = s.subs
            prefix = f"stacks/{s.name}/{sub.name}/"
            leaves = {k[len(prefix):]: v for k, v in flat.items()
                      if k.startswith(prefix)}
            self.stacks[s.name] = nn.ModuleList(
                build_block(cfg, sub.kind, {k: v[i] for k, v in leaves.items()},
                            window=_sub_window(cfg, sub))
                for i in range(s.length))

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return F.embedding(tokens, self.tok_embed).to(self.cfg.cdtype)

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """Tied head: ``h @ tok_embed.T`` (a plain matmul, as the JAX package
        leaves this einsum to XLA). Untied: the ``lm_head`` projection, a
        ``Dense`` leaf that w8/w4 quantize (w8 runs it through
        ``quant_matmul``)."""
        if self.lm_head is None:
            return h @ self.tok_embed.to(h.dtype).T
        return self.lm_head(h)

    def _trunk(self, x: torch.Tensor, *, mode: str, pos0: int = 0,
               caches=None, total_len: Optional[int] = None):
        """Every block in order, then the final norm. Returns (h, caches):
        None in train mode, the caches built in prefill, the (in place
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
                    n: torch.stack([c[n] for c in layers]) for n in layers[0]}}
        return self.final_norm(x), new_caches

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.head(self._trunk(self.embed(tokens), mode="train")[0])

    def prefill(self, tokens: torch.Tensor, total_len: Optional[int] = None):
        """tokens (B, S) -> (logits of the last position (B, V), caches).
        Each attention stack's rings hold ``min(total_len, window)`` slots
        (or ``total_len``, default S) for the decode steps that follow; an
        ssm stack keeps its conv tail and scan state whatever ``total_len``."""
        total = total_len if total_len is not None else tokens.shape[1]
        h, caches = self._trunk(self.embed(tokens), mode="prefill",
                                total_len=total)
        return self.head(h[:, -1]), caches

    def decode_step(self, caches, token: torch.Tensor, pos: int):
        """token (B,) at position ``pos`` (a host int: the number of tokens
        already cached) -> (logits (B, V), caches). The rings (or conv and
        scan states) of ``caches`` are written in place, and the same tree is
        returned: a caller that wants to keep the cache it passed clones it
        first."""
        pos = int(pos)
        h, caches = self._trunk(self.embed(token[:, None]), mode="decode",
                                pos0=pos, caches=caches)
        return self.head(h[:, 0]), caches


DenseLM = CausalLM


def forward_logits(cfg: ModelConfig, model: CausalLM, batch) -> torch.Tensor:
    """Full-sequence logits. batch: {"tokens": (B, S) int}."""
    return model(batch["tokens"])


def prefill(cfg: ModelConfig, model: CausalLM, batch, total_len: Optional[int] = None):
    """batch: {"tokens": (B, S) int} -> (last-position logits (B, V), caches);
    see ``CausalLM.prefill``."""
    return model.prefill(batch["tokens"], total_len)


def decode_step(cfg: ModelConfig, model: CausalLM, caches, token, pos):
    """token: (B,) int; pos: host int (tokens already cached). Writes the
    caches in place; see ``CausalLM.decode_step``."""
    return model.decode_step(caches, token, pos)


# --------------------------------------------------------------------------
# cache trees: {stack: {sub: {leaf: (layers, B, ...)}}}
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, B: int, seq_len: int, dtype=None,
               device: DeviceLike = None):
    """Zero caches: rings with every slot empty for ``seq_len`` positions
    (windowed stacks capped at their window), or zero conv and scan states."""
    dev = resolve_device(device)
    dtype = dtype if dtype is not None else cfg.cdtype
    Dh, HK = cfg.resolved_head_dim, cfg.n_kv_heads
    caches = {}
    for s in stack_defs(cfg):
        (sub,) = s.subs
        if sub.kind == "ssm":
            shapes = {"conv": (cfg.ssm_conv - 1, cfg.d_inner),
                      "ssm": (cfg.d_inner, cfg.ssm_state)}
        else:
            window = _sub_window(cfg, sub)
            C = min(window, seq_len) if window else seq_len
            shapes = {"k": (C, HK, Dh), "v": (C, HK, Dh)}
        caches[s.name] = {sub.name: {
            n: torch.zeros((s.length, B) + shape, dtype=dtype, device=dev)
            for n, shape in shapes.items()}}
    return caches


def cache_axes(cfg: ModelConfig):
    """Logical axis names of every cache leaf, in ``init_cache``'s tree."""
    def block(kind):
        if kind == "ssm":
            return {"conv": ("layers", "batch", None, "inner"),
                    "ssm": ("layers", "batch", "inner", None)}
        axes = ("layers", "batch", "kv_cache_seq", "kv_heads", None)
        return {"k": axes, "v": axes}
    return {s.name: {sub.name: block(sub.kind) for sub in s.subs}
            for s in stack_defs(cfg)}
