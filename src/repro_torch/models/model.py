"""Model assembly (port of ``repro.models.model``) for the dense, the
Mamba-1 SSM, the Griffin hybrid and the mixture-of-experts families.

``CausalLM`` holds the embedding, one ``nn.ModuleList`` of steps per stack,
the final norm and, for an untied head, the ``lm_head`` projection. A step
is a ``SuperBlock``: one block per sub of the stack, in order, as the
reference scans a superblock. Dense and ssm models have one stack, ``main``,
of one sub ``blk`` (``attn`` or ``ssm`` blocks); recurrentgemma has a
``period`` stack of (s0 rec, s1 rec, s2 attn) steps and a ``tail`` of
``rec`` steps; an MoE model has a ``dense0`` stack of its
``first_dense_layers`` dense layers, if any, then a ``main`` stack whose
``attn`` blocks hold the experts in place of the MLP. The model is built
from a flat mapping of tensors in the JAX package's layout (leaf paths
``tok_embed``, ``final_norm/scale``, ``stacks/main/blk/attn/wq``,
``stacks/period/s0/rec/w_a``, ..., stacked leaves with the step on dim
0), so one constructor serves both
``params.init`` and ``params.load_jax_params``. ``DenseLM`` is the same
class under the name it had while only dense models ran.

Serving runs ``prefill`` (the prompt, building one cache per layer) and
then ``decode_step`` per token. The cache tree mirrors the reference's:
{stack: {sub: {"k", "v": (steps, B, C, HK, Dh)}}} for attention rings
(MLA's {"ckv": (steps, B, C, R), "krope": (steps, B, C, rope)}),
{stack: {sub: {"conv": (steps, B, K-1, di), "ssm": (steps, B, di, N)}}} for
the Mamba state and {stack: {sub: {"conv": (steps, B, K-1, w), "lru":
(steps, B, w)}}} for the RG-LRU state. Decode updates every leaf in place.
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
from repro_torch.models.layers import Dense, build_norm


@dataclasses.dataclass(frozen=True)
class Sub:
    name: str
    kind: str
    repeat: int = 1
    moe: bool = False


@dataclasses.dataclass(frozen=True)
class StackDef:
    name: str
    length: int
    subs: Tuple[Sub, ...]


def check_ported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError unless the port runs every feature of
    ``cfg``: a dense model (GQA, QKV and o biases, qwen3's per-head q/k
    norm, RoPE or none, RMSNorm or LayerNorm, SwiGLU, GeGLU or the plain
    gelu MLP with its biases, a tied or untied head, head_dim apart from
    d_model / n_heads, an optional sliding window), a Mamba-1 model with
    falcon-mamba's features, a Griffin hybrid with recurrentgemma's (a
    block pattern of ``rec`` and ``attn`` blocks, local attention, the
    Gemma embedding scale), or a mixture-of-experts model (top-k routed
    experts with capacity, shared experts, leading dense layers), with GQA
    or MLA attention. The vlm and audio families are not ported yet, and
    each is refused by name."""
    families = (("vlm", bool(cfg.cross_attn_every)), ("audio", cfg.enc_dec))
    missing = [name for name, on in families if on]
    if cfg.family not in ("dense", "ssm", "hybrid", "moe"):
        missing.insert(0, cfg.family)
    elif cfg.moe != (cfg.family == "moe"):
        missing.insert(0, f"family={cfg.family} with moe={cfg.moe}")
    elif cfg.ssm != (cfg.family == "ssm"):
        missing.insert(0, f"family={cfg.family} with ssm={cfg.ssm}")
    elif bool(cfg.block_pattern) != (cfg.family == "hybrid"):
        missing.insert(0, f"family={cfg.family} with block_pattern={cfg.block_pattern}")
    missing += [f"block kind {k!r}" for k in sorted(set(cfg.block_pattern))
                if k not in ("rec", "attn")]
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: not ported to repro_torch yet: {', '.join(missing)}")


def stack_defs(cfg: ModelConfig) -> Tuple[StackDef, ...]:
    """Decoder trunk stacks, in execution order: one ``main`` stack of one
    sub for dense and ssm models; for a block pattern, a ``period`` stack
    whose step holds one sub per kind of the pattern (s0, s1, ...), then
    the remainder layers as a ``tail`` stack (one kind) or as ``tail0``,
    ``tail1``, ... of one layer each (mixed kinds); for an MoE model, a
    ``dense0`` stack of ``first_dense_layers`` dense layers (when there are
    any), then ``main`` of MoE layers."""
    check_ported(cfg)
    L = cfg.n_layers
    if cfg.ssm:
        return (StackDef("main", L, (Sub("blk", "ssm"),)),)
    if cfg.block_pattern:
        p = cfg.block_pattern
        n_per, n_full = len(p), L // len(p)
        defs = [StackDef("period", n_full,
                         tuple(Sub(f"s{i}", p[i]) for i in range(n_per)))]
        rem_kinds = p[:L - n_full * n_per]
        if len(set(rem_kinds)) == 1:
            defs.append(StackDef("tail", len(rem_kinds), (Sub("blk", rem_kinds[0]),)))
        else:
            defs += [StackDef(f"tail{i}", 1, (Sub("blk", k),))
                     for i, k in enumerate(rem_kinds)]
        return tuple(defs)
    if cfg.moe:
        dense0 = cfg.first_dense_layers
        return ((StackDef("dense0", dense0, (Sub("blk", "attn"),)),) if dense0 else ()) + (
            StackDef("main", L - dense0, (Sub("blk", "attn", 1, True),)),)
    return (StackDef("main", L, (Sub("blk", "attn"),)),)


def _sub_window(cfg: ModelConfig, sub: Sub) -> Optional[int]:
    if sub.kind != "attn":
        return None
    return cfg.local_window if cfg.block_pattern else cfg.sliding_window


def _cache_len(window: Optional[int], total_len: Optional[int]) -> Optional[int]:
    """Ring slots of a prefill's cache: ``total_len``, capped at the window."""
    if total_len is None:
        return None
    return min(total_len, window) if window else total_len


def _strip(p: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    """The entries of ``p`` under ``prefix``, keyed without it."""
    return {k[len(prefix):]: v for k, v in p.items() if k.startswith(prefix)}


def _layer(tree, i: int):
    """Layer ``i`` of every leaf of a {sub: {leaf: (layers, ...)}} tree, as
    views."""
    return {sub: {n: t[i] for n, t in leaves.items()} for sub, leaves in tree.items()}


class SuperBlock(nn.Module):
    """One step of a stack: one block per sub, run in order, each under the
    sub's name. ``p`` holds the step's tensors keyed ``<sub>/<block leaf>``.
    A cut between two steps is a legal split point; a step is never cut."""

    def __init__(self, cfg: ModelConfig, sdef: StackDef, p: Dict[str, torch.Tensor]):
        super().__init__()
        self.names = tuple(sub.name for sub in sdef.subs)
        self.windows = {sub.name: _sub_window(cfg, sub) for sub in sdef.subs}
        for sub in sdef.subs:
            self.add_module(sub.name, build_block(cfg, sub.kind, _strip(p, f"{sub.name}/"),
                                                  window=self.windows[sub.name], moe=sub.moe))

    def forward(self, x: torch.Tensor, *, pos0: int = 0, mode: str = "train",
                cache=None, total_len: Optional[int] = None):
        """Returns (x, {sub: new_cache}); ``cache`` is {sub: {leaf: tensor}}
        or None."""
        new_cache = {}
        for name in self.names:
            x, new_cache[name] = getattr(self, name)(
                x, pos0=pos0, mode=mode, cache=None if cache is None else cache[name],
                cache_len=_cache_len(self.windows[name], total_len) if mode == "prefill" else None)
        return x, new_cache


class CausalLM(nn.Module):
    def __init__(self, cfg: ModelConfig, flat: Dict[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        self.tok_embed = nn.Parameter(flat["tok_embed"], requires_grad=False)
        # the Gemma convention: embeddings times sqrt(d_model), rounded to
        # the compute dtype first, as the reference does
        self.register_buffer("embed_scale", torch.tensor(
            cfg.d_model ** 0.5, dtype=cfg.cdtype, device=flat["tok_embed"].device)
            if cfg.family == "hybrid" else None, persistent=False)
        self.final_norm = build_norm(flat, "final_norm")
        self.lm_head = None if cfg.tie_embeddings else Dense(flat["lm_head"])
        self.stacks = nn.ModuleDict()
        for s in stack_defs(cfg):
            leaves = _strip(flat, f"stacks/{s.name}/")
            self.stacks[s.name] = nn.ModuleList(
                SuperBlock(cfg, s, {k: v[i] for k, v in leaves.items()})
                for i in range(s.length))

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        x = F.embedding(tokens, self.tok_embed).to(self.cfg.cdtype)
        return x if self.embed_scale is None else x * self.embed_scale

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
        """Every step of every stack in order, then the final norm. Returns
        (h, caches): None in train mode, the caches built in prefill, the (in
        place updated) ``caches`` in decode."""
        new_caches = {"train": None, "prefill": {}, "decode": caches}[mode]
        for s in stack_defs(self.cfg):
            steps = []
            for i, step in enumerate(self.stacks[s.name]):
                c = None if caches is None else _layer(caches[s.name], i)
                x, nc = step(x, pos0=pos0, mode=mode, cache=c, total_len=total_len)
                steps.append(nc)
            if mode == "prefill":
                new_caches[s.name] = {
                    sub: {n: torch.stack([c[sub][n] for c in steps]) for n in leaves}
                    for sub, leaves in steps[0].items()}
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

def _cache_shapes(cfg: ModelConfig, sub: Sub, seq_len: int):
    """{leaf: shape without (layers, B)} of one sub's cache."""
    if sub.kind == "ssm":
        return {"conv": (cfg.ssm_conv - 1, cfg.d_inner),
                "ssm": (cfg.d_inner, cfg.ssm_state)}
    if sub.kind == "rec":
        w = cfg.resolved_lru_width
        return {"conv": (cfg.ssm_conv - 1, w), "lru": (w,)}
    C = _cache_len(_sub_window(cfg, sub), seq_len)
    if cfg.use_mla:
        return {"ckv": (C, cfg.kv_lora_rank), "krope": (C, cfg.qk_rope_head_dim)}
    Dh, HK = cfg.resolved_head_dim, cfg.n_kv_heads
    return {"k": (C, HK, Dh), "v": (C, HK, Dh)}


def init_cache(cfg: ModelConfig, B: int, seq_len: int, dtype=None,
               device: DeviceLike = None):
    """Zero caches: rings with every slot empty for ``seq_len`` positions
    (windowed subs capped at their window), or zero conv and recurrent
    states."""
    dev = resolve_device(device)
    dtype = dtype if dtype is not None else cfg.cdtype
    return {s.name: {sub.name: {
        n: torch.zeros((s.length, B) + shape, dtype=dtype, device=dev)
        for n, shape in _cache_shapes(cfg, sub, seq_len).items()} for sub in s.subs}
        for s in stack_defs(cfg)}


_CACHE_AXES = {
    "ssm": {"conv": ("layers", "batch", None, "inner"),
            "ssm": ("layers", "batch", "inner", None)},
    "rec": {"conv": ("layers", "batch", None, "lru"), "lru": ("layers", "batch", "lru")},
    "attn": {"k": ("layers", "batch", "kv_cache_seq", "kv_heads", None),
             "v": ("layers", "batch", "kv_cache_seq", "kv_heads", None)},
    "mla": {"ckv": ("layers", "batch", "kv_cache_seq", None),
            "krope": ("layers", "batch", "kv_cache_seq", None)},
}


def cache_axes(cfg: ModelConfig):
    """Logical axis names of every cache leaf, in ``init_cache``'s tree."""
    def kind(sub):
        return "mla" if cfg.use_mla and sub.kind == "attn" else sub.kind
    return {s.name: {sub.name: dict(_CACHE_AXES[kind(sub)]) for sub in s.subs}
            for s in stack_defs(cfg)}
