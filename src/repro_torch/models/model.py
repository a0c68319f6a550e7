"""Model assembly (port of ``repro.models.model``) for every family: dense,
Mamba-1 SSM, Griffin hybrid, mixture of experts, and the cross-attention
families (llama-3.2-vision, vlm; whisper, audio).

``CausalLM`` holds the embedding, one ``nn.ModuleList`` of steps per stack,
the final norm and, for an untied head, the ``lm_head`` projection. A step
is a ``SuperBlock``: one block per sub of the stack, in order, as the
reference scans a superblock. Dense and ssm models have one stack, ``main``,
of one sub ``blk`` (``attn`` or ``ssm`` blocks); recurrentgemma has a
``period`` stack of (s0 rec, s1 rec, s2 attn) steps and a ``tail`` of
``rec`` steps; an MoE model has a ``dense0`` stack of its
``first_dense_layers`` dense layers, if any, then a ``main`` stack whose
``attn`` blocks hold the experts in place of the MLP; a vlm model has a
``period`` stack of (``attn`` x (cross_attn_every - 1), ``xattn``) steps and
a ``tail`` of ``attn`` blocks for the remainder, the repeated ``attn`` sub an
``nn.ModuleList`` inside each step; an audio model has a ``main`` stack of
``dec`` blocks and, in ``enc_stacks``, an ``enc`` stack of the encoder's
bidirectional blocks, with ``enc_norm``. The cross-attention layers read
``kv_src``: the media embeddings (vlm) or the encoder's output over the
frame embeddings (audio), computed from the batch by ``kv_src``. The
model is built from a flat mapping of tensors in the JAX package's layout (leaf paths
``tok_embed``, ``final_norm/scale``, ``stacks/main/blk/attn/wq``,
``stacks/period/s0/rec/w_a``, ..., stacked leaves with the step on dim
0, and a repeated sub's leaves with (step, repeat) on dims 0 and 1), so one
constructor serves both
``params.init`` and ``params.load_jax_params``. ``DenseLM`` is the same
class under the name it had while only dense models ran.

Serving runs ``prefill`` (the prompt, building one cache per layer) and
then ``decode_step`` per token. The cache tree mirrors the reference's:
{stack: {sub: {"k", "v": (steps, B, C, HK, Dh)}}} for attention rings
(MLA's {"ckv": (steps, B, C, R), "krope": (steps, B, C, rope)}),
{stack: {sub: {"conv": (steps, B, K-1, di), "ssm": (steps, B, di, N)}}} for
the Mamba state and {stack: {sub: {"conv": (steps, B, K-1, w), "lru":
(steps, B, w)}}} for the RG-LRU state; a cross-attention layer adds {"xk",
"xv": (steps, B, Skv, HK, Dh)} (an ``xattn`` sub's whole cache, merged with
a ``dec`` block's rings), and a repeated sub's leaves carry (steps, repeat)
in front. Decode updates every ring and state in place and reads the
cross caches.
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
from repro_torch.models.layers import Dense, build_norm, sinusoidal_positions


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
    Gemma embedding scale), a mixture-of-experts model (top-k routed
    experts with capacity, shared experts, leading dense layers) with GQA
    or MLA attention, a vlm model (``cross_attn_every``: gated
    cross-attention layers over media embeddings) or an audio model
    (``enc_dec``: a bidirectional encoder over frame embeddings and a
    decoder with cross-attention, sinusoidal positions). A family whose
    flags do not match it is refused, naming both."""
    flags = (("moe", "moe"), ("ssm", "ssm"), ("hybrid", "block_pattern"),
             ("vlm", "cross_attn_every"), ("audio", "enc_dec"))
    if cfg.family not in ("dense",) + tuple(fam for fam, _ in flags):
        missing = [cfg.family]
    else:
        missing = [f"family={cfg.family} with {attr}={getattr(cfg, attr)}"
                   for fam, attr in flags if bool(getattr(cfg, attr)) != (cfg.family == fam)]
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
    ``tail1``, ... of one layer each (mixed kinds); for a vlm model, a
    ``period`` stack whose step holds ``cross_attn_every - 1`` repeated
    ``attn`` blocks and one ``xattn`` block, then a ``tail`` of ``attn``
    blocks for the remainder; for an audio model, a ``main`` stack of
    ``dec`` blocks; for an MoE model, a ``dense0`` stack of
    ``first_dense_layers`` dense layers (when there are any), then
    ``main`` of MoE layers."""
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
    if cfg.cross_attn_every:
        e = cfg.cross_attn_every
        defs = (StackDef("period", L // e, (Sub("attn", "attn", e - 1), Sub("xattn", "xattn"))),)
        rem = L - (L // e) * e
        return defs + ((StackDef("tail", rem, (Sub("blk", "attn"),)),) if rem else ())
    if cfg.enc_dec:
        return (StackDef("main", L, (Sub("blk", "dec"),)),)
    if cfg.moe:
        dense0 = cfg.first_dense_layers
        return ((StackDef("dense0", dense0, (Sub("blk", "attn"),)),) if dense0 else ()) + (
            StackDef("main", L - dense0, (Sub("blk", "attn", 1, True),)),)
    return (StackDef("main", L, (Sub("blk", "attn"),)),)


def enc_stack_defs(cfg: ModelConfig) -> Tuple[StackDef, ...]:
    """The encoder's stacks (audio only): ``enc`` of ``n_encoder_layers``
    bidirectional blocks."""
    if not cfg.enc_dec:
        return ()
    return (StackDef("enc", cfg.n_encoder_layers, (Sub("blk", "enc"),)),)


def _sub_window(cfg: ModelConfig, sub: Sub) -> Optional[int]:
    if sub.kind == "attn" and cfg.block_pattern:
        return cfg.local_window
    return cfg.sliding_window if sub.kind in ("attn", "dec") else None


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


def _stacked(caches):
    """[{leaf: tensor}] -> {leaf: the tensors stacked on a new dim 0}."""
    return {n: torch.stack([c[n] for c in caches]) for n in caches[0]}


class SuperBlock(nn.Module):
    """One step of a stack: one block per sub, run in order, each under the
    sub's name; a sub of ``repeat > 1`` is an ``nn.ModuleList`` of that many
    blocks, its leaves (and caches) carrying the repeat on dim 0, as the
    reference's inner scan stacks them. ``p`` holds the step's tensors keyed
    ``<sub>/<block leaf>``. A cut between two steps is a legal split point;
    a step is never cut."""

    def __init__(self, cfg: ModelConfig, sdef: StackDef, p: Dict[str, torch.Tensor]):
        super().__init__()
        self.names = tuple(sub.name for sub in sdef.subs)
        self.windows = {sub.name: _sub_window(cfg, sub) for sub in sdef.subs}
        for sub in sdef.subs:
            leaves, kw = _strip(p, f"{sub.name}/"), dict(window=self.windows[sub.name],
                                                         moe=sub.moe)
            self.add_module(sub.name, build_block(cfg, sub.kind, leaves, **kw)
                            if sub.repeat == 1 else nn.ModuleList(
                                build_block(cfg, sub.kind, {k: v[r] for k, v in leaves.items()},
                                            **kw) for r in range(sub.repeat)))

    def forward(self, x: torch.Tensor, *, pos0: int = 0, mode: str = "train",
                cache=None, total_len: Optional[int] = None,
                kv_src: Optional[torch.Tensor] = None):
        """Returns (x, {sub: new_cache}); ``cache`` is {sub: {leaf: tensor}}
        or None; ``kv_src`` goes to every block (the cross-attention ones
        read it)."""
        new_cache = {}
        for name in self.names:
            mod, c = getattr(self, name), None if cache is None else cache[name]
            kw = dict(pos0=pos0, mode=mode, kv_src=kv_src, cache_len=_cache_len(
                self.windows[name], total_len) if mode == "prefill" else None)
            if not isinstance(mod, nn.ModuleList):
                x, new_cache[name] = mod(x, cache=c, **kw)
                continue
            reps = []
            for r, blk in enumerate(mod):
                x, nc = blk(x, cache=None if c is None else {n: t[r] for n, t in c.items()},
                            **kw)
                reps.append(nc)
            # decode wrote the repeats' views of ``c`` in place
            new_cache[name] = _stacked(reps) if mode == "prefill" else c
        return x, new_cache


def _build_stacks(cfg: ModelConfig, defs, flat: Dict[str, torch.Tensor],
                  prefix: str) -> nn.ModuleDict:
    """One ``nn.ModuleList`` of steps per stack of ``defs``, from the leaves
    under ``<prefix>/<stack>/``, step on dim 0."""
    out = nn.ModuleDict()
    for s in defs:
        leaves = _strip(flat, f"{prefix}/{s.name}/")
        out[s.name] = nn.ModuleList(SuperBlock(cfg, s, {k: v[i] for k, v in leaves.items()})
                                    for i in range(s.length))
    return out


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
        self.stacks = _build_stacks(cfg, stack_defs(cfg), flat, "stacks")
        self.enc_stacks = self.enc_norm = None
        if cfg.enc_dec:
            self.enc_stacks = _build_stacks(cfg, enc_stack_defs(cfg), flat, "enc_stacks")
            self.enc_norm = build_norm(flat, "enc_norm")

    def embed(self, tokens: torch.Tensor, pos0: int = 0) -> torch.Tensor:
        """Token embeddings in the compute dtype (times the Gemma scale for
        the hybrid family); an audio model adds the sinusoidal positions of
        ``pos0 .. pos0 + S - 1`` (no RoPE)."""
        cfg = self.cfg
        x = F.embedding(tokens, self.tok_embed).to(cfg.cdtype)
        if self.embed_scale is not None:
            x = x * self.embed_scale
        if cfg.enc_dec:
            x = x + sinusoidal_positions(tokens.shape[1], cfg.d_model, offset=pos0,
                                         device=x.device).to(cfg.cdtype)
        return x

    def encode(self, enc_frames: torch.Tensor) -> torch.Tensor:
        """The audio encoder: frame embeddings (B, S_enc, d) plus their
        sinusoidal positions, through the ``enc`` stack in train mode
        (bidirectional), then ``enc_norm``."""
        cfg = self.cfg
        x = enc_frames.to(cfg.cdtype)
        x = x + sinusoidal_positions(x.shape[1], cfg.d_model, device=x.device).to(cfg.cdtype)
        for s in enc_stack_defs(cfg):
            for step in self.enc_stacks[s.name]:
                x, _ = step(x)
        return self.enc_norm(x)

    def kv_src(self, batch) -> Optional[torch.Tensor]:
        """What the cross-attention layers attend to: the encoder's output
        over ``batch["enc_frames"]`` (audio), ``batch["media"]`` in the
        compute dtype (vlm), else None."""
        if self.cfg.enc_dec:
            return self.encode(batch["enc_frames"])
        if self.cfg.cross_attn_every:
            return batch["media"].to(self.cfg.cdtype)
        return None

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """Tied head: ``h @ tok_embed.T`` (a plain matmul, as the JAX package
        leaves this einsum to XLA). Untied: the ``lm_head`` projection, a
        ``Dense`` leaf that w8/w4 quantize (w8 runs it through
        ``quant_matmul``)."""
        if self.lm_head is None:
            return h @ self.tok_embed.to(h.dtype).T
        return self.lm_head(h)

    def _trunk(self, x: torch.Tensor, *, mode: str, pos0: int = 0,
               caches=None, total_len: Optional[int] = None,
               kv_src: Optional[torch.Tensor] = None):
        """Every step of every stack in order, then the final norm. Returns
        (h, caches): None in train mode, the caches built in prefill, the (in
        place updated) ``caches`` in decode."""
        new_caches = {"train": None, "prefill": {}, "decode": caches}[mode]
        for s in stack_defs(self.cfg):
            steps = []
            for i, step in enumerate(self.stacks[s.name]):
                c = None if caches is None else _layer(caches[s.name], i)
                x, nc = step(x, pos0=pos0, mode=mode, cache=c, total_len=total_len,
                             kv_src=kv_src)
                steps.append(nc)
            if mode == "prefill":
                new_caches[s.name] = {sub: _stacked([c[sub] for c in steps])
                                      for sub in steps[0]}
        return self.final_norm(x), new_caches

    def forward(self, batch) -> torch.Tensor:
        """batch: {"tokens": (B, S) int, and "media" (B, n_media, d) for a
        vlm model or "enc_frames" (B, S_enc, d) for an audio model}, or the
        tokens alone -> logits (B, S, V)."""
        batch = batch if isinstance(batch, dict) else {"tokens": batch}
        h, _ = self._trunk(self.embed(batch["tokens"]), mode="train", kv_src=self.kv_src(batch))
        return self.head(h)

    def prefill(self, batch, total_len: Optional[int] = None):
        """batch (as ``forward`` takes it) -> (logits of the last position
        (B, V), caches). Each attention stack's rings hold ``min(total_len,
        window)`` slots (or ``total_len``, default S) for the decode steps
        that follow; an ssm stack keeps its conv tail and scan state
        whatever ``total_len``; a cross-attention layer keeps its keys and
        values over ``kv_src``."""
        batch = batch if isinstance(batch, dict) else {"tokens": batch}
        tokens = batch["tokens"]
        total = total_len if total_len is not None else tokens.shape[1]
        h, caches = self._trunk(self.embed(tokens), mode="prefill", total_len=total,
                                kv_src=self.kv_src(batch))
        return self.head(h[:, -1]), caches

    def decode_step(self, caches, token: torch.Tensor, pos: int):
        """token (B,) at position ``pos`` (a host int: the number of tokens
        already cached) -> (logits (B, V), caches). The rings (or conv and
        scan states) of ``caches`` are written in place, and the same tree is
        returned: a caller that wants to keep the cache it passed clones it
        first. No ``kv_src``: the cross-attention layers read the prefill's
        {"xk", "xv"}, as in the reference."""
        pos = int(pos)
        h, caches = self._trunk(self.embed(token[:, None], pos0=pos), mode="decode",
                                pos0=pos, caches=caches)
        return self.head(h[:, 0]), caches


DenseLM = CausalLM


def forward_logits(cfg: ModelConfig, model: CausalLM, batch) -> torch.Tensor:
    """Full-sequence logits. batch: {"tokens": (B, S) int} plus "media" or
    "enc_frames" for the cross-attention families."""
    return model(batch)


def prefill(cfg: ModelConfig, model: CausalLM, batch, total_len: Optional[int] = None):
    """batch (as ``forward_logits`` takes it) -> (last-position logits (B,
    V), caches); see ``CausalLM.prefill``."""
    return model.prefill(batch, total_len)


def decode_step(cfg: ModelConfig, model: CausalLM, caches, token, pos):
    """token: (B,) int; pos: host int (tokens already cached). Writes the
    caches in place; see ``CausalLM.decode_step``."""
    return model.decode_step(caches, token, pos)


# --------------------------------------------------------------------------
# cache trees: {stack: {sub: {leaf: (layers, B, ...)}}}
# --------------------------------------------------------------------------

def _lead(s: StackDef, sub: Sub) -> Tuple[int, ...]:
    """The stacking dims in front of a sub's cache leaves: (steps,), and
    (steps, repeat) for a repeated sub."""
    return (s.length,) if sub.repeat == 1 else (s.length, sub.repeat)


def _cache_shapes(cfg: ModelConfig, sub: Sub, seq_len: int):
    """{leaf: shape without (layers, B)} of one sub's cache."""
    if sub.kind == "ssm":
        return {"conv": (cfg.ssm_conv - 1, cfg.d_inner),
                "ssm": (cfg.d_inner, cfg.ssm_state)}
    if sub.kind == "rec":
        w = cfg.resolved_lru_width
        return {"conv": (cfg.ssm_conv - 1, w), "lru": (w,)}
    Dh, HK = cfg.resolved_head_dim, cfg.n_kv_heads
    if sub.kind == "xattn":
        return {"xk": (cfg.n_media_tokens, HK, Dh), "xv": (cfg.n_media_tokens, HK, Dh)}
    C = _cache_len(_sub_window(cfg, sub), seq_len)
    if cfg.use_mla:
        return {"ckv": (C, cfg.kv_lora_rank), "krope": (C, cfg.qk_rope_head_dim)}
    ring = {"k": (C, HK, Dh), "v": (C, HK, Dh)}
    if sub.kind == "dec":
        ring.update(xk=(cfg.encoder_seq, HK, Dh), xv=(cfg.encoder_seq, HK, Dh))
    return ring


def init_cache(cfg: ModelConfig, B: int, seq_len: int, dtype=None,
               device: DeviceLike = None):
    """Zero caches: rings with every slot empty for ``seq_len`` positions
    (windowed subs capped at their window), zero conv and recurrent
    states, zero cross-attention keys and values over the media tokens or
    the encoder's frames."""
    dev = resolve_device(device)
    dtype = dtype if dtype is not None else cfg.cdtype
    return {s.name: {sub.name: {
        n: torch.zeros(_lead(s, sub) + (B,) + shape, dtype=dtype, device=dev)
        for n, shape in _cache_shapes(cfg, sub, seq_len).items()} for sub in s.subs}
        for s in stack_defs(cfg)}


_RING_AXES = {"k": ("batch", "kv_cache_seq", "kv_heads", None),
              "v": ("batch", "kv_cache_seq", "kv_heads", None)}
_CROSS_AXES = {"xk": ("batch", None, "kv_heads", None), "xv": ("batch", None, "kv_heads", None)}
_CACHE_AXES = {
    "ssm": {"conv": ("batch", None, "inner"), "ssm": ("batch", "inner", None)},
    "rec": {"conv": ("batch", None, "lru"), "lru": ("batch", "lru")},
    "attn": _RING_AXES,
    "mla": {"ckv": ("batch", "kv_cache_seq", None), "krope": ("batch", "kv_cache_seq", None)},
    "xattn": _CROSS_AXES,
    "dec": {**_RING_AXES, **_CROSS_AXES},
}


def cache_axes(cfg: ModelConfig):
    """Logical axis names of every cache leaf, in ``init_cache``'s tree: a
    "layers" axis for each stacking dim in front."""
    def kind(sub):
        return "mla" if cfg.use_mla and sub.kind == "attn" else sub.kind
    return {s.name: {sub.name: {n: ("layers",) * len(_lead(s, sub)) + ax
                                for n, ax in _CACHE_AXES[kind(sub)].items()}
                     for sub in s.subs}
            for s in stack_defs(cfg)}


# --------------------------------------------------------------------------
# batches
# --------------------------------------------------------------------------

def zero_cross_inputs(cfg: ModelConfig, B: int, device: DeviceLike = None):
    """The stub inputs of the cross-attention families as the reference's
    serve CLI, scheduler and execute backend feed them: zero media (B,
    n_media_tokens, d) for a vlm model, zero frames (B, encoder_seq, d) for
    an audio model, in the compute dtype; {} for the others."""
    dev = resolve_device(device)
    out = {}
    if cfg.cross_attn_every:
        out["media"] = torch.zeros((B, cfg.n_media_tokens, cfg.d_model), dtype=cfg.cdtype,
                                   device=dev)
    if cfg.enc_dec:
        out["enc_frames"] = torch.zeros((B, cfg.encoder_seq, cfg.d_model), dtype=cfg.cdtype,
                                        device=dev)
    return out


def batch_on(batch, device: torch.device):
    """A model batch on ``device``: the tokens as int64, "media" and
    "enc_frames" (numpy arrays or tensors) as they are, other keys
    dropped."""
    out = {"tokens": torch.as_tensor(batch["tokens"], device=device).long()}
    for key in ("media", "enc_frames"):
        if key in batch:
            out[key] = torch.as_tensor(batch[key], device=device)
    return out
