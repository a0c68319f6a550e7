"""Model configuration system (PyTorch port of ``repro.configs.base``).

The same ``ModelConfig`` dataclass with every field of the reference, so a
configuration compares field by field across the two packages. ``pdtype``
and ``cdtype`` return torch dtypes. Every family runs in the port
(``repro_torch.models.model.check_ported`` raises for flags that do not
match the family).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    if name not in _TORCH_DTYPES:
        raise ValueError(f"unknown dtype {name!r}; known: {sorted(_TORCH_DTYPES)}")
    return _TORCH_DTYPES[name]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # -- identity -----------------------------------------------------------
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    source: str = ""                 # citation (arXiv id / model card)

    # -- trunk --------------------------------------------------------------
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 32000
    head_dim: Optional[int] = None   # default: d_model // n_heads
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    mlp_act: str = "swiglu"          # swiglu | gelu | geglu
    tie_embeddings: bool = False

    # -- attention ----------------------------------------------------------
    rope_theta: float = 10_000.0
    use_rope: bool = True
    qkv_bias: bool = False           # qwen2-style QKV bias
    qk_norm: bool = False            # qwen3-style per-head RMSNorm on q,k
    sliding_window: Optional[int] = None   # SWA window; None = full attention
    attn_bias: bool = False          # bias on all attn projections (whisper)

    # -- MLA (deepseek-v2) ----------------------------------------------------
    use_mla: bool = False
    kv_lora_rank: int = 512
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128
    mla_absorb: bool = False

    # -- MoE ------------------------------------------------------------------
    moe: bool = False
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    moe_impl: str = "einsum"
    moe_chunk: int = 1024

    # -- SSM (mamba-1) ----------------------------------------------------------
    ssm: bool = False
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: Optional[int] = None

    # -- hybrid (RG-LRU, recurrentgemma) -----------------------------------
    block_pattern: Tuple[str, ...] = ()
    lru_width: Optional[int] = None
    local_window: int = 2048

    # -- encoder-decoder (whisper) ------------------------------------------
    enc_dec: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 1500

    # -- VLM (llama-3.2-vision) ----------------------------------------------
    cross_attn_every: int = 0
    n_media_tokens: int = 0

    # -- numerics -------------------------------------------------------------
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 1024
    attn_causal_skip: bool = False
    train_remat: bool = True
    fsdp: bool = False

    # -- EdgeRL execution-profile metadata -------------------------------------
    versions: Tuple[str, ...] = ("bf16", "w8", "w4")

    # ------------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // self.n_heads

    @property
    def resolved_dt_rank(self) -> int:
        if self.dt_rank is not None:
            return self.dt_rank
        return -(-self.d_model // 16)

    @property
    def resolved_lru_width(self) -> int:
        return self.lru_width if self.lru_width is not None else self.d_model

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind of the decoder trunk: "attn", "rec" (RG-LRU),
        "ssm" (mamba) or "xattn" (cross-attention)."""
        if self.ssm:
            return ("ssm",) * self.n_layers
        if self.block_pattern:
            p = self.block_pattern
            return tuple(p[i % len(p)] for i in range(self.n_layers))
        if self.cross_attn_every:
            return tuple("xattn" if (i + 1) % self.cross_attn_every == 0
                         else "attn" for i in range(self.n_layers))
        return ("attn",) * self.n_layers

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: <=2 layers (per stack), d_model<=512, <=4 experts."""
        kw = dict(
            n_layers=max(2, min(2, self.n_layers)),
            d_model=min(self.d_model, 256),
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, 2),
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            head_dim=64 if self.resolved_head_dim >= 64 else self.resolved_head_dim,
            param_dtype="float32",
            compute_dtype="float32",
        )
        if self.moe:
            kw.update(
                n_experts=min(self.n_experts, 4),
                top_k=min(self.top_k, 2),
                moe_d_ff=min(self.moe_d_ff, 256),
                first_dense_layers=min(self.first_dense_layers, 1),
                capacity_factor=float(self.n_experts) / max(self.top_k, 1),
            )
        if self.use_mla:
            kw.update(kv_lora_rank=64, qk_rope_head_dim=16,
                      qk_nope_head_dim=32, v_head_dim=32)
        if self.ssm:
            kw.update(ssm_state=8, dt_rank=16)
        if self.block_pattern:
            kw.update(n_layers=max(2, len(self.block_pattern)),
                      lru_width=min(self.resolved_lru_width, 256),
                      local_window=64)
        if self.enc_dec:
            kw.update(n_encoder_layers=2, encoder_seq=16)
        if self.cross_attn_every:
            kw.update(n_layers=4, cross_attn_every=2, n_media_tokens=8)
        if self.sliding_window is not None:
            kw.update(sliding_window=min(self.sliding_window, 64))
        return self.with_overrides(**kw)


_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    from repro_torch.configs import ALL_ARCHS  # noqa: F401  (registration)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]

