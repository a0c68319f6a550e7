"""Analytic per-block FLOPs and parameter counts of the transformer
architectures (port of ``repro.core.transformer_cost``; plain Python over
the port's ``ModelConfig``). The EdgeRL transformer profiles
(``core/profiles.py``) are built from them.
"""
from __future__ import annotations

from typing import List

from repro_torch.configs.base import ModelConfig


def _attn_flops(cfg: ModelConfig, seq_ctx: int) -> float:
    d, Dh = cfg.d_model, cfg.resolved_head_dim
    H, HK = cfg.n_heads, cfg.n_kv_heads
    if cfg.use_mla:
        qd = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        proj = 2 * d * H * qd                       # q
        proj += 2 * d * (cfg.kv_lora_rank + cfg.qk_rope_head_dim)
        proj += 2 * cfg.kv_lora_rank * H * (cfg.qk_nope_head_dim
                                            + cfg.v_head_dim)
        proj += 2 * H * cfg.v_head_dim * d          # out
        score = 2 * H * qd * seq_ctx + 2 * H * cfg.v_head_dim * seq_ctx
    else:
        proj = 2 * d * H * Dh + 2 * 2 * d * HK * Dh + 2 * H * Dh * d
        score = 2 * H * Dh * seq_ctx * 2
    return proj + score


def _mlp_flops(cfg: ModelConfig, d_ff: int) -> float:
    mats = 3 if cfg.mlp_act in ("swiglu", "geglu") else 2
    return 2.0 * mats * cfg.d_model * d_ff


def _moe_flops(cfg: ModelConfig) -> float:
    active = cfg.top_k + cfg.n_shared_experts
    return 2.0 * 3 * cfg.d_model * cfg.moe_d_ff * active \
        + 2.0 * cfg.d_model * cfg.n_experts          # router


def _ssm_flops(cfg: ModelConfig) -> float:
    d, di, n, r = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.resolved_dt_rank
    f = 2 * d * 2 * di                 # in_proj
    f += cfg.ssm_conv * di             # conv
    f += 2 * di * (r + 2 * n)          # x_proj
    f += 2 * r * di                    # dt_proj
    f += 6 * di * n                    # scan update + output
    f += 2 * di * d                    # out_proj
    return float(f)


def _rec_flops(cfg: ModelConfig) -> float:
    d, w = cfg.d_model, cfg.resolved_lru_width
    f = 2 * d * w * 2                  # two branches
    f += cfg.ssm_conv * w
    f += 2 * w * w * 2                 # gates
    f += 8 * w                         # recurrence
    f += 2 * w * d                     # out
    return float(f)


def block_flops_per_token(cfg: ModelConfig, seq_ctx: int = None, *,
                          weights_only: bool = False) -> List[float]:
    """FLOPs per token per block, in layer order.

    ``weights_only=True`` zeroes every attention-score context (self,
    cross, media), leaving just the weight-matmul terms, so dividing by 2
    gives a per-block parameter count independent of the profiling shape."""
    ctx = 0 if weights_only else (seq_ctx if seq_ctx is not None else 2048)
    if cfg.sliding_window:
        ctx = min(ctx, cfg.sliding_window)
    enc_ctx = 0 if weights_only else cfg.encoder_seq
    media_ctx = 0 if weights_only else cfg.n_media_tokens
    out = []
    for i, kind in enumerate(cfg.layer_kinds()):
        if kind == "ssm":
            out.append(_ssm_flops(cfg))
        elif kind == "rec":
            out.append(_rec_flops(cfg) + _mlp_flops(cfg, cfg.d_ff))
        elif kind == "xattn":
            out.append(_attn_flops(cfg, media_ctx)
                       + _mlp_flops(cfg, cfg.d_ff))
        elif cfg.enc_dec:
            # decoder block: self-attn + cross-attn(enc) + mlp
            out.append(_attn_flops(cfg, ctx)
                       + _attn_flops(cfg, enc_ctx)
                       + _mlp_flops(cfg, cfg.d_ff))
        else:
            lctx = min(ctx, cfg.local_window) if cfg.block_pattern else ctx
            mlp = (_moe_flops(cfg) if (cfg.moe and i >= cfg.first_dense_layers)
                   else _mlp_flops(cfg, cfg.d_ff if cfg.d_ff else 4 * cfg.d_model))
            out.append(_attn_flops(cfg, lctx) + mlp)
    return out


def block_params(cfg: ModelConfig) -> List[float]:
    """Per-block parameter-count estimate: weight-matmul FLOPs / 2 with
    all attention contexts zeroed. MoE layers count ALL experts: shipping
    or storing a layer moves every expert."""
    out = [f / 2.0 for f in block_flops_per_token(cfg, weights_only=True)]
    if cfg.moe:
        inactive = 3.0 * cfg.d_model * cfg.moe_d_ff \
            * (cfg.n_experts - cfg.top_k)
        for i, kind in enumerate(cfg.layer_kinds()):
            if kind == "attn" and i >= cfg.first_dense_layers:
                out[i] += inactive
    return out


def _attn_proj_flops(cfg: ModelConfig) -> float:
    """Projection-only attention FLOPs that route through the dense layers
    (for MLA only wq/wo)."""
    d, Dh = cfg.d_model, cfg.resolved_head_dim
    H, HK = cfg.n_heads, cfg.n_kv_heads
    if cfg.use_mla:
        qd = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        return 2.0 * d * H * qd + 2.0 * H * cfg.v_head_dim * d
    return 2.0 * d * H * Dh + 2.0 * 2 * d * HK * Dh + 2.0 * H * Dh * d


def block_dense_flops(cfg: ModelConfig) -> List[float]:
    """Per-block FLOPs of the dense-consumed projections: the share that
    executes with quantized weights under a quantized version (attention
    scores, MoE experts and SSM/LRU mixers are not in it)."""
    out = []
    for i, kind in enumerate(cfg.layer_kinds()):
        if kind == "ssm":
            out.append(0.0)                       # mixer is einsum-consumed
        elif kind == "rec":
            out.append(_mlp_flops(cfg, cfg.d_ff))  # mixer excluded, MLP in
        elif kind == "xattn":
            out.append(_attn_proj_flops(cfg) + _mlp_flops(cfg, cfg.d_ff))
        elif cfg.enc_dec:
            out.append(2.0 * _attn_proj_flops(cfg)
                       + _mlp_flops(cfg, cfg.d_ff))
        else:
            moe_layer = cfg.moe and i >= cfg.first_dense_layers
            mlp = 0.0 if moe_layer else _mlp_flops(
                cfg, cfg.d_ff if cfg.d_ff else 4 * cfg.d_model)
            out.append(_attn_proj_flops(cfg) + mlp)
    return out


def active_params(cfg: ModelConfig) -> float:
    """Parameter count with only the active MoE experts (for 6*N_active*D)."""
    from repro_torch.models.params import n_params
    total = float(n_params(cfg))
    if not cfg.moe:
        return total
    n_moe_layers = cfg.n_layers - cfg.first_dense_layers
    expert_params = 3.0 * cfg.d_model * cfg.moe_d_ff * cfg.n_experts \
        * n_moe_layers
    active_frac = cfg.top_k / cfg.n_experts
    return total - expert_params * (1.0 - active_frac)


def model_flops(cfg: ModelConfig, kind: str, batch: int, seq: int) -> float:
    """MODEL_FLOPS of the roofline: 6*N*D to train, 2*N*D to infer."""
    n = active_params(cfg)
    if kind == "train":
        return 6.0 * n * batch * seq
    if kind == "prefill":
        return 2.0 * n * batch * seq
    return 2.0 * n * batch          # decode: one token per sequence
