"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention.

[arXiv:2401.04088]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    source="arXiv:2401.04088 (Mixtral of Experts)",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16_384,             # per-expert hidden size
    vocab_size=32_768,
    head_dim=128,
    moe=True,
    n_experts=8,
    n_shared_experts=0,
    top_k=2,
    moe_d_ff=16_384,
    sliding_window=4096,
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    mlp_act="swiglu",
))
