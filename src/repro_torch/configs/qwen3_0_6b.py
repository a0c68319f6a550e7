"""qwen3-0.6b [dense] — qk_norm, GQA (kv=8). [hf:Qwen/Qwen3-8B family card]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    source="hf:Qwen/Qwen3-0.6B (Qwen3 family)",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=3072,
    vocab_size=151_936,
    head_dim=128,
    qk_norm=True,
    qkv_bias=False,
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    mlp_act="swiglu",
    tie_embeddings=True,
))
