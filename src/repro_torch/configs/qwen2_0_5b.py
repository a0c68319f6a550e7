"""qwen2-0.5b [dense] — GQA (kv=2), QKV bias. [arXiv:2407.10671]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    source="arXiv:2407.10671 (Qwen2 Technical Report)",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151_936,
    head_dim=64,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    norm="rmsnorm",
    mlp_act="swiglu",
    tie_embeddings=True,
))
