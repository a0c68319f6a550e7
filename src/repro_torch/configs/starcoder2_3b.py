"""starcoder2-3b [dense] — GQA (kv=2), RoPE. [arXiv:2402.19173]

StarCoder2-3B uses layernorm + gelu MLP and attention biases.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="starcoder2-3b",
    family="dense",
    source="arXiv:2402.19173 (StarCoder 2)",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    d_ff=12_288,
    vocab_size=49_152,
    head_dim=128,
    rope_theta=100_000.0,
    qkv_bias=True,
    attn_bias=True,
    norm="layernorm",
    mlp_act="gelu",
    sliding_window=4096,     # starcoder2 trains with 4k sliding window
))
