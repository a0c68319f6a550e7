"""phi3-medium-14b [dense] — RoPE, SwiGLU, GQA (kv=10). [arXiv:2404.14219]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    source="arXiv:2404.14219 (Phi-3 Technical Report)",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17_920,
    vocab_size=100_352,
    head_dim=128,
    rope_theta=10_000.0,
    norm="rmsnorm",
    mlp_act="swiglu",
))
