"""llama-3.2-vision-90b [vlm] — cross-attn image layers every 5th slot.

100 layers total = 80 self-attention decoder layers + 20 gated
cross-attention layers. The ViT vision tower + projector is a STUB:
``input_specs`` supplies precomputed patch embeddings (n_media_tokens,
d_model). [hf:meta-llama/Llama-3.2-11B-Vision scaled per 90B card]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    source="hf:meta-llama/Llama-3.2-90B-Vision",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28_672,
    vocab_size=128_256,
    head_dim=128,
    rope_theta=500_000.0,
    cross_attn_every=5,
    n_media_tokens=1601,    # one image tile: (448/14)^2 + 1 cls
    norm="rmsnorm",
    mlp_act="swiglu",
))
