"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, (rec,rec,attn).

26 layers with repeating (recurrent, recurrent, local-attention) pattern
per the Griffin paper; remainder layers are recurrent. [arXiv:2402.19427]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    source="arXiv:2402.19427 (Griffin / RecurrentGemma)",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab_size=256_000,
    head_dim=256,
    block_pattern=("rec", "rec", "attn"),
    lru_width=2560,
    local_window=2048,
    use_rope=True,
    rope_theta=10_000.0,
    norm="rmsnorm",
    mlp_act="geglu",
    tie_embeddings=True,
))
