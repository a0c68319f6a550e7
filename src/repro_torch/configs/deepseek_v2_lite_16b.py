"""deepseek-v2-lite-16b [moe] — MLA (kv_lora=512), 2 shared + 64 routed top-6.

Assignment header says "MoE 64e top-6" while the bracket note says
"2 shared+160 routed" (which is full DeepSeek-V2); we follow the primary
numbers and the published V2-Lite card: 64 routed experts, top-6, 2 shared,
per-expert FFN 1408, first layer dense. [arXiv:2405.04434]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    source="arXiv:2405.04434 (DeepSeek-V2)",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,               # routed-expert hidden size (per assignment)
    vocab_size=102_400,
    use_mla=True,
    kv_lora_rank=512,
    qk_rope_head_dim=64,
    qk_nope_head_dim=128,
    v_head_dim=128,
    moe=True,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    first_dense_layers=1,
    rope_theta=10_000.0,
    norm="rmsnorm",
    mlp_act="swiglu",
))
