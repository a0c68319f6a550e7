"""falcon-mamba-7b [ssm] — attention-free Mamba-1. [arXiv:2410.05355]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    source="arXiv:2410.05355 (Falcon Mamba)",
    n_layers=64,
    d_model=4096,
    n_heads=1,           # unused (attention-free)
    n_kv_heads=1,
    d_ff=0,              # mamba block replaces the MLP
    vocab_size=65_024,
    ssm=True,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    use_rope=False,
    norm="rmsnorm",
))
