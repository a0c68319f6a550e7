"""Model configurations ported so far: the dense family (qwen2-0.5b), the
Mamba-1 SSM family (falcon-mamba-7b) and the Griffin hybrid family
(recurrentgemma-2b)."""
from repro_torch.configs import falcon_mamba_7b, qwen2_0_5b, recurrentgemma_2b
from repro_torch.configs.base import ModelConfig, get_config, register

ALL_ARCHS = (qwen2_0_5b.CONFIG.name, falcon_mamba_7b.CONFIG.name,
             recurrentgemma_2b.CONFIG.name)

__all__ = ["ModelConfig", "get_config", "register", "ALL_ARCHS"]
