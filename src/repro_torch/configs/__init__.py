"""Model configurations ported so far: the dense family (qwen2-0.5b,
qwen3-0.6b, starcoder2-3b, phi3-medium-14b), the Mamba-1 SSM family
(falcon-mamba-7b), the Griffin hybrid family (recurrentgemma-2b) and the
mixture-of-experts family (mixtral-8x22b, and deepseek-v2-lite-16b with
MLA attention)."""
from repro_torch.configs import (deepseek_v2_lite_16b, falcon_mamba_7b, mixtral_8x22b,
                                 phi3_medium_14b, qwen2_0_5b, qwen3_0_6b, recurrentgemma_2b,
                                 starcoder2_3b)
from repro_torch.configs.base import ModelConfig, get_config, register

ALL_ARCHS = (qwen2_0_5b.CONFIG.name, falcon_mamba_7b.CONFIG.name,
             recurrentgemma_2b.CONFIG.name, qwen3_0_6b.CONFIG.name,
             starcoder2_3b.CONFIG.name, phi3_medium_14b.CONFIG.name,
             mixtral_8x22b.CONFIG.name, deepseek_v2_lite_16b.CONFIG.name)

__all__ = ["ModelConfig", "get_config", "register", "ALL_ARCHS"]
