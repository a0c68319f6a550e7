"""Model configurations of the port: the dense family (qwen2-0.5b,
qwen3-0.6b, starcoder2-3b, phi3-medium-14b), the Mamba-1 SSM family
(falcon-mamba-7b), the Griffin hybrid family (recurrentgemma-2b) and the
mixture-of-experts family (mixtral-8x22b, and deepseek-v2-lite-16b with
MLA attention), and the cross-attention families (llama-3.2-vision-90b, vlm;
whisper-large-v3, audio): every configuration of the JAX package."""
from repro_torch.configs import (deepseek_v2_lite_16b, falcon_mamba_7b,
                                 llama_3_2_vision_90b, mixtral_8x22b, phi3_medium_14b,
                                 qwen2_0_5b, qwen3_0_6b, recurrentgemma_2b, starcoder2_3b,
                                 whisper_large_v3)
from repro_torch.configs.base import ModelConfig, get_config, register

ALL_ARCHS = (qwen2_0_5b.CONFIG.name, falcon_mamba_7b.CONFIG.name,
             recurrentgemma_2b.CONFIG.name, qwen3_0_6b.CONFIG.name,
             starcoder2_3b.CONFIG.name, phi3_medium_14b.CONFIG.name,
             mixtral_8x22b.CONFIG.name, deepseek_v2_lite_16b.CONFIG.name,
             llama_3_2_vision_90b.CONFIG.name, whisper_large_v3.CONFIG.name)

__all__ = ["ModelConfig", "get_config", "register", "ALL_ARCHS"]
