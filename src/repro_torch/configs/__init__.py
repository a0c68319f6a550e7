"""Model configurations ported so far (the dense family: qwen2-0.5b)."""
from repro_torch.configs import qwen2_0_5b
from repro_torch.configs.base import ModelConfig, get_config, register

ALL_ARCHS = (qwen2_0_5b.CONFIG.name,)

__all__ = ["ModelConfig", "get_config", "register", "ALL_ARCHS"]
