"""Dense transformer, Mamba-1 SSM and Griffin hybrid models in PyTorch
(port of ``repro.models``)."""
from repro_torch.models.model import (CausalLM, DenseLM, cache_axes,
                                      decode_step, forward_logits, init_cache,
                                      prefill, stack_defs)
from repro_torch.models.params import (export_params, init, load_jax_params,
                                       plan_model)

__all__ = ["CausalLM", "DenseLM", "cache_axes", "decode_step",
           "forward_logits", "init_cache", "prefill", "stack_defs",
           "export_params", "init", "load_jax_params", "plan_model"]
