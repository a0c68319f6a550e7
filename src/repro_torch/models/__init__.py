"""Every model family of the JAX package in PyTorch (port of
``repro.models``): dense, Mamba-1 SSM, Griffin hybrid, mixture of experts
(with MLA), and the cross-attention families vlm and audio."""
from repro_torch.models.model import (CausalLM, DenseLM, cache_axes,
                                      decode_step, enc_stack_defs, forward_logits,
                                      init_cache, prefill, stack_defs)
from repro_torch.models.params import (export_params, init, load_jax_params,
                                       plan_model)

__all__ = ["CausalLM", "DenseLM", "cache_axes", "decode_step", "enc_stack_defs",
           "forward_logits", "init_cache", "prefill", "stack_defs",
           "export_params", "init", "load_jax_params", "plan_model"]
