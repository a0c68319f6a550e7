"""Every model family of the JAX package in PyTorch (port of
``repro.models``): dense, Mamba-1 SSM, Griffin hybrid, mixture of experts
(with MLA), and the cross-attention families vlm and audio."""
from repro_torch.models.model import (CausalLM, DenseLM, cache_axes,
                                      decode_step, enc_stack_defs, forward_logits,
                                      forward_train, init_cache, lm_loss, prefill,
                                      stack_defs)
from repro_torch.models.params import (abstract_params, assign_params, export_grads,
                                       export_params, init, load_jax_params, n_params,
                                       param_axes, param_tree, plan_model, set_trainable)

__all__ = ["CausalLM", "DenseLM", "cache_axes", "decode_step", "enc_stack_defs",
           "forward_logits", "forward_train", "init_cache", "lm_loss", "prefill",
           "stack_defs", "assign_params", "export_grads", "export_params", "init",
           "load_jax_params", "param_tree", "plan_model", "set_trainable",
           "abstract_params", "n_params", "param_axes"]
