"""PyTorch + CUDA port of the EdgeRL reproduction (``repro``).

Module paths mirror ``repro``: ``repro_torch.models.attention`` is the
counterpart of ``repro.models.attention``. The port imports torch and
numpy, never JAX and nothing of ``repro``. Its entry points run on the CUDA
card unless the caller passes ``device="cpu"``; every TPU kernel on the
ported path is a hand-written CUDA kernel (``repro_torch.kernels``).

Ported so far, for the dense qwen2-0.5b, qwen3-0.6b, starcoder2-3b and
phi3-medium-14b, the Mamba-1 falcon-mamba-7b and the Griffin hybrid
recurrentgemma-2b: EdgeRL split serving
(``SplitServingEngine``) in its bf16, w8 and w4 versions, and decode
serving (``ServingEngine``, ``ContinuousBatchingServer``,
``launch.serve``) over ring KV caches and recurrent states. And the
controller (``repro_torch.core``): profiles, the pricing core under torch
and numpy, the EdgeEnv MDP, the A2C agent, the baselines and static
policies, and the paper's closed loop (``launch.split_serving``), in which
the trained controller's (version, cut) decisions are served by
``SplitServingEngine``.
"""
