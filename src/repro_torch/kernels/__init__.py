"""Hand-written CUDA kernels for Hopper (sm_90a), one per TPU kernel of the
JAX package that the port's path runs, each beside its plain PyTorch
version (ref.py) and reached through ops.py:

  flash_attention — online-softmax attention, GQA + causal + sliding window
  flash_decode    — one-token GQA attention over a ring KV cache
  quant_matmul    — int8 x int8 -> int32 matmul with f32 rescale
  mamba_scan      — Mamba-1 selective scan, state in f32
  rglru_scan      — the RG-LRU diagonal linear recurrence, in f32

Sources live in csrc/; _build.py compiles them at first use.
"""
