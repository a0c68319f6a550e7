"""RG-LRU recurrent mixer (port of ``repro.models.rglru``, Griffin /
RecurrentGemma).

Two branches from the input: (i) a linear map and a tanh GeLU gate, (ii) a
linear map, the causal conv and the RG-LRU recurrence; merged
multiplicatively and projected back. The recurrence (Griffin eqs. 1-4):

    r_t = sigmoid(W_a x_t + b_a)          recurrence gate
    i_t = sigmoid(W_x x_t + b_x)          input gate
    log a_t = -c * softplus(Lambda) * r_t  (a = diag, c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Train and prefill run the recurrence over the whole sequence through
``ops.rglru_scan_full``: the CUDA kernel on the card, its plain version on
the CPU. Decode is one conv step and one recurrence step against the
{conv, lru} state, as the reference runs it.

The five projections (``w_gate_branch``, ``w_rec_branch``, ``w_a``, ``w_x``,
``w_out``) are plain matmuls, not ``Dense`` leaves, so ``quantize_tree``
leaves them in float, as the reference's does.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import causal_conv1d, causal_conv1d_step, gelu
from repro_torch.models.ssm import softplus

MODES = ("train", "prefill", "decode")
LRU_C = 8.0
LEAVES = ("w_gate_branch", "w_rec_branch", "conv_w", "conv_b", "w_a", "b_a",
          "w_x", "b_x", "lam", "w_out")


class RecMixer(nn.Module):
    """``p`` holds one layer's tensors under the reference's leaf names
    (``LEAVES``); ``lam`` is f32."""

    def __init__(self, cfg: ModelConfig, p: Dict[str, torch.Tensor]):
        super().__init__()
        for name in LEAVES:
            setattr(self, name, nn.Parameter(p[name], requires_grad=False))

    def gates(self, u: torch.Tensor):
        """u: (B, T, w) post-conv activations -> (a, gx), f32."""
        r = torch.sigmoid(u @ self.w_a + self.b_a).to(torch.float32)
        i = torch.sigmoid(u @ self.w_x + self.b_x).to(torch.float32)
        a = torch.exp(-LRU_C * softplus(self.lam.to(torch.float32)) * r)
        gx = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * u.to(torch.float32))
        return a, gx

    def forward(self, x: torch.Tensor, *, mode: str = "train",
                cache: Optional[Dict[str, torch.Tensor]] = None):
        """x: (B, S, d). Returns (out, new_cache); new_cache is None in train
        mode. prefill builds {"conv": (B, K-1, w), the last K-1 pre-conv
        inputs, left-padded with zeros when S < K-1; "lru": (B, w), the last
        state in x's dtype}. decode (S == 1) steps from ``cache`` and writes
        the new state into its tensors in place, returning the same dict."""
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} not in {MODES}")
        B, S, _ = x.shape
        gate = gelu(x @ self.w_gate_branch)
        u = x @ self.w_rec_branch
        new_cache = None
        if mode == "decode":
            u_t, conv_state = causal_conv1d_step(u[:, 0], cache["conv"],
                                                 self.conv_w, self.conv_b)
            a, gx = self.gates(u_t[:, None])
            h = a[:, 0] * cache["lru"].to(torch.float32) + gx[:, 0]
            y = h[:, None].to(x.dtype)
            cache["conv"].copy_(conv_state)
            cache["lru"].copy_(h)
            new_cache = cache
        else:
            a, gx = self.gates(causal_conv1d(u, self.conv_w, self.conv_b))
            y, h_last = ops.rglru_scan_full(a, gx)
            y = y.to(x.dtype)
            if mode == "prefill":
                K = self.conv_w.shape[0]
                pad = u.new_zeros((B, max(0, (K - 1) - S), u.shape[-1]))
                new_cache = {"conv": torch.cat([pad, u[:, -(K - 1):]], dim=1),
                             "lru": h_last.to(x.dtype)}
        return (y * gate) @ self.w_out, new_cache
