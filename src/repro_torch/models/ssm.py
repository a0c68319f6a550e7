"""Mamba-1 selective SSM mixer (port of ``repro.models.ssm``, falcon-mamba).

Train and prefill run the selective scan over the whole sequence through
``ops.mamba_scan_full``: the CUDA kernel on the card, its plain version on
the CPU. Decode is one conv step and one recurrence step against the
{conv, ssm} state, with the plain recurrence, as the reference runs it.

The four projections (``in_proj``, ``x_proj``, ``dt_proj``, ``out_proj``)
are plain matmuls, not ``Dense`` leaves, so ``quantize_tree`` leaves them
in float, as the reference's does.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.models.layers import causal_conv1d, causal_conv1d_step, dense

MODES = ("train", "prefill", "decode")
LEAVES = ("in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias",
          "a_log", "d_skip", "out_proj")


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * sigmoid(x)."""
    return x * torch.sigmoid(x)


class SSMMixer(nn.Module):
    """in_proj -> causal conv -> SiLU -> selective scan (+ D-skip), gated by
    SiLU(z), -> out_proj. ``p`` holds one layer's tensors under the
    reference's leaf names (``LEAVES``); ``a_log`` and ``d_skip`` are f32."""

    def __init__(self, cfg: ModelConfig, p: Dict[str, torch.Tensor]):
        super().__init__()
        self.d_inner, self.n_state = cfg.d_inner, cfg.ssm_state
        self.dt_rank = cfg.resolved_dt_rank
        for name in LEAVES:
            setattr(self, name, nn.Parameter(p[name], requires_grad=False))

    def ssm_params(self, u: torch.Tensor):
        """u: (B, T, di) post-conv activations -> (dt, Bm, Cm), f32. Bm and
        Cm are slices of the x_proj output (strided views)."""
        r, n = self.dt_rank, self.n_state
        xdbc = dense(u, self.x_proj)                                   # (B, T, r + 2n)
        dt = softplus(dense(xdbc[..., :r], self.dt_proj) + self.dt_bias).to(torch.float32)
        return dt, xdbc[..., r:r + n].to(torch.float32), xdbc[..., r + n:].to(torch.float32)

    def ssm_scan_chunked(self, u: torch.Tensor, h0: Optional[torch.Tensor] = None):
        """The plain selective scan with the D-skip, from state ``h0``
        (default zero). u: (B, S, di). Returns (y in u's dtype, h_final f32).
        The reference's chunks only regroup the same sequential steps, so
        one loop over S computes what it computes."""
        A = -torch.exp(self.a_log.to(torch.float32))
        dt, Bm, Cm = self.ssm_params(u)
        uf = u.to(torch.float32)
        y, h = ref.mamba_scan_ref(uf, dt, Bm, Cm, A, h0=h0)
        return (y + uf * self.d_skip).to(u.dtype), h

    def forward(self, x: torch.Tensor, *, mode: str = "train",
                cache: Optional[Dict[str, torch.Tensor]] = None):
        """x: (B, S, d). Returns (out, new_cache); new_cache is None in train
        mode. prefill builds {"conv": (B, K-1, di), the last K-1 pre-conv
        inputs, left-padded with zeros when S < K-1; "ssm": (B, di, N)}.
        decode (S == 1) steps from ``cache`` and writes the new state into
        its tensors in place, returning the same dict."""
        if mode not in MODES:
            raise ValueError(f"mode {mode!r} not in {MODES}")
        B, S, _ = x.shape
        di = self.d_inner
        xz = dense(x, self.in_proj)
        xin, z = xz[..., :di], xz[..., di:]
        new_cache = None
        if mode == "decode":
            u_t, conv_state = causal_conv1d_step(xin[:, 0], cache["conv"],
                                                 self.conv_w, self.conv_b)
            y, h = self.ssm_scan_chunked(silu(u_t)[:, None],
                                         h0=cache["ssm"].to(torch.float32))
            cache["conv"].copy_(conv_state)
            cache["ssm"].copy_(h)
            new_cache = cache
        else:
            u = silu(causal_conv1d(xin, self.conv_w, self.conv_b))
            dt, Bm, Cm = self.ssm_params(u)
            y, h = ops.mamba_scan_full(u, dt, Bm, Cm, self.a_log, self.d_skip)
            if mode == "prefill":
                K = self.conv_w.shape[0]
                pad = xin.new_zeros((B, max(0, (K - 1) - S), di))
                new_cache = {"conv": torch.cat([pad, xin[:, -(K - 1):]], dim=1),
                             "ssm": h.to(x.dtype)}
        return dense(y * silu(z), self.out_proj), new_cache
