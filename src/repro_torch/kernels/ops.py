"""The models' entry to the kernels, dispatched by the tensor's device.

A CUDA tensor goes to the hand-written kernel, always: a kernel that does
not build or launch raises. A CPU tensor goes to the kernel's plain
PyTorch version. There is no switch that turns the kernels off on the card.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.kernels.quant_matmul import quant_matmul
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.quant.quantize import QTensor, quantize_act


def quantized_dense(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """Dense projection against a quantized weight.

    w8a8 leaves quantize the activations per row and run the int8 x int8
    product; weight-only leaves (w8wo, packed w4) dequantize to f32 and use
    the plain matmul, as the JAX package does (it has no kernel for them).
    """
    if w.act_bits == 8 and w.bits == 8:
        xq, xs = quantize_act(x)
        lead = x.shape[:-1]
        args = (xq.reshape(-1, x.shape[-1]), w.q, xs.reshape(-1),
                w.scale.reshape(-1))
        out = quant_matmul(*args) if x.is_cuda else ref.quant_matmul_ref(*args)
        return out.reshape(*lead, -1).to(x.dtype)
    return x @ w.dequantize().to(x.dtype)


def attention_bhsd(q, k, v, *, causal=True, window=None, logit_scale=None):
    """(B,H,S,D) attention: the flash kernel on CUDA, its plain version on
    the CPU."""
    if q.is_cuda:
        return flash_attention(q, k, v, causal=causal, window=window,
                               logit_scale=logit_scale)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   logit_scale=logit_scale)


def decode_attention(q_bhd, k_cache, v_cache, pos, *, window=None,
                     logit_scale=None):
    """Single-token ring-cache attention. q: (B,H,Dh); caches (B,HK,C,Dh);
    pos: host int. The flash decode kernel on CUDA, its plain version on
    the CPU."""
    if q_bhd.is_cuda:
        return flash_decode(q_bhd, k_cache, v_cache, pos, window=window,
                            logit_scale=logit_scale)
    return ref.flash_decode_ref(q_bhd, k_cache, v_cache, pos, window=window,
                                logit_scale=logit_scale)


def mamba_scan_full(u, dt, Bm, Cm, a_log, d_skip):
    """Selective scan with the D-skip. u, dt: (B, S, DI); Bm, Cm: (B, S, N);
    a_log: (DI, N); d_skip: (DI,). u is scanned in f32, as the reference
    casts it: the scan kernel on CUDA, its plain version on the CPU. Returns
    (y + u * d_skip in u's dtype, h_final (B, DI, N) f32)."""
    A = -torch.exp(a_log.to(torch.float32))
    uf = u.to(torch.float32)
    if uf.is_cuda:
        y, h = mamba_scan(uf, dt, Bm, Cm, A)
    else:
        y, h = ref.mamba_scan_ref(uf, dt, Bm, Cm, A)
    return (y + uf * d_skip).to(u.dtype), h


def rglru_scan_full(a, gx):
    """Diagonal recurrence h_t = a_t * h_{t-1} + gx_t from h = 0. a, gx:
    (B, S, W) f32. The scan kernel on CUDA, its plain version on the CPU.
    Returns (h_seq (B, S, W) f32, h_last (B, W) f32)."""
    if a.is_cuda:
        return rglru_scan(a, gx)
    return ref.rglru_scan_ref(a, gx)
