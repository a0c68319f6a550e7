"""The models' entry to the kernels, dispatched by the tensor's device.

A CUDA tensor goes to the hand-written kernel, always: a kernel that does
not build or launch raises. A CPU tensor goes to the kernel's plain
PyTorch version. There is no switch that turns the kernels off on the card.
A DTensor (a sharded model's) goes to ``kernels.sharded``, which calls back
here with its local shards.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref, sharded
from repro_torch.kernels.flash_attention import FlashAttentionFn, flash_attention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.mamba_scan import MambaScanFn, mamba_scan
from repro_torch.kernels.quant_matmul import quant_matmul
from repro_torch.kernels.rglru_scan import RglruScanFn, rglru_scan
from repro_torch.quant.quantize import QTensor, quantize_act


def quantized_dense(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """Dense projection against a quantized weight.

    w8a8 leaves quantize the activations per row and run the int8 x int8
    product; weight-only leaves (w8wo, packed w4) dequantize to f32 and use
    the plain matmul, as the JAX package does (it has no kernel for them).
    A DTensor x runs on its row shards against the whole weight.
    """
    if sharded.is_dtensor(x):
        return sharded.rows_call(x, lambda xl: quantized_dense(xl, w))
    if w.act_bits == 8 and w.bits == 8:
        xq, xs = quantize_act(x)
        lead = x.shape[:-1]
        args = (xq.reshape(-1, x.shape[-1]), w.q, xs.reshape(-1),
                w.scale.reshape(-1))
        out = quant_matmul(*args) if x.is_cuda else ref.quant_matmul_ref(*args)
        return out.reshape(*lead, -1).to(x.dtype)
    return x @ w.dequantize().to(x.dtype)


def _under_grad(*ts) -> bool:
    """Autograd will need these tensors' gradient: grad mode is on and one
    of them requires it."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def attention_bhsd(q, k, v, *, causal=True, window=None, logit_scale=None):
    """(B,H,S,D) attention: the flash kernel on CUDA, its plain version on
    the CPU. On CUDA under autograd (grad enabled and an operand that
    requires it) ``FlashAttentionFn`` runs the forward kernel with its
    log-sum-exp and, in the backward, the backward kernel; otherwise the
    forward kernel alone. On the CPU autograd differentiates the plain
    version."""
    if sharded.is_dtensor(q):
        return sharded.attention(q, k, v, lambda ql, kl, vl: attention_bhsd(
            ql, kl, vl, causal=causal, window=window, logit_scale=logit_scale))
    if q.is_cuda:
        if _under_grad(q, k, v):
            return FlashAttentionFn.apply(q, k, v, causal, window, logit_scale)
        return flash_attention(q, k, v, causal=causal, window=window,
                               logit_scale=logit_scale)
    return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                   logit_scale=logit_scale)


def decode_attention(q_bhd, k_cache, v_cache, pos, *, window=None,
                     logit_scale=None):
    """Single-token ring-cache attention. q: (B,H,Dh); caches (B,HK,C,Dh);
    pos: host int. The flash decode kernel on CUDA, its plain version on
    the CPU."""
    if sharded.is_dtensor(q_bhd):
        return sharded.attention(q_bhd, k_cache, v_cache, lambda ql, kl, vl: (
            decode_attention(ql, kl, vl, pos, window=window, logit_scale=logit_scale)))
    if q_bhd.is_cuda:
        return flash_decode(q_bhd, k_cache, v_cache, pos, window=window,
                            logit_scale=logit_scale)
    return ref.flash_decode_ref(q_bhd, k_cache, v_cache, pos, window=window,
                                logit_scale=logit_scale)


def mamba_scan_full(u, dt, Bm, Cm, a_log, d_skip):
    """Selective scan with the D-skip. u, dt: (B, S, DI); Bm, Cm: (B, S, N);
    a_log: (DI, N); d_skip: (DI,). u is scanned in f32, as the reference
    casts it: the scan kernel on CUDA, its plain version on the CPU. On CUDA
    under autograd ``MambaScanFn`` runs the forward kernel with its
    chunk-start states and, in the backward, the backward kernel; otherwise
    the forward kernel alone. On the CPU autograd differentiates the plain
    version. Returns (y + u * d_skip in u's dtype, h_final (B, DI, N) f32).
    DTensor operands run on their batch or channel shards."""
    if any(sharded.is_dtensor(t) for t in (u, dt, Bm, Cm, a_log, d_skip)):
        return sharded.channel_scan(
            (u, dt), (a_log, d_skip), (Bm, Cm),
            lambda s, c, r: mamba_scan_full(s[0], s[1], r[0], r[1], c[0], c[1]),
            ({0: 0, 2: 2}, {0: 0, 2: 1}))
    A = -torch.exp(a_log.to(torch.float32))
    uf = u.to(torch.float32)
    if uf.is_cuda:
        if _under_grad(uf, dt, Bm, Cm, A):
            y, h = MambaScanFn.apply(uf, dt, Bm, Cm, A)
        else:
            y, h = mamba_scan(uf, dt, Bm, Cm, A)
    else:
        y, h = ref.mamba_scan_ref(uf, dt, Bm, Cm, A)
    return (y + uf * d_skip).to(u.dtype), h


def rglru_scan_full(a, gx):
    """Diagonal recurrence h_t = a_t * h_{t-1} + gx_t from h = 0. a, gx:
    (B, S, W) f32. The scan kernel on CUDA, its plain version on the CPU. On
    CUDA under autograd ``RglruScanFn`` runs the forward kernel and, in the
    backward, the backward kernel. Returns (h_seq (B, S, W) f32, h_last (B,
    W) f32). DTensor operands run on their batch or channel shards."""
    if sharded.is_dtensor(a) or sharded.is_dtensor(gx):
        return sharded.channel_scan((a, gx), (), (), lambda s, c, r: rglru_scan_full(*s),
                                    ({0: 0, 2: 2}, {0: 0, 2: 1}))
    if a.is_cuda:
        if _under_grad(a, gx):
            return RglruScanFn.apply(a, gx)
        return rglru_scan(a, gx)
    return ref.rglru_scan_ref(a, gx)
