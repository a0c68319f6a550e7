"""Plain PyTorch versions of the hand-written kernels.

They run the same function as the CUDA kernels with ordinary tensor ops.
The CPU path of the port uses them, the tests compare them with the JAX
package, and ``chip_smoke.py`` holds each kernel against them on the card.
"""
from __future__ import annotations

import torch


def flash_attention_ref(q, k, v, *, causal=True, window=None,
                        logit_scale=None):
    """q: (B,H,Sq,D); k: (B,HK,Skv,D); v: (B,HK,Skv,Dv) -> (B,H,Sq,Dv)
    [kernel layout]. v's head dim may differ from q's and k's (MLA's 192
    and 128): the output has Dv columns and the default scale is D ** -0.5
    of q's D, as ``plain_attention`` computes them.

    GQA: query head h reads kv head h % HK (plain_attention's grouping)."""
    # imported here (and in flash_decode_ref): models -> kernels.ops -> the
    # kernel wrappers -> this module
    from repro_torch.models.attention_core import plain_attention

    out = plain_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        q_positions=torch.arange(q.shape[2], device=q.device),
        kv_positions=torch.arange(k.shape[2], device=k.device),
        causal=causal, window=window, logit_scale=logit_scale)
    return out.transpose(1, 2)


def flash_decode_ref(q, k, v, pos, *, window=None, logit_scale=None):
    """q: (B,H,Dh); k,v: (B,HK,C,Dh) ring caches; pos: int -> (B,H,Dv).

    One query at position ``pos`` over the ring: slot s holds position
    ``slot_positions(pos, C)[s]``, empty (negative) slots and slots outside
    the window are masked. The current token must already be written at
    slot ``pos % C``. GQA: query head h reads kv head h % HK."""
    from repro_torch.models.attention import slot_positions
    from repro_torch.models.attention_core import plain_attention

    out = plain_attention(
        q[:, None], k.transpose(1, 2), v.transpose(1, 2),
        q_positions=torch.tensor([pos], device=q.device),
        kv_positions=slot_positions(pos, k.shape[2], device=k.device),
        causal=True, window=window, logit_scale=logit_scale)
    return out[:, 0]


def quant_matmul_ref(x_q, w_q, x_scale, w_scale):
    """x_q (M,K) int8, w_q (K,N) int8, x_scale (M,), w_scale (N,) ->
    f32 (M,N) = (x_q @ w_q) * x_scale[:,None] * w_scale[None,:].

    The integer product is exact: every partial sum is an integer below
    2**53, so a float64 matmul (which runs on CPU and CUDA alike) gives the
    int32 accumulator of the JAX reference bit for bit."""
    acc = (x_q.to(torch.float64) @ w_q.to(torch.float64)).to(torch.int32)
    return (acc.to(torch.float32)
            * x_scale.reshape(-1, 1) * w_scale.reshape(1, -1))


def mamba_scan_ref(u, dt, Bm, Cm, A, h0=None):
    """Mamba-1 selective scan, the plain sequential recurrence.

    u, dt: (B, S, DI); Bm, Cm: (B, S, N); A: (DI, N) (= -exp(a_log)); h0:
    an optional (B, DI, N) start state (default zero). Per step, in f32:
    h <- exp(dt * A) * h + (dt * u) (x) B, then y_t = sum_n h * C_t. No
    D-skip (``ops.mamba_scan_full`` adds it). Returns (y (B, S, DI) in u's
    dtype, h_final (B, DI, N) f32)."""
    B, S, DI = u.shape
    uf, dtf = u.to(torch.float32), dt.to(torch.float32)
    h = (torch.zeros((B, DI, A.shape[1]), dtype=torch.float32, device=u.device)
         if h0 is None else h0.to(torch.float32))
    ys = []
    for t in range(S):
        dA = torch.exp(dtf[:, t, :, None] * A)                   # (B, DI, N)
        h = dA * h + (dtf[:, t] * uf[:, t])[..., None] * Bm[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cm[:, t]))
    return torch.stack(ys, dim=1).to(u.dtype), h


def rglru_scan_ref(a, gx, h0=None):
    """Diagonal linear recurrence h_t = a_t * h_{t-1} + gx_t.

    a, gx: (B, S, W) f32; h0: an optional (B, W) start state (default zero),
    folded into the first step as the reference does. Returns (h_seq, h_last).
    An associative scan, as the reference's: log2(S) rounds of the combine
    (a1, b1), (a2, b2) -> (a2 * a1, a2 * b1 + b2) over doubling offsets."""
    if h0 is not None:
        gx = torch.cat([gx[:, :1] + a[:, :1] * h0[:, None], gx[:, 1:]], dim=1)
    S, off = a.shape[1], 1
    while off < S:
        gx = torch.cat([gx[:, :off], a[:, off:] * gx[:, :-off] + gx[:, off:]], dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return gx, gx[:, -1]
