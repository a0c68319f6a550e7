"""Plain PyTorch versions of the hand-written kernels.

They run the same function as the CUDA kernels with ordinary tensor ops.
The CPU path of the port uses them, the tests compare them with the JAX
package, and ``chip_smoke.py`` holds each kernel against them on the card.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor


def flash_attention_ref(q, k, v, *, causal=True, window=None,
                        logit_scale=None, with_lse=False):
    """q: (B,H,Sq,D); k: (B,HK,Skv,D); v: (B,HK,Skv,Dv) -> (B,H,Sq,Dv)
    [kernel layout]. v's head dim may differ from q's and k's (MLA's 192
    and 128): the output has Dv columns and the default scale is D ** -0.5
    of q's D, as ``plain_attention`` computes them. With ``with_lse`` also
    each query row's log-sum-exp of its scaled, masked scores, (B,H,Sq)
    f32: the forward kernel's second output.

    GQA: query head h reads kv head h % HK (plain_attention's grouping)."""
    # imported here (and in flash_decode_ref): models -> kernels.ops -> the
    # kernel wrappers -> this module
    from repro_torch.models.attention_core import plain_attention

    out = plain_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        q_positions=torch.arange(q.shape[2], device=q.device),
        kv_positions=torch.arange(k.shape[2], device=k.device),
        causal=causal, window=window, logit_scale=logit_scale).transpose(1, 2)
    if not with_lse:
        return out
    s, vis, _ = _scores(q, k, causal, window, logit_scale)
    return out, torch.logsumexp(torch.where(vis, s, NEG_INF), dim=-1)


NEG_INF = -1e30


def _acc(t):
    """The type the plain backward computes in: f32, or f64 for f64 inputs
    (the oracle that measures both f32 versions' rounding)."""
    return torch.promote_types(t.dtype, torch.float32)


def _scores(q, k, causal, window, logit_scale):
    """The scaled scores (B,H,Sq,Skv) in f32 (f64 for f64 inputs), query head
    h against kv head h % HK, their visibility (Sq,Skv) (query i at position
    i, key j at j) and the scale."""
    H, Sq, D = q.shape[1:]
    HK, Skv = k.shape[1], k.shape[2]
    scale = logit_scale if logit_scale is not None else D ** -0.5
    f = _acc(q)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(f), k.to(f).repeat(1, H // HK, 1, 1)) * scale
    i = torch.arange(Sq, device=q.device)[:, None]
    j = torch.arange(Skv, device=q.device)[None, :]
    vis = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        vis = vis & (j <= i)
    if window is not None:
        vis = vis & (i - j < window)
    return s, vis, scale


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal=True, window=None,
                            logit_scale=None):
    """The gradient of ``flash_attention_ref`` at (q, k, v), by the backward
    kernel's math, in f32: P recomputed from the forward's ``lse`` (0 on
    masked pairs), delta = rowsum(dO * O), dS = P (dO V^T - delta), dQ =
    scale dS K, dK = scale dS^T Q and dV = P^T dO summed over the G query
    heads h = hk, hk + HK, ... that read kv head hk. o: (B,H,Sq,Dv) the
    forward's output, lse: (B,H,Sq) f32, do: the output's gradient. Returns
    (dq, dk, dv) in the inputs' dtypes. f64 inputs are computed in f64."""
    B, H, Sq, D = q.shape
    HK, Skv, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = H // HK
    s, vis, scale = _scores(q, k, causal, window, logit_scale)
    f = _acc(q)
    p = torch.where(vis, torch.exp(s - lse.to(f)[..., None]), 0.0)
    dof = do.to(f)
    delta = (dof * o.to(f)).sum(-1)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, v.to(f).repeat(1, G, 1, 1))
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, k.to(f).repeat(1, G, 1, 1)) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, q.to(f)) * scale
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    # head h = g * HK + hk reads kv head hk
    dk = dk.reshape(B, G, HK, Skv, D).sum(1)
    dv = dv.reshape(B, G, HK, Skv, Dv).sum(1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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
    dtype, h_final (B, DI, N) f32). f64 inputs run in f64 (the backward's
    oracle).

    Under ``FakeTensorMode`` (shapes only, no values: the dry run) the S
    steps run as one step over all S positions at once: the loop body's
    ops on S-fold shapes, so an op count sees the loop's forward op for op
    (and its backward's products; the per-step reductions of the backward
    once), where a trace step by step dispatches S times a layer's ops one
    by one (4096 and 32768 positions at falcon-mamba's shapes)."""
    B, S, DI = u.shape
    f = _acc(u)
    uf, dtf = u.to(f), dt.to(f)
    h = (torch.zeros((B, DI, A.shape[1]), dtype=f, device=u.device)
         if h0 is None else h0.to(f))
    if isinstance(uf, FakeTensor):
        dA = torch.exp(dtf[..., None] * A)                          # (B, S, DI, N)
        hs = dA * h[:, None] + (dtf * uf)[..., None] * Bm[:, :, None, :]
        return torch.einsum("bsdn,bsn->bsd", hs, Cm).to(u.dtype), hs[:, -1]
    ys = []
    for t in range(S):
        dA = torch.exp(dtf[:, t, :, None] * A)                   # (B, DI, N)
        h = dA * h + (dtf[:, t] * uf[:, t])[..., None] * Bm[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cm[:, t]))
    return torch.stack(ys, dim=1).to(u.dtype), h


def mamba_scan_bwd_ref(u, dt, Bm, Cm, A, dy, dh=None):
    """The gradient of ``mamba_scan_ref`` (from h = 0) at (u, dt, Bm, Cm, A),
    as an explicit reverse recurrence, in f32 (f64 for f64 inputs): the
    states h_t are re-run forward, then per (b, d, n) chain, from t = S - 1
    down, with g the gradient of h_t (g_{S-1} from ``dh``, the gradient of
    h_final, or 0):
        g_t = dy_t C_t + a_{t+1} g_{t+1},  a_t = exp(dt_t A);
        du_t = sum_n g_t dt_t B_t;  ddt_t = sum_n g_t (u_t B_t + A a_t h_{t-1});
        dB_t = sum_d g_t dt_t u_t;  dC_t = sum_d dy_t h_t;
        dA = sum_{b,t} g_t a_t dt_t h_{t-1}.
    dy: (B, S, DI), the gradient of y; dh: (B, DI, N) or None. Returns (du in
    u's dtype, ddt, dBm, dCm (B, S, N), dA (DI, N)), f32 (f64 for f64)."""
    f = _acc(u)
    uf, dtf, Bf, Cf, Af, dyf = (t.to(f) for t in (u, dt, Bm, Cm, A, dy))
    B, S, DI = u.shape
    N = A.shape[1]
    hs = [uf.new_zeros((B, DI, N))]                                # h_{t-1}, t = 0..S
    for t in range(S):
        a = torch.exp(dtf[:, t, :, None] * Af)
        hs.append(a * hs[-1] + (dtf[:, t] * uf[:, t])[..., None] * Bf[:, t, None, :])
    g = uf.new_zeros((B, DI, N)) if dh is None else dh.to(f).clone()
    du, ddt = torch.empty_like(uf), torch.empty_like(uf)
    dB, dC = Bf.new_empty((B, S, N)), Bf.new_empty((B, S, N))
    dA = Af.new_zeros((DI, N))
    for t in range(S - 1, -1, -1):
        g = g + dyf[:, t, :, None] * Cf[:, t, None, :]
        a = torch.exp(dtf[:, t, :, None] * Af)
        gah = g * a * hs[t]
        gB = (g * Bf[:, t, None, :]).sum(-1)
        du[:, t] = dtf[:, t] * gB
        ddt[:, t] = uf[:, t] * gB + (gah * Af).sum(-1)
        dB[:, t] = torch.einsum("bdn,bd->bn", g, dtf[:, t] * uf[:, t])
        dC[:, t] = torch.einsum("bdn,bd->bn", hs[t + 1], dyf[:, t])
        dA += (gah * dtf[:, t, :, None]).sum(0)
        g = a * g
    return du.to(u.dtype), ddt, dB, dC, dA


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


def rglru_scan_bwd_ref(a, h_seq, dy, dh_last=None):
    """The gradient of ``rglru_scan_ref`` (from h = 0) at (a, gx), as an
    explicit reverse recurrence over t = S - 1 down to 0, with g the gradient
    of h_t:
        g_t = dy_t + a_{t+1} g_{t+1}  (g_{S-1} = dy_{S-1} + dh_last);
        dgx_t = g_t;  da_t = g_t h_{t-1}  (h_{-1} = 0).
    h_seq: the forward's (B, S, W) states; dy: their gradient; dh_last: the
    gradient of h_last, (B, W), or None. Returns (da, dgx), in f32 (f64 for
    f64 inputs)."""
    f = _acc(a)
    af, hf, dyf = (t.to(f) for t in (a, h_seq, dy))
    B, S, W = a.shape
    g = af.new_zeros((B, W)) if dh_last is None else dh_last.to(f).clone()
    da, dgx = torch.empty_like(af), torch.empty_like(af)
    for t in range(S - 1, -1, -1):
        g = g + dyf[:, t]
        dgx[:, t] = g
        da[:, t] = g * hf[:, t - 1] if t > 0 else 0.0
        g = af[:, t] * g
    return da, dgx
