"""Flash attention: the CUDA kernels' wrappers, forward and backward.

The forward replaces ``repro/kernels/flash_attention.py::flash_attention``
(Pallas ``_flash_kernel``). The kernel (``csrc/flash_attention.cu``) keeps the TPU
kernel's semantics: query head h reads kv head h % HK, masks are
positional with the finite -1e30, the denominator is clamped at 1e-30. Its
source note says what bounds it on the H100 and how the design answers
that. ``flash_attention_ref`` is the plain version with the same contract.

The backward (``csrc/flash_attention_bwd.cu``) has no TPU counterpart: the
JAX package trains through its jnp attention. ``FlashAttentionFn`` binds
the forward (with its log-sum-exp) and the backward kernel into autograd,
so a train step on the card differentiates every self-attention through
the two kernels; ``flash_attention_bwd_ref`` is the backward's plain
version. ``bwd_plan`` asks the kernel how it cuts the dK/dV pass's key
tiles into parts for the card's SMs; the wrapper allocates the parts'
workspace.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_bwd_ref, flash_attention_ref

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_bwd",
           "flash_attention_ref", "flash_attention_bwd_ref", "FlashAttentionFn",
           "launches", "bwd_launches", "bwd_plan"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (D of q and k, Dv of v and the output) of the kernel's instances: the
# square widths of the dense families, and deepseek-v2-lite-16b's MLA at its
# published (192, 128) and reduced (48, 32) widths
HEAD_DIMS = ((64, 64), (128, 128), (256, 256), (192, 128), (48, 32))
# the backward kernel's instances; the others wait (ROADMAP.md section 2,
# "Backward kernels still to write")
BWD_HEAD_DIMS = ((64, 64), (128, 128), (192, 128), (48, 32))
BWD_MISSING = "ROADMAP.md section 2, 'Backward kernels still to write'"
BWD_BM = 64   # keys a dK/dV block owns: the workspace part's rows

launches = 0       # forward kernel launches since the count was last set to 0
bwd_launches = 0   # backward calls (the delta, dK/dV, reduce and dQ kernels) likewise


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its start and row strides are 16-byte aligned and its
    last dim contiguous, as the kernels' 16-byte copies need (every view the
    models pass is), else a contiguous copy."""
    size = t.element_size()
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s * size % 16 == 0 for s in t.stride()[:-1])):
        return t
    return t.clone(memory_format=torch.contiguous_format)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.library("flash_attention").flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_entry():
    fn = _build.library("flash_attention_bwd").flash_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_int] * 12 + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _plan_entry():
    fn = _build.library("flash_attention_bwd").flash_attention_bwd_plan
    fn.argtypes = [ctypes.c_int] * 11 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return fn


class BwdPlan(NamedTuple):
    """The dK/dV pass's split, as the kernel plans it
    (csrc/flash_attention_bwd.cu, plan_split): its key tiles' walks cut into
    parts of at most ``chunk`` walked tiles, ``slots`` workspace parts a
    (batch row, kv head), and ``longest`` the longest block's walk."""
    chunk: int
    slots: int
    longest: int


@functools.lru_cache(maxsize=1024)
def bwd_plan(B: int, H: int, HK: int, Sq: int, Skv: int, D: int, Dv: int,
             dtype: torch.dtype, causal: bool, window: Optional[int], sms: int) -> BwdPlan:
    """The kernel's split of the dK/dV pass of a call on a card of ``sms`` SMs."""
    out = (ctypes.c_int * 3)()
    err = _plan_entry()(B, H, HK, Sq, Skv, D, Dv, _DTYPES[dtype], int(causal), window or 0,
                        sms, out)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd_plan failed: CUDA error {err}")
    return BwdPlan(*out)


def _check(q, k, v, causal, window, what="flash_attention"):
    """The forward's contract; returns (B, H, HK, Sq, Skv, D, Dv)."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError(f"{what} runs on CUDA tensors only; the plain "
                         "version for the CPU is flash_attention_ref")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{what}: operands lie on different devices")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what}: dtypes {q.dtype}, {k.dtype}, {v.dtype}; "
                        f"takes one of {list(_DTYPES)}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"{what}: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, D = q.shape
    _, HK, Skv, Dk = k.shape
    Dv = v.shape[3]
    if k.shape[0] != B or Dk != D or HK == 0 or H % HK:
        raise ValueError(f"{what}: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    if (D, Dv) not in HEAD_DIMS:
        raise ValueError(f"{what}: (q/k, v) head dims ({D}, {Dv}) have no "
                         f"instance; the instances are {HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{what}: the head dim must be contiguous")
    if (causal or window is not None) and Sq != Skv:
        raise ValueError(f"{what}: a causal or windowed mask needs Sq == Skv")
    if window is not None and window < 1:
        raise ValueError(f"{what}: window must be >= 1, got {window}")
    return B, H, HK, Sq, Skv, D, Dv


def _strides(*ts):
    return (ctypes.c_longlong * (3 * len(ts)))(*(s for t in ts for s in t.stride()[:3]))


def _out_like(q, width):
    """(B, H, Sq, width) in q's dtype, as a view of a (B, Sq, H, width)
    buffer (the model's layout)."""
    B, H, Sq, _ = q.shape
    return torch.empty((B, Sq, H, width), dtype=q.dtype, device=q.device).transpose(1, 2)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        logit_scale: Optional[float] = None, with_lse: bool = False):
    """q: (B,H,Sq,D); k: (B,HK,Skv,D); v: (B,HK,Skv,Dv) on one CUDA device,
    all f32 or all bf16, each with its last dim contiguous (any b, h, s
    strides, so views of the model's (B,S,H,D) tensors pass without a
    copy); (D, Dv) one of ``HEAD_DIMS``. Returns (B,H,Sq,Dv) in q's dtype,
    as a view of a (B,Sq,H,Dv) buffer, and with ``with_lse`` also each
    query row's log-sum-exp of its scaled scores, (B,H,Sq) f32 (the
    backward's input). The default scale is D ** -0.5, of q's D, as the TPU
    kernel's.

    Sq may differ from Skv only without a causal mask or window: with
    either, query i and key j sit at positions i and j, and every query
    row must see its own key."""
    global launches
    B, H, HK, Sq, Skv, D, Dv = _check(q, k, v, causal, window)
    q, k, v = (_aligned(t) for t in (q, k, v))
    out = _out_like(q, Dv)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    scale = logit_scale if logit_scale is not None else D ** -0.5
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   None if lse is None else lse.data_ptr(), _strides(q, k, v, out),
                   B, H, HK, Sq, Skv, D, Dv, _DTYPES[q.dtype], int(causal),
                   window if window is not None else 0, scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    launches += 1
    return (out, lse) if with_lse else out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    logit_scale: Optional[float] = None) -> torch.Tensor:
    """The forward kernel without its log-sum-exp; see ``flash_attention_fwd``."""
    return flash_attention_fwd(q, k, v, causal=causal, window=window,
                               logit_scale=logit_scale)


def check_bwd_head_dims(D: int, Dv: int) -> None:
    """Raise unless the backward kernel has an instance at (D, Dv)."""
    if (D, Dv) not in BWD_HEAD_DIMS:
        raise NotImplementedError(
            f"flash_attention's backward kernel has no instance at (q/k, v) head dims "
            f"({D}, {Dv}); its instances are {BWD_HEAD_DIMS}, the others wait "
            f"({BWD_MISSING})")


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: Optional[int] = None,
                        logit_scale: Optional[float] = None,
                        events: Optional[Sequence[torch.cuda.Event]] = None):
    """The gradient of ``flash_attention`` at (q, k, v): o its output and lse
    its log-sum-exp (``flash_attention_fwd(..., with_lse=True)``), do the
    gradient of o. Returns (dq, dk, dv), each in q's dtype and shape, laid
    out as views of (B, S, H, D) buffers. (D, Dv) one of ``BWD_HEAD_DIMS``;
    any other pair raises (there is no plain fallback on the card).

    ``events``: five timing events, recorded on the stream before the delta
    pre-pass and after each of the delta, dK/dV, reduce and dQ kernels, so
    that each kernel can be timed apart."""
    global bwd_launches
    B, H, HK, Sq, Skv, D, Dv = _check(q, k, v, causal, window, "flash_attention_bwd")
    check_bwd_head_dims(D, Dv)
    for name, t, shape in (("o", o, (B, H, Sq, Dv)), ("do", do, (B, H, Sq, Dv))):
        if tuple(t.shape) != shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, wants {shape} {q.dtype} on {q.device}")
    if (tuple(lse.shape) != (B, H, Sq) or lse.dtype != torch.float32
            or lse.device != q.device):
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} {lse.dtype}, "
                         f"wants ({B}, {H}, {Sq}) float32")
    q, k, v, o, do = (_aligned(t) for t in (q, k, v, o, do))
    lse = lse.contiguous()
    plan = bwd_plan(B, H, HK, Sq, Skv, D, Dv, q.dtype, bool(causal), window,
                    _build.sm_count(q.device))
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    ws = (torch.empty((B * HK * plan.slots, BWD_BM, D + Dv), dtype=torch.float32,
                      device=q.device) if plan.slots else None)
    dq = _out_like(q, D)
    dk = torch.empty((B, Skv, HK, D), dtype=q.dtype, device=q.device).transpose(1, 2)
    dv = torch.empty((B, Skv, HK, Dv), dtype=q.dtype, device=q.device).transpose(1, 2)
    scale = logit_scale if logit_scale is not None else D ** -0.5
    stream = torch.cuda.current_stream(q.device)
    marks = None
    if events is not None:
        if len(events) != 5:
            raise ValueError(f"flash_attention_bwd: {len(events)} events, wants 5")
        for e in events:   # a torch event exists from its first record on
            e.record(stream)
        marks = (ctypes.c_void_p * 5)(*(e.cuda_event for e in events))
    err = _bwd_entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                       lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                       dv.data_ptr(), None if ws is None else ws.data_ptr(),
                       _strides(q, k, v, o, do, dq, dk, dv), plan.chunk, plan.slots, B, H,
                       HK, Sq, Skv, D, Dv, _DTYPES[q.dtype], int(causal),
                       window if window is not None else 0, scale, marks, stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd launch failed: CUDA error {err}")
    bwd_launches += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """``flash_attention`` under autograd on the card: the forward kernel
    with its log-sum-exp, then the backward kernel. Saves q, k, v, the
    output and the lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int],
                logit_scale: Optional[float]):
        check_bwd_head_dims(q.shape[-1], v.shape[-1])
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                       logit_scale=logit_scale, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, logit_scale=logit_scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, **ctx.opts)
        return dq, dk, dv, None, None, None
