"""Forward flash attention: the CUDA kernel's wrapper.

Replaces ``repro/kernels/flash_attention.py::flash_attention`` (Pallas
``_flash_kernel``). The kernel (``csrc/flash_attention.cu``) keeps the TPU
kernel's semantics: query head h reads kv head h % HK, masks are
positional with the finite -1e30, the denominator is clamped at 1e-30. Its
source note says what bounds it on the H100 and how the design answers
that. ``flash_attention_ref`` is the plain version with the same contract.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref

__all__ = ["flash_attention", "flash_attention_ref", "launches"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (D of q and k, Dv of v and the output) of the kernel's instances: the
# square widths of the dense families, and deepseek-v2-lite-16b's MLA at its
# published (192, 128) and reduced (48, 32) widths
HEAD_DIMS = ((64, 64), (128, 128), (256, 256), (192, 128), (48, 32))

launches = 0   # kernel launches since the count was last set to 0


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its start and row strides are 16-byte aligned, as
    the kernel's 16-byte copies need (every view the models pass is), else
    a contiguous copy."""
    size = t.element_size()
    if t.data_ptr() % 16 == 0 and all(s * size % 16 == 0 for s in t.stride()[:-1]):
        return t
    return t.clone(memory_format=torch.contiguous_format)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.library("flash_attention").flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    logit_scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,H,Sq,D); k: (B,HK,Skv,D); v: (B,HK,Skv,Dv) on one CUDA device,
    all f32 or all bf16, each with its last dim contiguous (any b, h, s
    strides, so views of the model's (B,S,H,D) tensors pass without a
    copy); (D, Dv) one of ``HEAD_DIMS``. Returns (B,H,Sq,Dv) in q's dtype,
    as a view of a (B,Sq,H,Dv) buffer. The default scale is D ** -0.5, of
    q's D, as the TPU kernel's.

    Sq may differ from Skv only without a causal mask or window: with
    either, query i and key j sit at positions i and j, and every query
    row must see its own key."""
    global launches
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_attention runs on CUDA tensors only; the plain "
                         "version for the CPU is flash_attention_ref")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: operands lie on different devices")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, {v.dtype}; "
                        f"takes one of {list(_DTYPES)}")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, Sq, D = q.shape
    _, HK, Skv, Dk = k.shape
    Dv = v.shape[3]
    if k.shape[0] != B or Dk != D or HK == 0 or H % HK:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} vs k {tuple(k.shape)}")
    if (D, Dv) not in HEAD_DIMS:
        raise ValueError(f"flash_attention: (q/k, v) head dims ({D}, {Dv}) have no "
                         f"instance; the instances are {HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the head dim must be contiguous")
    if (causal or window is not None) and Sq != Skv:
        raise ValueError("flash_attention: a causal or windowed mask needs Sq == Skv")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    q, k, v = (_aligned(t) for t in (q, k, v))
    out = torch.empty((B, Sq, H, Dv), dtype=q.dtype, device=q.device).transpose(1, 2)
    scale = logit_scale if logit_scale is not None else D ** -0.5
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   strides, B, H, HK, Sq, Skv, D, Dv, _DTYPES[q.dtype], int(causal),
                   window if window is not None else 0, scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    launches += 1
    return out
