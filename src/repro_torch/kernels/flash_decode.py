"""Flash decode over a ring KV cache: the CUDA kernel's wrapper.

Replaces ``repro/kernels/flash_decode.py::flash_decode`` (Pallas
``_decode_kernel``). The kernel (``csrc/flash_decode.cu``) keeps the TPU
kernel's semantics: slot s holds position ``pos - ((pos - s) mod C)``, empty
slots and slots outside the window are masked inside the kernel, query head
h reads kv head h % HK, the denominator is clamped at 1e-30. It masks slots
>= C itself, so the cache is never padded or copied. Its source note says
what bounds it on the H100 and how the design answers that.
``flash_decode_ref`` is the plain version with the same contract.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_decode_ref

__all__ = ["flash_decode", "flash_decode_ref", "launches"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256)
_INT32_MAX = 2 ** 31 - 1

launches = 0   # kernel launches since the count was last set to 0


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.library("flash_decode").flash_decode_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, pos, window):
    """Raise on what the kernel does not take, wherever the tensors lie."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_decode: dtypes {q.dtype}, {k.dtype}, {v.dtype}; "
                        f"takes one of {list(_DTYPES)}")
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_decode: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, D = q.shape
    _, HK, C, Dk = k.shape
    if k.shape[0] != B or Dk != D or HK == 0 or H % HK or C == 0:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} vs k/v {tuple(k.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_decode: head dim {D} not in {HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_decode: the head dim must be contiguous")
    if not 0 <= int(pos) <= _INT32_MAX:
        raise ValueError(f"flash_decode: pos must be an int32 >= 0, got {pos}")
    if window is not None and window < 1:
        raise ValueError(f"flash_decode: window must be >= 1, got {window}")


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: int, *,
                 window: Optional[int] = None,
                 logit_scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,H,D); k, v: (B,HK,C,D) ring caches on one CUDA device, all f32
    or all bf16, each with its last dim contiguous (any b, h, s strides, so
    the model's (B,C,HK,D) cache layers pass as views). ``pos`` is a host
    int: the position of the query, whose k and v are already written at
    slot pos % C. Returns a contiguous (B,H,D) in q's dtype."""
    global launches
    _check(q, k, v, pos, window)
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_decode runs on CUDA tensors only; the plain "
                         "version for the CPU is flash_decode_ref")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_decode: operands lie on different devices")
    B, H, D = q.shape
    _, HK, C, _ = k.shape
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    scale = logit_scale if logit_scale is not None else D ** -0.5
    strides = (ctypes.c_longlong * 8)(*q.stride()[:2], *k.stride()[:3],
                                      *v.stride()[:3])
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entry()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   strides, B, H, HK, C, D, _DTYPES[q.dtype], int(pos),
                   window if window is not None else 0, scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_decode launch failed: CUDA error {err}")
    launches += 1
    return out
