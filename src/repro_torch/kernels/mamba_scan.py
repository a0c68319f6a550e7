"""Mamba-1 selective scan: the CUDA kernel's wrapper.

Replaces ``repro/kernels/mamba_scan.py::mamba_scan`` (Pallas
``_mamba_kernel``). The kernel (``csrc/mamba_scan.cu``) keeps the TPU
kernel's semantics: the state h (B, DI, N) starts at zero and stays in f32,
h <- exp(dt * A) * h + (dt * u) (x) B, y_t = sum_n h * C_t, no D-skip. It
takes any S and DI and masks the ragged edges itself, so nothing is padded
or copied. Its source note says what bounds it on the H100 and how the
design answers that. ``mamba_scan_ref`` is the plain version with the same
contract.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import mamba_scan_ref

__all__ = ["mamba_scan", "mamba_scan_ref", "launches"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 32       # N lanes of one warp hold a channel's states
_MAX_BATCH = 65535   # the grid's y dimension

launches = 0   # kernel launches since the count was last set to 0


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.library("mamba_scan").mamba_scan_fwd
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(u, dt, Bm, Cm, A):
    """Raise on what the kernel does not take, wherever the tensors lie."""
    if u.dtype not in _DTYPES:
        raise TypeError(f"mamba_scan: u is {u.dtype}; takes one of {list(_DTYPES)}")
    if any(t.dtype != torch.float32 for t in (dt, Bm, Cm, A)):
        raise TypeError(f"mamba_scan: dt, Bm, Cm, A must be float32, got "
                        f"{dt.dtype}, {Bm.dtype}, {Cm.dtype}, {A.dtype}")
    if u.dim() != 3 or Bm.dim() != 3:
        raise ValueError(f"mamba_scan: shapes u {tuple(u.shape)}, Bm {tuple(Bm.shape)}")
    B, S, DI = u.shape
    N = Bm.shape[-1]
    if (dt.shape != u.shape or Bm.shape != (B, S, N) or Cm.shape != Bm.shape
            or A.shape != (DI, N)):
        raise ValueError(f"mamba_scan: shapes u {tuple(u.shape)}, dt {tuple(dt.shape)}, "
                         f"Bm {tuple(Bm.shape)}, Cm {tuple(Cm.shape)}, A {tuple(A.shape)}")
    if min(B, S, DI, N) < 1 or B > _MAX_BATCH:
        raise ValueError(f"mamba_scan: B={B}, S={S}, DI={DI}, N={N} out of range")
    if N > MAX_STATE:
        raise ValueError(f"mamba_scan: state size {N} above {MAX_STATE}")
    if not (u.is_contiguous() and dt.is_contiguous() and A.is_contiguous()):
        raise ValueError("mamba_scan: u, dt and A must be contiguous")
    if Bm.stride(-1) != 1 or Cm.stride(-1) != 1:
        raise ValueError("mamba_scan: the state dim of Bm and Cm must be contiguous")


def mamba_scan(u: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
               Cm: torch.Tensor, A: torch.Tensor):
    """u, dt: (B, S, DI); Bm, Cm: (B, S, N) with N <= 32; A: (DI, N), on one
    CUDA device. u is f32 or bf16, the rest f32. u, dt and A are
    contiguous; Bm and Cm are read through their batch and sequence strides
    (n contiguous), so the slices of the model's x_proj output pass without
    a copy. Returns (y (B, S, DI) in u's dtype, h_final (B, DI, N) f32)."""
    global launches
    _check(u, dt, Bm, Cm, A)
    tensors = (u, dt, Bm, Cm, A)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("mamba_scan runs on CUDA tensors only; the plain "
                         "version for the CPU is mamba_scan_ref")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("mamba_scan: operands lie on different devices")
    B, S, DI = u.shape
    N = Bm.shape[-1]
    y = torch.empty((B, S, DI), dtype=u.dtype, device=u.device)
    h = torch.empty((B, DI, N), dtype=torch.float32, device=u.device)
    strides = (ctypes.c_longlong * 4)(*Bm.stride()[:2], *Cm.stride()[:2])
    stream = torch.cuda.current_stream(u.device).cuda_stream
    err = _entry()(u.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                   A.data_ptr(), y.data_ptr(), h.data_ptr(), strides, B, S, DI, N,
                   _DTYPES[u.dtype], stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan launch failed: CUDA error {err}")
    launches += 1
    return y, h
