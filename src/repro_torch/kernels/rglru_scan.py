"""RG-LRU diagonal linear recurrence: the CUDA kernel's wrapper.

Replaces ``repro/kernels/rglru_scan.py::rglru_scan`` (Pallas
``_rglru_kernel``). The kernel (``csrc/rglru_scan.cu``) keeps the TPU
kernel's semantics: h_t = a_t * h_{t-1} + gx_t from h = 0, in f32, returning
every h_t and the last. It takes any S and W and masks the ragged edges
itself, so nothing is padded or copied. Its source note says what bounds it
on the H100 and how the design answers that. ``rglru_scan_ref`` is the
plain version with the same contract.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rglru_scan_ref

__all__ = ["rglru_scan", "rglru_scan_ref", "launches"]

_MAX_BATCH = 65535   # the grid's y dimension

launches = 0   # kernel launches since the count was last set to 0


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.library("rglru_scan").rglru_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(a, gx):
    """Raise on what the kernel does not take, wherever the tensors lie."""
    if a.dtype != torch.float32 or gx.dtype != torch.float32:
        raise TypeError(f"rglru_scan: a and gx must be float32, got {a.dtype}, {gx.dtype}")
    if a.dim() != 3 or gx.shape != a.shape:
        raise ValueError(f"rglru_scan: shapes a {tuple(a.shape)}, gx {tuple(gx.shape)}")
    B, S, W = a.shape
    if min(B, S, W) < 1 or B > _MAX_BATCH:
        raise ValueError(f"rglru_scan: B={B}, S={S}, W={W} out of range")
    if not (a.is_contiguous() and gx.is_contiguous()):
        raise ValueError("rglru_scan: a and gx must be contiguous")


def rglru_scan(a: torch.Tensor, gx: torch.Tensor):
    """a, gx: contiguous (B, S, W) float32 on one CUDA device. Returns
    (h_seq (B, S, W) f32, h_last (B, W) f32)."""
    global launches
    _check(a, gx)
    if not (a.is_cuda and gx.is_cuda):
        raise ValueError("rglru_scan runs on CUDA tensors only; the plain "
                         "version for the CPU is rglru_scan_ref")
    if a.device != gx.device:
        raise ValueError("rglru_scan: operands lie on different devices")
    B, S, W = a.shape
    y = torch.empty_like(a)
    h = torch.empty((B, W), dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _entry()(a.data_ptr(), gx.data_ptr(), y.data_ptr(), h.data_ptr(), B, S, W, stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan launch failed: CUDA error {err}")
    launches += 1
    return y, h
