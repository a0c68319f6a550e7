"""int8 x int8 -> int32 matmul with f32 rescale: the CUDA kernel's wrapper.

Replaces ``repro/kernels/quant_matmul.py::quant_matmul`` (Pallas
``_qmm_kernel``). The kernel (``csrc/quant_matmul.cu``) runs the int8
tensor cores through ``mma.sync``; its source note says what bounds it on
the H100 and how the design answers that. ``quant_matmul_ref`` is the plain
version with the same contract.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import quant_matmul_ref

__all__ = ["quant_matmul", "quant_matmul_ref", "launches"]

# the int32 accumulator cannot overflow: K * 128 * 128 < 2**31
MAX_K = (2 ** 31 - 1) // (128 * 128)

launches = 0   # kernel launches since the count was last set to 0


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.library("quant_matmul").quant_matmul_s8
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def quant_matmul(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
                 w_scale: torch.Tensor) -> torch.Tensor:
    """x_q (M,K) int8, w_q (K,N) int8, x_scale (M,) f32, w_scale (N,) f32,
    all contiguous on one CUDA device -> f32 (M,N), equal bit for bit to
    ``quant_matmul_ref``."""
    global launches
    tensors = (x_q, w_q, x_scale, w_scale)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("quant_matmul runs on CUDA tensors only; the plain "
                         "version for the CPU is quant_matmul_ref")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("quant_matmul: operands lie on different devices")
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"quant_matmul: codes must be int8, got {x_q.dtype}, {w_q.dtype}")
    if x_scale.dtype != torch.float32 or w_scale.dtype != torch.float32:
        raise TypeError("quant_matmul: scales must be float32")
    if x_q.dim() != 2 or w_q.dim() != 2 or x_q.shape[1] != w_q.shape[0]:
        raise ValueError(f"quant_matmul: shapes {tuple(x_q.shape)} x {tuple(w_q.shape)}")
    M, K = x_q.shape
    N = w_q.shape[1]
    if x_scale.shape != (M,) or w_scale.shape != (N,):
        raise ValueError(f"quant_matmul: scales {tuple(x_scale.shape)}, "
                         f"{tuple(w_scale.shape)} for M={M}, N={N}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("quant_matmul: operands must be contiguous")
    if K > MAX_K:
        raise ValueError(f"quant_matmul: K={K} could overflow the int32 sum")
    out = torch.empty((M, N), dtype=torch.float32, device=x_q.device)
    stream = torch.cuda.current_stream(x_q.device).cuda_stream
    err = _entry()(x_q.data_ptr(), w_q.data_ptr(), x_scale.data_ptr(),
                   w_scale.data_ptr(), out.data_ptr(), M, N, K, stream)
    if err != 0:
        raise RuntimeError(f"quant_matmul launch failed: CUDA error {err}")
    launches += 1
    return out
