"""RG-LRU diagonal linear recurrence: the CUDA kernel's wrapper.

Replaces ``repro/kernels/rglru_scan.py::rglru_scan`` (Pallas
``_rglru_kernel``). The kernel (``csrc/rglru_scan.cu``) keeps the TPU
kernel's semantics: h_t = a_t * h_{t-1} + gx_t from h = 0, in f32, returning
every h_t and the last. It takes any S and W and masks the ragged edges
itself, so nothing is padded or copied. ``plan`` sizes the one launch: a
block for each tile of 32 channels of a batch row, walking S in chunks of
16 x warps steps. Its source note says what bounds it on the H100 and how
the design answers that. ``rglru_scan_ref`` is the plain version with the
same contract; ``rglru_scan_chunked`` runs a plan's arithmetic with torch
ops, for the tests (nothing on the path calls it).

The backward kernel (same source) has no TPU counterpart: the JAX package
differentiates its jnp scan. It is the forward's plan run over reversed
time (``bwd_plan``: at most BWD_WARPS warps a block); ``RglruScanFn`` binds
the two into autograd and ``rglru_scan_bwd_ref`` is its plain version.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rglru_scan_bwd_ref, rglru_scan_ref

__all__ = ["rglru_scan", "rglru_scan_ref", "rglru_scan_chunked", "rglru_scan_bwd",
           "rglru_scan_bwd_ref", "RglruScanFn", "launches", "bwd_launches", "plan",
           "bwd_plan"]

# the kernel's constants (csrc/rglru_scan.cu)
TILE = 32          # channels a block owns
STEPS = 16         # steps a warp owns in a chunk
MAX_WARPS = 32     # warps of a block that takes all of S (1024 threads)
WALK_WARPS = 16    # warps of a block that walks chunks
BWD_WARPS = 16     # warps of a backward block at most
_INT32_MAX = 2 ** 31 - 1

launches = 0       # forward kernel launches since the count was last set to 0
bwd_launches = 0   # backward kernel launches likewise


class Plan(NamedTuple):
    """How one call is cut: ``tiles`` tiles of TILE channels a batch row,
    one block of ``warps`` warps for each of the ``blocks`` (b, tile)s
    (block i is (b, tile) = divmod(i, tiles)), walking S in ``chunks``
    chunks of ``chunk`` = STEPS x ``warps`` steps."""
    warps: int
    chunk: int
    tiles: int
    chunks: int
    blocks: int


def plan(B: int, S: int, W: int, sms: int, max_warps: int = MAX_WARPS) -> Plan:
    """The kernel's work split for a card with ``sms`` SMs. One chunk where
    S fits a block of at most ``max_warps`` warps (MAX_WARPS, S <= 512, in
    the forward; BWD_WARPS, S <= 256, in the backward: a warp for each 16
    steps). Else the block walks S: a walking thread holds two chunks' loads
    (121 registers), so an SM holds 16 walking warps, and the block
    takes 16 warps where the tiles fit one an SM, 8 where two, else 4."""
    tiles = -(-W // TILE)
    blocks = B * tiles
    warps = -(-S // STEPS)
    if warps > max_warps:
        warps = WALK_WARPS if blocks <= sms else 8 if blocks <= 2 * sms else 4
    return Plan(warps, STEPS * warps, tiles, -(-S // (STEPS * warps)), blocks)


def rglru_scan_chunked(a: torch.Tensor, gx: torch.Tensor, p: Plan):
    """The kernel's arithmetic under plan ``p``, with torch ops in f32 (a
    multiply and an add where the kernel runs one FMA), chunk by chunk:
    each warp's local pair (P = prod a, H = h from 0) over its STEPS steps;
    each warp's carry-in, the pairs of the warps before it applied in order
    to the chunk's carry; the re-walk from there, whose last warp's final
    state is the next chunk's carry. Steps past S and channels past W are
    the identity (a = 1, gx = 0), as the kernel masks them. Returns
    (h_seq, h_last)."""
    B, S, W = a.shape
    Sp, Wp = p.chunks * p.chunk, p.tiles * TILE
    A = a.new_ones((B, Sp, Wp))
    G = gx.new_zeros((B, Sp, Wp))
    A[:, :S, :W] = a
    G[:, :S, :W] = gx
    A = A.view(B, p.chunks, p.warps, STEPS, Wp)
    G = G.view(B, p.chunks, p.warps, STEPS, Wp)
    y = torch.empty_like(A)
    carry = A.new_zeros((B, Wp))
    for c in range(p.chunks):
        P, H = A.new_ones((B, p.warps, Wp)), A.new_zeros((B, p.warps, Wp))
        for u in range(STEPS):                         # local pairs
            H = A[:, c, :, u] * H + G[:, c, :, u]
            P = P * A[:, c, :, u]
        h = A.new_empty((B, p.warps, Wp))              # warps' carry-ins
        h[:, 0] = carry
        for j in range(1, p.warps):
            h[:, j] = P[:, j - 1] * h[:, j - 1] + H[:, j - 1]
        for u in range(STEPS):                         # the re-walk
            h = A[:, c, :, u] * h + G[:, c, :, u]
            y[:, c, :, u] = h
        carry = h[:, -1]
    y = y.view(B, Sp, Wp)[:, :S, :W]
    return y.contiguous(), y[:, -1].contiguous()


def bwd_plan(B: int, S: int, W: int, sms: int) -> Plan:
    """The backward kernel's split: the forward's plan over reversed time,
    with at most BWD_WARPS warps a block."""
    return plan(B, S, W, sms, BWD_WARPS)


@functools.lru_cache(maxsize=1024)
def _plan(device: torch.device, B: int, S: int, W: int, max_warps: int = MAX_WARPS) -> Plan:
    p = plan(B, S, W, _build.sm_count(device), max_warps)
    if p.blocks > _INT32_MAX:
        raise ValueError(f"rglru_scan: B={B}, S={S}, W={W} out of range ({p.blocks} blocks)")
    return p


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.library("rglru_scan").rglru_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_entry():
    fn = _build.library("rglru_scan").rglru_scan_bwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(a, gx):
    """Raise on what the kernel does not take, wherever the tensors lie."""
    if a.dtype != torch.float32 or gx.dtype != torch.float32:
        raise TypeError(f"rglru_scan: a and gx must be float32, got {a.dtype}, {gx.dtype}")
    if a.dim() != 3 or gx.shape != a.shape:
        raise ValueError(f"rglru_scan: shapes a {tuple(a.shape)}, gx {tuple(gx.shape)}")
    B, S, W = a.shape
    if min(B, S, W) < 1 or max(S, W) > _INT32_MAX:
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
    dev = a.device
    if gx.device != dev:
        raise ValueError("rglru_scan: operands lie on different devices")
    B, S, W = a.shape
    p = _plan(dev, B, S, W)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    y = torch.empty_like(a)
    h = torch.empty((B, W), dtype=torch.float32, device=dev)
    err = _entry()(a.data_ptr(), gx.data_ptr(), y.data_ptr(), h.data_ptr(), B, S, W, p.warps,
                   stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan launch failed: CUDA error {err}")
    launches += 1
    return y, h


def rglru_scan_bwd(a: torch.Tensor, h_seq: torch.Tensor, dy: torch.Tensor,
                   dh_last=None):
    """The gradient of ``rglru_scan`` at (a, gx): h_seq its output, dy the
    gradient of h_seq, dh_last that of h_last (B, W) or None; all f32 on one
    CUDA device, contiguous. Returns (da, dgx), contiguous (B, S, W) f32."""
    global bwd_launches
    _check(a, h_seq)
    _check(a, dy)
    ts = (a, h_seq, dy) + (() if dh_last is None else (dh_last,))
    if not all(t.is_cuda for t in ts):
        raise ValueError("rglru_scan_bwd runs on CUDA tensors only; the plain "
                         "version for the CPU is rglru_scan_bwd_ref")
    dev = a.device
    if any(t.device != dev for t in ts):
        raise ValueError("rglru_scan_bwd: operands lie on different devices")
    B, S, W = a.shape
    if dh_last is not None and (tuple(dh_last.shape) != (B, W) or dh_last.dtype != torch.float32
                                or not dh_last.is_contiguous()):
        raise ValueError(f"rglru_scan_bwd: dh_last {tuple(dh_last.shape)} {dh_last.dtype}, "
                         f"wants a contiguous ({B}, {W}) float32")
    p = _plan(dev, B, S, W, BWD_WARPS)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    da, dgx = torch.empty_like(a), torch.empty_like(a)
    err = _bwd_entry()(a.data_ptr(), h_seq.data_ptr(), dy.data_ptr(),
                       None if dh_last is None else dh_last.data_ptr(), da.data_ptr(),
                       dgx.data_ptr(), B, S, W, p.warps, stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan_bwd launch failed: CUDA error {err}")
    bwd_launches += 1
    return da, dgx


class RglruScanFn(torch.autograd.Function):
    """The recurrence under autograd: on CUDA tensors the forward kernel,
    then the backward kernel from its h_seq; on CPU tensors
    ``rglru_scan_ref`` and ``rglru_scan_bwd_ref``. Returns (h_seq, h_last)."""

    @staticmethod
    def forward(ctx, a, gx):
        ctx.set_materialize_grads(False)
        y, h = rglru_scan(a, gx) if a.is_cuda else rglru_scan_ref(a, gx)
        ctx.save_for_backward(a, y)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        a, y = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(y)
        if a.is_cuda:
            return rglru_scan_bwd(a, y, dy.contiguous(), None if dh is None else dh.contiguous())
        return rglru_scan_bwd_ref(a, y, dy, dh)
