"""Mamba-1 selective scan: the CUDA kernel's wrapper.

Replaces ``repro/kernels/mamba_scan.py::mamba_scan`` (Pallas
``_mamba_kernel``). The kernel (``csrc/mamba_scan.cu``) keeps the TPU
kernel's semantics: the state h (B, DI, N) starts at zero and stays in f32,
h <- exp(dt * A) * h + (dt * u) (x) B, y_t = sum_n h * C_t, no D-skip. It
takes any S and DI and masks the ragged edges itself, so nothing is padded
or copied. Its source note says what bounds it on the H100 and how the
design answers that. ``mamba_scan_ref`` is the plain version with the same
contract.

The backward kernel (same source) has no TPU counterpart: the JAX package
differentiates its jnp scan. The forward writes, on request, the f32 state
each chunk of ``CHUNK_STEPS`` steps starts from; ``mamba_scan_bwd`` walks
the chunks from the last, re-running each from its saved state in
registers, and
``MambaScanFn`` binds the two into autograd. ``mamba_scan_bwd_ref`` is the
backward's plain version; ``mamba_scan_bwd_chunked`` runs the kernel's
chunk plan with torch ops, for the tests (nothing on the path calls it).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import mamba_scan_bwd_ref, mamba_scan_ref

__all__ = ["mamba_scan", "mamba_scan_ref", "mamba_scan_bwd", "mamba_scan_bwd_ref",
           "mamba_scan_bwd_chunked", "MambaScanFn", "CHUNK_STEPS", "launches",
           "bwd_launches"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 32       # N lanes of one warp hold a channel's states
_MAX_BATCH = 65535   # the grid's y dimension
# steps of the backward's chunks, whose start states the forward saves
# (BWD_STEPS in csrc/mamba_scan.cu)
CHUNK_STEPS = 16


launches = 0       # forward kernel launches since the count was last set to 0
bwd_launches = 0   # backward calls (the walk and its reduce pass) likewise


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.library("mamba_scan").mamba_scan_fwd
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _scratch_entry():
    fn = _build.library("mamba_scan").mamba_scan_bwd_scratch
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _bwd_entry():
    fn = _build.library("mamba_scan").mamba_scan_bwd
    fn.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)
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


def _on_card(what, *ts):
    if not all(t.is_cuda for t in ts):
        raise ValueError(f"{what} runs on CUDA tensors only; the plain "
                         f"version for the CPU is {what}_ref")
    if len({t.device for t in ts}) != 1:
        raise ValueError(f"{what}: operands lie on different devices")


def mamba_scan(u: torch.Tensor, dt: torch.Tensor, Bm: torch.Tensor,
               Cm: torch.Tensor, A: torch.Tensor, *, chunk_states: bool = False):
    """u, dt: (B, S, DI); Bm, Cm: (B, S, N) with N <= 32; A: (DI, N), on one
    CUDA device. u is f32 or bf16, the rest f32. u, dt and A are
    contiguous; Bm and Cm are read through their batch and sequence strides
    (n contiguous), so the slices of the model's x_proj output pass without
    a copy. Returns (y (B, S, DI) in u's dtype, h_final (B, DI, N) f32), and
    with ``chunk_states`` also the f32 state each chunk of
    ``CHUNK_STEPS`` steps starts from, (B, chunks, DI, N): the
    backward's input."""
    global launches
    _check(u, dt, Bm, Cm, A)
    _on_card("mamba_scan", u, dt, Bm, Cm, A)
    B, S, DI = u.shape
    N = Bm.shape[-1]
    y = torch.empty((B, S, DI), dtype=u.dtype, device=u.device)
    h = torch.empty((B, DI, N), dtype=torch.float32, device=u.device)
    hc = (torch.empty((B, -(-S // CHUNK_STEPS), DI, N), dtype=torch.float32,
                      device=u.device) if chunk_states else None)
    strides = (ctypes.c_longlong * 4)(*Bm.stride()[:2], *Cm.stride()[:2])
    stream = torch.cuda.current_stream(u.device).cuda_stream
    err = _entry()(u.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                   A.data_ptr(), y.data_ptr(), h.data_ptr(),
                   None if hc is None else hc.data_ptr(), strides, B, S, DI, N,
                   _DTYPES[u.dtype], stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan launch failed: CUDA error {err}")
    launches += 1
    return (y, h, hc) if chunk_states else (y, h)


def mamba_scan_bwd(u, dt, Bm, Cm, A, h_chunks, dy, dh=None, *,
                   events: Optional[Sequence[torch.cuda.Event]] = None):
    """The gradient of ``mamba_scan`` (f32 u) at (u, dt, Bm, Cm, A): h_chunks
    the forward's chunk-start states (``mamba_scan(..., chunk_states=True)``),
    dy the gradient of y, dh that of h_final or None. Returns (du, ddt (B,
    S, DI), dBm, dCm (B, S, N), dA (DI, N)), f32, contiguous. Any other dtype
    raises (there is no plain fallback on the card).

    ``events``: three timing events, recorded on the stream before the walk
    and after the walk and its reduce pass, so that each can be timed
    apart."""
    global bwd_launches
    _check(u, dt, Bm, Cm, A)
    if u.dtype != torch.float32:
        raise TypeError(f"mamba_scan_bwd: u is {u.dtype}; the backward takes float32")
    B, S, DI = u.shape
    N = Bm.shape[-1]
    want = {"h_chunks": (h_chunks, (B, -(-S // CHUNK_STEPS), DI, N)),
            "dy": (dy, (B, S, DI))}
    if dh is not None:
        want["dh"] = (dh, (B, DI, N))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"mamba_scan_bwd: {name} {tuple(t.shape)} {t.dtype}, wants a "
                             f"contiguous {shape} float32")
    _on_card("mamba_scan_bwd", u, dt, Bm, Cm, A, h_chunks, dy,
             *(() if dh is None else (dh,)))
    floats = ctypes.c_longlong()   # the scratch the kernel's plan needs
    err = _scratch_entry()(B, S, DI, N, ctypes.byref(floats))
    if err != 0:
        raise RuntimeError(f"mamba_scan_bwd_scratch failed: CUDA error {err}")
    du, ddt = torch.empty_like(u), torch.empty_like(u)
    dB = torch.empty((B, S, N), dtype=torch.float32, device=u.device)
    dC = torch.empty_like(dB)
    dA = torch.empty((DI, N), dtype=torch.float32, device=u.device)
    part = torch.empty(floats.value, dtype=torch.float32, device=u.device)
    strides = (ctypes.c_longlong * 4)(*Bm.stride()[:2], *Cm.stride()[:2])
    stream = torch.cuda.current_stream(u.device)
    marks = None
    if events is not None:
        if len(events) != 3:
            raise ValueError(f"mamba_scan_bwd: {len(events)} events, wants 3")
        for e in events:   # a torch event exists from its first record on
            e.record(stream)
        marks = (ctypes.c_void_p * 3)(*(e.cuda_event for e in events))
    err = _bwd_entry()(u.data_ptr(), dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                       A.data_ptr(), h_chunks.data_ptr(), dy.data_ptr(),
                       None if dh is None else dh.data_ptr(), du.data_ptr(), ddt.data_ptr(),
                       dB.data_ptr(), dC.data_ptr(), dA.data_ptr(), part.data_ptr(), strides,
                       B, S, DI, N, marks, stream.cuda_stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan_bwd launch failed: CUDA error {err}")
    bwd_launches += 1
    return du, ddt, dB, dC, dA


def mamba_scan_bwd_chunked(u, dt, Bm, Cm, A, dy, dh=None, *, tile: int):
    """The backward kernel's plan with torch ops in f32: the forward's
    chunk-start states (every ``CHUNK_STEPS`` steps), then the chunks from
    the last, each re-run from its saved state and walked in reverse with g
    carried across chunks, a ragged last chunk padded with steps that leave
    g and h as they are; dB and dC summed over tiles of ``tile`` channels
    (the kernel's block width, which its source sets), then over the tiles
    in order, dA over the batch rows in order. Returns what
    ``mamba_scan_bwd`` returns."""
    B, S, DI = u.shape
    N = A.shape[1]
    L, TILE = CHUNK_STEPS, tile
    nchunks, tiles = -(-S // L), -(-DI // TILE)
    u, dt, dy = (t.to(torch.float32) for t in (u, dt, dy))
    # the ragged last chunk's missing steps as zeros: a = exp(0) = 1 and no
    # input, so g and h pass through them unchanged
    pad = nchunks * L - S
    u, dt, dy = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (u, dt, dy))
    Bm, Cm = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (Bm, Cm))
    ex = lambda t: torch.exp(dt[:, t, :, None] * A)          # noqa: E731
    step = lambda t, h: ex(t) * h + (dt[:, t] * u[:, t])[..., None] * Bm[:, t, None, :]  # noqa: E731
    h, states = u.new_zeros((B, DI, N)), []
    for t in range(S):
        if t % L == 0:
            states.append(h)
        h = step(t, h)
    g = u.new_zeros((B, DI, N)) if dh is None else dh.to(torch.float32).clone()
    du, ddt = u.new_empty((B, S, DI)), u.new_empty((B, S, DI))
    part_b = u.new_zeros((tiles, B, S, N))
    part_c = u.new_zeros((tiles, B, S, N))
    part_a = u.new_zeros((B, DI, N))

    def by_tile(x):                                           # (B, DI, N) -> (tiles, B, N)
        pad = x.new_zeros((B, tiles * TILE, N))
        pad[:, :DI] = x
        return pad.view(B, tiles, TILE, N).sum(2).transpose(0, 1)

    for ch in range(nchunks - 1, -1, -1):
        t0 = ch * L
        hs = [states[ch]]                                    # h_{t-1} for t = t0 .. t0 + L
        for t in range(t0, t0 + L):
            hs.append(step(t, hs[-1]))
        for t in range(t0 + L - 1, t0 - 1, -1):
            a = ex(t)
            g = g + dy[:, t, :, None] * Cm[:, t, None, :]
            gah = g * a * hs[t - t0]
            gb = (g * Bm[:, t, None, :]).sum(-1)
            part_a += gah * dt[:, t, :, None]
            if t < S:
                du[:, t] = dt[:, t] * gb
                ddt[:, t] = u[:, t] * gb + (gah * A).sum(-1)
                part_b[:, :, t] = by_tile(g * (dt[:, t] * u[:, t])[..., None])
                part_c[:, :, t] = by_tile(hs[t - t0 + 1] * dy[:, t, :, None])
            g = a * g
    dB, dC, dA = part_b[0].clone(), part_c[0].clone(), part_a[0].clone()
    for i in range(1, tiles):
        dB, dC = dB + part_b[i], dC + part_c[i]
    for r in range(1, B):
        dA = dA + part_a[r]
    return du, ddt, dB, dC, dA


class MambaScanFn(torch.autograd.Function):
    """The scan (f32 u, from h = 0) under autograd: on CUDA tensors the
    forward kernel with its chunk-start states, then the backward kernel; on
    CPU tensors ``mamba_scan_ref`` and ``mamba_scan_bwd_ref``. Returns (y,
    h_final)."""

    @staticmethod
    def forward(ctx, u, dt, Bm, Cm, A):
        ctx.set_materialize_grads(False)
        if u.is_cuda:
            y, h, hc = mamba_scan(u, dt, Bm, Cm, A, chunk_states=True)
        else:
            (y, h), hc = mamba_scan_ref(u, dt, Bm, Cm, A), None
        ctx.save_for_backward(u, dt, Bm, Cm, A, hc)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        u, dt, Bm, Cm, A, hc = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(u)
        if u.is_cuda:
            dh = None if dh is None else dh.contiguous()
            return mamba_scan_bwd(u, dt, Bm, Cm, A, hc, dy.contiguous(), dh)
        return mamba_scan_bwd_ref(u, dt, Bm, Cm, A, dy, dh)
