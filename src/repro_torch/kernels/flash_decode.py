"""Flash decode over a ring KV cache: the CUDA kernel's wrapper.

Replaces ``repro/kernels/flash_decode.py::flash_decode`` (Pallas
``_decode_kernel``). The kernel (``csrc/flash_decode.cu``) keeps the TPU
kernel's semantics: slot s holds position ``pos - ((pos - s) mod C)``, empty
slots and slots outside the window are masked inside the kernel, query head
h reads kv head h % HK, the denominator is clamped at 1e-30. It reads only
the visible arc of the ring, so masked slots are never read and the cache
is never padded or copied. ``plan`` cuts that arc into the blocks of one
launch; their partials meet in a workspace kept per stream. Its source
note says what bounds it on the H100 and how the design answers that.
``flash_decode_ref`` is the plain version with the same contract.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import _aligned
from repro_torch.kernels.ref import flash_decode_ref

__all__ = ["flash_decode", "flash_decode_ref", "launches", "plan"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 256)
_INT32_MAX = 2 ** 31 - 1
GROUP = 16          # query heads of one kv head that one block holds at most

launches = 0   # kernel launches since the count was last set to 0


class Plan(NamedTuple):
    """How one call cuts the visible arc of the ring: ``nvis`` slots at
    distances 0..nvis-1 from the query (slot (pos - dist) mod C), in chunks
    of ``chunk`` rows, ``per_split`` chunks to a block, ``splits`` blocks
    per (batch row, kv head, group of up to 16 query heads)."""
    nvis: int
    chunk: int
    per_split: int
    splits: int
    units: int        # B x HK x head groups


def plan(B: int, H: int, HK: int, C: int, D: int, pos: int,
         window: Optional[int], sms: int) -> Plan:
    """The kernel's work split for a card with ``sms`` SMs. Chunks start at
    64 rows (fewer at D = 128 and 256, so two stages of K and V stay near
    64 KB of shared memory) and halve, down to 8 rows, until the blocks
    reach the SM count; then about one block an SM per (b, kv head, group)
    takes the chunks, each split walking its chunks through a two-stage
    ring. (More splits shorten the walk but lengthen the merge, which one
    block does: G x D floats a split.)"""
    return _split(B, H, HK, D, min(pos + 1, C, window if window is not None else C), sms)


def _split(B: int, H: int, HK: int, D: int, nvis: int, sms: int) -> Plan:
    units = B * HK * -(-(H // HK) // GROUP)
    chunk, low = min(64, 4096 // D), max(8, 512 // D)
    while chunk > low and units * -(-nvis // chunk) < sms:
        chunk //= 2
    nchunks = -(-nvis // chunk)
    want = max(1, -(-sms // units))
    per_split = -(-nchunks // want)
    return Plan(nvis, chunk, per_split, -(-nchunks // per_split), units)


def _workspace_size(sms: int) -> Tuple[int, int]:
    """Floats of split partials and int32 merge counters that every plan on
    a card with ``sms`` SMs fits in: a plan splits only when its units are
    fewer than the SMs, and then units x splits < 2 x SMs."""
    return 2 * sms * GROUP * (max(HEAD_DIMS) + 2), sms


# per (device index, stream handle): the split partials and the merge
# counters (0 between calls). Each is made once, at the size every plan
# fits in, and never freed or grown, so the pointers a CUDA graph captured
# stay valid. The counters need the calls that share them to be ordered:
# each stream gets its own, and calls on one stream are ordered.
_WORKSPACE: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(device: torch.device, stream: int) -> Tuple[torch.Tensor, torch.Tensor]:
    ws = _WORKSPACE.get((device.index, stream))
    if ws is None:
        if torch.cuda.is_current_stream_capturing():
            # made now, its counters would be zeroed only when the graph runs
            raise RuntimeError("flash_decode: this stream has no workspace yet; call "
                               "flash_decode once on it before capturing a CUDA graph")
        n_part, n_count = _workspace_size(_build.sm_count(device))
        ws = (torch.empty(n_part, dtype=torch.float32, device=device),
              torch.zeros(n_count, dtype=torch.int32, device=device))
        _WORKSPACE[(device.index, stream)] = ws
    return ws


@functools.lru_cache(maxsize=1024)
def _geometry(device: torch.device, dtype: int, B: int, H: int, HK: int, C: int, D: int,
              nvis: int, *strides: int):
    """The plan and the kernel's int64 geometry array (strides, sizes, plan)
    of a call: the same for every layer of a decode step, so built once and
    passed as one argument (each argument ctypes converts costs host time,
    and a decode step is bound by host time)."""
    sms = _build.sm_count(device)
    p = _split(B, H, HK, D, nvis, sms)
    n_part, n_count = _workspace_size(sms)
    if p.splits > 1 and (p.units * p.splits * GROUP * (D + 2) > n_part or p.units > n_count):
        raise RuntimeError(f"flash_decode: plan {p} exceeds the workspace")
    geometry = (ctypes.c_longlong * 18)(*strides, B, H, HK, C, D, dtype,
                                        p.nvis, p.chunk, p.per_split, p.splits)
    return p, geometry


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.library("flash_decode").flash_decode_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
                                            ctypes.c_float] + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, pos, window):
    """Raise on what the kernel does not take, wherever the tensors lie;
    returns the sizes and the three stride tuples. (Every call of a decode
    step passes here, so it reads each attribute once.)"""
    dt = q.dtype
    if dt not in _DTYPES or k.dtype is not dt or v.dtype is not dt:
        raise TypeError(f"flash_decode: dtypes {q.dtype}, {k.dtype}, {v.dtype}; "
                        f"takes one of {list(_DTYPES)}")
    qs, ks = q.shape, k.shape
    if len(qs) != 3 or len(ks) != 4 or v.shape != ks:
        raise ValueError(f"flash_decode: shapes {tuple(qs)}, {tuple(ks)}, {tuple(v.shape)}")
    B, H, D = qs
    _, HK, C, Dk = ks
    if ks[0] != B or Dk != D or HK == 0 or H % HK or C == 0:
        raise ValueError(f"flash_decode: q {tuple(qs)} vs k/v {tuple(ks)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_decode: head dim {D} not in {HEAD_DIMS}")
    sq, sk, sv = q.stride(), k.stride(), v.stride()
    if sq[2] != 1 or sk[3] != 1 or sv[3] != 1:
        raise ValueError("flash_decode: the head dim must be contiguous")
    if not 0 <= int(pos) <= _INT32_MAX:
        raise ValueError(f"flash_decode: pos must be an int32 >= 0, got {pos}")
    if window is not None and window < 1:
        raise ValueError(f"flash_decode: window must be >= 1, got {window}")
    return B, H, HK, C, D, sq, sk, sv


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos: int, *,
                 window: Optional[int] = None,
                 logit_scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,H,D); k, v: (B,HK,C,D) ring caches on one CUDA device, all f32
    or all bf16, each with its last dim contiguous (any b, h, s strides, so
    the model's (B,C,HK,D) cache layers pass as views). ``pos`` is a host
    int: the position of the query, whose k and v are already written at
    slot pos % C. Returns a contiguous (B,H,D) in q's dtype."""
    global launches
    B, H, HK, C, D, sq, sk, sv = _check(q, k, v, pos, window)
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("flash_decode runs on CUDA tensors only; the plain "
                         "version for the CPU is flash_decode_ref")
    dev = q.device
    if k.device != dev or v.device != dev:
        raise ValueError("flash_decode: operands lie on different devices")
    kp, vp = k.data_ptr(), v.data_ptr()
    if ((kp | vp) % 16
            or (sk[0] | sk[1] | sk[2] | sv[0] | sv[1] | sv[2]) * k.element_size() % 16):
        k, v = _aligned(k), _aligned(v)
        kp, vp, sk, sv = k.data_ptr(), v.data_ptr(), k.stride(), v.stride()
    pos = int(pos)
    p, geometry = _geometry(dev, _DTYPES[q.dtype], B, H, HK, C, D,
                            min(pos + 1, C, window if window is not None else C),
                            sq[0], sq[1], sk[0], sk[1], sk[2], sv[0], sv[1], sv[2])
    # PyTorch's current stream by its raw handle (torch.cuda.current_stream
    # builds a Stream object, microseconds a call, in a host-bound step)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    part = count = None
    if p.splits > 1:
        part, count = (t.data_ptr() for t in _workspace(dev, stream))
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    scale = logit_scale if logit_scale is not None else D ** -0.5
    err = _entry()(q.data_ptr(), kp, vp, out.data_ptr(), geometry, pos, scale, part, count,
                   stream)
    if err != 0:
        # a workspace whose launch failed may hold a counter that is not 0
        _WORKSPACE.pop((dev.index, stream), None)
        raise RuntimeError(f"flash_decode launch failed: CUDA error {err}")
    launches += 1
    return out
