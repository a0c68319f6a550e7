"""int8 x int8 -> int32 matmul with f32 rescale: the CUDA kernel's wrapper.

Replaces ``repro/kernels/quant_matmul.py::quant_matmul`` (Pallas
``_qmm_kernel``). The kernel (``csrc/quant_matmul.cu``) has two regimes
behind one entry point, one launch a call, and ``plan`` picks one by M and
the depth of K: a split-K stream of the weight bytes (``__dp4a``, the
partials summed in the same launch through a workspace kept per stream)
for small M over deep K, else ``wgmma`` s8 fed by TMA. Both read the
weight K-major. Its source note says what bounds each regime on the H100
and how the design answers that. ``quant_matmul_ref`` is the plain version
with the same contract.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import quant_matmul_ref

__all__ = ["quant_matmul", "quant_matmul_ref", "launches", "plan", "split_plan", "wgmma_plan"]

# the int32 accumulator cannot overflow: K * 128 * 128 < 2**31
MAX_K = (2 ** 31 - 1) // (128 * 128)
SPLIT_M_MAX = 64          # rows up to which the split-K regime may run
WG_WALK_MAX = 16          # k steps of the busiest wgmma block that small M allows
KROWS = 16                # rows of K: the grain of a split's slice
SPLIT_WIDTHS = (128, 64, 32)
SPLIT_MT_MAX = 16         # rows of x one split block holds
WG_BK = 128               # bytes of K a wgmma stage
WG_TILES = ((128, 128), (128, 64))   # wgmma tiles (rows, columns), largest first

launches = 0   # kernel launches since the count was last set to 0


class Plan(NamedTuple):
    """One call's work split. ``regime`` "split": tiles of ``mt`` rows x
    ``bn`` columns, each cut along K into ``splits`` slices of ``per_rows``
    rows (a multiple of 16), one block a (tile, slice). "wgmma": tiles of
    ``mt`` rows x ``bn`` columns, which min(tiles, SMs) persistent blocks
    walk (``per_rows`` and ``splits`` unused: K, 1)."""
    regime: str
    bn: int
    mt: int
    per_rows: int
    splits: int
    tiles: int

    @property
    def blocks(self) -> int:
        """The split regime's blocks (the wgmma regime runs min(tiles, SMs))."""
        return self.tiles * self.splits


def plan(M: int, N: int, K: int, sms: int, aligned: bool = True) -> Plan:
    """The work split on a card with ``sms`` SMs. The wgmma regime needs
    K % 16 == 0, N % 4 == 0 and 16-byte ``aligned`` operands (TMA); it
    takes every M above ``SPLIT_M_MAX``, and smaller M when its busiest
    block walks at most ``WG_WALK_MAX`` 128-deep steps of K: there it is
    the faster one (both regimes are then bound by a few memory round
    trips, and the split regime's merge adds some). Longer walks at small M
    go to the split regime, which spreads K over the card."""
    if K % 16 == 0 and N % 4 == 0 and aligned:
        p = wgmma_plan(M, N, K, sms)
        if M > SPLIT_M_MAX or -(-p.tiles // sms) * -(-K // WG_BK) <= WG_WALK_MAX:
            return p
    return split_plan(M, N, K, sms)


def wgmma_plan(M: int, N: int, K: int, sms: int) -> Plan:
    """The largest of the ``WG_TILES`` (rows, columns) whose tiles give the
    card one an SM, else the smallest; the kernel runs min(tiles, SMs)
    persistent blocks."""
    for bm, bn in WG_TILES:
        tiles = -(-M // bm) * -(-N // bn)
        if tiles >= sms:
            break
    return Plan("wgmma", bn, bm, K, 1, tiles)


def split_plan(M: int, N: int, K: int, sms: int) -> Plan:
    """``mt`` the fewest of 4, 8, 16 rows that hold M (16 for larger M),
    the widest ``bn`` of 128, 64, 32 at which the tiles times the 16-row
    units of K reach twice the SMs; tiles that fill the card alone take
    all of K, fewer tiles cut K so that the blocks reach the SM count (so a
    split plan has fewer tiles than SMs, which bounds its workspace)."""
    mt = next((t for t in (4, 8) if M <= t), SPLIT_MT_MAX)
    m_tiles = -(-M // mt)
    units = -(-K // KROWS)
    for bn in SPLIT_WIDTHS:
        tiles = m_tiles * -(-N // bn)
        if tiles * units >= 2 * sms:
            break
    if tiles >= sms:
        return Plan("split", bn, mt, units * KROWS, 1, tiles)
    per = max(1, units * tiles // sms)
    return Plan("split", bn, mt, per * KROWS, -(-units // per), tiles)


def _workspace_size(sms: int) -> Tuple[int, int]:
    """int32 partials and tile counters that every split plan on a card with
    ``sms`` SMs fits in: such a plan has fewer tiles than SMs, each of at
    most 16 x 128 partial sums."""
    return sms * SPLIT_MT_MAX * SPLIT_WIDTHS[0], sms


# per (device index, stream handle): the split partials and the tile
# counters, both 0 between calls (the last block of each tile zeroes its
# own). Each is made once, at the size every plan fits in, and never freed
# or grown, so the pointers a CUDA graph captured stay valid. Calls that
# share them must be ordered: each stream gets its own.
_WORKSPACE: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _workspace(device: torch.device, stream: int) -> Tuple[torch.Tensor, torch.Tensor]:
    ws = _WORKSPACE.get((device.index, stream))
    if ws is None:
        if torch.cuda.is_current_stream_capturing():
            # made now, it would be zeroed only when the graph runs
            raise RuntimeError("quant_matmul: this stream has no workspace yet; call "
                               "quant_matmul once on it before capturing a CUDA graph")
        n_part, n_count = _workspace_size(_build.sm_count(device))
        ws = (torch.zeros(n_part, dtype=torch.int32, device=device),
              torch.zeros(n_count, dtype=torch.int32, device=device))
        _WORKSPACE[(device.index, stream)] = ws
    return ws


_REGIMES = {"split": 0, "wgmma": 1}


@functools.lru_cache(maxsize=1024)
def _geometry(device: torch.device, M: int, N: int, K: int, aligned: bool):
    """The plan and the kernel's int64 plan array of a call: the same for
    every call of a shape, so built once and passed as one argument."""
    p = plan(M, N, K, _build.sm_count(device), aligned)
    n_part, n_count = _workspace_size(_build.sm_count(device))
    if p.splits > 1 and (p.tiles * p.mt * p.bn > n_part or p.tiles > n_count):
        raise RuntimeError(f"quant_matmul: plan {p} exceeds the workspace")
    array = (ctypes.c_longlong * 8)(M, N, K, _REGIMES[p.regime], p.bn, p.mt, p.per_rows,
                                    p.splits)
    return p, array


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.library("quant_matmul").quant_matmul_s8
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    return fn


def _k_major(w_q: torch.Tensor) -> torch.Tensor:
    """w_q (K, N) as the kernel reads it, (N, K) row major: a view where
    w_q is held K-major (a w8a8 leaf is), else a copy made for the call."""
    w_t = w_q.t()
    return w_t if w_t.is_contiguous() else w_t.contiguous()


def quant_matmul(x_q: torch.Tensor, w_q: torch.Tensor, x_scale: torch.Tensor,
                 w_scale: torch.Tensor) -> torch.Tensor:
    """x_q (M,K) int8, w_q (K,N) int8, x_scale (M,) f32, w_scale (N,) f32,
    all on one CUDA device -> f32 (M,N), equal bit for bit to
    ``quant_matmul_ref``. x_q and the scales are contiguous; w_q is either
    held K-major (its transpose is contiguous, as a w8a8 leaf of
    ``models/layers.py::Dense`` holds it: no copy) or contiguous, and then
    every call pays a transpose of the whole weight into a K-major copy
    (K * N bytes read and written; 266 MB for falcon-mamba-7b's head)."""
    global launches
    tensors = (x_q, w_q, x_scale, w_scale)
    if not all(t.is_cuda for t in tensors):
        raise ValueError("quant_matmul runs on CUDA tensors only; the plain "
                         "version for the CPU is quant_matmul_ref")
    dev = x_q.device
    if any(t.device != dev for t in tensors[1:]):
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
    if not (all(t.is_contiguous() for t in (x_q, x_scale, w_scale))
            and (w_q.is_contiguous() or w_q.t().is_contiguous())):
        raise ValueError("quant_matmul: x_q and the scales must be contiguous, "
                         "w_q contiguous or K-major")
    if K > MAX_K:
        raise ValueError(f"quant_matmul: K={K} could overflow the int32 sum")
    w_t = _k_major(w_q)
    aligned = (x_q.data_ptr() | w_t.data_ptr()) % 16 == 0
    p, array = _geometry(dev, M, N, K, aligned)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    part = count = None
    if p.splits > 1:
        part, count = (t.data_ptr() for t in _workspace(dev, stream))
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    err = _entry()(x_q.data_ptr(), w_t.data_ptr(), x_scale.data_ptr(), w_scale.data_ptr(),
                   out.data_ptr(), array, part, count, stream)
    if err != 0:
        # a workspace whose launch failed may hold a partial that is not 0
        _WORKSPACE.pop((dev.index, stream), None)
        raise RuntimeError(f"quant_matmul launch failed: CUDA error {err}")
    launches += 1
    return out
