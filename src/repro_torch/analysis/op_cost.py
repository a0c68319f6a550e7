"""Analytic cost of a step, counted op by op as it runs (the port's
counterpart of ``repro.analysis.jaxpr_cost``).

The reference walks a step's jaxpr; the port runs the step under a
``TorchDispatchMode`` (with ``FakeTensorMode`` in the dry run: shapes only,
nothing computed) and classifies every aten op it sees with the
reference's rules:

  flops: matmuls as ``torch.utils.flop_counter.FlopCounterMode`` counts
         them (its registry: mm, bmm, addmm, baddbmm, convolutions, SDPA;
         2*M*N*K for a product), 1 per output element for every other op
         except layout and zero-cost ops
  bytes: ``bytes_min`` the matmuls' inputs and outputs plus the outputs of
         gathers, scatters and indexing (elementwise work fused away);
         ``bytes`` adds every other op's outputs (unfused bound);
         ``bytes_fused`` the matmul traffic that leaves a flash kernel
         (score-like outputs and probability-like inputs kept on chip, the
         reference's rule) plus the gathers'.

Remat is counted as it runs: ``torch.utils.checkpoint`` re-runs the
forward inside the backward, and the mode sees both. Ops in Python loops
are counted each time they run, so there are no trip counts to recover.

The reference's primitive classes map to aten ops as follows (the aten
names, without overload):

  LAYOUT_PRIMS (0 flops, no bytes): reshape, transpose, broadcast_in_dim,
    squeeze, slice, concatenate, rev, pad, copy, convert_element_type,
    stop_gradient -> view, _unsafe_view, reshape, view_as, t, transpose,
    permute, expand, expand_as, squeeze, unsqueeze, slice, select, split,
    split_with_sizes, unbind, narrow, cat, stack, flip, roll,
    constant_pad_nd, select_backward and slice_backward (a slice's
    transpose, JAX's pad), clone, copy, copy_, _to_copy, to, contiguous, detach,
    alias, lift_fresh, empty, empty_like, empty_strided, new_empty, zeros,
    zeros_like, new_zeros, ones, ones_like, new_ones, full, full_like,
    new_full, fill, fill_, zero_, scalar_tensor, _local_scalar_dense,
    unfold, as_strided, diagonal, movedim
  ZERO_PRIMS (0 flops, no bytes): iota, eq, ne, ge, gt, le, lt, and, or,
    not, select_n, sign, is_finite, argmax, argmin -> arange, eq, ne, ge,
    gt, le, lt, logical_and, logical_or, logical_not, bitwise_and,
    bitwise_or, bitwise_not, where, sign, isfinite, argmax, argmin
  TRANSCENDENTAL (1 flop an element): exp, log, tanh, logistic, erf,
    rsqrt, sqrt, sin, cos, pow, log1p, expm1, cbrt -> exp, log, tanh,
    sigmoid, erf, rsqrt, sqrt, sin, cos, pow, log1p, expm1
  gather, scatter, scatter-add, dynamic_slice, dynamic_update_slice, take
    (output bytes in every bound) -> embedding, embedding_dense_backward,
    gather, scatter, scatter_add, scatter_reduce, index, index_put,
    index_select, index_add, index_copy, _index_put_impl_
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

LAYOUT_OPS = frozenset("""
view _unsafe_view reshape view_as t transpose permute expand expand_as squeeze
unsqueeze slice select split split_with_sizes unbind narrow cat stack flip roll
constant_pad_nd select_backward slice_backward clone copy copy_ _to_copy to contiguous
detach alias lift_fresh
empty empty_like empty_strided new_empty zeros zeros_like new_zeros ones ones_like
new_ones full full_like new_full fill fill_ zero_ scalar_tensor _local_scalar_dense
unfold as_strided diagonal movedim
""".split())
ZERO_OPS = frozenset("""
arange eq ne ge gt le lt logical_and logical_or logical_not bitwise_and bitwise_or
bitwise_not where sign isfinite argmax argmin
""".split())
TRANSCENDENTAL_OPS = frozenset("""
exp log tanh sigmoid erf rsqrt sqrt sin cos pow log1p expm1
""".split())
GATHER_OPS = frozenset("""
embedding embedding_dense_backward gather scatter scatter_add scatter_reduce index
index_put index_put_ index_select index_add index_copy _index_put_impl_
""".split())
# the dispatcher's own bookkeeping, never an operation of the program
_IGNORED = frozenset("detach_ _has_compatible_shallow_copy_type is_same_size device".split())


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCost(TorchDispatchMode):
    """Counts what runs inside it: ``totals`` {"flops", "bytes",
    "bytes_min", "bytes_fused"} and ``by_op`` {aten op: {"flops",
    "bytes_min", "count"}} (``analyze_jaxpr_by_op``'s breakdown; matmul
    ops are the keys of FlopCounterMode's registry)."""

    def __init__(self):
        super().__init__()
        self.totals = {"flops": 0.0, "bytes": 0.0, "bytes_min": 0.0, "bytes_fused": 0.0}
        self.by_op: Dict[str, Dict[str, float]] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if name in _IGNORED or name in LAYOUT_OPS or name in ZERO_OPS:
            return out
        outs = _tensors(out)
        out_elems = sum(t.numel() for t in outs)
        out_bytes = sum(_nbytes(t) for t in outs)
        acc = self.totals
        d = self.by_op.setdefault(name, {"flops": 0.0, "bytes_min": 0.0, "count": 0})
        d["count"] += 1
        if func.overloadpacket in flop_registry:
            flops = float(flop_registry[func.overloadpacket](*args, **kwargs, out_val=out))
            in_bytes = [_nbytes(t) for t in _tensors((args, kwargs))]
            moved = out_bytes + sum(in_bytes)
            acc["flops"] += flops
            acc["bytes"] += moved
            acc["bytes_min"] += moved
            # a score-like output (much larger than both inputs) and a
            # probability-like input (much larger than the output) stay on
            # chip inside a flash kernel
            fused = out_bytes if out_bytes <= 4 * max(in_bytes) else 0
            fused += sum(b for b in in_bytes if b <= 4 * max(out_bytes, min(in_bytes)))
            acc["bytes_fused"] += fused
            d["flops"] += flops
            d["bytes_min"] += moved
        elif name in GATHER_OPS:
            for k in ("bytes", "bytes_min", "bytes_fused"):
                acc[k] += out_bytes
            d["bytes_min"] += out_bytes
        else:
            # transcendental and every other op: 1 flop an output element
            acc["flops"] += out_elems
            acc["bytes"] += out_bytes
        return out


def analyze_fn(fn, *args, **kwargs) -> Dict[str, float]:
    """{"flops", "bytes", "bytes_min", "bytes_fused"} of ``fn(*args,
    **kwargs)`` as it runs (its backward too, if it calls one)."""
    with OpCost() as cost:
        fn(*args, **kwargs)
    return dict(cost.totals)


def analyze_fn_by_op(fn, *args, **kwargs) -> Dict[str, Dict[str, float]]:
    """The by-op breakdown of ``fn(*args, **kwargs)`` (``OpCost.by_op``)."""
    with OpCost() as cost:
        fn(*args, **kwargs)
    return cost.by_op


def matmul_flops(by_op: Dict[str, Dict[str, float]]) -> float:
    """The matmul FLOPs of a by-op breakdown: the ops FlopCounterMode counts
    (the reference's ``dot_general``)."""
    names = {p.__name__ for p in flop_registry}
    return sum(v["flops"] for k, v in by_op.items() if k in names)
