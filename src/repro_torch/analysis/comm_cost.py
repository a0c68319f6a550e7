"""The collectives a sharded step runs, with their bytes (the port's
counterpart of ``repro.analysis.hlo_collectives``).

The reference parses them out of compiled HLO and multiplies loop bodies by
trip counts. The port counts them as they run: ``CommCost`` is a
``TorchDispatchMode`` that lets DTensor desugar each op first (it returns
``NotImplemented`` for ops on DTensors, as ``CommDebugMode`` does) and sees
the functional collectives (``_c10d_functional``) and eager process-group
collectives (``c10d``) that come out. Ops in a Python loop are counted each
time they run.

Bytes convention, the reference's: per-op moved bytes = result bytes
(all-gather, all-to-all, permute), twice the operand bytes (all-reduce:
the reduce and the broadcast phases), operand bytes (reduce-scatter),
divided later by the device count for the per-link roofline term. On a
CPU mesh (gloo or the fake group), DTensor moves a shard to another dim as
an all-gather and a local chunk where NCCL takes an all-to-all, so such a
move is counted as an all-gather there.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# aten-level collective -> (reference kind, which tensors' bytes it moves)
_KINDS = {
    "all_gather_into_tensor": ("all-gather", "result"),
    "all_gather_into_tensor_coalesced": ("all-gather", "result"),
    "all_reduce": ("all-reduce", "operand2"),
    "all_reduce_": ("all-reduce", "operand2"),
    "all_reduce_coalesced": ("all-reduce", "operand2"),
    "reduce_scatter_tensor": ("reduce-scatter", "operand"),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", "operand"),
    "all_to_all_single": ("all-to-all", "result"),
    "_allgather_base_": ("all-gather", "result"),
    "allgather_": ("all-gather", "result"),
    "allgather_into_tensor_coalesced_": ("all-gather", "result"),
    "allreduce_": ("all-reduce", "operand2"),
    "allreduce_coalesced_": ("all-reduce", "operand2"),
    "_reduce_scatter_base_": ("reduce-scatter", "operand"),
    "reduce_scatter_": ("reduce-scatter", "operand"),
    "alltoall_": ("all-to-all", "result"),
    "alltoall_base_": ("all-to-all", "result"),
}
_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d")


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


class CommCost(TorchDispatchMode):
    """Counts the collectives run inside it. ``result()`` gives the
    reference's keys: ``<kind>`` bytes, ``n_<kind>`` counts and
    ``total_bytes``."""

    def __init__(self):
        super().__init__()
        self.bytes: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if packet._qualified_op_name.split("::")[0] in _NAMESPACES \
                and packet.__name__ in _KINDS:
            kind, rule = _KINDS[packet.__name__]
            if rule == "result":
                moved = _bytes(out)
            else:
                # the operands: the first argument (a tensor or a list)
                moved = _bytes(args[0]) * (2 if rule == "operand2" else 1)
            self.bytes[kind] += moved
            self.counts[f"n_{kind}"] += 1
        return out

    def result(self) -> Dict[str, float]:
        out: Dict[str, float] = dict(self.bytes)
        out.update(self.counts)
        out["total_bytes"] = float(sum(self.bytes.values()))
        return out
