"""The matrix work of one layer of a Mamba-1 model (``reference/mamba1``)."""
from __future__ import annotations

from typing import Dict, List, Mapping, Tuple


def projections(m: Mapping) -> Tuple[List[Tuple[int, int]], List[Tuple[int, int]]]:
    """((K, N) of each projection the versions quantize (none: the four are
    plain matmuls in the port), of each that stays f32)."""
    d = m["d_model"]
    di, r, n = m["ssm_expand"] * d, m["resolved_dt_rank"], m["ssm_state"]
    return [], [(d, 2 * di), (di, r + 2 * n), (r, di), (di, d)]


def attention_flops(m: Mapping, B: int, S: int) -> float:
    return 0.0


def kernels(m: Mapping) -> Dict[str, int]:
    """Launches of the version-independent kernels in one layer."""
    return {"mamba_scan": 1}
