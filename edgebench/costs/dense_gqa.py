"""The matrix work of one layer of a dense GQA decoder (``reference/dense_gqa``)."""
from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

from edgebench.costs import flash_attention


def projections(m: Mapping) -> Tuple[List[Tuple[int, int]], List[Tuple[int, int]]]:
    """((K, N) of each projection the versions quantize, of each that stays f32)."""
    d, H, HK, Dh, f = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"], m["d_ff"]
    return [(d, H * Dh), (d, HK * Dh), (d, HK * Dh), (H * Dh, d), (d, f), (f, d)], []


def attention_flops(m: Mapping, B: int, S: int) -> float:
    return flash_attention.cost(B, S, m["n_heads"], m["n_kv_heads"], m["head_dim"],
                                m["head_dim"], m["sliding_window"])["f32_flops"]


def kernels(m: Mapping) -> Dict[str, int]:
    """Launches of the version-independent kernels in one layer."""
    return {"flash_attention": 1}
