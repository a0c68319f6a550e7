"""``flash_attention`` (csrc/flash_attention.cu), the causal forward: q (B,
H, S, D), k (B, HK, S, D), v (B, HK, S, Dv), out (B, H, S, Dv), f32."""
from __future__ import annotations

from typing import Dict, Optional

KERNEL = ("flash_fwd",)


def visible_pairs(S: int, window: Optional[int]) -> int:
    """(query, key) pairs a causal mask, cut at ``window``, lets through."""
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def cost(B: int, S: int, H: int, HK: int, D: int, Dv: int,
         window: Optional[int]) -> Dict[str, float]:
    pairs = B * H * visible_pairs(S, window)
    return {"f32_flops": 2.0 * pairs * (D + Dv),
            "bytes": 4.0 * B * S * (H * D + HK * D + HK * Dv + H * Dv)}


def bound_s(c: Dict[str, float], peaks: Dict) -> float:
    return max(c["f32_flops"] / peaks["f32_flops_per_s"], c["bytes"] / peaks["hbm_bytes_per_s"])
