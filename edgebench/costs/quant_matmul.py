"""``quant_matmul`` (csrc/quant_matmul.cu): x codes (M, K) int8, weight codes
(K, N) int8, row scales (M,) and column scales (N,) f32 in, (M, N) f32 out."""
from __future__ import annotations

from typing import Dict

KERNEL = ("qmm_wgmma", "qmm_split")


def cost(M: int, K: int, N: int) -> Dict[str, float]:
    return {"int8_ops": 2.0 * M * K * N,
            "bytes": float(M * K + K * N + 4 * M + 4 * N + 4 * M * N)}


def bound_s(c: Dict[str, float], peaks: Dict) -> float:
    return max(c["int8_ops"] / peaks["int8_ops_per_s"], c["bytes"] / peaks["hbm_bytes_per_s"])
