"""``mamba_scan`` (csrc/mamba_scan.cu), the forward: u, dt (B, S, DI), B and C
(B, S, N) and A (DI, N) f32 in; y (B, S, DI) and the final state (B, DI, N)
f32 out. One exp a (position, channel, state): exp(dt A)."""
from __future__ import annotations

from typing import Dict

KERNEL = ("mamba_scan",)
NOT = ("bwd",)


def cost(B: int, S: int, DI: int, N: int) -> Dict[str, float]:
    return {"exps": float(B * S * DI * N),
            "bytes": float(4 * (2 * B * S * DI + 2 * B * S * N + DI * N + B * S * DI + B * DI * N))}


def bound_s(c: Dict[str, float], peaks: Dict) -> float:
    return max(c["exps"] / peaks["sfu_exp_per_s"], c["bytes"] / peaks["hbm_bytes_per_s"])
