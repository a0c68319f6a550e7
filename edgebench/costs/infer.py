"""One ``SplitServingEngine.infer`` of B x S tokens: its matrix work (each
layer's projections and attention products, from the configuration's own
file ``costs/<reference>.py``, and the head), split into f32 FLOPs and int8
operations by the version, and the launches of each hand-written kernel it
makes. Elementwise work (norms, the activation quantization, the conv, the
scan's own arithmetic) is not counted, so a share of the peak from these
counts is a lower bound."""
from __future__ import annotations

import importlib
from typing import Dict, Mapping

KERNELS = ("flash_attention", "quant_matmul", "mamba_scan")


def arch(config: Mapping):
    return importlib.import_module(f"edgebench.costs.{config['reference']}")


def cost(config: Mapping, B: int, S: int, version: str) -> Dict[str, float]:
    m, a = config["model"], arch(config)
    M, L = B * S, m["n_layers"]
    quant, plain = a.projections(m)
    head = 2.0 * M * m["d_model"] * m["vocab_size"]
    tied = m["tie_embeddings"]          # a tied head is a plain matmul
    qwork = L * sum(2.0 * M * k * n for k, n in quant) + (0.0 if tied else head)
    f32 = (L * (sum(2.0 * M * k * n for k, n in plain) + a.attention_flops(m, B, S))
           + (head if tied else 0.0))
    if version == "w8":
        return {"f32_flops": f32, "int8_ops": qwork}
    return {"f32_flops": f32 + qwork, "int8_ops": 0.0}


def launches(config: Mapping, version: str) -> Dict[str, int]:
    """Launches of each hand-written kernel in one infer."""
    m, a = config["model"], arch(config)
    L = m["n_layers"]
    out = {k: L * n for k, n in a.kernels(m).items()}
    quant, _ = a.projections(m)
    out["quant_matmul"] = (L * len(quant) + (not m["tie_embeddings"])) if version == "w8" else 0
    return {k: out.get(k, 0) for k in KERNELS}


def ideal_s(config: Mapping, B: int, S: int, version: str, peaks: Mapping) -> float:
    c = cost(config, B, S, version)
    return c["f32_flops"] / peaks["f32_flops_per_s"] + c["int8_ops"] / peaks["int8_ops_per_s"]
