"""AdamW + cosine schedule as plain functions over a dict of tensors (port
of ``repro.optim.adamw``).

The optimizer state mirrors the parameters: {"m", "v"} in f32 plus a
0-d int32 ``step`` on their device. The arithmetic is the reference's,
``(m / bc1) / (sqrt(v / bc2) + eps)`` plus decoupled decay, which
``torch.optim.AdamW`` rounds and decays differently. Dicts are walked in
sorted key order, the reference's tree order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def adamw_init(params: Tensors) -> Dict:
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()}
    dev = next(iter(params.values())).device
    return {"m": zeros, "v": {k: z.clone() for k, z in zeros.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio`` (f32, on the
    step's device)."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clip((step - cfg.warmup_steps)
                   / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * t))
    frac = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * frac


def global_norm(tree: Tensors) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(tree[k].to(torch.float32)))
                          for k in sorted(tree)))


def clip_by_global_norm(tree: Tensors, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: g.to(torch.float32) * scale for k, g in tree.items()}, norm


def adamw_update(cfg: AdamWConfig, params: Tensors, grads: Tensors, state: Dict):
    """One step: returns (new params, new state, {"lr", "grad_norm"});
    nothing is updated in place."""
    step = state["step"] + 1
    lr = cosine_schedule(cfg, step)
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    b1, b2 = cfg.b1, cfg.b2
    m = {k: b1 * state["m"][k] + (1 - b1) * grads[k] for k in params}
    v = {k: b2 * state["v"][k] + (1 - b2) * torch.square(grads[k]) for k in params}
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)

    def upd(p, m_, v_):
        u = (m_ / bc1) / (torch.sqrt(v_ / bc2) + cfg.eps)
        u = u + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * u).to(p.dtype)

    new_params = {k: upd(params[k], m[k], v[k]) for k in params}
    return new_params, {"m": m, "v": v, "step": step}, {"lr": lr, "grad_norm": gnorm}
