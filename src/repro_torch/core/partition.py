"""Cut-point partitioning of the model into head and tail (port of
``repro.core.partition``).

The device runs the embedding and the blocks before the cut (the head),
the cut activation crosses the link, the server runs the rest (the tail).
A cut ``(stack_name, i)`` sits between step i-1 and step i of that stack (a
step is one superblock: recurrentgemma's (rec, rec, attn) period,
llama-3.2-vision's (4 attn, xattn) period, or one block); head and tail
run ``steps[lo:hi]`` of each stack's ModuleList. Both sides compute the
cross-attention families' ``kv_src`` from the batch (the whisper encoder
runs in the head and again in the tail, as in the reference) and pass it
to every step. ``split_forward`` == tail(head(x)) equals the full forward.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M


def cut_for_layer(cfg: ModelConfig, layer_idx: int) -> Tuple[str, int]:
    """Map a global block index to the nearest legal cut (stack, index):
    a stack whose step covers several blocks rounds to the closest step
    boundary."""
    remaining = int(layer_idx)
    defs = M.stack_defs(cfg)
    for si, s in enumerate(defs):
        per = sum(sub.repeat for sub in s.subs)
        total = s.length * per
        if remaining <= total or si == len(defs) - 1:
            step = int(round(remaining / per))
            if si == 0:
                step = max(step, 1)   # cut 0 == full offload (caller-level)
            return (s.name, min(step, s.length))
        remaining -= total
    raise AssertionError("unreachable")


def cut_points(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """Legal cut boundaries: (stack_name, index within the stack)."""
    defs = M.stack_defs(cfg)
    return [(s.name, i) for s in defs for i in range(s.length + 1)
            if (s.name, i) != (defs[0].name, 0)]   # cut 0 == full offload


def _segments(cfg: ModelConfig, cut: Tuple[str, int]):
    """Split stack defs into head segments and tail segments at cut."""
    heads, tails = [], []
    passed = False
    for s in M.stack_defs(cfg):
        if s.name == cut[0]:
            heads.append((s, 0, cut[1]))
            tails.append((s, cut[1], s.length))
            passed = True
        elif not passed:
            heads.append((s, 0, s.length))
        else:
            tails.append((s, 0, s.length))
    return heads, tails


def _run_stacks(model: M.CausalLM, x: torch.Tensor, segments, kv_src) -> torch.Tensor:
    for sdef, lo, hi in segments:
        for step in model.stacks[sdef.name][lo:hi]:
            x, _ = step(x, kv_src=kv_src)
    return x


def run_head(cfg: ModelConfig, model: M.CausalLM, batch, cut: Tuple[str, int]):
    """Device side: embed + head blocks. Returns the cut activation."""
    heads, _ = _segments(cfg, cut)
    return _run_stacks(model, model.embed(batch["tokens"]), heads, model.kv_src(batch))


def run_tail(cfg: ModelConfig, model: M.CausalLM, x: torch.Tensor, batch,
             cut: Tuple[str, int]):
    """Server side: tail blocks + final norm + logits."""
    _, tails = _segments(cfg, cut)
    x = _run_stacks(model, x, tails, model.kv_src(batch))
    return model.head(model.final_norm(x))


def split_forward(cfg: ModelConfig, model: M.CausalLM, batch,
                  cut: Tuple[str, int]):
    """Full split execution; equals forward_logits(cfg, model, batch)."""
    return run_tail(cfg, model, run_head(cfg, model, batch, cut), batch, cut)


def cut_activation_bytes(cfg: ModelConfig, batch_shape) -> int:
    B, S = batch_shape
    return B * S * cfg.d_model * cfg.cdtype.itemsize
