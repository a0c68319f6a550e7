"""How ``correct`` is decided: the logits that the timed ``infer`` calls
returned for a sample of requests, held against the plain reference, and
the link bytes of every batch served in the window.

Numbers compared (limits in ``edgebench/limits/<workload>.json``):

- ``logit_err.<version>``: over the sampled requests of that version and
  each of their positions, the widest gap between the program's logit and
  the reference's, over that position's root mean square of the reference's
  logits. The widest over all positions and vocabulary entries.
- ``logit_med.<version>``: the median over those positions of the same
  per-position gap. A few int8 codes that rounding flips set the widest
  gap; the median reads what every position carries, such as f32 work done
  in a lower precision under a w8 path.
- ``bad_answers``: batches of the window whose logits are not (B, S, vocab)
  or whose ``act_bytes`` differ from the bytes of the cut activation the
  version ships (int8 codes and f32 row scales for w8, f32 otherwise).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Mapping, Tuple

import torch

from edgebench import reference
from edgebench.reference.arith import CONTROLS

LIMITS_DIR = Path(__file__).resolve().parent / "limits"


def load_limits(workload: str) -> Dict[str, float]:
    path = LIMITS_DIR / f"{workload}.json"
    return json.loads(path.read_text())["limits"] if path.is_file() else {}


def load_controls(workload: str) -> List[str]:
    """The controls of ``CONTROLS`` that have to fail one of the cell's
    numbers (the limits file's ``controls``)."""
    return json.loads((LIMITS_DIR / f"{workload}.json").read_text())["controls"]


def position_errs(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """(S,) max_v |got - want| / rms_v(want) at each position; inf throughout
    where the shapes differ or the program's logits are not finite."""
    got, want = got.to(torch.float32), want.to(torch.float32)
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        return torch.full(want.shape[:-1], float("inf"), device=want.device)
    rms = want.square().mean(dim=-1).sqrt().clamp_min(1e-30)
    return (got - want).abs().amax(dim=-1) / rms


def logit_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The widest of ``position_errs``."""
    return float(position_errs(got, want).max())


def link_bytes(config: Mapping, B: int, S: int, version: str) -> int:
    d = config["model"]["d_model"]
    return B * S * d + B * S * 4 if version == "w8" else B * S * d * 4


def bad_answers(config: Mapping, served) -> int:
    V = config["model"]["vocab_size"]
    return sum(1 for s in served
               if s.logits_shape != (s.batch.B, s.batch.S, V)
               or s.act_bytes != link_bytes(config, s.batch.B, s.batch.S, s.batch.version))


def requests_of(held: Mapping[int, Tuple[object, int, torch.Tensor]]) -> List[Dict]:
    """The reference's requests from the held {batch index: (batch, row,
    logits)}: one B = 1 request each, with its layers before the cut."""
    out = []
    for _, (b, row, _) in sorted(held.items()):
        stack, at = b.cut
        if stack != "main":
            raise ValueError(f"cut {b.cut}: the reference knows one stack, 'main'")
        out.append({"tokens": b.tokens[row], "version": b.version, "cut": at})
    return out


def errors(config: Mapping, seed: int, held, device,
           with_control: bool = False) -> Dict[str, float]:
    """{"logit_err.<version>": widest, "logit_med.<version>": median} of the
    held requests' position errors against the reference; ``with_control``
    adds the same numbers of each control of ``CONTROLS`` on the same
    requests, under "<control>.logit_err.<version>" and so on."""
    reqs = requests_of(held)
    want = reference.logits(config, seed, reqs, device)
    sides = [("", [lg for _, (_, _, lg) in sorted(held.items())])]
    if with_control:
        sides += [(f"{name}.", reference.logits(config, seed, reqs, device, control=name))
                  for name in CONTROLS]
    out: Dict[str, float] = {}
    for prefix, got in sides:
        errs: Dict[str, List[torch.Tensor]] = {}
        for r, g, w in zip(reqs, got, want):
            errs.setdefault(r["version"], []).append(position_errs(g, w))
        for v, e in errs.items():
            e = torch.cat(e)
            out[f"{prefix}logit_err.{v}"] = float(e.max())
            out[f"{prefix}logit_med.{v}"] = float(e.median())
    return out


def verdict(numbers: Mapping[str, float], limits: Mapping[str, float]) -> Tuple[bool, List[str]]:
    """(every number within its limit, and every number has one; lines
    'name number limit')."""
    ok, lines = bool(numbers), []
    for name in sorted(numbers):
        limit = limits.get(name)
        value = numbers[name]
        ok = ok and limit is not None and value <= limit
        lines.append(f"{name} {value!r} limit {limit!r}")
    return ok, lines
