"""Declarative benchmark case matrix (port of ``repro.bench.matrix``,
pure Python).

A benchmark is a plain function that emits rows through
``repro_torch.bench.runner.emit``; the matrix is the registry that turns
those functions into an expanded list of ``Case``s — optionally
cartesian-expanded over parameter axes (fleet sizes, scenarios,
backends) the way antmicro/benchalot expands config matrices — that
the runner executes and the gate keys history on.

    m = Matrix()
    m.add(quant_matmul, tags=("system", "smoke"))
    m.add(fleet_sim, tags=("system", "smoke"),
          axes={"n_uavs": (8, 64, 256)})
    m.select(only=["fleet_sim"])          # all three expanded cases
    m.select(only=["fleet_sim[n_uavs=64]"])  # exactly one

Axis values may be a callable (resolved lazily at expansion) so a
registry-backed axis — scenario names, policy names — doesn't force
the registry import at matrix-definition time.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from itertools import product
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class Case:
    """One executable benchmark case: ``fn(**params)``."""
    name: str                       # expanded, unique: fleet_sim[n_uavs=64]
    group: str                      # the registered function's name
    fn: Callable
    params: Dict = field(default_factory=dict)
    tags: Tuple[str, ...] = ()

    def run(self, **overrides):
        return self.fn(**{**self.params, **overrides})

    def with_params(self, **overrides) -> "Case":
        return replace(self, params={**self.params, **overrides})


def _axis_values(v):
    return tuple(v() if callable(v) else v)


class Matrix:
    """Ordered registry of benchmark functions with optional axes."""

    def __init__(self):
        self._specs: List[Dict] = []

    def add(self, fn: Callable, *, name: Optional[str] = None,
            tags: Sequence[str] = (),
            axes: Optional[Dict[str, object]] = None, **fixed) -> None:
        """Register ``fn``. ``axes`` maps kwarg name -> values (or a
        zero-arg callable yielding them); the case list is the
        cartesian product. ``fixed`` kwargs apply to every case."""
        self._specs.append({"fn": fn, "name": name or fn.__name__,
                            "tags": tuple(tags), "axes": dict(axes or {}),
                            "fixed": dict(fixed)})

    def groups(self) -> List[str]:
        return [s["name"] for s in self._specs]

    def cases(self) -> List[Case]:
        out: List[Case] = []
        for s in self._specs:
            if not s["axes"]:
                out.append(Case(name=s["name"], group=s["name"],
                                fn=s["fn"], params=dict(s["fixed"]),
                                tags=s["tags"]))
                continue
            keys = list(s["axes"])
            for combo in product(*(_axis_values(s["axes"][k])
                                   for k in keys)):
                params = {**s["fixed"], **dict(zip(keys, combo))}
                label = ",".join(f"{k}={v}" for k, v in zip(keys, combo))
                out.append(Case(name=f"{s['name']}[{label}]",
                                group=s["name"], fn=s["fn"],
                                params=params, tags=s["tags"]))
        return out

    def select(self, only: Optional[Iterable[str]] = None,
               tags: Optional[Iterable[str]] = None) -> List[Case]:
        """Filter cases by group/case name and/or tags. Unknown names
        raise a KeyError listing the valid ones (registry convention)."""
        cases = self.cases()
        if tags:
            want = set(tags)
            cases = [c for c in cases if want & set(c.tags)]
        if only is None:
            return cases
        only = list(only)
        known = {c.name for c in cases} | {c.group for c in cases}
        unknown = sorted(set(only) - known)
        if unknown:
            raise KeyError(
                f"unknown benchmark(s) {unknown}; valid groups: "
                f"{sorted({c.group for c in cases})}, valid cases: "
                f"{sorted(c.name for c in cases)}")
        sel = set(only)
        return [c for c in cases if c.name in sel or c.group in sel]
