"""Counters, gauges and histograms with labeled series (port of
``repro.obs.metrics``, numpy).

A ``Metrics`` registry lives on each ``Recorder``; the module-level
``inc``/``gauge``/``observe`` helpers dispatch through the process
recorder (no-ops when recording is off). Each (name, labels) pair is
one series — e.g. ``inc("fleet.dropped", 3, policy="a2c")`` and
``inc("fleet.dropped", 1, policy="ppo")`` accumulate independently —
and every series snapshots to one ``metric`` JSONL event at
``Recorder.close()``.

Histograms keep raw values (fleet runs observe a few values per epoch,
thousands at most) and summarize to count/mean/min/max/p50/p95/p99 in
the snapshot.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from repro_torch.obs import events as _ev


def _key(name: str, labels: Dict) -> Tuple:
    return (name, tuple(sorted(labels.items())))


class Metrics:
    """Label-keyed counter/gauge/histogram registry (one per Recorder)."""

    def __init__(self):
        self._counters: Dict[Tuple, float] = {}
        self._gauges: Dict[Tuple, float] = {}
        self._hists: Dict[Tuple, List[float]] = {}

    def inc(self, name: str, value: float = 1.0, **labels):
        k = _key(name, labels)
        self._counters[k] = self._counters.get(k, 0.0) + float(value)

    def gauge(self, name: str, value: float, **labels):
        self._gauges[_key(name, labels)] = float(value)

    def observe(self, name: str, value: float, **labels):
        self._hists.setdefault(_key(name, labels), []).append(float(value))

    def snapshot(self) -> List[Dict]:
        """One ``metric`` event dict per series (JSONL-ready)."""
        out = []
        for (name, labels), v in sorted(self._counters.items()):
            out.append({"type": "metric", "kind": "counter", "name": name,
                        "labels": dict(labels), "value": v})
        for (name, labels), v in sorted(self._gauges.items()):
            out.append({"type": "metric", "kind": "gauge", "name": name,
                        "labels": dict(labels), "value": v})
        for (name, labels), vals in sorted(self._hists.items()):
            a = np.asarray(vals)
            out.append({"type": "metric", "kind": "histogram", "name": name,
                        "labels": dict(labels), "count": int(a.size),
                        "mean": float(a.mean()), "min": float(a.min()),
                        "max": float(a.max()),
                        "p50": float(np.percentile(a, 50)),
                        "p95": float(np.percentile(a, 95)),
                        "p99": float(np.percentile(a, 99))})
        return out


# -- module-level helpers over the process recorder ------------------------

def inc(name: str, value: float = 1.0, **labels) -> None:
    _ev.get_recorder().metrics.inc(name, value, **labels)


def gauge(name: str, value: float, **labels) -> None:
    _ev.get_recorder().metrics.gauge(name, value, **labels)


def observe(name: str, value: float, **labels) -> None:
    _ev.get_recorder().metrics.observe(name, value, **labels)
