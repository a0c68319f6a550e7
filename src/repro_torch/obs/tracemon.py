"""Build accounting: how often a specialized step was built, per call
site (port of the trace-counting half of ``repro.obs.jaxmon``).

The reference counts jit (re-)traces: ``count_trace(site)`` sits inside
a jitted body, which Python runs only while tracing. The port compiles
nothing on those paths; what stands in for a trace is the build of a
specialized step function, cached by the value it is specialized on
(``repro_torch.online.adapt``: one update step per window bucket, one
capture step per exploration rate). ``count_trace`` is called where
such a step is built, never where it is called, so the counter moves
exactly when the reference's retrace counter would.

The compile-duration half of ``jaxmon`` (``install``,
``compile_stats``, ``track_compiles``) waits for the obs slice.
"""
from __future__ import annotations

import collections
from contextlib import contextmanager
from typing import Dict

from repro_torch.obs import events as _ev

# site -> number of times a step was built there (process-wide, monotone)
_TRACE_COUNTS: collections.Counter = collections.Counter()


def count_trace(site: str) -> None:
    """Record one build of the step at ``site`` (a ``jax.trace`` event
    when recording, as the reference names it)."""
    _TRACE_COUNTS[site] += 1
    rec = _ev.get_recorder()
    if rec.enabled:
        rec.event("jax.trace", site=site, n=_TRACE_COUNTS[site])


def trace_counts() -> Dict[str, int]:
    return dict(_TRACE_COUNTS)


def reset_trace_counts() -> None:
    _TRACE_COUNTS.clear()


@contextmanager
def track_traces():
    """Yields a dict filled (on exit) with per-site build-count deltas
    for the block: ``{}`` means no site built a step."""
    before = dict(_TRACE_COUNTS)
    delta: Dict[str, int] = {}
    try:
        yield delta
    finally:
        for k, v in _TRACE_COUNTS.items():
            d = v - before.get(k, 0)
            if d:
                delta[k] = d
