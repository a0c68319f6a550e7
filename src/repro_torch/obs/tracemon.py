"""Build accounting (port of ``repro.obs.jaxmon``): how often a
specialized step was built, per call site, and how many CUDA kernels
``nvcc`` compiled, in how many seconds.

Two independent mechanisms, both on the host:

**Step-build counting.** The reference counts jit (re-)traces: ``count_trace(site)`` sits inside
a jitted body, which Python runs only while tracing. The port compiles
nothing on those paths; what stands in for a trace is the build of a
specialized step function, cached by the value it is specialized on
(``repro_torch.online.adapt``: one update step per window bucket, one
capture step per exploration rate). ``count_trace`` is called where
such a step is built, never where it is called, so the counter moves
exactly when the reference's retrace counter would.

**Compile accounting.** What the reference's compile listener counts
(jaxpr traces, MLIR lowerings, XLA compiles) the port does once, ahead
of time: ``nvcc`` builds each kernel's library
(``repro_torch.kernels._build.build``). ``install`` registers a build
listener there that adds each build to the process-wide totals
(``nvcc_build_n``, ``nvcc_build_s``) and mirrors it into the active
recorder as a ``build.kernel`` event with the kernel's name and
seconds. ``Recorder`` snapshots the totals at start and emits the delta
at close under the reference's ``jax`` summary event, so an events file
says how much of a run was spent compiling kernels. A library already
built (cached under ``build/repro_torch/``) counts nothing.
"""
from __future__ import annotations

import collections
from contextlib import contextmanager
from typing import Dict

from repro_torch.obs import events as _ev

# site -> number of times a step was built there (process-wide, monotone)
_TRACE_COUNTS: collections.Counter = collections.Counter()

# nvcc build totals (process-wide)
_COMPILE: collections.Counter = collections.Counter()
_INSTALLED = False


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


def _on_build(kernel: str, seconds: float) -> None:
    _COMPILE["nvcc_build_n"] += 1
    _COMPILE["nvcc_build_s"] += seconds
    rec = _ev.get_recorder()
    if rec.enabled:
        rec.event("build.kernel", kernel=kernel, seconds=seconds)


def install() -> None:
    """Register the kernel-build listener (idempotent)."""
    global _INSTALLED
    if _INSTALLED:
        return
    from repro_torch.kernels import _build
    _build.add_build_listener(_on_build)
    _INSTALLED = True


def compile_stats() -> Dict[str, float]:
    """Process-wide build totals: ``nvcc_build_n`` libraries compiled in
    ``nvcc_build_s`` seconds (absent until the first build)."""
    install()
    return dict(_COMPILE)


@contextmanager
def track_compiles():
    """Yields a dict filled (on exit) with build-total deltas for the
    block; ``nvcc_build_n`` is the number of kernels it compiled."""
    install()
    before = dict(_COMPILE)
    delta: Dict[str, float] = {}
    try:
        yield delta
    finally:
        for k, v in _COMPILE.items():
            d = v - before.get(k, 0)
            if d:
                delta[k] = d
