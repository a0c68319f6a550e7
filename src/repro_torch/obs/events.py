"""Structured tracing: a process-global ``Recorder`` with a null
default, nested spans on a monotonic clock, and versioned JSONL
emission (port of ``repro.obs.events``, pure Python).

Design rules:

- **Null by default, zero overhead off.** The module-global recorder is
  a ``NullRecorder`` whose ``span()`` returns one shared no-op context
  manager: a disabled ``with obs.span(...)`` is a dict-free attribute
  lookup plus two no-op calls.
- **Recording never changes results.** Spans and events read the
  monotonic clock and append dicts; they consume no RNG and touch no
  simulation state, so ``SimResult``/``ComparisonReport`` are
  bit-identical with recording on vs. off (tested).
- **Host side only.** Spans wrap host calls around kernel launches and
  never synchronize the card; the build counter
  (``repro_torch.obs.tracemon``) counts specialized-step builds on the
  host.

JSONL schema (``SCHEMA_VERSION``, the reference's, so either package
reads the other's files): the first line is a meta record
``{"type": "meta", "schema": 1, "clock": "perf_counter", "meta": {...}}``;
every following line is one event with a ``type`` in {span, event, log,
metric, jax}, a monotonic ``t`` (seconds since the recorder started)
and a total-order ``seq``. Spans are emitted at *exit* (so a parent
follows its children in the file) and carry ``dur`` (seconds),
``depth`` and ``parent``; ``read_events`` round-trips the file and
checks the schema version. At close one ``jax`` summary event (the
reference's type name) carries the step-build counts of
``tracemon.trace_counts()`` and, under ``compile``, the kernel builds
(``nvcc_build_n``/``_s``) made while the recorder was open.
``Recorder.report`` folds the events (``repro_torch.obs.report``).
"""
from __future__ import annotations

import json
import sys
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

SCHEMA_VERSION = 1

EVENT_TYPES = ("span", "event", "log", "metric", "jax")


# --------------------------------------------------------------------------
# null (disabled) implementation — the process default
# --------------------------------------------------------------------------

class _NullSpan:
    """Shared no-op context manager: the entire cost of a disabled
    span."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _NullMetrics:
    __slots__ = ()

    def inc(self, name, value=1.0, **labels):
        return None

    def gauge(self, name, value, **labels):
        return None

    def observe(self, name, value, **labels):
        return None


class NullRecorder:
    """Disabled recorder: every hook is a no-op."""

    enabled = False
    metrics = _NullMetrics()

    def span(self, name, /, **attrs):
        return _NULL_SPAN

    def event(self, name, /, **attrs):
        return None

    def log_event(self, level: str, msg: str):
        return None

    def close(self):
        return None


# --------------------------------------------------------------------------
# live implementation
# --------------------------------------------------------------------------

class _Span:
    """Timed nested region. Enter pushes onto the recorder's span
    stack; exit records one ``span`` event with start/duration/depth/
    parent. Single-threaded by design (the fleet loop is)."""

    __slots__ = ("_rec", "name", "attrs", "_t0")

    def __init__(self, rec: "Recorder", name: str, attrs: Dict):
        self._rec = rec
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        self._rec._stack.append(self.name)
        self._t0 = self._rec.clock()
        return self

    def __exit__(self, *exc):
        rec = self._rec
        t1 = rec.clock()
        stack = rec._stack
        stack.pop()
        ev = {"type": "span", "name": self.name,
              "t": self._t0 - rec.t0, "dur": t1 - self._t0,
              "depth": len(stack),
              "parent": stack[-1] if stack else None}
        if self.attrs:
            ev["attrs"] = self.attrs
        rec._emit(ev)
        return False


def _json_default(o):
    """numpy scalars/arrays inside attrs serialize as plain JSON."""
    if hasattr(o, "item"):
        return o.item()
    if hasattr(o, "tolist"):
        return o.tolist()
    return str(o)


class Recorder:
    """In-memory event recorder, optionally flushed to a JSONL file on
    ``close()``. Install process-wide with ``set_recorder`` or the
    ``recording(...)`` context manager."""

    enabled = True

    def __init__(self, path: Optional[str] = None,
                 meta: Optional[Dict] = None, clock=time.perf_counter,
                 flush_every: Optional[int] = None):
        from repro_torch.obs.metrics import Metrics

        self.path = path
        self.clock = clock
        self.t0 = clock()
        self.meta = dict(meta or {})
        self.events: List[Dict] = []
        self.metrics = Metrics()
        self._stack: List[str] = []
        self._seq = 0
        self._closed = False
        # opt-in incremental flushing: every N events the tail is
        # appended to the file, so a killed long run loses at most the
        # last N events (read back with the truncation-tolerant
        # read_events). Default None keeps the single write at close().
        self._flush_every = int(flush_every) if flush_every else None
        self._written = 0          # events already flushed to the file
        self._fh = None
        # kernel-build accounting: snapshot the process totals now, emit
        # the delta in the summary event at close
        from repro_torch.obs import tracemon
        self._compile0 = tracemon.compile_stats()

    def _emit(self, ev: Dict):
        ev["seq"] = self._seq
        self._seq += 1
        self.events.append(ev)
        if self._flush_every and self.path and \
                len(self.events) - self._written >= self._flush_every:
            self._flush()

    def _flush(self):
        """Append the unwritten event tail to the file (opens it — and
        writes the meta header — on first use)."""
        if self._fh is None:
            self._fh = open(self.path, "w")
            self._fh.write(json.dumps(
                {"type": "meta", "schema": SCHEMA_VERSION,
                 "clock": "perf_counter", "meta": self.meta},
                default=_json_default) + "\n")
        for ev in self.events[self._written:]:
            self._fh.write(json.dumps(ev, default=_json_default) + "\n")
        self._written = len(self.events)
        self._fh.flush()

    def span(self, name: str, /, **attrs) -> _Span:
        return _Span(self, name, attrs)

    def event(self, name: str, /, **attrs):
        ev = {"type": "event", "name": name, "t": self.clock() - self.t0}
        if attrs:
            ev["attrs"] = attrs
        self._emit(ev)

    def log_event(self, level: str, msg: str):
        self._emit({"type": "log", "level": level, "msg": msg,
                    "t": self.clock() - self.t0})

    def report(self) -> Dict:
        """Fold this recorder's events into a summary
        (repro_torch.obs.report)."""
        from repro_torch.obs.report import fold
        return fold(self.events, meta=self.meta)

    def close(self):
        """Flush metrics + the build counts, then write the JSONL file
        (when a path was given). Idempotent."""
        if self._closed:
            return
        self._closed = True
        t = self.clock() - self.t0
        for m in self.metrics.snapshot():
            m["t"] = t
            self._emit(m)
        from repro_torch.obs import tracemon
        now = tracemon.compile_stats()
        delta = {k: now[k] - self._compile0.get(k, 0)
                 for k in now if now[k] != self._compile0.get(k, 0)}
        self._emit({"type": "jax", "t": t, "compile": delta,
                    "traces": tracemon.trace_counts()})
        if self._fh is not None:
            self._flush()
            self._fh.close()
            self._fh = None
        elif self.path:
            with open(self.path, "w") as f:
                f.write(json.dumps(
                    {"type": "meta", "schema": SCHEMA_VERSION,
                     "clock": "perf_counter", "meta": self.meta},
                    default=_json_default) + "\n")
                for ev in self.events:
                    f.write(json.dumps(ev, default=_json_default) + "\n")


# --------------------------------------------------------------------------
# process-global recorder + module-level hooks (the instrumentation API)
# --------------------------------------------------------------------------

_NULL = NullRecorder()
_RECORDER = _NULL


def get_recorder():
    return _RECORDER


def set_recorder(rec) -> None:
    """Install ``rec`` process-wide (None restores the null default)."""
    global _RECORDER
    _RECORDER = rec if rec is not None else _NULL


def span(name: str, /, **attrs):
    """Nested timed region on the active recorder (no-op when off)."""
    return _RECORDER.span(name, **attrs)


def event(name: str, /, **attrs) -> None:
    """Point-in-time structured event (no-op when off)."""
    return _RECORDER.event(name, **attrs)


@contextmanager
def recording(path: Optional[str] = None, meta: Optional[Dict] = None,
              flush_every: Optional[int] = None):
    """Install a fresh Recorder for the block; restore the previous one
    and close (flush/write) on exit. Yields the recorder."""
    prev = _RECORDER
    rec = Recorder(path=path, meta=meta, flush_every=flush_every)
    set_recorder(rec)
    try:
        yield rec
    finally:
        set_recorder(prev)
        rec.close()


def read_events(path: str) -> Tuple[Dict, List[Dict]]:
    """Load a JSONL event file -> (meta, events). Fails loudly on a
    missing/mismatched schema version. A truncated *final* line — a run
    killed mid-write under ``flush_every`` — is skipped silently;
    corruption anywhere else still raises."""
    with open(path) as f:
        raw = [s for s in f if s.strip()]
    lines = []
    for i, s in enumerate(raw):
        try:
            lines.append(json.loads(s))
        except json.JSONDecodeError:
            if i == len(raw) - 1:
                break               # torn tail from a killed run
            raise ValueError(f"{path}: corrupt JSONL at line {i + 1}")
    if not lines or lines[0].get("type") != "meta":
        raise ValueError(f"{path}: not an obs event file (no meta header)")
    meta = lines[0]
    if meta.get("schema") != SCHEMA_VERSION:
        raise ValueError(f"{path}: schema {meta.get('schema')!r} != "
                         f"supported {SCHEMA_VERSION}")
    events = lines[1:]
    bad = [e for e in events if e.get("type") not in EVENT_TYPES]
    if bad:
        raise ValueError(f"{path}: unknown event type(s) "
                         f"{sorted({e.get('type') for e in bad})}")
    return meta, events


# --------------------------------------------------------------------------
# structured logging (the print() replacement)
# --------------------------------------------------------------------------
#
# Verbosity gates what reaches the console; every log is additionally
# recorded as a "log" event when recording is on, so --quiet runs still
# keep their story in the JSONL.

_VERBOSITY = 1          # 0 = warnings only, 1 = info, 2 = debug


def set_verbosity(level: int) -> None:
    global _VERBOSITY
    _VERBOSITY = int(level)


def get_verbosity() -> int:
    return _VERBOSITY


def log(msg: str, level: str = "info") -> None:
    _RECORDER.log_event(level, msg)
    if level == "warn":
        print(msg, file=sys.stderr, flush=True)
    elif level == "info" and _VERBOSITY >= 1:
        print(msg, flush=True)
    elif level == "debug" and _VERBOSITY >= 2:
        print(msg, flush=True)


def info(msg: str) -> None:
    log(msg, "info")


def debug(msg: str) -> None:
    log(msg, "debug")


def warn(msg: str) -> None:
    log(msg, "warn")
