"""The traced slices: ``torch.profiler`` over batches of the window, reduced
to a record that the per-layer metric readers take: the device kernels, the
slice's length and, where the host's ops were recorded, the slice's bounds,
the benchmark's span around each infer and the host ops, all in the
profiler's one clock (ns)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

WINDOW_SPAN = "edgebench.window"
INFER_SPAN = "edgebench.infer."

Interval = Tuple[str, int, int]   # (name, start ns, end ns)


@dataclasses.dataclass
class Record:
    config: Mapping
    batches: List[Dict]           # {"B", "S", "version"} of each traced infer
    window_s: float               # the slice's length
    kernels: List[Interval]       # device kernels (no copies or fills)
    peaks: Mapping
    window: Optional[Tuple[int, int]] = None   # the slice, ns, where the host was traced
    spans: List[Interval] = dataclasses.field(default_factory=list)     # infer spans
    host_ops: List[Interval] = dataclasses.field(default_factory=list)  # for naming gaps

    def launches_of(self, names, exclude=()) -> List[Interval]:
        return [k for k in self.kernels
                if any(n in k[0] for n in names) and not any(x in k[0] for x in exclude)]


def _activity(ev) -> str:
    try:
        return str(ev.activity_type())
    except Exception:    # older kineto bindings
        return ""


def from_profile(prof, config: Mapping, batches: List[Dict], peaks: Mapping,
                 window_s: Optional[float] = None) -> Record:
    """Reduce a finished ``torch.profiler.profile`` to a ``Record``. With
    ``window_s`` (the slice's length by the host's clock) every kernel of the
    trace is the slice's; without it the slice is the trace's window span,
    and the host's ops and spans are kept. Raises if the slice holds no
    device kernel: a traced run without device time is not a measurement."""
    kernels, spans, host, window = [], [], [], None
    for ev in prof.profiler.kineto_results.events():
        name, t0 = ev.name(), ev.start_ns()
        t1 = t0 + ev.duration_ns()
        on_device = "CUDA" in str(ev.device_type())
        if on_device:
            # copies, fills and the device side of the benchmark's own spans
            # (gpu_user_annotation) are not kernels
            act = _activity(ev).lower()
            if ("memcpy" in act or "memset" in act or "annotation" in act
                    or name.startswith(("Memcpy", "Memset", "edgebench."))):
                continue
            kernels.append((name, t0, t1))
        elif name == WINDOW_SPAN:
            window = (t0, t1)
        elif name.startswith(INFER_SPAN):
            spans.append((name, t0, t1))
        else:
            host.append((name, t0, t1))
    if window_s is None:
        if window is None:
            raise RuntimeError(f"the trace has no {WINDOW_SPAN} span")
        kernels = [k for k in kernels if k[1] >= window[0] and k[2] <= window[1]]
        window_s = (window[1] - window[0]) * 1e-9
    kernels.sort(key=lambda k: (k[1], k[2]))
    if not kernels:
        raise RuntimeError("the profiler recorded no device kernel in the traced slice")
    return Record(config, batches, window_s, kernels, peaks, window,
                  sorted(spans, key=lambda s: (s[1], s[2])),
                  sorted(host, key=lambda h: (h[1], h[2])))


def busy_intervals(rec: Record) -> List[Tuple[int, int]]:
    """The union of the kernels' intervals, clipped to the slice's bounds
    where the record has them."""
    lo, hi = rec.window if rec.window is not None else (None, None)
    out: List[List[int]] = []
    for _, a, b in rec.kernels:
        if lo is not None:
            a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_s(rec: Record) -> float:
    return sum(b - a for a, b in busy_intervals(rec)) * 1e-9


class _Sweep:
    """The intervals open at increasing times ``t``: each interval is added
    once and dropped once it has ended, so naming every gap of a slice is
    linear in its events."""

    def __init__(self, intervals: List[Interval]):
        self.todo, self.i, self.open = intervals, 0, []

    def at(self, t: int) -> List[Interval]:
        while self.i < len(self.todo) and self.todo[self.i][1] <= t:
            self.open.append(self.todo[self.i])
            self.i += 1
        self.open = [iv for iv in self.open if iv[2] >= t]
        return self.open


def gap_names(rec: Record, times: List[int]) -> List[str]:
    """What the host did at each of the increasing ``times``: the infer span
    around it and the innermost host op running then."""
    spans, ops, out = _Sweep(rec.spans), _Sweep(rec.host_ops), []
    for t in times:
        span, op = spans.at(t), ops.at(t)
        inner = min(op, key=lambda o: o[2] - o[1])[0] if op else "no host op"
        out.append(f"{span[0][0] if span else 'between infers'}: {inner}")
    return out


def breakdown(rec: Record, named: Optional[Record] = None, top: int = 10) -> Dict[str, list]:
    """{"device_ops": the kernels of ``rec`` that took most device time,
    "idle_gaps": the idle time of ``named`` (a slice traced with the host's
    ops; ``rec`` if not given) summed by what the host was doing in it}, in
    seconds, at most ``top`` of each."""
    named = rec if named is None else named
    by_op: Dict[str, float] = {}
    for name, a, b in rec.kernels:
        by_op[name] = by_op.get(name, 0.0) + (b - a) * 1e-9
    gaps: Dict[str, float] = {}
    edges = [named.window[0]] + [t for iv in busy_intervals(named) for t in iv] + [named.window[1]]
    idle = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    for (a, b), name in zip(idle, gap_names(named, [(a + b) // 2 for a, b in idle])):
        gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-9

    def first(d: Dict[str, float]) -> list:
        return [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": first(by_op), "idle_gaps": first(gaps)}


def roofline_pct(rec: Record, names, exclude, per_batch_costs,
                 bound_s) -> Optional[float]:
    """100 x (the sum of the bounds of the kernel's calls in the slice) /
    (the device time of all its launches there). ``per_batch_costs(batch)``
    gives the cost of each call that one infer makes. The sums need no
    matching of launches to calls, so a kernel that splits a call into
    several launches is still read whole. None where the slice has no such
    launch or call."""
    launches = rec.launches_of(names, exclude)
    costs = [c for b in rec.batches for c in per_batch_costs(b)]
    if not launches or not costs:
        return None
    device = sum(b - a for _, a, b in launches) * 1e-9
    return 100.0 * sum(bound_s(c, rec.peaks) for c in costs) / device
