"""The program's spans in the traced slices: ``repro_torch.obs`` records them
on the profiler's clock (``Recorder(clock=time.time_ns)``, Unix ns, as
``torch.profiler`` stamps its events), and the reduction credits the
device's work and idle time to them, in slice A (the device's activity
alone, which records the runtime's calls too, and whose host the profiler
barely slows):

- a kernel, matched to the runtime call that launched it by the profiler's
  correlation id, is credited to the innermost program span open at that
  launch: the host's clocks alone decide it;
- an idle gap of the device is credited to the innermost program span open
  at its midpoint: the device's clock against the host's.

``Record`` is ``trace.Record`` with the slice's program spans and each
kernel's launch time. Every reader of ``trace.Record`` reads it alike; the
readers of the program's spans (``metrics/act_quant_ms.py``,
``act_quant_idle_pct.py``, ``w4_dequant_ms.py``) read None from a
``trace.Record``, or from a slice in which the program recorded no such span,
as a program without the spans gives. ``breakdown`` names slice B's idle gaps
by program span as well.

``Tracer`` is ``harness.Tracer`` with the recorder installed over slices A
and B alone. The harness does not use it yet: ``spanrun.py`` runs a cell
with it in the harness's place and reads these metrics.
"""
from __future__ import annotations

import dataclasses
import re
import time
from typing import Dict, List, Optional, Tuple

from edgebench import harness, trace

Span = Tuple[str, int, int, int]      # (name, start ns, end ns, depth)
RUNTIME_CALL = re.compile(r"cu(da)?[A-Z]")     # CUDA's API calls: cudaX and cuX
NO_SPAN = "no program span"


@dataclasses.dataclass
class Record(trace.Record):
    program: List[Span] = dataclasses.field(default_factory=list)   # by start
    launch_of: Dict[trace.Interval, int] = dataclasses.field(default_factory=dict)
    bounds: Optional[Tuple[int, int]] = None     # the slice's ends, ns, where known


def program_spans(recorder) -> List[Span]:
    """The recorder's spans on its clock's absolute scale, by start."""
    return sorted(((e["name"], recorder.t0 + e["t"], recorder.t0 + e["t"] + e["dur"], e["depth"])
                   for e in recorder.events if e["type"] == "span"), key=lambda s: (s[1], -s[2]))


def launches(prof) -> Dict[trace.Interval, int]:
    """{kernel (name, start, end): the start of the runtime call that
    launched it}, matched by the profiler's correlation id. Only CUDA's API
    calls (``cudaLaunchKernel``, ``cuLaunchKernel``, ...) are launches: the
    profiler's own host records (``Activity Buffer Request``, ``Lazy
    Function Loading``) and torch's ops carry ids of their own that can
    equal a kernel's. Empty where the trace holds no runtime
    calls."""
    calls, kernels = {}, []
    for ev in prof.profiler.kineto_results.events():
        if "CUDA" in str(ev.device_type()):
            kernels.append(((ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns()),
                            ev.correlation_id()))
        elif RUNTIME_CALL.match(ev.name()):
            calls.setdefault(ev.correlation_id(), ev.start_ns())
    return {k: calls[c] for k, c in kernels if c in calls}


def from_profile(prof, recorder, config, batches, peaks, window_s=None,
                 bounds=None) -> Record:
    """``trace.from_profile`` with the program's spans of ``recorder`` (None:
    a program that records none) and each kernel's launch."""
    rec = trace.from_profile(prof, config, batches, peaks, window_s=window_s)
    spans = program_spans(recorder) if recorder is not None else []
    return Record(**{f.name: getattr(rec, f.name) for f in dataclasses.fields(trace.Record)},
                  program=spans, launch_of=launches(prof) if spans else {}, bounds=bounds)


def innermost(spans: List[Span], times: List[int]) -> List[Optional[Span]]:
    """The innermost span open at each of the increasing ``times``: open at
    t means start <= t < end, so a time at a span's end is its parent's."""
    sweep, out = trace._Sweep(spans), []
    for t in times:
        open_ = [s for s in sweep.at(t) if s[2] > t]
        out.append(max(open_, key=lambda s: s[3]) if open_ else None)
    return out


def credited_kernels(rec: Record) -> List[Tuple[trace.Interval, int, Optional[Span]]]:
    """Each kernel with a known launch: (kernel, launch ns, the innermost
    program span open at the launch, or None), by launch."""
    ks = sorted(((k, rec.launch_of[k]) for k in rec.kernels if k in rec.launch_of),
                key=lambda kl: kl[1])
    return [(k, t, s) for (k, t), s in zip(ks, innermost(rec.program, [t for _, t in ks]))]


def kernel_s(rec: Record, name: str) -> float:
    """Device seconds of the kernels launched inside spans ``name``, nested
    spans of another name excluded."""
    return sum(b - a for (_, a, b), _, s in credited_kernels(rec)
               if s is not None and s[0] == name) * 1e-9


def idle_gaps(rec: trace.Record, bounds: Optional[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The device's idle intervals: between busy intervals, and from the
    slice's ends where ``bounds`` gives them."""
    busy = trace.busy_intervals(rec)
    if not busy:
        return [bounds] if bounds else []
    edges = [t for iv in busy for t in iv]
    edges = ([bounds[0]] if bounds else [busy[0][0]]) + edges + \
        ([bounds[1]] if bounds else [busy[-1][1]])
    return [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]


def idle_by_span(rec: Record) -> Dict[str, float]:
    """Idle seconds of the slice by the innermost program span open at each
    gap's midpoint (``NO_SPAN`` where none is)."""
    gaps = idle_gaps(rec, rec.window or rec.bounds)
    out: Dict[str, float] = {}
    for (a, b), s in zip(gaps, innermost(rec.program, [(a + b) // 2 for a, b in gaps])):
        key = s[0] if s else NO_SPAN
        out[key] = out.get(key, 0.0) + (b - a) * 1e-9
    return out


def gap_names(rec: Record, times: List[int]) -> List[str]:
    """``trace.gap_names`` with the innermost program span between the infer
    span and the host op: ``<infer span>: <program span>: <host op>``; where
    no program span is open, the name ``trace.gap_names`` gives."""
    out = []
    for name, s in zip(trace.gap_names(rec, times), innermost(rec.program, times)):
        if s is not None:
            infer, op = name.split(": ", 1)
            name = f"{infer}: {s[0]}: {op}"
        out.append(name)
    return out


def breakdown(rec: trace.Record, named: Record, top: int = 10) -> Dict[str, list]:
    """``trace.breakdown`` with the idle gaps of ``named`` named by
    ``gap_names``."""
    out = trace.breakdown(rec, named, top)
    gaps: Dict[str, float] = {}
    idle = idle_gaps(named, named.window)
    for (a, b), name in zip(idle, gap_names(named, [(a + b) // 2 for a, b in idle])):
        gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-9
    out["idle_gaps"] = [[k[:160], v] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:top]]
    return out


def per_batch_ms(rec: trace.Record, span: str, version: Optional[str] = None) -> Optional[float]:
    """Device ms of the slice's kernels credited to ``span``, per batch of the
    slice (of ``version`` alone, where given); None where the slice holds no
    such span or no kernel's launch."""
    if not getattr(rec, "launch_of", None) or not any(s[0] == span for s in rec.program):
        return None
    n = sum(1 for x in rec.batches if version is None or x["version"] == version)
    return 1e3 * kernel_s(rec, span) / n if n else None


def batches_of(spans):
    """{"B", "S", "version"} of each ``serving.infer`` span, in order."""
    return [{"B": s["attrs"]["B"], "S": s["attrs"]["S"], "version": s["attrs"]["version"]}
            for s in sorted((e for e in spans if e.get("name") == "serving.infer"),
                            key=lambda e: e["t"])]


def crediting(rec: Record, span: str = "quant.act") -> Dict:
    """The checks of a slice's crediting: kernels with a known launch, those
    that start before their launch, launches outside their span, the kernels
    each ``span`` call launched (the counts seen), the infers whose credited
    kernels are not their calls times the commonest count, and the least,
    median and largest (kernel start - launch), in us."""
    credited = credited_kernels(rec)
    per_call = {s: 0 for s in rec.program if s[0] == span}
    early = outside = 0
    for (_, k0, _), t, s in credited:
        early += k0 < t
        if s is not None:
            outside += not (s[1] <= t < s[2])
            if s in per_call:
                per_call[s] += 1
    counts = sorted(per_call.values())
    mode = max(set(counts), key=counts.count) if counts else 0
    infers = [s for s in rec.program if s[0] == "serving.infer"]
    off = sum(1 for f in infers
              if sum(n for c, n in per_call.items() if f[1] <= c[1] <= f[2])
              != mode * sum(1 for c in per_call if f[1] <= c[1] <= f[2]))
    lag = sorted((k[1] - t) / 1e3 for k, t, _ in credited)
    return {"kernels": len(rec.kernels), "with_launch": len(credited),
            "before_launch": early, "launch_outside_span": outside,
            f"{span}_calls": len(per_call), f"kernels_a_{span}_call": sorted(set(counts)),
            "infers_off": off,
            "kernel_after_launch_us": [lag[0], lag[len(lag) // 2], lag[-1]] if lag else []}


class Tracer(harness.Tracer):
    """``harness.Tracer`` that installs one ``obs.Recorder`` on the
    profiler's clock for each of slices A and B, kept in memory (no file),
    and restores the null recorder when B ends. ``bounds_a`` holds slice A's
    ends on that clock, as the host issues its first batch and finishes its
    last."""

    def __init__(self, n: int, device):
        from repro_torch import obs

        super().__init__(n, device)
        self.recorders: List = [obs.Recorder(clock=time.time_ns)]
        self.bounds_a: List[int] = []
        obs.set_recorder(self.recorders[0])

    def at(self, index: int) -> None:
        from repro_torch import obs

        if index in (0, self.n):
            self.bounds_a.append(time.time_ns())
        super().at(index)
        if index == self.n:
            self.recorders.append(obs.Recorder(clock=time.time_ns))
            obs.set_recorder(self.recorders[1])

    def close(self) -> None:
        from repro_torch import obs

        super().close()
        obs.set_recorder(None)
