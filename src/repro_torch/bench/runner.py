"""Execute a case matrix under observation (port of
``repro.bench.runner``).

The runner owns the row surface benchmark functions emit through
(``emit(name, us, derived)`` — the CSV line plus a structured record)
and the per-case obs story: every run installs one live
``obs.Recorder`` (written to ``--trace`` when asked), each case runs
inside a ``bench`` span, which waits for the card before it closes (the
rule of ``stats._block``), so a case's device work stays in its own
phases and never spills into the next case's; and the slice of events
the case produced is folded via ``repro_torch.obs.report`` into a
compact per-phase breakdown (``{phase: {count, total_s}}``) stored on
the case's records. That breakdown is what lets the gate name the
regressed *phase* (``fleet.queues`` vs ``pricing.analytical``), not
just the case.

Failure encoding: a case that raises produces a record
``{"name": ..., "error": "Type: msg"}`` with **no timing fields** —
``-1.0`` sentinels would poison baseline statistics, so history and
gate skip error records explicitly.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from repro_torch import obs
from repro_torch.bench.matrix import Case
from repro_torch.bench.stats import _block, format_sig, summarize

# phases kept per record (largest total_s first)
MAX_PHASES = 16


@dataclass
class Sink:
    """Collects CSV rows + structured records for one run."""
    echo: bool = True
    rows: List[str] = field(default_factory=list)
    records: List[Dict] = field(default_factory=list)

    def row(self, name: str, us_per_call: float, derived: str,
            **extra) -> None:
        """One benchmark result. ``us_per_call`` may be a
        ``stats.Timing`` carrying repeated samples; plain floats are
        single-sample (reported, not gateable). 4 significant digits
        everywhere — fixed one-decimal rounding collapsed
        sub-microsecond cases to 0.0/0.1."""
        line = f"{name},{float(us_per_call):.4g},{derived}"
        self.rows.append(line)
        samples = [float(s) for s in
                   getattr(us_per_call, "samples", (float(us_per_call),))]
        s = summarize(samples)
        rec = {"name": name,
               "us_per_call": format_sig(float(us_per_call)),
               "derived": derived,
               "samples": [format_sig(x) for x in samples],
               "n": s.n,
               "min": format_sig(s.min),
               "median": format_sig(s.median),
               "mean": format_sig(s.mean),
               "std": format_sig(s.std),
               "ci_lo": format_sig(s.ci_lo),
               "ci_hi": format_sig(s.ci_hi)}
        if extra:
            rec["extra"] = {k: format_sig(v) if isinstance(v, float)
                            else v for k, v in extra.items()}
        self.records.append(rec)
        if self.echo:
            print(line, flush=True)

    def error(self, name: str, exc: BaseException) -> None:
        msg = f"{type(exc).__name__}: {exc}".replace(",", ";") \
            .replace("\n", " ")[:500]
        line = f"{name},ERROR,{msg}"
        self.rows.append(line)
        self.records.append({"name": name, "error": msg})
        if self.echo:
            print(line, flush=True)


_SINK: Optional[Sink] = None


def emit(name: str, us_per_call: float, derived: str, **extra) -> None:
    """Module-level row hook for benchmark functions (the runner binds
    the active sink around each run)."""
    if _SINK is None:
        raise RuntimeError("repro_torch.bench.runner.emit called outside "
                           "a run (use runner.run or bind a Sink)")
    _SINK.row(name, us_per_call, derived, **extra)


def fold_phases(events: Sequence[Dict]) -> Dict[str, Dict]:
    """Fold one case's event slice into {phase: {count, total_s}} via
    the canonical obs fold; the wrapping ``bench`` span is dropped and
    phases are capped at MAX_PHASES by total time."""
    from repro_torch.obs.report import fold
    phases = fold(list(events)).get("phases", {})
    phases.pop("bench", None)
    items = sorted(phases.items(), key=lambda kv: -kv[1]["total_s"])
    return {name: {"count": int(p["count"]),
                   "total_s": format_sig(p["total_s"], 6)}
            for name, p in items[:MAX_PHASES]}


@dataclass
class RunResult:
    records: List[Dict]
    rows: List[str]
    errors: int


def run(cases: Sequence[Case], trace: Optional[str] = None,
        meta: Optional[Dict] = None, echo: bool = True,
        header: bool = True,
        overrides: Optional[Dict[str, Dict]] = None) -> RunResult:
    """Execute ``cases`` in order under one live recorder.

    ``overrides`` maps group name -> extra kwargs merged into the
    case's params at call time (the CLI's --agent/--episodes surface).
    Cases always run recorded — even without ``trace`` — so the phase
    breakdown exists and the timing environment is identical between
    gated runs. Each case's ``bench`` span closes only after the card
    has finished the case's work.
    """
    global _SINK
    sink = Sink(echo=echo)
    errors = 0
    if echo and header:
        print("name,us_per_call,derived")
    prev = _SINK
    _SINK = sink
    try:
        with obs.recording(trace, meta=dict(meta or {})) as rec:
            for case in cases:
                kw = dict((overrides or {}).get(case.group, {}))
                s0, i0 = len(rec.events), len(sink.records)
                try:
                    with obs.span("bench", name=case.name):
                        _block(case.run(**kw))
                except Exception as e:   # noqa: BLE001 — report, keep benching
                    sink.error(case.name, e)
                    errors += 1
                phases = fold_phases(rec.events[s0:])
                for r in sink.records[i0:]:
                    r["case"] = case.name
                    if phases and "error" not in r:
                        r["phases"] = phases
    finally:
        _SINK = prev
    return RunResult(records=sink.records, rows=sink.rows, errors=errors)
