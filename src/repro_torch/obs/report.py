"""Fold a run's events into a timing report (port of
``repro.obs.report``, pure Python).

``fold(events)`` aggregates span events by name (count / total / mean /
min / max), collects point events, logs, metrics, the drift/online
timeline and the build-accounting summary into one JSON-serializable
dict; ``render(report)`` turns it into the aligned text tables
``python -m repro_torch.launch.obsview`` prints.

Span totals are wall-time sums per span *name*: nested spans overlap
their parents (``fleet.decide`` time is inside ``fleet.epoch`` time),
so the per-phase shares are each phase's fraction of the run wall;
they intentionally do not sum to 100%.

The summary event keeps the reference's type and keys (``jax``, with
``compile`` and ``traces``), so either package folds the other's files.
In the port, ``compile`` holds the ``nvcc`` builds of the CUDA kernels
(``nvcc_build_n``, ``nvcc_build_s``; ``repro_torch.obs.tracemon``) and
``traces`` the specialized-step builds per site; ``build_table``
renders whichever phases the file carries.
"""
from __future__ import annotations

from typing import Dict, List, Optional

# event names folded into the drift/adaptation timeline: drift regime
# machinery, online adaptation, autoscaler decisions, SLO error-budget
# alerts, and timeline bookkeeping events
_TIMELINE_PREFIXES = ("drift.", "online.", "autoscale.", "slo.",
                      "timeline.")


def fold(events: List[Dict], meta: Optional[Dict] = None) -> Dict:
    spans: Dict[str, Dict] = {}
    counts: Dict[str, int] = {}
    timeline: List[Dict] = []
    metrics: List[Dict] = []
    jax_summary: Optional[Dict] = None
    logs = 0
    wall = 0.0
    for ev in events:
        t = float(ev.get("t", 0.0))
        typ = ev.get("type")
        if typ == "span":
            dur = float(ev.get("dur", 0.0))
            wall = max(wall, t + dur)
            s = spans.setdefault(ev["name"], {
                "count": 0, "total_s": 0.0, "min_s": dur, "max_s": dur,
                "depth": ev.get("depth", 0)})
            s["count"] += 1
            s["total_s"] += dur
            s["min_s"] = min(s["min_s"], dur)
            s["max_s"] = max(s["max_s"], dur)
        elif typ == "event":
            wall = max(wall, t)
            counts[ev["name"]] = counts.get(ev["name"], 0) + 1
            if ev["name"].startswith(_TIMELINE_PREFIXES):
                timeline.append({"t": t, "name": ev["name"],
                                 "attrs": ev.get("attrs", {})})
        elif typ == "log":
            logs += 1
        elif typ == "metric":
            metrics.append({k: v for k, v in ev.items()
                            if k not in ("type", "seq", "t")})
        elif typ == "jax":
            jax_summary = {"compile": ev.get("compile", {}),
                           "traces": ev.get("traces", {})}
    for s in spans.values():
        s["mean_us"] = s["total_s"] / s["count"] * 1e6
        s["share"] = s["total_s"] / wall if wall > 0 else 0.0
    return {"meta": dict(meta or {}), "wall_s": wall,
            "phases": spans, "events": counts, "timeline": timeline,
            "logs": logs, "metrics": metrics, "jax": jax_summary}


def load(path: str) -> Dict:
    """events.jsonl -> folded report."""
    from repro_torch.obs.events import read_events
    meta, events = read_events(path)
    return fold(events, meta=meta.get("meta"))


# --------------------------------------------------------------------------
# rendering
# --------------------------------------------------------------------------

def phase_table(report: Dict) -> str:
    """Per-phase timing breakdown, widest total first."""
    rows = sorted(report["phases"].items(),
                  key=lambda kv: -kv[1]["total_s"])
    if not rows:
        return "(no spans recorded)"
    lines = [f"{'span':24s} {'count':>7s} {'total_s':>9s} {'mean_us':>10s} "
             f"{'min_us':>10s} {'max_us':>10s} {'%wall':>6s}"]
    for name, s in rows:
        lines.append(
            f"{name:24s} {s['count']:7d} {s['total_s']:9.3f} "
            f"{s['mean_us']:10.1f} {s['min_s']*1e6:10.1f} "
            f"{s['max_s']*1e6:10.1f} {s['share']*100:6.1f}")
    return "\n".join(lines)


def timeline_table(report: Dict, limit: int = 40) -> str:
    """Drift/online events in time order (regime switches, triggers,
    bursts, hot-swaps)."""
    tl = report["timeline"]
    if not tl:
        return "(no drift/online events)"
    lines = []
    for e in tl[:limit]:
        attrs = " ".join(f"{k}={v}" for k, v in e["attrs"].items())
        lines.append(f"  t={e['t']:9.3f}s {e['name']:24s} {attrs}")
    if len(tl) > limit:
        lines.append(f"  ... {len(tl) - limit} more")
    return "\n".join(lines)


def build_table(report: Dict) -> str:
    """The build counters: each compile phase the file carries (the
    port's ``nvcc_build``; the reference's jaxpr_trace, mlir_lower and
    backend_compile) with its count and seconds, then the step builds
    (the reference's jit traces) by site."""
    j = report.get("jax")
    if not j:
        return "(no build accounting)"
    c = j.get("compile", {})
    phases = sorted({k[:-2] for k in c if k.endswith("_n")}) or ["nvcc_build"]
    lines = []
    for phase in phases:
        n = c.get(phase + "_n", 0)
        s = c.get(phase + "_s", 0.0)
        lines.append(f"  {phase:18s} n={int(n):5d} total={s:8.3f}s")
    tr = j.get("traces", {})
    if tr:
        lines.append("  step builds by site:")
        for site, n in sorted(tr.items()):
            lines.append(f"    {site:30s} {n}")
    return "\n".join(lines)


def metrics_table(report: Dict) -> str:
    ms = report["metrics"]
    if not ms:
        return "(no metrics)"
    lines = []
    for m in ms:
        labels = ",".join(f"{k}={v}" for k, v in m.get("labels", {}).items())
        name = m["name"] + (f"{{{labels}}}" if labels else "")
        if m["kind"] == "histogram":
            lines.append(f"  {name:40s} n={m['count']:<6d} "
                         f"mean={m['mean']:.3f} p50={m['p50']:.3f} "
                         f"p95={m['p95']:.3f} p99={m['p99']:.3f} "
                         f"max={m['max']:.3f}")
        else:
            lines.append(f"  {name:40s} {m['kind']}={m['value']:g}")
    return "\n".join(lines)


def render(report: Dict) -> str:
    parts = [f"wall: {report['wall_s']:.3f}s   spans: "
             f"{sum(s['count'] for s in report['phases'].values())}   "
             f"events: {sum(report['events'].values())}   "
             f"logs: {report['logs']}",
             "", "per-phase timing:", phase_table(report)]
    if report["timeline"]:
        parts += ["", "drift/online timeline:", timeline_table(report)]
    if report["metrics"]:
        parts += ["", "metrics:", metrics_table(report)]
    if report.get("jax"):
        parts += ["", "build accounting:", build_table(report)]
    return "\n".join(parts)
