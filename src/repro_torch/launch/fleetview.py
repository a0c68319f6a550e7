"""Render a flight-recorder timeline file as a terminal dashboard:
unicode sparklines per fleet series, annotation markers (drift regime
switches, autoscaler decisions, hot-swaps, SLO pages), per-server
DVFS/replica rows for cluster runs, and the error-budget burn table
(port of ``scripts/fleetview.py``; reads the port's files and the
reference's).

    # record a timeline, then view it
    PYTHONPATH=src python -m repro_torch.launch.simulate --scenario cluster-brownout \
        --timeline-out flight.json
    PYTHONPATH=src python -m repro_torch.launch.fleetview flight.json

    # machine-readable export; '-' = stdout
    PYTHONPATH=src python -m repro_torch.launch.fleetview flight.json --json -

    # static HTML dashboard (inline SVG, no dependencies)
    PYTHONPATH=src python -m repro_torch.launch.fleetview flight.json --html dash.html

    # pipe straight through without touching disk
    PYTHONPATH=src python -m repro_torch.launch.simulate --scenario diurnal-fleet \
        --compare device_only --timeline-out - \
        | PYTHONPATH=src python -m repro_torch.launch.fleetview -
"""
from __future__ import annotations

import argparse
import html as html_mod
import json
import os
import sys
from typing import Dict, List, Optional

import numpy as np

from repro_torch.obs.timeline import read_timeline

# the fleet series worth a sparkline row, in display order
SERIES = ("arrivals", "goodput", "lat_p95", "lat_mean", "energy_wh",
          "queue_jobs", "dropped", "alive")

# annotation kind -> single-char marker on the epoch axis
MARKERS = {"regime_switch": "R", "autoscale": "A", "hotswap": "H",
           "drift_trigger": "D", "burst_start": "B", "slo_alert": "!"}

BLOCKS = "▁▂▃▄▅▆▇█"


# --------------------------------------------------------------------------
# sparklines
# --------------------------------------------------------------------------

def _column(run: Dict, key: str) -> Optional[np.ndarray]:
    col = run["timeline"]["columns"].get(key)
    if col is None:
        return None
    return np.array([np.nan if v is None else float(v) for v in col])


def _bucket(values: np.ndarray, width: int) -> np.ndarray:
    """Downsample to ``width`` buckets by nan-mean so long horizons fit
    one terminal row; short series pass through unchanged."""
    T = values.shape[0]
    if T <= width:
        return values
    edges = np.linspace(0, T, width + 1).astype(int)
    out = np.full(width, np.nan)
    for i in range(width):
        chunk = values[edges[i]:max(edges[i + 1], edges[i] + 1)]
        if np.any(np.isfinite(chunk)):
            out[i] = np.nanmean(chunk)
    return out


def spark(values: np.ndarray, width: int) -> str:
    """Unicode sparkline; '·' where the bucket has no finite sample
    (e.g. percentile columns under the scan engine)."""
    v = _bucket(values, width)
    finite = v[np.isfinite(v)]
    if finite.size == 0:
        return "·" * v.shape[0]
    lo, hi = float(finite.min()), float(finite.max())
    span = hi - lo
    chars = []
    for x in v:
        if not np.isfinite(x):
            chars.append("·")
        elif span <= 0:
            chars.append(BLOCKS[3])
        else:
            chars.append(BLOCKS[min(int((x - lo) / span * 8), 7)])
    return "".join(chars)


def marker_line(run: Dict, width: int) -> str:
    """One character row under the sparklines marking annotation epochs
    (later annotations win a contested cell; '*' = several kinds)."""
    tl = run["timeline"]
    epochs = tl["columns"].get("epoch", [])
    anns = tl.get("annotations", [])
    if not epochs or not anns:
        return ""
    e0, e1 = epochs[0], epochs[-1]
    span = max(e1 - e0, 1)
    w = min(len(epochs), width)
    cells = [" "] * w
    for a in anns:
        pos = min(int((a["epoch"] - e0) / span * (w - 1)), w - 1) \
            if w > 1 else 0
        m = MARKERS.get(a["kind"], "?")
        cells[pos] = m if cells[pos] in (" ", m) else "*"
    return "".join(cells)


# --------------------------------------------------------------------------
# terminal rendering
# --------------------------------------------------------------------------

def _fmt(v) -> str:
    if v is None:
        return "—"
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def _series_rows(run: Dict, width: int) -> List[str]:
    lines = []
    for key in SERIES:
        col = _column(run, key)
        if col is None or col.size == 0:
            continue
        finite = col[np.isfinite(col)]
        if finite.size == 0:
            stats = "(no samples)"
        else:
            stats = (f"min={finite.min():.4g} max={finite.max():.4g} "
                     f"last={col[-1]:.4g}" if np.isfinite(col[-1]) else
                     f"min={finite.min():.4g} max={finite.max():.4g}")
        lines.append(f"  {key:11s} {spark(col, width)}  {stats}")
    mk = marker_line(run, width)
    if mk.strip():
        lines.append(f"  {'events':11s} {mk}")
    return lines


def _annotation_rows(run: Dict, limit: int = 20) -> List[str]:
    anns = run["timeline"].get("annotations", [])
    if not anns:
        return []
    lines = ["  annotations:"]
    for a in anns[:limit]:
        attrs = " ".join(f"{k}={_fmt(v)}" for k, v in a.items()
                         if k not in ("epoch", "kind"))
        mark = MARKERS.get(a["kind"], "?")
        lines.append(f"    [{mark}] epoch={a['epoch']:<6d} "
                     f"{a['kind']:14s} {attrs}")
    if len(anns) > limit:
        lines.append(f"    ... {len(anns) - limit} more")
    return lines


def _server_rows(run: Dict, width: int) -> List[str]:
    srv = run["timeline"].get("servers")
    if not srv:
        return []
    names = srv.get("names") or [f"srv{i}" for i in range(srv["n"])]
    lines = [f"  servers ({srv['n']}):"]
    for s, name in enumerate(names):
        parts = [f"    {name:10s}"]
        for key, label in (("srv_queue", "queue"), ("srv_dvfs", "dvfs"),
                           ("srv_replicas", "repl")):
            series = srv.get(key)
            if series is None:
                continue
            col = np.array([np.nan if v is None else float(v)
                            for v in series[s]])
            parts.append(f"{label} {spark(col, max(width // 3, 8))}")
        lines.append(" ".join(parts))
    return lines


def _slo_rows(run: Dict) -> List[str]:
    slo = run["timeline"].get("slo")
    if not slo:
        return []
    tte = slo.get("time_to_exhaustion_epochs")
    lines = [
        "  error budget: "
        f"target={slo['target']:.3f} attainment={slo['attainment']:.4f} "
        f"remaining={slo['budget_remaining']:.3f} "
        f"tte={_fmt(tte)} epochs",
        f"    burn max: fast={slo['max_burn_fast']:.2f} "
        f"(page>{slo['fast_burn']:g}/{slo['fast_window']}ep) "
        f"slow={slo['max_burn_slow']:.2f} "
        f"(page>{slo['slow_burn']:g}/{slo['slow_window']}ep)"]
    for i, a in enumerate(slo.get("alerts_detail", [])):
        end = a["end"] if a["end"] is not None else "run-end"
        lines.append(f"    page #{i + 1}: epochs {a['start']}–{end}  "
                     f"peak burn fast={a['peak_burn_fast']:.1f} "
                     f"slow={a['peak_burn_slow']:.1f}")
    return lines


def render(doc: Dict, width: int = 72) -> str:
    out = []
    meta = doc.get("meta", {})
    head = " ".join(f"{k}={v}" for k, v in meta.items()
                    if isinstance(v, (str, int, float)))
    out.append(f"fleet flight recorder — {len(doc['runs'])} run(s)"
               + (f"  [{head}]" if head else ""))
    for run in doc["runs"]:
        tl = run["timeline"]
        out += ["", f"== {run.get('policy', '?')} seed "
                f"{run.get('seed', '?')}  (engine={tl['engine']}, "
                f"{tl['epochs']} epochs, stride {tl['stride']}) "
                + "=" * 8]
        out += _series_rows(run, width)
        out += _server_rows(run, width)
        out += _slo_rows(run)
        out += _annotation_rows(run)
    legend = " ".join(f"{m}={k}" for k, m in MARKERS.items())
    out += ["", f"markers: {legend}  (*=multiple)"]
    return "\n".join(out)


# --------------------------------------------------------------------------
# machine-readable export
# --------------------------------------------------------------------------

def summarize(doc: Dict) -> Dict:
    """Per-run series stats, annotation counts by kind, the full
    annotation/server/slo payloads: everything a test asserts on without
    re-parsing the raw columns."""
    runs = []
    for run in doc["runs"]:
        tl = run["timeline"]
        series = {}
        for key, col in tl["columns"].items():
            v = np.array([np.nan if x is None else float(x) for x in col])
            finite = v[np.isfinite(v)]
            series[key] = {
                "n": int(v.shape[0]),
                "min": float(finite.min()) if finite.size else None,
                "max": float(finite.max()) if finite.size else None,
                "mean": float(finite.mean()) if finite.size else None,
                "last": (float(v[-1]) if v.size and np.isfinite(v[-1])
                         else None)}
        by_kind: Dict[str, int] = {}
        for a in tl.get("annotations", []):
            by_kind[a["kind"]] = by_kind.get(a["kind"], 0) + 1
        runs.append({
            "policy": run.get("policy"), "seed": run.get("seed"),
            "engine": tl["engine"], "epochs": tl["epochs"],
            "stride": tl["stride"], "series": series,
            "annotation_counts": by_kind,
            "annotations": tl.get("annotations", []),
            "servers": tl.get("servers"),
            "slo": tl.get("slo")})
    return {"type": "fleetview", "schema": doc["schema"],
            "meta": doc.get("meta", {}), "runs": runs}


# --------------------------------------------------------------------------
# HTML export
# --------------------------------------------------------------------------

def _svg_series(values: np.ndarray, w: int = 640, h: int = 60,
                color: str = "#2a6fdb") -> str:
    finite = values[np.isfinite(values)]
    if finite.size == 0:
        return f'<svg width="{w}" height="{h}"></svg>'
    lo, hi = float(finite.min()), float(finite.max())
    span = hi - lo if hi > lo else 1.0
    T = values.shape[0]
    pts = []
    for i, v in enumerate(values):
        if not np.isfinite(v):
            continue
        x = i / max(T - 1, 1) * (w - 4) + 2
        y = h - 4 - (v - lo) / span * (h - 8)
        pts.append(f"{x:.1f},{y:.1f}")
    return (f'<svg width="{w}" height="{h}">'
            f'<polyline fill="none" stroke="{color}" stroke-width="1.2" '
            f'points="{" ".join(pts)}"/></svg>')


def to_html(doc: Dict) -> str:
    parts = ["<!doctype html><meta charset='utf-8'>"
             "<title>fleet flight recorder</title>"
             "<style>body{font:13px monospace;margin:24px;max-width:760px}"
             "h2{border-bottom:1px solid #ccc}table{border-collapse:"
             "collapse}td,th{padding:2px 8px;border:1px solid #ddd}"
             ".ann{color:#a40}</style>",
             f"<h1>fleet flight recorder — {len(doc['runs'])} run(s)</h1>"]
    for run in doc["runs"]:
        tl = run["timeline"]
        parts.append(f"<h2>{html_mod.escape(str(run.get('policy')))} "
                     f"seed {run.get('seed')} — engine {tl['engine']}, "
                     f"{tl['epochs']} epochs</h2>")
        for key in SERIES:
            col = _column(run, key)
            if col is None or not np.any(np.isfinite(col)):
                continue
            finite = col[np.isfinite(col)]
            parts.append(f"<div><b>{key}</b> "
                         f"min={finite.min():.4g} max={finite.max():.4g}"
                         f"<br>{_svg_series(col)}</div>")
        slo = tl.get("slo")
        if slo:
            parts.append(
                "<table><tr><th>target</th><th>attainment</th>"
                "<th>budget left</th><th>pages</th><th>max burn "
                "fast/slow</th></tr>"
                f"<tr><td>{slo['target']:.3f}</td>"
                f"<td>{slo['attainment']:.4f}</td>"
                f"<td>{slo['budget_remaining']:.3f}</td>"
                f"<td>{slo['alerts']}</td>"
                f"<td>{slo['max_burn_fast']:.1f} / "
                f"{slo['max_burn_slow']:.1f}</td></tr></table>")
        anns = tl.get("annotations", [])
        if anns:
            rows = "".join(
                f"<li>epoch {a['epoch']}: {html_mod.escape(a['kind'])} "
                + html_mod.escape(" ".join(
                    f"{k}={v}" for k, v in a.items()
                    if k not in ("epoch", "kind"))) + "</li>"
                for a in anns[:50])
            parts.append(f"<div class='ann'><b>annotations</b>"
                         f"<ul>{rows}</ul></div>")
    return "\n".join(parts)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("timeline", help="flight-recorder file from "
                    "launch.simulate --timeline-out ('-' = stdin)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the machine-readable summary ('-' = "
                    "JSON only, to stdout)")
    ap.add_argument("--html", metavar="PATH", default=None,
                    help="write a static HTML dashboard (inline SVG)")
    ap.add_argument("--width", type=int, default=72,
                    help="sparkline width in characters (default 72)")
    args = ap.parse_args(argv)

    try:
        doc = read_timeline(args.timeline)
    except (OSError, ValueError, json.JSONDecodeError) as e:
        raise SystemExit(f"fleetview: {e}")

    # File exports happen before the terminal render so a closed stdout
    # (e.g. piping the dashboard to `head`) can't lose them.
    if args.json and args.json != "-":
        with open(args.json, "w") as f:
            json.dump(summarize(doc), f, indent=2, default=str)
    if args.html:
        with open(args.html, "w") as f:
            f.write(to_html(doc))

    try:
        if args.json == "-":
            json.dump(summarize(doc), sys.stdout, indent=2, default=str)
            print()
        else:
            print(render(doc, width=args.width))
            if args.json:
                print(f"\nwrote {args.json}")
            if args.html:
                print(f"wrote {args.html}")
        sys.stdout.flush()
    except BrokenPipeError:
        # Reader went away (| head); the exports above already landed.
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        raise SystemExit(0)


if __name__ == "__main__":
    main()
