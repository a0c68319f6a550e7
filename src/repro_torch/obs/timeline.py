"""The fleet's flight recorder (port of ``repro.obs.timeline``; numpy
only, copied: a file written by either package reads in the other).

A ``Timeline`` captures columnar per-epoch time-series from a fleet
simulation: fleet aggregates (latency percentiles, energy, drops,
goodput, SLO hits), per-server series in cluster runs (queue depth,
DVFS step, replicas, replica power), and annotation events (drift
regime switches, autoscaler decisions with their measured-depth
trigger, adapter hot-swaps, Page-Hinkley trips). Columns follow the
``EpochLog`` discipline (one typed, geometrically-grown numpy array
per key, ``stride`` bounding memory on mega-fleet horizons), extended
with fixed-width (epoch, server) vector columns for the per-server
series.

Capture rules (the reference's DESIGN.md §9/§13):

- **Null by default.** ``FleetConfig.timeline=False`` allocates nothing
  and adds zero work to the epoch loop.
- **Result-neutral.** Capture only *reads* simulation state (no RNG,
  no mutation, no float-summation-order changes), so ``SimResult`` is
  bit-identical with capture on vs off (tested across all engines).
- **Scan-carry rule.** The scan engine keeps its epoch loop on the card
  and copies nothing to the host inside it; only O(1)-per-epoch
  accumulators are written into its stacked per-epoch outputs, which
  are extracted on the host after the loop. Per-epoch
  percentile columns are therefore NaN under ``engine="scan"`` (mean /
  max / energy / SLO columns stay exact).

``to_json()`` serializes one run; ``write_timeline`` bundles a whole
``ComparisonReport``'s runs into the flight-recorder file
``python -m repro_torch.launch.fleetview`` renders.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np

TIMELINE_SCHEMA = 1

# scalar per-epoch columns every engine fills (NaN where undefined)
FLEET_COLUMNS = ("epoch", "arrivals", "served", "dropped", "slo_hits",
                 "alive", "regime", "queue_jobs", "backlog_s",
                 "lat_mean", "lat_p50", "lat_p95", "lat_p99", "lat_max",
                 "energy_wh", "goodput")

# per-server vector columns (cluster runs only)
SERVER_COLUMNS = ("srv_queue", "srv_dvfs", "srv_replicas", "srv_power_w")

_J_PER_WH = 3600.0


class Timeline:
    """Columnar per-epoch flight recorder for one simulation run."""

    def __init__(self, *, slo_s: float = 1.0, slot_seconds: float = 1.0,
                 stride: int = 1, n_servers: int = 0,
                 server_names: Optional[List[str]] = None,
                 engine: str = "loop"):
        if stride < 1:
            raise ValueError(f"stride must be >= 1, got {stride}")
        self.slo_s = float(slo_s)
        self.slot_seconds = float(slot_seconds)
        self.stride = int(stride)
        self.n_servers = int(n_servers)
        self.server_names = list(server_names or [])
        self.engine = engine
        self._cols: Dict[str, np.ndarray] = {}
        self._n = 0
        self._offered = 0
        self._pending: Optional[Dict] = None
        self.annotations: List[Dict] = []
        self.slo_report = None          # repro_torch.obs.slo.SLOReport

    # -- columnar store (EpochLog discipline + vector columns) -------------

    def _alloc(self, key: str, v) -> np.ndarray:
        a = np.asarray(v)
        if a.ndim == 0:
            dtype = np.int64 if a.dtype.kind in "iu" else np.float64
            return np.zeros(16, dtype)
        dtype = np.int64 if a.dtype.kind in "iu" else np.float64
        return np.zeros((16,) + a.shape, dtype)

    def _grow(self, need: int):
        for k, col in self._cols.items():
            if col.shape[0] < need:
                new = np.zeros((max(need, 2 * col.shape[0]),)
                               + col.shape[1:], col.dtype)
                new[:self._n] = col[:self._n]
                self._cols[k] = new

    def _store(self, row: Dict) -> None:
        if not self._cols:
            self._cols = {k: self._alloc(k, v) for k, v in row.items()}
        self._grow(self._n + 1)
        for k, v in row.items():
            self._cols[k][self._n] = v
        self._n += 1

    def _flush_pending(self) -> None:
        if self._pending is None:
            return
        row, self._pending = self._pending, None
        self._store(row)

    def _append_row(self, row: Dict) -> None:
        keep = self._offered % self.stride == 0
        self._offered += 1
        if keep:
            self._pending = None
            self._store(row)
        else:
            # hold the horizon's final epoch (EpochLog stride rule)
            self._pending = row

    def column(self, key: str) -> np.ndarray:
        self._flush_pending()
        return self._cols[key][:self._n]

    @property
    def columns(self) -> Dict[str, np.ndarray]:
        self._flush_pending()
        return {k: c[:self._n] for k, c in self._cols.items()}

    def __len__(self) -> int:
        self._flush_pending()
        return self._n

    def __repr__(self) -> str:
        return (f"Timeline(rows={len(self)}, engine={self.engine!r}, "
                f"servers={self.n_servers}, "
                f"annotations={len(self.annotations)})")

    # -- capture API (called from the fleet loop / scan extraction) --------

    def append_epoch(self, *, epoch: int, arrivals: int, dropped: int,
                     slo_hits: int, alive: int, regime: int,
                     queue_jobs: float, backlog_s: float,
                     lat: Optional[np.ndarray] = None,
                     energy_j: float = 0.0,
                     srv_queue: Optional[np.ndarray] = None,
                     srv_dvfs: Optional[np.ndarray] = None,
                     srv_replicas: Optional[np.ndarray] = None,
                     srv_power_w: Optional[np.ndarray] = None) -> None:
        """Record one host-engine epoch. ``lat`` is the epoch's
        per-request latency array (percentiles are summarized here and
        the array is not retained)."""
        served = 0 if lat is None else int(lat.size)
        if served:
            p50, p95, p99 = np.percentile(lat, [50.0, 95.0, 99.0])
            lmean, lmax = float(np.mean(lat)), float(np.max(lat))
        else:
            p50 = p95 = p99 = lmean = lmax = float("nan")
        row = {
            "epoch": int(epoch), "arrivals": int(arrivals),
            "served": served, "dropped": int(dropped),
            "slo_hits": int(slo_hits), "alive": int(alive),
            "regime": int(regime), "queue_jobs": float(queue_jobs),
            "backlog_s": float(backlog_s),
            "lat_mean": lmean, "lat_p50": float(p50),
            "lat_p95": float(p95), "lat_p99": float(p99), "lat_max": lmax,
            "energy_wh": float(energy_j) / _J_PER_WH,
            "goodput": float(slo_hits) / self.slot_seconds,
        }
        if self.n_servers:
            # np.array copies: the pool mutates these in place next epoch
            row["srv_queue"] = np.array(srv_queue, np.float64)
            row["srv_dvfs"] = np.array(srv_dvfs, np.float64)
            row["srv_replicas"] = np.array(srv_replicas, np.int64)
            row["srv_power_w"] = np.array(srv_power_w, np.float64)
        self._append_row(row)

    def extend_epochs(self, *, epoch, arrivals, served, dropped, slo_hits,
                      alive, queue_jobs, backlog_s, lat_sum, lat_max,
                      energy_j) -> None:
        """Bulk-append the scan engine's stacked per-epoch outputs
        (host-side, after the scan returns). Only O(1)-per-epoch
        accumulators exist on that path, so percentile columns are NaN
        (the scan-carry rule)."""
        epoch = np.asarray(epoch, np.int64)
        T = epoch.shape[0]
        served = np.asarray(served, np.float64)
        lat_sum = np.asarray(lat_sum, np.float64)
        with np.errstate(invalid="ignore", divide="ignore"):
            lat_mean = np.where(served > 0, lat_sum / served, np.nan)
        lat_max = np.where(served > 0, np.asarray(lat_max, np.float64),
                           np.nan)
        nan = np.full(T, np.nan)
        slo_hits = np.asarray(slo_hits, np.int64)
        rows = {
            "epoch": epoch, "arrivals": np.asarray(arrivals, np.int64),
            "served": served.astype(np.int64),
            "dropped": np.asarray(dropped, np.int64),
            "slo_hits": slo_hits, "alive": np.asarray(alive, np.int64),
            "regime": np.zeros(T, np.int64),
            "queue_jobs": np.asarray(queue_jobs, np.float64),
            "backlog_s": np.asarray(backlog_s, np.float64),
            "lat_mean": lat_mean, "lat_p50": nan, "lat_p95": nan,
            "lat_p99": nan, "lat_max": lat_max,
            "energy_wh": np.asarray(energy_j, np.float64) / _J_PER_WH,
            "goodput": slo_hits / self.slot_seconds,
        }
        keep = (np.arange(self._offered, self._offered + T)
                % self.stride) == 0
        self._offered += T
        sel = {k: v[keep] for k, v in rows.items()}
        m = len(sel["epoch"])
        stored_last = T > 0 and bool(keep[-1])
        self._pending = None if stored_last or T == 0 \
            else {k: v[-1] for k, v in rows.items()}
        if m == 0:
            return
        if not self._cols:
            self._cols = {k: self._alloc(k, v[0]) for k, v in sel.items()}
        self._grow(self._n + m)
        for k, v in sel.items():
            self._cols[k][self._n:self._n + m] = v
        self._n += m

    def annotate(self, epoch: int, kind: str, **attrs) -> None:
        """Mark a point event on the timeline (regime switch, autoscale
        decision, hot-swap, drift trigger, SLO alert)."""
        self.annotations.append({"epoch": int(epoch), "kind": str(kind),
                                 **attrs})

    def finalize(self, slo_cfg=None, *, emit_events: bool = True):
        """Compute the SRE error-budget report from the recorded series
        (repro_torch.obs.slo), annotate its burn alerts, and optionally mirror
        them into the active obs recorder. Idempotent."""
        if self.slo_report is not None or len(self) == 0:
            return self.slo_report
        from repro_torch.obs import slo as slo_mod
        cfg = slo_cfg if slo_cfg is not None else slo_mod.SLOConfig()
        self.slo_report = slo_mod.compute(
            self.column("epoch"), self.column("arrivals"),
            self.column("slo_hits"), cfg)
        for a in self.slo_report.alerts:
            self.annotate(a["start"], "slo_alert", **{
                k: v for k, v in a.items() if k != "start"})
        if emit_events:
            slo_mod.emit_events(self.slo_report)
        return self.slo_report

    # -- serialization ------------------------------------------------------

    def to_json(self) -> Dict:
        self._flush_pending()
        cols, servers = {}, {}
        for k, c in self.columns.items():
            if c.ndim == 1:
                cols[k] = _jsonable(c)
            else:
                servers[k] = [_jsonable(c[:, s])
                              for s in range(c.shape[1])]
        out = {"schema": TIMELINE_SCHEMA, "engine": self.engine,
               "epochs": len(self), "stride": self.stride,
               "slo_s": self.slo_s, "slot_seconds": self.slot_seconds,
               "columns": cols, "annotations": list(self.annotations)}
        if self.n_servers:
            out["servers"] = {"n": self.n_servers,
                              "names": self.server_names, **servers}
        if self.slo_report is not None:
            out["slo"] = self.slo_report.to_json()
        return out


def _jsonable(arr: np.ndarray) -> List:
    """Column -> JSON list; NaN becomes null so the export stays
    strictly machine-readable."""
    if arr.dtype.kind == "f":
        return [None if np.isnan(v) else float(v) for v in arr]
    return [int(v) for v in arr]


def write_timeline(path: str, runs: List[Dict],
                   meta: Optional[Dict] = None) -> None:
    """Write the flight-recorder file: ``runs`` is a list of
    ``{"policy", "seed", "timeline": Timeline}`` entries (one per
    (policy, seed) simulation). ``path`` "-" streams to stdout."""
    doc = {"type": "timeline", "schema": TIMELINE_SCHEMA,
           "meta": dict(meta or {}),
           "runs": [{**{k: v for k, v in r.items() if k != "timeline"},
                     "timeline": (r["timeline"].to_json()
                                  if isinstance(r["timeline"], Timeline)
                                  else r["timeline"])}
                    for r in runs]}
    text = json.dumps(doc, indent=None, separators=(",", ":"))
    if path == "-":
        import sys
        sys.stdout.write(text + "\n")
    else:
        with open(path, "w") as f:
            f.write(text + "\n")


def read_timeline(path: str) -> Dict:
    """Load and schema-check a flight-recorder file."""
    if path == "-":
        import sys
        doc = json.load(sys.stdin)
    else:
        with open(path) as f:
            doc = json.load(f)
    if doc.get("type") != "timeline":
        raise ValueError(f"{path}: not a timeline file (write one with "
                         "simulate.py --timeline-out)")
    if doc.get("schema") != TIMELINE_SCHEMA:
        raise ValueError(f"{path}: timeline schema {doc.get('schema')!r} "
                         f"!= supported {TIMELINE_SCHEMA}")
    return doc
