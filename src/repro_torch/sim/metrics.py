"""Per-request fleet metrics: latency percentiles, SLO attainment,
goodput and energy, not just slot-averaged scores (copy of
``repro.sim.metrics``, numpy only).

``summarize_latencies`` is the shared schema: the fleet simulator and
the continuous-batching scheduler (``serving.ServerStats``) both report
through it, so a latency table means the same thing whether the numbers
came from the analytical pricer or from wall-clock decode steps.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

# Keys every latency report carries (values are floats; "unit" is the
# only string: "s" for the simulator, "steps" for the scheduler).
LATENCY_SCHEMA = ("count", "mean", "p50", "p95", "p99", "max",
                  "slo", "slo_attainment", "goodput")


def summarize_latencies(latencies, *, slo: Optional[float] = None,
                        duration: Optional[float] = None,
                        unit: str = "s") -> Dict:
    """Percentiles + SLO attainment + goodput for a latency array.

    ``slo``: deadline in the same unit; attainment is the fraction of
    requests at or under it. ``duration``: wall span of the measurement
    window; goodput is SLO-met requests per unit duration (falls back
    to all completed requests when no SLO is given).
    """
    lat = np.asarray(latencies, dtype=np.float64).ravel()
    out = {k: 0.0 for k in LATENCY_SCHEMA}
    out["unit"] = unit
    out["count"] = float(lat.size)
    out["slo"] = float(slo) if slo is not None else float("nan")
    if lat.size == 0:
        out["slo_attainment"] = float("nan")
        return out
    out["mean"] = float(np.mean(lat))
    p50, p95, p99 = np.percentile(lat, [50.0, 95.0, 99.0])
    out["p50"], out["p95"], out["p99"] = float(p50), float(p95), float(p99)
    out["max"] = float(np.max(lat))
    good = float(np.sum(lat <= slo)) if slo is not None else float(lat.size)
    out["slo_attainment"] = good / lat.size if slo is not None \
        else float("nan")
    out["goodput"] = good / duration if duration else 0.0
    return out


@dataclasses.dataclass
class FleetMetrics:
    """Streaming accumulator for per-request outcomes.

    Latency/energy arrays are appended per (device, epoch) batch and
    concatenated once at summary time, so recording is O(1) per batch
    and a multi-million-request run stays a handful of numpy arrays.
    """
    slo_s: float = 1.0
    _lat: List[np.ndarray] = dataclasses.field(default_factory=list)
    _energy: List[np.ndarray] = dataclasses.field(default_factory=list)
    _device: List[np.ndarray] = dataclasses.field(default_factory=list)
    dropped: int = 0

    def record(self, latencies_s, energies_j=None, device=None):
        lat = np.asarray(latencies_s, dtype=np.float64).ravel()
        if lat.size == 0:
            return
        self._lat.append(lat)
        if energies_j is not None:
            e = np.asarray(energies_j, dtype=np.float64).ravel()
            self._energy.append(np.broadcast_to(e, lat.shape).copy()
                                if e.size != lat.size else e)
        if device is not None:
            d = np.asarray(device, dtype=np.int32)
            # scalar (the loop engine's per-device batches) broadcasts;
            # the vectorized engine passes one per-request id array
            self._device.append(np.broadcast_to(d, lat.shape).copy()
                                if d.shape != lat.shape else d)

    def drop(self, n: int):
        """Requests lost outright (dead device): SLO misses, no latency."""
        self.dropped += int(n)

    def mark(self) -> Tuple[int, int]:
        """Opaque position in the (latency, energy) batch lists; pair
        with ``since`` to slice out one epoch's recordings."""
        return (len(self._lat), len(self._energy))

    def since(self, mark: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
        """(latencies, energies) recorded after ``mark`` — read-only
        concatenated views the timeline capture summarizes per epoch."""
        i, j = mark
        lat = np.concatenate(self._lat[i:]) if len(self._lat) > i \
            else np.zeros(0)
        en = np.concatenate(self._energy[j:]) if len(self._energy) > j \
            else np.zeros(0)
        return lat, en

    @property
    def latencies_s(self) -> np.ndarray:
        return np.concatenate(self._lat) if self._lat else np.zeros(0)

    @property
    def energies_j(self) -> np.ndarray:
        return np.concatenate(self._energy) if self._energy else np.zeros(0)

    @property
    def devices(self) -> np.ndarray:
        return np.concatenate(self._device) if self._device \
            else np.zeros(0, np.int32)

    def summary(self, duration_s: Optional[float] = None) -> Dict:
        lat = self.latencies_s
        out = summarize_latencies(lat, slo=self.slo_s, duration=duration_s,
                                  unit="s")
        # dropped requests count against attainment and goodput
        total = lat.size + self.dropped
        if total:
            met = out["slo_attainment"] * lat.size if lat.size else 0.0
            out["slo_attainment"] = met / total
        out["dropped"] = float(self.dropped)
        e = self.energies_j
        out["energy_j"] = float(np.sum(e))
        out["energy_per_request_j"] = float(np.mean(e)) if e.size else 0.0
        out["duration_s"] = float(duration_s) if duration_s else 0.0
        return out


class EpochLog:
    """Columnar per-epoch log with a dict-row view.

    ``record_epochs=True`` used to allocate a Python dict per epoch —
    ~400 bytes and a GC object each for runs that can span 100k epochs.
    This stores one preallocated, geometrically-grown numpy column per
    key and materializes dict rows only on access, so existing
    consumers (``log[0]["arrivals"]``, ``log[8:]``, iteration, ``len``)
    keep working unchanged.

    ``stride`` keeps every stride-th offered row; ``cap`` stops keeping
    rows after ``cap`` are stored. Both bound memory on mega-fleet
    horizons without touching the simulation itself.

    The most recently offered row is always retained (cap permitting):
    a stride-skipped final epoch is held pending and materialized on
    first read, so timelines and summaries agree at the horizon even
    when the run length isn't stride-aligned.
    """

    def __init__(self, stride: int = 1, cap: Optional[int] = None):
        if stride < 1:
            raise ValueError(f"stride must be >= 1, got {stride}")
        self.stride = int(stride)
        self.cap = cap if cap is None else int(cap)
        self._cols: Dict[str, np.ndarray] = {}
        self._n = 0          # rows stored
        self._offered = 0    # rows offered (pre stride/cap)
        self._pending: Optional[Dict] = None   # last stride-skipped row

    def _grow(self, need: int):
        for k, col in self._cols.items():
            if col.shape[0] < need:
                new = np.zeros(max(need, 2 * col.shape[0]), col.dtype)
                new[:self._n] = col[:self._n]
                self._cols[k] = new

    def _store(self, row: Dict) -> None:
        if not self._cols:
            for k, v in row.items():
                dtype = np.int64 if isinstance(v, (int, np.integer)) \
                    else np.float64 if isinstance(v, (float, np.floating)) \
                    else object
                self._cols[k] = np.zeros(16, dtype)
        self._grow(self._n + 1)
        for k, v in row.items():
            self._cols[k][self._n] = v
        self._n += 1

    def _flush_pending(self) -> None:
        """Materialize the held final row before any read."""
        if self._pending is None:
            return
        row, self._pending = self._pending, None
        if self.cap is None or self._n < self.cap:
            self._store(row)

    def append(self, row: Dict) -> None:
        keep = (self._offered % self.stride == 0) and (
            self.cap is None or self._n < self.cap)
        self._offered += 1
        if not keep:
            # hold the row: if it turns out to be the horizon's last,
            # reads materialize it so the log ends at the final epoch
            self._pending = dict(row)
            return
        self._pending = None
        self._store(row)

    def extend_columns(self, **cols) -> None:
        """Bulk-append equal-length columns (the scan engine's stacked
        per-epoch outputs), applying stride/cap by slicing."""
        T = len(next(iter(cols.values())))
        idx = np.arange(self._offered, self._offered + T)
        keep = (idx % self.stride) == 0
        self._offered += T
        arrs = {k: np.asarray(v) for k, v in cols.items()}
        sel = {k: v[keep] for k, v in arrs.items()}
        kept = len(next(iter(sel.values()))) if sel else 0
        m = kept
        if self.cap is not None:
            m = min(m, max(self.cap - self._n, 0))
        # the batch's final row stays pending unless it was stored
        stored_last = T > 0 and bool(keep[-1]) and m == kept
        self._pending = None if stored_last or T == 0 \
            else {k: v[-1] for k, v in arrs.items()}
        if m == 0:
            return
        if not self._cols:
            self._cols = {k: np.zeros(16, np.asarray(v).dtype)
                          for k, v in sel.items()}
        self._grow(self._n + m)
        for k, v in sel.items():
            self._cols[k][self._n:self._n + m] = v[:m]
        self._n += m

    def column(self, key: str) -> np.ndarray:
        self._flush_pending()
        return self._cols[key][:self._n]

    @property
    def columns(self) -> Dict[str, np.ndarray]:
        self._flush_pending()
        return {k: c[:self._n] for k, c in self._cols.items()}

    def _row(self, i: int) -> Dict:
        return {k: c[i].item() if hasattr(c[i], "item") else c[i]
                for k, c in self._cols.items()}

    def __len__(self) -> int:
        self._flush_pending()
        return self._n

    def __bool__(self) -> bool:
        self._flush_pending()
        return self._n > 0

    def __iter__(self) -> Iterator[Dict]:
        self._flush_pending()
        return (self._row(i) for i in range(self._n))

    def __getitem__(self, i):
        self._flush_pending()
        if isinstance(i, slice):
            return [self._row(j) for j in range(*i.indices(self._n))]
        if i < 0:
            i += self._n
        if not 0 <= i < self._n:
            raise IndexError(i)
        return self._row(i)

    def __repr__(self) -> str:
        return (f"EpochLog(rows={self._n}, offered={self._offered}, "
                f"keys={list(self._cols)})")
