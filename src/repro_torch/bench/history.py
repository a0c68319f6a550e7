"""Append-only perf trajectory (port of ``repro.bench.history``).

A history file (JSONL) holds one line per benchmark row per run: the
record the runner produced (name, samples, CI bounds, phases) stamped
with the run id, unix time, git sha and an **environment fingerprint**
— host, machine, CPU count, python, torch and CUDA versions, the card's
name, count and power limit. Baselines are only ever selected from rows
whose fingerprint matches the current environment byte-for-byte:
timings from a 2-core laptop say nothing about a 4-core CI runner, and
gating across them would manufacture regressions. CI normalizes its
ephemeral hostnames via ``REPRO_BENCH_HOST``. The fingerprint's keys
are not the reference's (it records jax, its backend and the Pallas
flag), so a reference history never baselines a port run: the gate
reports ``fingerprint_mismatch``.

Error records (``{"error": ...}``, no timing fields) are appended too
— the history is the full story — but ``baseline_for`` skips them
explicitly so a crashed run can never poison baseline statistics.
"""
from __future__ import annotations

import functools
import json
import os
import platform
import shutil
import subprocess
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch

HISTORY_SCHEMA = 1

# rows from this many most-recent matching runs are pooled into the
# baseline sample set (more samples -> a sharper Mann-Whitney test)
DEFAULT_POOL = 3


def git_sha() -> str:
    sha = os.environ.get("GITHUB_SHA")
    if sha:
        return sha[:12]
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short=12", "HEAD"],
            capture_output=True, text=True, timeout=10,
            cwd=os.path.dirname(os.path.abspath(__file__)),
        ).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


@functools.lru_cache(maxsize=None)
def _power_limit() -> str:
    """The cards' power limit as ``nvidia-smi`` prints it ("700.00 W";
    several cards' joined by "; "), or "none" without the tool. Asked
    once a process."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return "none"
    try:
        out = subprocess.run(
            [exe, "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=10).stdout
    except (OSError, subprocess.SubprocessError):
        return "none"
    return "; ".join(x.strip() for x in out.splitlines() if x.strip()) \
        or "none"


def fingerprint() -> Dict[str, object]:
    """The environment key baselines must match on. ``REPRO_BENCH_HOST``
    overrides the hostname (CI runners are ephemeral but uniform). The
    card's name and power limit are in it: a card set below its maximum
    runs slower under load."""
    on_card = torch.cuda.is_available()
    return {
        "host": os.environ.get("REPRO_BENCH_HOST") or platform.node(),
        "machine": platform.machine(),
        "cpu_count": os.cpu_count(),
        "python": platform.python_version(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda or "none",
        "device": torch.cuda.get_device_name() if on_card else "cpu",
        "device_count": torch.cuda.device_count(),
        "power_limit": _power_limit(),
    }


def fp_key(fp: Dict[str, object]) -> str:
    return "|".join(f"{k}={fp[k]}" for k in sorted(fp))


# --------------------------------------------------------------------------
# JSONL I/O
# --------------------------------------------------------------------------

def append(path: str, rows: Sequence[Dict]) -> None:
    """Append rows (one JSON line each) — never rewrites prior history."""
    with open(path, "a") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


def load(path: str) -> List[Dict]:
    """All history rows, file order (oldest first). Missing file -> []."""
    if not os.path.exists(path):
        return []
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def stamp(records: Sequence[Dict], *, run_id: str, t_unix: float,
          sha: Optional[str] = None,
          fp: Optional[Dict] = None) -> List[Dict]:
    """Records -> history rows: schema + run/sha/time/fingerprint."""
    sha = sha or git_sha()
    fp = fp or fingerprint()
    return [{"schema": HISTORY_SCHEMA, "run_id": run_id,
             "t_unix": t_unix, "git_sha": sha, "fingerprint": fp, **r}
            for r in records]


# --------------------------------------------------------------------------
# baseline selection
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class Baseline:
    """Pooled baseline for one case name: samples from the ``pool``
    most recent matching-fingerprint runs, plus those source rows (the
    gate averages their phase breakdowns for attribution)."""
    name: str
    samples: List[float]
    rows: List[Dict]        # newest last

    @property
    def shas(self) -> List[str]:
        return [r.get("git_sha", "?") for r in self.rows]


def usable(row: Dict) -> bool:
    """A history row baselines may draw from: non-error, has samples."""
    return "error" not in row and bool(row.get("samples"))


def baseline_for(name: str, fp: Dict, rows: Sequence[Dict],
                 pool: int = DEFAULT_POOL) -> Optional[Baseline]:
    """Most recent ``pool`` matching rows for ``name`` under ``fp``;
    None when no matching-fingerprint history exists (verdict "new" —
    or "fingerprint_mismatch" when other-fingerprint rows do exist)."""
    key = fp_key(fp)
    match = [r for r in rows
             if r.get("name") == name and usable(r)
             and fp_key(r.get("fingerprint", {})) == key]
    if not match:
        return None
    match = match[-pool:]
    samples: List[float] = []
    for r in match:
        samples.extend(float(s) for s in r["samples"])
    return Baseline(name=name, samples=samples, rows=match)


def has_foreign_fingerprint(name: str, fp: Dict,
                            rows: Sequence[Dict]) -> bool:
    """True when history holds usable rows for ``name`` under a
    *different* fingerprint — the refuse-to-gate signal."""
    key = fp_key(fp)
    return any(r.get("name") == name and usable(r)
               and fp_key(r.get("fingerprint", {})) != key
               for r in rows)
