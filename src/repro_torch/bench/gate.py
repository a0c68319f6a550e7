"""Statistically gated perf regression detection (port of
``repro.bench.gate``).

``gate_records(current, history, fp)`` compares every timed record of
the current run against its pooled matching-fingerprint baseline
(``history.baseline_for``) with the ``stats.compare`` rule — minimum
effect threshold AND nonparametric significance — and returns a
``GateReport`` of per-case verdicts:

    regression            significantly slower beyond min_effect  (FAILS)
    improved              significantly faster beyond min_effect
    ok                    within noise or below min_effect
    insufficient          too few samples on either side (reported only)
    new                   no history for this case+fingerprint
    fingerprint_mismatch  history exists but only under other
                          environments — the gate REFUSES to compare
    error                 the case crashed this run (bench exit already
                          nonzero; never compared)

For every regression the gate folds the per-phase obs breakdown the
runner stored (current vs the baseline rows' average) and names the
*dominant regressed phase* — the span contributing the largest
absolute slowdown — so a failed ``fleet_sim`` says
``pricing.analytical +120%`` instead of making you rerun under a
profiler. ``render`` prints the verdict table plus the devices/sec
scaling curves (records carrying ``extra.devices_per_s``) the
mega-fleet work tracks.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.bench import history as hist
from repro_torch.bench.stats import compare, format_sig

# a phase only counts as regressed if its own slowdown clears this
# fraction AND it explains a visible share of the case's added time
PHASE_MIN_EFFECT = 0.10
PHASE_MIN_TOTAL_S = 1e-5


@dataclass
class CaseVerdict:
    name: str
    status: str                         # see module docstring
    effect: float = 0.0                 # median ratio - 1 (+ = slower)
    p: float = 1.0                      # one-sided MWU p (direction of effect)
    base_median: float = float("nan")
    cur_median: float = float("nan")
    n_base: int = 0
    n_cur: int = 0
    cur_ci: Tuple[float, float] = (float("nan"), float("nan"))
    base_shas: List[str] = field(default_factory=list)
    phase: Optional[str] = None         # dominant regressed span name
    phase_detail: str = ""
    note: str = ""

    def to_json(self) -> Dict:
        d = {"name": self.name, "status": self.status,
             "effect": format_sig(self.effect),
             "p": format_sig(self.p),
             "base_median": format_sig(self.base_median),
             "cur_median": format_sig(self.cur_median),
             "n_base": self.n_base, "n_cur": self.n_cur,
             "cur_ci": [format_sig(x) for x in self.cur_ci],
             "base_shas": self.base_shas}
        if self.phase:
            d["phase"] = self.phase
            d["phase_detail"] = self.phase_detail
        if self.note:
            d["note"] = self.note
        return d


@dataclass
class GateReport:
    verdicts: List[CaseVerdict]
    fingerprint: Dict
    refused: bool = False               # nothing at all was comparable
    reason: str = ""

    @property
    def regressions(self) -> List[CaseVerdict]:
        return [v for v in self.verdicts if v.status == "regression"]

    @property
    def failed(self) -> bool:
        return bool(self.regressions)

    def counts(self) -> Dict[str, int]:
        c: Dict[str, int] = {}
        for v in self.verdicts:
            c[v.status] = c.get(v.status, 0) + 1
        return c

    def to_json(self) -> Dict:
        return {"failed": self.failed, "refused": self.refused,
                "reason": self.reason, "counts": self.counts(),
                "fingerprint": self.fingerprint,
                "verdicts": [v.to_json() for v in self.verdicts]}


# --------------------------------------------------------------------------
# phase attribution
# --------------------------------------------------------------------------

def _mean_phases(rows: Sequence[Dict]) -> Dict[str, float]:
    """Average per-phase total_s across the baseline rows that carry a
    breakdown (older-history rows without one contribute nothing)."""
    acc: Dict[str, List[float]] = {}
    for r in rows:
        for name, p in (r.get("phases") or {}).items():
            acc.setdefault(name, []).append(float(p["total_s"]))
    return {name: sum(v) / len(v) for name, v in acc.items()}


def attribute_phase(base_rows: Sequence[Dict], cur_record: Dict,
                    min_effect: float = PHASE_MIN_EFFECT
                    ) -> Tuple[Optional[str], str]:
    """Name the span whose slowdown dominates the case's added time.

    Ranked by absolute added seconds (a phase that doubled but costs
    2us never outranks one that grew 30% on the critical path); a
    phase must itself be slower than baseline by ``min_effect``. Spans
    new in the current run (absent from every baseline row) qualify
    with their full cost."""
    base = _mean_phases(base_rows)
    cur = cur_record.get("phases") or {}
    if not cur:
        return None, ""
    best: Optional[Tuple[float, str, str]] = None
    for name, p in cur.items():
        ct = float(p["total_s"])
        if ct < PHASE_MIN_TOTAL_S:
            continue
        bt = base.get(name)
        if bt is None:
            if base:        # genuinely new span this run
                cand = (ct, name, f"new span, {ct*1e3:.2f}ms")
            else:           # baseline has no breakdown at all
                continue
        else:
            if bt <= 0 or ct / bt - 1.0 <= min_effect:
                continue
            cand = (ct - bt, name,
                    f"+{(ct/bt - 1.0)*100:.0f}% "
                    f"({bt*1e3:.2f}ms -> {ct*1e3:.2f}ms)")
        if best is None or cand[0] > best[0]:
            best = cand
    if best is None:
        return None, ""
    return best[1], best[2]


# --------------------------------------------------------------------------
# gating
# --------------------------------------------------------------------------

def gate_records(records: Sequence[Dict], history_rows: Sequence[Dict],
                 fp: Optional[Dict] = None, *, min_effect: float = 0.10,
                 alpha: float = 0.05, pool: int = hist.DEFAULT_POOL,
                 min_samples: int = 3) -> GateReport:
    fp = fp or hist.fingerprint()
    verdicts: List[CaseVerdict] = []
    comparable = 0
    mismatched = 0
    for rec in records:
        name = rec.get("name", "?")
        if "error" in rec:
            verdicts.append(CaseVerdict(name=name, status="error",
                                        note=rec["error"]))
            continue
        base = hist.baseline_for(name, fp, history_rows, pool=pool)
        if base is None:
            if hist.has_foreign_fingerprint(name, fp, history_rows):
                mismatched += 1
                verdicts.append(CaseVerdict(
                    name=name, status="fingerprint_mismatch",
                    note="history rows exist only under other "
                         "environment fingerprints"))
            else:
                verdicts.append(CaseVerdict(name=name, status="new"))
            continue
        comparable += 1
        cur_samples = [float(s) for s in rec.get("samples", [])]
        c = compare(base.samples, cur_samples, min_effect=min_effect,
                    alpha=alpha, min_samples=min_samples)
        v = CaseVerdict(name=name, status=c.verdict, effect=c.effect,
                        p=c.p_slower if c.effect >= 0 else c.p_faster,
                        base_median=c.base_median,
                        cur_median=c.cur_median, n_base=c.n_base,
                        n_cur=c.n_cur, cur_ci=c.cur_ci,
                        base_shas=base.shas)
        if c.verdict == "regression":
            v.phase, v.phase_detail = attribute_phase(base.rows, rec)
        verdicts.append(v)
    refused = (comparable == 0 and mismatched > 0)
    reason = ""
    if refused:
        reason = (f"refusing to gate: history matches no case under "
                  f"fingerprint {hist.fp_key(fp)} "
                  f"({mismatched} case(s) recorded under other "
                  f"environments)")
    return GateReport(verdicts=verdicts, fingerprint=fp,
                      refused=refused, reason=reason)


# --------------------------------------------------------------------------
# rendering
# --------------------------------------------------------------------------

_STATUS_ORDER = ["regression", "error", "improved", "ok", "insufficient",
                 "new", "fingerprint_mismatch"]


def _fmt_us(x: float) -> str:
    return "-" if x != x else f"{x:.4g}"


def scaling_curves(records: Sequence[Dict]) -> str:
    """devices/sec scaling curves from records carrying
    ``extra.devices_per_s`` (the mega-fleet trajectory)."""
    rows = [(r["name"], r["extra"]) for r in records
            if "extra" in r and "devices_per_s" in r["extra"]]
    if not rows:
        return ""
    lines = ["scaling (devices/sec):"]
    for name, ex in rows:
        dev = ex.get("devices", "?")
        lines.append(f"  {name:32s} devices={dev:>8} "
                     f"devices_per_s={ex['devices_per_s']:.4g}")
    return "\n".join(lines)


def render(report: GateReport,
           records: Sequence[Dict] = ()) -> str:
    c = report.counts()
    head = "bench gate: " + ("REFUSED" if report.refused else
                             "FAIL" if report.failed else "PASS")
    head += "   " + "  ".join(f"{k}={c[k]}" for k in _STATUS_ORDER
                              if k in c)
    lines = [head, f"fingerprint: {hist.fp_key(report.fingerprint)}"]
    if report.reason:
        lines.append(report.reason)
    lines += ["", f"{'case':36s} {'verdict':>20s} {'base_med':>10s} "
                  f"{'cur_med':>10s} {'effect':>8s} {'p':>7s}  n"]
    order = {s: i for i, s in enumerate(_STATUS_ORDER)}
    for v in sorted(report.verdicts,
                    key=lambda v: (order.get(v.status, 99), v.name)):
        eff = f"{v.effect*100:+.1f}%" if v.n_base else "-"
        p = f"{v.p:.3f}" if v.n_base else "-"
        lines.append(f"{v.name:36s} {v.status:>20s} "
                     f"{_fmt_us(v.base_median):>10s} "
                     f"{_fmt_us(v.cur_median):>10s} {eff:>8s} {p:>7s}  "
                     f"{v.n_base}v{v.n_cur}")
        if v.status == "regression":
            if v.phase:
                lines.append(f"{'':36s}   ^ dominant regressed phase: "
                             f"{v.phase} {v.phase_detail}")
            else:
                lines.append(f"{'':36s}   ^ no phase breakdown available "
                             f"for attribution")
        if v.note:
            lines.append(f"{'':36s}   ^ {v.note}")
    curves = scaling_curves(records)
    if curves:
        lines += ["", curves]
    return "\n".join(lines)
