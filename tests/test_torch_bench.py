"""repro_torch.bench against repro.bench on the CPU.

A counterpart of each test of ``tests/test_bench.py`` (the injected 2x
slowdown flagged, jitter at a realistic CV passing, the tiny but
significant shift passing, error rows never poisoning baselines, a
fingerprint mismatch refusing to gate, the dominant regressed phase
named), then parity with the reference on the same inputs, seeded with
numpy: the statistics, the matrix, the phase fold, the gate's verdicts
and its text, bit for bit. Then what is the port's own: the wait for the
card in ``timeit`` and in the runner's ``bench`` span (counted with
``torch.cuda`` patched; on the real CPU nothing is called), the
fingerprint's keys, and the gate CLI's exit codes against
``scripts/benchgate.py`` on the same files.
"""
import dataclasses
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import bench as ref  # noqa: E402
from repro.bench import gate as ref_gate  # noqa: E402
from repro.bench import history as ref_hist  # noqa: E402
from repro.bench import runner as ref_runner  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.bench import (Matrix, Timing, baseline_for,  # noqa: E402
                               bootstrap_ci, compare, fingerprint, format_sig,
                               gate_records, mann_whitney_u, reject_outliers,
                               render, stamp, summarize, timeit)
from repro_torch.bench import history as bhist  # noqa: E402
from repro_torch.bench import runner as brunner  # noqa: E402
from repro_torch.bench import stats as bstats  # noqa: E402
from repro_torch.bench.gate import attribute_phase  # noqa: E402
from repro_torch.launch import benchgate  # noqa: E402

FP = fingerprint()
ROOT = Path(__file__).resolve().parents[1]


def _samples(rng, mean_us, cv=0.05, n=5):
    """Realistic timing stream: lognormal-ish positive jitter."""
    return list(np.abs(rng.normal(mean_us, cv * mean_us, size=n)))


# --------------------------------------------------------------------------
# stats (the reference's tests)
# --------------------------------------------------------------------------

class TestStats:
    def test_timing_is_float_and_scales_samples(self):
        t = Timing(10.0, [10.0, 12.0, 11.0])
        assert float(t) == 10.0 and t.samples == (10.0, 12.0, 11.0)
        half = t / 2
        assert isinstance(half, Timing)
        assert half.samples == (5.0, 6.0, 5.5)
        assert (t * 3).samples == (30.0, 36.0, 33.0)
        assert f"{t:.1f}" == "10.0"

    def test_timeit_collects_reps(self):
        t = timeit(lambda: sum(range(100)), n=3, reps=4)
        assert len(t.samples) == 4
        assert float(t) == min(t.samples) > 0

    def test_format_sig(self):
        assert format_sig(0.03125) == 0.03125
        assert format_sig(1408.217) == 1408.0
        assert format_sig(0.000123456) == 0.0001235
        assert format_sig(0.0) == 0.0

    def test_reject_outliers_drops_scheduler_spike(self):
        xs = [100.0, 101.0, 99.0, 100.5, 1000.0]
        kept = reject_outliers(xs)
        assert 1000.0 not in kept and len(kept) == 4
        assert reject_outliers([1.0, 50.0]) == [1.0, 50.0]
        assert reject_outliers([5.0] * 6) == [5.0] * 6

    def test_bootstrap_ci_covers_median_and_is_deterministic(self):
        rng = np.random.default_rng(0)
        xs = _samples(rng, 100.0, cv=0.05, n=20)
        lo, hi = bootstrap_ci(xs)
        assert lo <= float(np.median(xs)) <= hi
        assert (lo, hi) == bootstrap_ci(xs)
        assert bootstrap_ci([7.0]) == (7.0, 7.0)

    def test_summarize(self):
        s = summarize([100.0, 102.0, 98.0, 101.0, 5000.0])
        assert s.n == 4 and s.n_raw == 5
        assert 98.0 <= s.median <= 102.0
        assert s.cv < 0.05

    def test_mann_whitney_separated_vs_null(self):
        rng = np.random.default_rng(1)
        a = _samples(rng, 100.0, n=8)
        b = _samples(rng, 200.0, n=8)
        assert mann_whitney_u(a, b) < 0.01
        assert mann_whitney_u(b, a) > 0.9
        same = _samples(rng, 100.0, n=8)
        assert mann_whitney_u(a, same) > 0.05
        big_a = _samples(rng, 100.0, n=200)
        big_b = _samples(rng, 150.0, n=200)
        assert mann_whitney_u(big_a, big_b) < 1e-6


class TestCompareRule:
    def test_injected_2x_slowdown_is_flagged(self):
        rng = np.random.default_rng(2)
        base = _samples(rng, 100.0, cv=0.05, n=15)
        cur = _samples(rng, 200.0, cv=0.05, n=5)
        c = compare(base, cur)
        assert c.verdict == "regression"
        assert c.effect > 0.8 and c.p_slower < 0.05

    def test_pure_jitter_at_realistic_cv_passes(self):
        rng = np.random.default_rng(3)
        for _ in range(20):
            base = _samples(rng, 100.0, cv=0.08, n=15)
            cur = _samples(rng, 100.0, cv=0.08, n=5)
            assert compare(base, cur).verdict != "regression"

    def test_tiny_but_significant_shift_passes(self):
        base = [100.0 + 0.01 * i for i in range(20)]
        cur = [103.0 + 0.01 * i for i in range(10)]
        c = compare(base, cur, min_effect=0.10)
        assert c.p_slower < 0.05 and c.verdict == "ok"

    def test_improvement_and_insufficient(self):
        rng = np.random.default_rng(4)
        base = _samples(rng, 200.0, n=15)
        cur = _samples(rng, 100.0, n=5)
        assert compare(base, cur).verdict == "improved"
        assert compare(base, cur[:2]).verdict == "insufficient"
        assert compare(base[:2], cur).verdict == "insufficient"


# --------------------------------------------------------------------------
# matrix
# --------------------------------------------------------------------------

def _noop(**kw):
    return None


class TestMatrix:
    def test_axes_expansion_and_select(self):
        m = Matrix()
        m.add(_noop, name="solo", tags=("smoke",))
        m.add(_noop, name="fleet", axes={"n": (8, 64)}, tags=("system",))
        names = [c.name for c in m.cases()]
        assert names == ["solo", "fleet[n=8]", "fleet[n=64]"]
        assert [c.params for c in m.cases()][1:] == [{"n": 8}, {"n": 64}]
        assert [c.name for c in m.select(only=["fleet"])] == \
            ["fleet[n=8]", "fleet[n=64]"]
        assert [c.name for c in m.select(only=["fleet[n=64]"])] == \
            ["fleet[n=64]"]
        assert [c.name for c in m.select(tags=["smoke"])] == ["solo"]

    def test_lazy_axis_and_unknown_name(self):
        m = Matrix()
        m.add(_noop, name="sc", axes={"scenario": lambda: ["a", "b"]})
        assert [c.name for c in m.cases()] == \
            ["sc[scenario=a]", "sc[scenario=b]"]
        with pytest.raises(KeyError, match="unknown benchmark"):
            m.select(only=["nope"])


# --------------------------------------------------------------------------
# runner
# --------------------------------------------------------------------------

class TestRunner:
    def test_records_phases_and_error_encoding(self):
        m = Matrix()

        def good():
            with obs.span("work.inner"):
                time.sleep(0.002)
            brunner.emit("good", Timing(5.0, [5.0, 6.0, 5.5]), "d=1",
                         devices=4, devices_per_s=123.4)

        def bad():
            raise ValueError("boom, with comma\nand newline")

        m.add(good)
        m.add(bad)
        res = brunner.run(m.cases(), echo=False)
        assert res.errors == 1
        g, b = res.records
        assert g["name"] == "good" and g["case"] == "good"
        assert g["samples"] == [5.0, 6.0, 5.5] and g["n"] == 3
        assert g["ci_lo"] <= g["median"] <= g["ci_hi"]
        assert "work.inner" in g["phases"]
        assert g["phases"]["work.inner"]["count"] == 1
        assert g["phases"]["work.inner"]["total_s"] >= 0.002
        assert "bench" not in g["phases"]
        assert g["extra"] == {"devices": 4, "devices_per_s": 123.4}
        assert set(b) == {"name", "error", "case"}
        assert "," not in b["error"] and "\n" not in b["error"]
        assert not obs.get_recorder().enabled


# --------------------------------------------------------------------------
# history
# --------------------------------------------------------------------------

def _hist_rows(rng, runs=3, mean=100.0, name="case_a", fp=None,
               phases=None, stamp_fn=stamp):
    rows = []
    for i in range(runs):
        rec = {"name": name, "us_per_call": mean,
               "samples": _samples(rng, mean, n=5)}
        if phases:
            rec["phases"] = phases
        rows += stamp_fn([rec], run_id=f"r{i}", t_unix=float(i),
                         sha=f"sha{i}", fp=fp or FP)
    return rows


class TestHistory:
    def test_roundtrip_and_stamp(self, tmp_path):
        p = tmp_path / "h.jsonl"
        rng = np.random.default_rng(5)
        rows = _hist_rows(rng, runs=2)
        bhist.append(str(p), rows[:1])
        bhist.append(str(p), rows[1:])
        back = bhist.load(str(p))
        assert back == rows
        assert back[0]["git_sha"] == "sha0"
        assert back[0]["fingerprint"] == FP
        assert bhist.load(str(tmp_path / "missing.jsonl")) == []

    def test_baseline_pools_recent_matching_runs(self):
        rng = np.random.default_rng(6)
        rows = _hist_rows(rng, runs=5)
        b = baseline_for("case_a", FP, rows, pool=3)
        assert len(b.rows) == 3 and len(b.samples) == 15
        assert b.shas == ["sha2", "sha3", "sha4"]

    def test_error_rows_never_poison_baselines(self):
        rows = stamp([{"name": "case_a", "error": "ValueError: boom"}],
                     run_id="r0", t_unix=0.0, sha="s", fp=FP)
        assert baseline_for("case_a", FP, rows) is None
        rows = stamp([{"name": "case_a", "us_per_call": -1.0}],
                     run_id="r0", t_unix=0.0, sha="s", fp=FP)
        assert baseline_for("case_a", FP, rows) is None

    def test_fingerprint_mismatch_yields_no_baseline(self):
        rng = np.random.default_rng(7)
        other = dict(FP, host="other-host")
        rows = _hist_rows(rng, fp=other)
        assert baseline_for("case_a", FP, rows) is None
        assert bhist.has_foreign_fingerprint("case_a", FP, rows)


# --------------------------------------------------------------------------
# gate
# --------------------------------------------------------------------------

PHASES_BASE = {"fleet.queues": {"count": 100, "total_s": 0.050},
               "pricing.analytical": {"count": 100, "total_s": 0.048},
               "fleet.decide": {"count": 100, "total_s": 0.020}}


class TestGate:
    def test_unchanged_run_passes(self):
        rng = np.random.default_rng(8)
        hist = _hist_rows(rng, runs=3, phases=PHASES_BASE)
        cur = [{"name": "case_a", "us_per_call": 100.0,
                "samples": _samples(rng, 100.0, n=5),
                "phases": PHASES_BASE}]
        rep = gate_records(cur, hist, FP)
        assert not rep.failed and not rep.refused
        assert rep.verdicts[0].status in ("ok", "improved")

    def test_slowdown_fails_and_names_dominant_phase(self):
        rng = np.random.default_rng(9)
        hist = _hist_rows(rng, runs=3, phases=PHASES_BASE)
        cur_phases = {"fleet.queues": {"count": 100, "total_s": 0.052},
                      "pricing.analytical": {"count": 100,
                                             "total_s": 0.148},
                      "fleet.decide": {"count": 100, "total_s": 0.021}}
        cur = [{"name": "case_a", "us_per_call": 200.0,
                "samples": _samples(rng, 200.0, n=5),
                "phases": cur_phases}]
        rep = gate_records(cur, hist, FP)
        assert rep.failed
        v = rep.verdicts[0]
        assert v.status == "regression"
        assert v.phase == "pricing.analytical"
        assert "+" in v.phase_detail
        txt = render(rep, cur)
        assert "FAIL" in txt and "pricing.analytical" in txt

    def test_fingerprint_mismatch_refuses_to_gate(self):
        rng = np.random.default_rng(10)
        other = dict(FP, cpu_count=64)
        hist = _hist_rows(rng, fp=other)
        cur = [{"name": "case_a", "us_per_call": 1000.0,
                "samples": _samples(rng, 1000.0, n=5)}]
        rep = gate_records(cur, hist, FP)
        assert rep.refused and not rep.failed
        assert rep.verdicts[0].status == "fingerprint_mismatch"
        assert "refusing to gate" in rep.reason
        assert "REFUSED" in render(rep, cur)

    def test_error_and_new_records_are_skipped_not_gated(self):
        rng = np.random.default_rng(11)
        hist = _hist_rows(rng, runs=3)
        cur = [{"name": "case_a", "error": "RuntimeError: x"},
               {"name": "case_new", "us_per_call": 5.0,
                "samples": [5.0, 5.1, 5.2]}]
        rep = gate_records(cur, hist, FP)
        assert not rep.failed
        assert {v.status for v in rep.verdicts} == {"error", "new"}

    def test_attribution_prefers_absolute_contribution(self):
        base = [{"phases": {"big": {"count": 1, "total_s": 1.0},
                            "tiny": {"count": 1, "total_s": 2e-5}}}]
        cur = {"phases": {"big": {"count": 1, "total_s": 1.5},
                          "tiny": {"count": 1, "total_s": 8e-5}}}
        phase, detail = attribute_phase(base, cur)
        assert phase == "big" and "+50%" in detail

    def test_gate_report_json_roundtrips(self):
        rng = np.random.default_rng(12)
        hist = _hist_rows(rng, runs=3)
        cur = [{"name": "case_a", "us_per_call": 100.0,
                "samples": _samples(rng, 100.0, n=5)}]
        d = gate_records(cur, hist, FP).to_json()
        assert json.loads(json.dumps(d)) == d
        assert d["counts"] and d["fingerprint"] == FP


# --------------------------------------------------------------------------
# parity with repro.bench, bit for bit
# --------------------------------------------------------------------------

def _sample_sets():
    """A dozen sample sets: small and large, ties, a spike, identical
    values (the degenerate MAD), a single sample."""
    rng = np.random.default_rng(20)
    return {
        "n3": _samples(rng, 100.0, n=3),
        "n5": _samples(rng, 100.0, n=5),
        "n8_slow": _samples(rng, 180.0, n=8),
        "n15": _samples(rng, 100.0, cv=0.08, n=15),
        "ties": list(np.round(rng.normal(100.0, 2.0, size=12))),
        "ties_shift": list(np.round(rng.normal(103.0, 2.0, size=9))),
        "spike": [100.0, 101.0, 99.0, 100.5, 1000.0, 100.2],
        "flat": [5.0] * 6,
        "mostly_flat": [5.0] * 5 + [5.5, 9.0],
        "one": [7.0],
        "n40": _samples(rng, 100.0, cv=0.1, n=40),
        "n60_slow": _samples(rng, 112.0, cv=0.1, n=60),
    }


SETS = _sample_sets()
# (baseline, current) pairs: the exact branch (C(n+m, m) <= 30,000), the
# normal branch, ties, degenerate and insufficient sides
PAIRS = [("n15", "n5"), ("n5", "n8_slow"), ("n8_slow", "n5"), ("n3", "n5"),
         ("ties", "ties_shift"), ("ties_shift", "ties"), ("flat", "mostly_flat"),
         ("spike", "n5"), ("n40", "n60_slow"), ("n60_slow", "n40"),
         ("one", "n5"), ("n15", "ties")]


def _same(a, b):
    """Equal bit for bit (NaN in the same places)."""
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


@pytest.mark.parametrize("name", sorted(SETS))
def test_summarize_reject_bootstrap_match_reference(name):
    xs = SETS[name]
    assert reject_outliers(xs) == ref.reject_outliers(xs)
    assert bootstrap_ci(xs) == ref.bootstrap_ci(xs)
    assert bootstrap_ci(xs, alpha=0.1, n_boot=500, seed=3) == \
        ref.bootstrap_ci(xs, alpha=0.1, n_boot=500, seed=3)
    assert _same(dataclasses.asdict(summarize(xs)),
                 dataclasses.asdict(ref.summarize(xs)))


@pytest.mark.parametrize("base,cur", PAIRS)
def test_mann_whitney_and_compare_match_reference(base, cur):
    a, b = SETS[base], SETS[cur]
    assert mann_whitney_u(a, b) == ref.mann_whitney_u(a, b)
    assert mann_whitney_u(b, a) == ref.mann_whitney_u(b, a)
    for kw in ({}, {"min_effect": 0.02, "alpha": 0.1, "min_samples": 5}):
        assert _same(dataclasses.asdict(compare(a, b, **kw)),
                     dataclasses.asdict(ref.compare(a, b, **kw)))


def test_both_mann_whitney_branches_are_exercised():
    """The pairs above reach the exact and the normal approximation."""
    import math
    sizes = [math.comb(len(SETS[a]) + len(SETS[b]), len(SETS[b]))
             for a, b in PAIRS]
    assert min(sizes) <= 30_000 < max(sizes)


def test_matrix_cases_match_reference():
    def build(cls):
        m = cls()
        m.add(_noop, name="solo", tags=("smoke",), fixed_k=1)
        m.add(_noop, name="grid", axes={"n": (8, 64), "p": ("a", "b")},
              tags=("system",), seed=0)
        m.add(_noop, name="lazy", axes={"scenario": lambda: ["x", "y"]})
        return m
    mine, theirs = build(Matrix), build(ref.Matrix)
    assert [(c.name, c.group, c.params, c.tags) for c in mine.cases()] == \
        [(c.name, c.group, c.params, c.tags) for c in theirs.cases()]
    for sel in ({"only": ["grid"]}, {"tags": ["smoke"]},
                {"only": ["lazy[scenario=y]", "solo"]}):
        assert [c.name for c in mine.select(**sel)] == \
            [c.name for c in theirs.select(**sel)]
    assert mine.groups() == theirs.groups()


def test_fold_phases_matches_reference():
    """One event list, past MAX_PHASES span names, with the wrapping
    ``bench`` span and point events, folds the same in both packages."""
    rng = np.random.default_rng(21)
    events, t = [], 0.0
    for i in range(40):
        dur = float(rng.uniform(1e-6, 2e-3))
        events.append({"type": "span", "name": f"phase.{i % 20}", "t": t,
                       "dur": dur, "depth": 1, "parent": "bench"})
        t += dur
        if i % 7 == 0:
            events.append({"type": "event", "name": "drift.tick", "t": t})
    events.append({"type": "span", "name": "bench", "t": 0.0, "dur": t,
                   "depth": 0, "parent": None})
    mine = brunner.fold_phases(events)
    assert len(mine) == brunner.MAX_PHASES and "bench" not in mine
    assert _same(mine, ref_runner.fold_phases(events))


def _gate_inputs():
    """Records and a history with every verdict: ok, regression (with
    phases), improved, insufficient, new, error, fingerprint_mismatch; a
    record with a devices/sec curve."""
    rng = np.random.default_rng(22)
    fp = {"host": "h", "machine": "x86_64", "cpu_count": 8,
          "python": "3.12", "torch": "t", "cuda": "12", "device": "card",
          "device_count": 1, "power_limit": "700.00 W"}
    foreign = dict(fp, device="other card")
    hist = []
    for name, mean in (("ok_case", 100.0), ("slow_case", 100.0),
                       ("fast_case", 200.0), ("few_case", 100.0)):
        hist += _hist_rows(rng, runs=3, mean=mean, name=name, fp=fp,
                           phases=PHASES_BASE, stamp_fn=ref_hist.stamp)
    hist += _hist_rows(rng, runs=2, name="foreign_case", fp=foreign,
                       stamp_fn=ref_hist.stamp)
    hist += ref_hist.stamp([{"name": "ok_case", "error": "E: x"}],
                           run_id="e", t_unix=9.0, sha="e", fp=fp)
    slow_phases = {"fleet.queues": {"count": 100, "total_s": 0.051},
                   "pricing.analytical": {"count": 100, "total_s": 0.150},
                   "fleet.decide": {"count": 100, "total_s": 0.020},
                   "fleet.new": {"count": 3, "total_s": 0.004}}
    records = [
        {"name": "ok_case", "samples": _samples(rng, 100.0),
         "phases": PHASES_BASE},
        {"name": "slow_case", "samples": _samples(rng, 200.0),
         "phases": slow_phases,
         "extra": {"devices": 100000, "devices_per_s": 1.5e6}},
        {"name": "fast_case", "samples": _samples(rng, 100.0)},
        {"name": "few_case", "samples": _samples(rng, 100.0, n=2)},
        {"name": "new_case", "samples": _samples(rng, 10.0)},
        {"name": "broken_case", "error": "RuntimeError: boom"},
        {"name": "foreign_case", "samples": _samples(rng, 100.0)},
    ]
    return records, hist, fp


@pytest.mark.parametrize("kw", [{}, {"min_effect": 0.5, "pool": 1},
                                {"alpha": 0.01, "min_samples": 2}])
def test_gate_records_and_render_match_reference(kw):
    records, hist, fp = _gate_inputs()
    mine = gate_records(records, hist, fp, **kw)
    theirs = ref_gate.gate_records(records, hist, fp, **kw)
    assert _same(mine.to_json(), theirs.to_json())
    assert render(mine, records) == ref_gate.render(theirs, records)
    if not kw:
        status = {v.name: v.status for v in mine.verdicts}
        assert status == {"ok_case": "ok", "slow_case": "regression",
                          "fast_case": "improved", "few_case": "insufficient",
                          "new_case": "new", "broken_case": "error",
                          "foreign_case": "fingerprint_mismatch"}
        slow = next(v for v in mine.verdicts if v.name == "slow_case")
        assert slow.phase == "pricing.analytical"
        assert "devices_per_s" in render(mine, records)


def test_refused_gate_matches_reference():
    records, hist, fp = _gate_inputs()
    other = dict(fp, host="elsewhere")
    mine = gate_records(records, hist, other)
    theirs = ref_gate.gate_records(records, hist, other)
    assert mine.refused and _same(mine.to_json(), theirs.to_json())
    assert render(mine, records) == ref_gate.render(theirs, records)


# --------------------------------------------------------------------------
# the wait for the card
# --------------------------------------------------------------------------

@pytest.fixture
def fake_cuda(monkeypatch):
    """``torch.cuda`` as if initialized on a card: each synchronize is
    logged with its device argument and the innermost open span."""
    log = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)

    def synchronize(device=None):
        stack = getattr(obs.get_recorder(), "_stack", None)
        log.append(("sync", device, stack[-1] if stack else None))
    monkeypatch.setattr(torch.cuda, "synchronize", synchronize)
    return log


def test_timeit_waits_after_each_warmup_call_and_each_repetition(fake_cuda):
    def fn():
        fake_cuda.append(("call",))
    t = timeit(fn, n=3, reps=4, warmup=2)
    assert len(t.samples) == 4
    kinds = "".join("c" if e[0] == "call" else "s" for e in fake_cuda)
    # each warmup call waited for, then each repetition's 3 calls
    assert kinds == "cs" * 2 + "cccs" * 4
    assert all(e[1] is None for e in fake_cuda if e[0] == "sync")


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on ``cuda:<index>`` (the wait's
    walk reads ``is_cuda`` and ``device`` only)."""
    __torch_function__ = torch._C._disabled_torch_function_impl
    is_cuda = True
    device = None


def _on_card(index):
    t = torch.Tensor._make_subclass(_OnCard, torch.zeros(1))
    t.device = torch.device("cuda", index)
    return t


def test_wait_synchronizes_each_other_card_in_the_output(fake_cuda):
    out = {"a": [_on_card(2), (_on_card(0), torch.zeros(1))],
           "b": (_on_card(1), {"c": _on_card(2)}), "d": 3}
    bstats._block(out)
    assert [e[1] for e in fake_cuda] == [None, 1, 2]


def test_runner_waits_once_per_case_inside_its_bench_span(fake_cuda):
    m = Matrix()

    def case_a():
        brunner.emit("a", Timing(1.0, [1.0, 1.1, 1.2]), "")

    def case_b():
        with obs.span("work"):
            pass
        brunner.emit("b", Timing(2.0, [2.0, 2.1, 2.2]), "")

    m.add(case_a)
    m.add(case_b)
    res = brunner.run(m.cases(), echo=False)
    assert res.errors == 0
    assert fake_cuda == [("sync", None, "bench"), ("sync", None, "bench")]
    assert "work" in res.records[1]["phases"]


def test_on_the_cpu_the_wait_calls_nothing(monkeypatch):
    assert not torch.cuda.is_initialized()
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: calls.append("synchronize"))
    monkeypatch.setattr(torch.cuda, "current_device",
                        lambda: calls.append("current_device"))
    timeit(lambda: torch.ones(3) * 2, n=2, reps=3)
    m = Matrix()
    m.add(lambda: brunner.emit("x", timeit(lambda: None, n=1, reps=3), ""),
          name="x")
    brunner.run(m.cases(), echo=False)
    bstats._block([torch.ones(2)])
    assert calls == []


# --------------------------------------------------------------------------
# the fingerprint
# --------------------------------------------------------------------------

PORT_KEYS = {"host", "machine", "cpu_count", "python", "torch", "cuda",
             "device", "device_count", "power_limit"}


def test_fingerprint_has_the_ports_keys(monkeypatch):
    fp = fingerprint()
    assert set(fp) == PORT_KEYS
    assert not {"jax", "backend", "pallas"} & set(fp)
    assert fp["torch"] == torch.__version__
    assert fp["cuda"] == (torch.version.cuda or "none")
    assert fp["device"] == "cpu" and fp["device_count"] == 0
    monkeypatch.setenv("REPRO_BENCH_HOST", "ci-runner")
    assert fingerprint()["host"] == "ci-runner"


def test_power_limit_read_once_from_nvidia_smi(monkeypatch, tmp_path):
    smi = tmp_path / "nvidia-smi"
    count = tmp_path / "count"
    smi.write_text(f"#!/bin/sh\necho x >> {count}\necho '700.00 W'\n")
    smi.chmod(0o755)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}{os.environ['PATH']}")
    bhist._power_limit.cache_clear()
    try:
        assert fingerprint()["power_limit"] == "700.00 W"
        assert fingerprint()["power_limit"] == "700.00 W"
        assert count.read_text().count("x") == 1
        monkeypatch.setattr(bhist.shutil, "which", lambda name: None)
        bhist._power_limit.cache_clear()
        assert fingerprint()["power_limit"] == "none"
    finally:
        bhist._power_limit.cache_clear()


def test_reference_history_never_baselines_a_port_run():
    rng = np.random.default_rng(23)
    ref_fp = ref.fingerprint()
    assert {"jax", "backend", "pallas"} <= set(ref_fp)
    hist = _hist_rows(rng, runs=3, fp=ref_fp)
    cur = [{"name": "case_a", "samples": _samples(rng, 100.0)}]
    rep = gate_records(cur, hist, FP)
    assert rep.refused and rep.verdicts[0].status == "fingerprint_mismatch"


# --------------------------------------------------------------------------
# the gate CLI
# --------------------------------------------------------------------------

def _results(path, records, fp, sha="abc", t=1000.0):
    path.write_text(json.dumps({"schema": 2, "unix_time": t, "git_sha": sha,
                                "fingerprint": fp, "rows": records}))
    return str(path)


def _run_records(rng, mean, fp_name="case_a"):
    return [{"name": fp_name, "us_per_call": mean,
             "samples": _samples(rng, mean), "phases": PHASES_BASE}]


def test_benchgate_exit_codes(tmp_path, capsys):
    rng = np.random.default_rng(24)
    hist = str(tmp_path / "h.jsonl")
    first = _results(tmp_path / "r0.json", _run_records(rng, 100.0), FP)
    assert benchgate.main([first, "--history", hist, "--strict"]) == 2
    assert len(bhist.load(hist)) == 1          # a new baseline is appended
    assert benchgate.main([first, "--history", hist]) == 0
    again = _results(tmp_path / "r1.json", _run_records(rng, 100.0), FP)
    assert benchgate.main([again, "--history", hist, "--strict"]) == 0
    n = len(bhist.load(hist))
    slow = _results(tmp_path / "r2.json", _run_records(rng, 250.0), FP)
    assert benchgate.main([slow, "--history", hist]) == 1
    assert len(bhist.load(hist)) == n          # a regression is not kept
    out = capsys.readouterr().out
    assert "FAIL" in out and "NOT appended" in out
    assert benchgate.main([slow, "--history", hist, "--append-always"]) == 1
    assert len(bhist.load(hist)) == n + 1
    assert benchgate.main([again, "--history", hist, "--no-append"]) == 0
    assert len(bhist.load(hist)) == n + 1
    foreign = _results(tmp_path / "r3.json", _run_records(rng, 100.0),
                       dict(FP, device="another card"))
    assert benchgate.main([foreign, "--history", hist, "--no-append"]) == 0
    assert benchgate.main([foreign, "--history", hist, "--no-append",
                           "--strict"]) == 2
    report = tmp_path / "gate.json"
    assert benchgate.main([again, "--history", hist, "--no-append",
                           "--json", str(report)]) == 0
    assert json.loads(report.read_text())["counts"] == {"ok": 1}


def test_benchgate_refuses_unreadable_results(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema": 1, "rows": []}))
    with pytest.raises(SystemExit, match="need 2"):
        benchgate.main([str(bad), "--history", str(tmp_path / "h.jsonl")])
    with pytest.raises(SystemExit, match="cannot read"):
        benchgate.main([str(tmp_path / "missing.json")])


def _reference_cli():
    spec = importlib.util.spec_from_file_location(
        "_ref_benchgate", ROOT / "scripts" / "benchgate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_benchgate_matches_reference_cli(tmp_path, monkeypatch, capsys):
    """The same results files, gated in turn against a history of each
    CLI's own, give the same exit codes, text and history rows."""
    rng = np.random.default_rng(25)
    fp = dict(FP, host="fixed")
    runs = [_run_records(rng, m) for m in (100.0, 102.0, 99.0, 240.0, 101.0)]
    ref_cli = _reference_cli()
    outputs = {}
    for who in ("port", "reference"):
        d = tmp_path / who
        d.mkdir()
        monkeypatch.chdir(d)
        codes, texts = [], []
        for i, recs in enumerate(runs):
            res = _results(d / f"r{i}.json", recs, fp, sha=f"s{i}", t=float(i))
            argv = [f"r{i}.json", "--history", "h.jsonl", "--strict",
                    "--json", "-"]
            if who == "port":
                codes.append(benchgate.main(argv))
            else:
                monkeypatch.setattr(sys, "argv", ["benchgate.py"] + argv)
                codes.append(ref_cli.main())
            texts.append(capsys.readouterr().out)
            assert os.path.exists(res)
        outputs[who] = (codes, texts, bhist.load(str(d / "h.jsonl")))
    assert outputs["port"] == outputs["reference"]
    assert outputs["port"][0] == [2, 0, 0, 1, 0]
