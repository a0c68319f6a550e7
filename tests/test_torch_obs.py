"""repro_torch.obs against repro.obs on the CPU: the null recorder, the
JSONL schema (files written by either package read by the other), nested
spans, metrics, structured logging, results bit-identical with recording
on and off, the build counter that stands in for the reference's retrace
counter (``tracemon``), and ``TrainDiag``/``check_health`` on one
history. Inputs come from numpy seeds."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.obs import events as ref_events  # noqa: E402
from repro.obs.metrics import Metrics as RefMetrics  # noqa: E402
from repro.obs.traindiag import TrainDiag as RefTrainDiag  # noqa: E402
from repro.obs.traindiag import check_health as ref_check_health  # noqa: E402

import repro_torch.core as T  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.obs import (NullRecorder, Recorder, SCHEMA_VERSION,  # noqa: E402
                             TrainDiag, check_health, read_events, recording,
                             tracemon)
from repro_torch.obs.metrics import Metrics  # noqa: E402
from repro_torch.online import OnlineConfig, get_schedule  # noqa: E402
from repro_torch.policies import build_policy  # noqa: E402
from repro_torch.scenarios import get_scenario, run_scenario  # noqa: E402
from repro_torch.sim import FleetConfig, PoissonTrace, simulate  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the port's ops here are small, so one thread
    is as fast alone, and it does not spin against the other test
    workers' threads when the suite runs in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# null default + recorder lifecycle
# --------------------------------------------------------------------------

def test_null_recorder_is_default_and_noop():
    rec = obs.get_recorder()
    assert isinstance(rec, NullRecorder) and not rec.enabled
    # the disabled span is one shared object: no allocation per use
    s1, s2 = obs.span("a", x=1), obs.span("b")
    assert s1 is s2
    with s1:
        pass
    obs.event("nothing", y=2)                      # no-op, no error
    obs.inc("c"), obs.gauge("g", 1.0), obs.observe("h", 2.0)


def test_recording_installs_and_restores(tmp_path):
    before = obs.get_recorder()
    with recording(str(tmp_path / "e.jsonl")) as rec:
        assert obs.get_recorder() is rec and rec.enabled
        obs.event("inside")
    assert obs.get_recorder() is before
    rec.close()                                    # idempotent
    meta, events = read_events(str(tmp_path / "e.jsonl"))
    assert meta["schema"] == SCHEMA_VERSION == ref_events.SCHEMA_VERSION
    assert any(e["type"] == "event" and e["name"] == "inside" for e in events)


def _record(path, rec_mod):
    """The same recording through either package's hooks."""
    with rec_mod.recording(path, meta={"tool": "test", "n": 3}) as rec:
        with rec_mod.span("outer", k="v"):
            rec_mod.event("point", val=np.float64(1.5))
        rec.metrics.inc("hits", 2.0)
        rec.metrics.observe("lat", 0.25)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_schema_round_trip_across_packages(tmp_path, writer):
    """A file written by one package reads back in both, with the same
    records apart from the clock."""
    path = str(tmp_path / "events.jsonl")
    _record(path, obs if writer == "port" else ref_events)
    meta, events = read_events(path)
    ref_meta, ref_evs = ref_events.read_events(path)
    assert meta == ref_meta and events == ref_evs
    assert meta["type"] == "meta" and meta["clock"] == "perf_counter"
    assert meta["meta"] == {"tool": "test", "n": 3}
    assert {"span", "event", "metric", "jax"} <= {e["type"] for e in events}
    point = next(e for e in events if e.get("name") == "point")
    assert point["attrs"]["val"] == 1.5
    seqs = [e["seq"] for e in events]
    assert seqs == list(range(len(events)))


def test_both_packages_write_the_same_records(tmp_path):
    """Same recording, each package: identical event streams once the
    timestamps and the summary record's build counts are set aside."""
    def strip(evs):
        out = []
        for e in evs:
            e = {k: v for k, v in e.items() if k not in ("t", "dur", "traces", "compile")}
            out.append(e)
        return out
    _record(str(tmp_path / "a.jsonl"), obs)
    _record(str(tmp_path / "b.jsonl"), ref_events)
    assert strip(read_events(str(tmp_path / "a.jsonl"))[1]) \
        == strip(read_events(str(tmp_path / "b.jsonl"))[1])


def test_read_events_rejects_foreign_files_and_skips_a_torn_tail(tmp_path):
    p = tmp_path / "x.jsonl"
    p.write_text('{"not": "meta"}\n')
    with pytest.raises(ValueError, match="no meta header"):
        read_events(str(p))
    p.write_text(json.dumps({"type": "meta", "schema": 999}) + "\n")
    with pytest.raises(ValueError, match="schema"):
        read_events(str(p))
    path = str(tmp_path / "f.jsonl")
    rec = Recorder(path=path, flush_every=2)
    for i in range(5):
        rec.event("e", i=i)
    with open(path) as f:                       # flushed in pairs so far
        assert len(f.readlines()) == 1 + 4
    rec.close()
    with open(path, "a") as f:
        f.write('{"type": "event", "na')        # a run killed mid-write
    _, events = read_events(path)
    assert [e["attrs"]["i"] for e in events if e["type"] == "event"] == list(range(5))


def test_nested_spans_depth_parent_ordering():
    rec = Recorder()
    with rec.span("a"):
        with rec.span("b", tag=1):
            pass
        with rec.span("c"):
            pass
    spans = [e for e in rec.events if e["type"] == "span"]
    # spans emit at exit: children precede the parent in the stream
    assert [s["name"] for s in spans] == ["b", "c", "a"]
    b, c, a = spans
    assert b["depth"] == c["depth"] == 1 and a["depth"] == 0
    assert b["parent"] == c["parent"] == "a" and a["parent"] is None
    assert b["attrs"] == {"tag": 1}
    assert a["t"] <= b["t"] and b["t"] + b["dur"] <= a["t"] + a["dur"] + 1e-9
    rec.event("drift.regime_switch", name="brownout")   # no collision
    assert rec.events[-1]["attrs"] == {"name": "brownout"}


# --------------------------------------------------------------------------
# metrics and logging
# --------------------------------------------------------------------------

def test_metrics_snapshot_equals_the_reference():
    r = np.random.default_rng(0)
    ms = Metrics(), RefMetrics()
    for m in ms:
        m.inc("req", 2.0, policy="a2c")
        m.inc("req", 3.0, policy="a2c")
        m.inc("req", 1.0, policy="greedy")
        m.gauge("level", 0.5)
        m.gauge("level", 0.7)                    # last write wins
    for v in r.uniform(0.0, 5.0, 101):
        for m in ms:
            m.observe("lat", float(v), policy="a2c")
    snap = ms[0].snapshot()
    assert snap == ms[1].snapshot()
    by = {(s["name"], tuple(sorted(s["labels"].items()))): s for s in snap}
    assert by[("req", (("policy", "a2c"),))]["value"] == 5.0
    assert by[("level", ())]["value"] == 0.7
    assert by[("lat", (("policy", "a2c"),))]["count"] == 101


def test_module_metrics_route_to_active_recorder(tmp_path):
    path = str(tmp_path / "m.jsonl")
    with recording(path):
        obs.inc("fleet.arrivals", 7, policy="x")
        obs.observe("q", 1.0)
    _, events = read_events(path)
    assert {"fleet.arrivals", "q"} <= {e["name"] for e in events if e["type"] == "metric"}


def test_structured_logging_gates_console(capsys, tmp_path):
    old = obs.get_verbosity()
    try:
        obs.set_verbosity(0)
        with recording(str(tmp_path / "l.jsonl")):
            obs.info("hidden info")
            obs.debug("hidden debug")
            obs.warn("visible warn")
        out = capsys.readouterr()
        assert "hidden" not in out.out and "hidden" not in out.err
        assert "visible warn" in out.err
        _, events = read_events(str(tmp_path / "l.jsonl"))
        logged = {(e["level"], e["msg"]) for e in events if e["type"] == "log"}
        assert {("info", "hidden info"), ("debug", "hidden debug"),
                ("warn", "visible warn")} <= logged
        obs.set_verbosity(2)
        obs.info("now info")
        obs.debug("now debug")
        out = capsys.readouterr()
        assert "now info" in out.out and "now debug" in out.out
    finally:
        obs.set_verbosity(old)


# --------------------------------------------------------------------------
# recording never changes results; the fleet loop's spans and counters
# --------------------------------------------------------------------------

def test_comparison_report_bit_identical_on_vs_off(tmp_path):
    sc = get_scenario("paper-exact")
    roster = ("greedy_oracle", "device_only")
    kw = dict(n_requests=1200, seeds=(0,), device="cpu")
    off = run_scenario(sc, roster, **kw)
    path = str(tmp_path / "t.jsonl")
    with recording(path):
        on = run_scenario(sc, roster, **kw)
    assert off.to_json() == on.to_json()
    _, events = read_events(path)
    names = {e["name"] for e in events if e["type"] == "span"}
    assert {"scenario.build", "scenario.simulate", "fleet.epoch", "fleet.decide",
            "fleet.queues", "fleet.dynamics"} <= names
    arrivals = [e for e in events if e["type"] == "metric" and e["name"] == "fleet.arrivals"]
    assert {a["labels"]["policy"] for a in arrivals} == set(roster)
    assert all(a["value"] == off.results[a["labels"]["policy"]].per_seed[0]["requests"]
               for a in arrivals)


# --------------------------------------------------------------------------
# build accounting (the reference's retrace counter)
# --------------------------------------------------------------------------

def test_count_trace_and_track_traces():
    site = "test.count_trace_site"
    before = tracemon.trace_counts().get(site, 0)
    with tracemon.track_traces() as d:
        tracemon.count_trace(site)
        tracemon.count_trace(site)
    assert d == {site: 2} and tracemon.trace_counts()[site] == before + 2
    with tracemon.track_traces() as d:
        pass
    assert d == {}
    rec = Recorder()
    obs.set_recorder(rec)
    try:
        tracemon.count_trace(site)
    finally:
        obs.set_recorder(None)
    ev = rec.events[-1]
    assert ev["name"] == "jax.trace" and ev["attrs"] == {"site": site, "n": before + 3}
    rec.close()
    assert rec.events[-1]["type"] == "jax" and rec.events[-1]["traces"][site] == before + 3


def test_online_run_builds_one_step_per_bucket_and_exploration_rate():
    """Across an online run (hot-swaps every epoch from the fourth), the
    update step is built once per window bucket (4, 8, 16) and the capture
    step once per exploration rate the run visits, as the reference
    re-traces; hot-swaps build nothing."""
    cfg, tables = T.make_paper_env(n_uavs=3, slot_seconds=10.0, peak_rps=20.0, device="cpu")
    pol = build_policy("a2c", cfg, tables, episodes=1, hidden1=64, hidden2=32, uav_head=16)
    pol.train(seed=0)
    oc = OnlineConfig(gate="always", window=16, min_window=4)
    with tracemon.track_traces() as d:
        res = simulate(cfg, tables, pol, PoissonTrace(rate_rps=6.0), n_requests=6000, seed=0,
                       fleet=FleetConfig(slo_s=1.0),
                       schedule=get_schedule("link-brownout", onset=5, recover=0), online=oc)
    assert res.adaptation["online"]["updates"] > 10
    assert d == {"online.update": 3, "online.capture": 2}, d


# --------------------------------------------------------------------------
# learner diagnostics
# --------------------------------------------------------------------------

def test_traindiag_and_check_health_equal_the_reference():
    """One history (a port PPO run's, plus a record with a missing key
    and one with a NaN), through both packages."""
    cfg, tables = T.make_paper_env(device="cpu")
    pol = build_policy("ppo", cfg, tables, episodes=3,
                       base=T.A2CConfig(hidden1=64, hidden2=32, uav_head=16))
    hist = pol.train(seed=0)
    assert set(hist[0]) >= set(obs.DIAG_KEYS)
    hist = hist + [{k: v for k, v in hist[-1].items() if k != "grad_norm"},
                   dict(hist[-1], approx_kl=float("nan"), entropy=1e-6,
                        explained_var=-0.5)]
    hist[0] = dict(hist[0], approx_kl=3.0)
    d, ref = TrainDiag.from_history(hist), RefTrainDiag.from_history(hist)
    assert d.updates == ref.updates == len(hist) and d.keys == ref.keys
    for k in d.keys:
        np.testing.assert_array_equal(d.column(k), ref.column(k))
    assert d.summary() == ref.summary()
    assert d.to_json() == ref.to_json()
    warnings = check_health(d)
    assert warnings == ref_check_health(ref) and len(warnings) == 3
    assert check_health(d, kl_limit=5.0, entropy_floor=0.0) \
        == ref_check_health(ref, kl_limit=5.0, entropy_floor=0.0)
    assert TrainDiag.from_history([]).updates == 0
