"""repro_torch's flight recorder and reporting half of obs against
repro's on the CPU: the SLO error-budget math and its alerts, the stride
rules, the scan engine's bulk path, capture result-neutral on all three
engines and on a server pool, the timeline's columns equal to the
reference's bit for bit on the host engines over the same worlds, the
online run's annotations, the cluster-brownout record (per-server series,
autoscaler decisions, the burn alert) through the fleetview export,
flight files and event files read by either package, report fold and
render, and the kernel-build accounting. Inputs come from numpy seeds."""
import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
from repro import obs as ref_obs  # noqa: E402
from repro.obs import report as ref_report  # noqa: E402
from repro.obs import slo as ref_slo  # noqa: E402
from repro.obs import timeline as ref_timeline  # noqa: E402
from repro.online import OnlineConfig as RefOnlineConfig  # noqa: E402
from repro.online import get_schedule as ref_get_schedule  # noqa: E402
from repro.policies import build_policy as ref_build_policy  # noqa: E402
from repro.scenarios import get_scenario as ref_get_scenario  # noqa: E402
from repro.scenarios import run_scenario as ref_run_scenario  # noqa: E402
from repro.sim import FleetConfig as RefFleetConfig  # noqa: E402
from repro.sim import PoissonTrace as RefPoissonTrace  # noqa: E402
from repro.sim import simulate as ref_simulate  # noqa: E402

import repro_torch.core as T  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.launch import fleetview, obsview  # noqa: E402
from repro_torch.launch import simulate as cli  # noqa: E402
from repro_torch.obs import (Recorder, SLOConfig, Timeline, read_events,  # noqa: E402
                             read_timeline, recording, report, tracemon,
                             write_timeline)
from repro_torch.obs.slo import compute, emit_events  # noqa: E402
from repro_torch.online import OnlineConfig, get_schedule  # noqa: E402
from repro_torch.policies import build_policy  # noqa: E402
from repro_torch.scenarios import get_scenario, run_scenario  # noqa: E402
from repro_torch.sim import EpochLog, FleetConfig, PoissonTrace, simulate  # noqa: E402

# cluster-brownout cut as the reference's acceptance test cuts it: one
# seed, 30,000 requests, the brownout moved to epochs 8-20, a 0.98 target
BROWNOUT = dict(seeds=(0,), n_requests=30_000, slo_target=0.98,
                drift_kw={"onset": 8, "relax": 20, "scale": 1.75, "queue_scale": 6.0})


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread, as the other port test files: the suite runs
    its files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _world(preset):
    sc = get_scenario(preset)
    env_cfg, tables, model_ids, bf = sc.build_env(device="cpu")
    return sc, env_cfg, tables, model_ids, bf


def _run(sc, env_cfg, tables, model_ids, bf, policy, engine, *,
         n_requests, seed=0, autoscaler=None, **fl_kw):
    fl = FleetConfig(slo_s=sc.slo_s, engine=engine, **fl_kw)
    return simulate(env_cfg, tables, policy, sc.build_trace(),
                    n_requests=n_requests, seed=seed, fleet=fl,
                    backend=bf() if engine != "scan" else None, model_ids=model_ids,
                    autoscaler=autoscaler)


def _ref_run(preset, policy_name, engine, *, n_requests, seed=0, with_autoscaler=False,
             **fl_kw):
    sc = ref_get_scenario(preset)
    env_cfg, tables, model_ids, bf = sc.build_env()
    return ref_simulate(env_cfg, tables, ref_build_policy(policy_name, env_cfg, tables),
                        sc.build_trace(), n_requests=n_requests, seed=seed,
                        fleet=RefFleetConfig(slo_s=sc.slo_s, engine=engine, **fl_kw),
                        backend=bf(), model_ids=model_ids,
                        autoscaler=sc.build_autoscaler() if with_autoscaler else None)


def assert_same_timeline(a, b):
    """Two timelines (reference, port) bit for bit: columns with their
    dtypes, annotations, the SLO report, the serialized form."""
    ca, cb = a.columns, b.columns
    assert set(cb) == set(ca)
    for k in ca:
        assert cb[k].dtype == ca[k].dtype, k
        np.testing.assert_array_equal(cb[k], ca[k], err_msg=k)
    assert b.annotations == a.annotations
    assert (b.engine, b.stride, b.n_servers, b.server_names) == \
        (a.engine, a.stride, a.n_servers, a.server_names)
    assert b.to_json() == a.to_json()


# --------------------------------------------------------------------------
# SLO error budgets: burn math + the multi-window page state machine
# --------------------------------------------------------------------------

def _same_report(a, b):
    assert b.summary() == a.summary()
    assert b.to_json() == a.to_json()


def test_slo_burn_rate_math():
    # constant 10% miss rate against a 5% budget: burn = 2.0 everywhere
    T_ = 40
    arrivals, hits = np.full(T_, 100), np.full(T_, 90)
    rep = compute(np.arange(T_), arrivals, hits, SLOConfig(target=0.95))
    np.testing.assert_allclose(rep.burn_fast, 2.0)
    np.testing.assert_allclose(rep.burn_slow, 2.0)
    assert rep.attainment == pytest.approx(0.9)
    assert rep.alerts == []
    assert rep.budget_remaining == 0.0 and rep.time_to_exhaustion == 0.0
    _same_report(ref_slo.compute(np.arange(T_), arrivals, hits,
                                 ref_slo.SLOConfig(target=0.95)), rep)


def test_slo_alert_fires_and_clears():
    cfg = SLOConfig(target=0.95)
    arrivals, hits = np.full(80, 100), np.full(80, 100)
    hits[30:50] = 40
    rep = compute(np.arange(80), arrivals, hits, cfg)
    assert len(rep.alerts) == 1
    a = rep.alerts[0]
    assert 30 < a["start"] < 50 and a["end"] is not None and a["end"] > 50
    assert a["peak_burn_fast"] == pytest.approx(12.0)
    assert a["peak_burn_slow"] > cfg.slow_burn
    _same_report(ref_slo.compute(np.arange(80), arrivals, hits, ref_slo.SLOConfig()), rep)
    hits2 = np.full(80, 100)
    hits2[30] = 0                       # one bad epoch never pages
    assert compute(np.arange(80), arrivals, hits2, cfg).alerts == []


def test_slo_unclosed_alert_and_page_epochs():
    arrivals, hits = np.full(40, 100), np.full(40, 100)
    hits[20:] = 30
    rep = compute(np.arange(40), arrivals, hits, SLOConfig(target=0.95))
    assert len(rep.alerts) == 1 and rep.alerts[0]["end"] is None
    assert rep.summary()["page_epochs"] == 40 - rep.alerts[0]["start"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_slo_report_equals_the_reference_on_random_series(seed):
    """Random bursty series, a few configurations: the same report."""
    r = np.random.default_rng(seed)
    T_ = int(r.integers(1, 200))
    arrivals = r.integers(0, 300, T_)
    hits = np.minimum(arrivals, (arrivals * r.uniform(0.3, 1.0, T_)).astype(int))
    for kw in (dict(), dict(target=0.99, fast_window=4, slow_window=16),
               dict(target=0.5, fast_burn=2.0, slow_burn=1.5)):
        _same_report(ref_slo.compute(np.arange(T_), arrivals, hits, ref_slo.SLOConfig(**kw)),
                     compute(np.arange(T_), arrivals, hits, SLOConfig(**kw)))


def test_slo_config_validation():
    with pytest.raises(ValueError, match="target"):
        SLOConfig(target=1.0)
    with pytest.raises(ValueError, match="window"):
        SLOConfig(fast_window=16, slow_window=8)
    assert SLOConfig(target=0.98).budget == pytest.approx(0.02)


def test_slo_emit_events_folds_into_report_timeline():
    arrivals, hits = np.full(40, 100), np.full(40, 100)
    hits[10:30] = 20
    rep = compute(np.arange(40), arrivals, hits, SLOConfig(target=0.95))
    assert rep.alerts
    r = Recorder()
    obs.set_recorder(r)
    try:
        emit_events(rep)
    finally:
        obs.set_recorder(None)
    names = [e["name"] for e in r.events if e["type"] == "event"]
    assert "slo.burn_alert" in names and "slo.budget" in names
    folded = report.fold(r.events)
    assert any(t["name"].startswith("slo.") for t in folded["timeline"])
    assert r.report()["timeline"] == folded["timeline"]


# --------------------------------------------------------------------------
# stride rules and the scan engine's bulk path
# --------------------------------------------------------------------------

def test_epoch_log_stride_retains_final_epoch():
    for n, want in ((10, [0, 3, 6, 9]), (11, [0, 3, 6, 9, 10]), (12, [0, 3, 6, 9, 11])):
        log = EpochLog(stride=3)
        for e in range(n):
            log.append({"epoch": e})
        assert list(log.column("epoch")) == want


def test_timeline_stride_retains_final_epoch():
    tls = [Timeline(stride=3), ref_timeline.Timeline(stride=3)]
    for tl in tls:
        for e in range(11):
            tl.append_epoch(epoch=e, arrivals=10, dropped=0, slo_hits=9,
                            alive=2, regime=0, queue_jobs=0.0, backlog_s=0.0,
                            lat=np.array([0.1 * (e + 1)]), energy_j=1.0)
    assert list(tls[0].column("epoch")) == [0, 3, 6, 9, 10]
    assert len(tls[0]) == 5
    assert tls[0].to_json() == tls[1].to_json()


def test_timeline_scan_bulk_path_matches_stride_rule():
    T_ = 10
    z = np.zeros(T_)
    kw = dict(epoch=np.arange(T_), arrivals=np.full(T_, 8), served=np.full(T_, 8),
              dropped=z, slo_hits=np.full(T_, 7), alive=np.full(T_, 4), queue_jobs=z,
              backlog_s=z, lat_sum=np.full(T_, 1.6), lat_max=np.full(T_, 0.5),
              energy_j=np.full(T_, 3600.0))
    tl, ref = Timeline(stride=4, slot_seconds=2.0), ref_timeline.Timeline(stride=4,
                                                                          slot_seconds=2.0)
    tl.extend_epochs(**kw)
    ref.extend_epochs(**kw)
    assert list(tl.column("epoch")) == [0, 4, 8, 9]
    assert tl.column("lat_mean")[0] == pytest.approx(0.2)
    assert np.isnan(tl.column("lat_p95")).all()
    assert tl.column("energy_wh")[0] == pytest.approx(1.0)
    assert tl.column("goodput")[0] == pytest.approx(3.5)
    assert tl.to_json() == ref.to_json()


# --------------------------------------------------------------------------
# result neutrality, and the columns against the reference's
# --------------------------------------------------------------------------

def _assert_bit_identical(a, b):
    assert np.array_equal(a.selection_hist, b.selection_hist)
    assert a.served == b.served and a.epochs == b.epochs
    assert a.metrics.dropped == b.metrics.dropped
    assert np.array_equal(a.metrics.latencies_s, b.metrics.latencies_s)
    assert np.array_equal(a.metrics.energies_j, b.metrics.energies_j)
    assert a.summary == b.summary
    assert list(a.epoch_log) == list(b.epoch_log)
    assert np.array_equal(a.server_hist, b.server_hist) if a.server_hist is not None \
        else b.server_hist is None


@pytest.mark.parametrize("engine", ["loop", "vectorized", "scan"])
def test_recording_neutral_across_engines(engine, tmp_path):
    sc, env_cfg, tables, mids, bf = _world("diurnal-fleet")
    pol = build_policy("device_only", env_cfg, tables)
    kw = dict(n_requests=3000, seed=1)
    off = _run(sc, env_cfg, tables, mids, bf, pol, engine, **kw)
    with recording(str(tmp_path / "t.jsonl")):
        on = _run(sc, env_cfg, tables, mids, bf, pol, engine, timeline=True, **kw)
    _assert_bit_identical(off, on)
    assert off.timeline is None
    tl = on.timeline
    assert len(tl) == on.epochs and tl.engine == engine and tl.slo_report is not None
    assert int(tl.column("served").sum()) == on.served
    assert int(tl.column("arrivals").sum()) >= on.served
    if engine == "scan":
        assert np.isnan(tl.column("lat_p95")).all()   # scan-carry rule
    else:
        assert np.isfinite(tl.column("lat_p95")).any()
        ref = _ref_run("diurnal-fleet", "device_only", engine, timeline=True, **kw)
        assert_same_timeline(ref.timeline, tl)


def test_scan_timeline_accounts_the_vectorized_workload():
    """The scan's timeline: arrivals per epoch equal to the vectorized
    engine's, percentile columns NaN, mean/max/energy finite."""
    sc, env_cfg, tables, mids, bf = _world("diurnal-fleet")
    pol = build_policy("device_only", env_cfg, tables)
    s = _run(sc, env_cfg, tables, mids, bf, pol, "scan", n_requests=15_000, timeline=True)
    v = _run(sc, env_cfg, tables, mids, bf, pol, "vectorized", n_requests=15_000,
             timeline=True)
    np.testing.assert_array_equal(s.timeline.column("arrivals"), v.timeline.column("arrivals"))
    for k in ("lat_p50", "lat_p95", "lat_p99"):
        assert np.isnan(s.timeline.column(k)).all()
    for k in ("lat_mean", "lat_max", "energy_wh"):
        assert np.isfinite(s.timeline.column(k)).all()
    assert s.timeline.column("served").sum() == s.served


@pytest.mark.parametrize("engine", ["loop", "vectorized"])
def test_recording_neutral_on_cluster_preset(engine, tmp_path):
    sc, env_cfg, tables, mids, bf = _world("edge-cluster")
    pol = build_policy("join_shortest_queue", env_cfg, tables)
    kw = dict(n_requests=3000, seed=0)
    off = _run(sc, env_cfg, tables, mids, bf, pol, engine,
               autoscaler=sc.build_autoscaler(), **kw)
    with recording(str(tmp_path / "t.jsonl")):
        on = _run(sc, env_cfg, tables, mids, bf, pol, engine,
                  autoscaler=sc.build_autoscaler(), timeline=True, **kw)
    _assert_bit_identical(off, on)
    tl = on.timeline
    assert tl.n_servers == 4
    for key in ("srv_queue", "srv_dvfs", "srv_replicas", "srv_power_w"):
        assert tl.column(key).shape == (len(tl), 4)
    assert (tl.column("srv_replicas") >= 1).all()
    ref = _ref_run("edge-cluster", "join_shortest_queue", engine, with_autoscaler=True,
                   timeline=True, **kw)
    assert_same_timeline(ref.timeline, tl)


def test_strided_timeline_equals_the_reference():
    sc, env_cfg, tables, mids, bf = _world("paper-mmpp-burst")
    pol = build_policy("greedy_oracle", env_cfg, tables)
    kw = dict(n_requests=6000, seed=2, timeline=True, log_stride=3, slo_target=0.9)
    b = _run(sc, env_cfg, tables, mids, bf, pol, "vectorized", **kw)
    a = _ref_run("paper-mmpp-burst", "greedy_oracle", "vectorized", **kw)
    assert_same_timeline(a.timeline, b.timeline)
    assert b.timeline.slo_report.cfg.target == 0.9


def test_online_run_annotates_triggers_and_hotswaps(tmp_path):
    """Drift + closed-loop adaptation leave their marks (regime switch,
    trigger or burst, every hot-swap), from one reference artifact as
    the reference's run does."""
    kw = dict(n_uavs=3, slot_seconds=10.0, peak_rps=20.0)
    ref_env, env = R.make_paper_env(**kw), T.make_paper_env(device="cpu", **kw)
    ref_pol = ref_build_policy("a2c", *ref_env, episodes=2)
    ref_pol.train(seed=0)
    path = ref_pol.save(str(tmp_path / "a2c.npz"))
    pol = build_policy("a2c", *env).load(path)
    oc = dict(algo="a2c", gate="always", explore_eps=0.0, window=16, min_window=4,
              update_every=1)
    res = simulate(*env, pol, PoissonTrace(rate_rps=6.0), n_requests=6000, seed=0,
                   fleet=FleetConfig(slo_s=1.0, timeline=True),
                   schedule=get_schedule("link-brownout", onset=5, recover=0),
                   online=OnlineConfig(**oc))
    assert res.adaptation["online"]["updates"] > 1
    kinds = {a["kind"] for a in res.timeline.annotations}
    assert "regime_switch" in kinds and "hotswap" in kinds
    assert "burst_start" in kinds or "drift_trigger" in kinds
    swaps = [a for a in res.timeline.annotations if a["kind"] == "hotswap"]
    assert len(swaps) == res.adaptation["online"]["updates"]
    ref = ref_simulate(*ref_env, ref_build_policy("a2c", *ref_env).load(path),
                       RefPoissonTrace(rate_rps=6.0), n_requests=6000, seed=0,
                       fleet=RefFleetConfig(slo_s=1.0, timeline=True),
                       schedule=ref_get_schedule("link-brownout", onset=5, recover=0),
                       online=RefOnlineConfig(**oc))
    assert [(a["epoch"], a["kind"]) for a in res.timeline.annotations] == \
        [(a["epoch"], a["kind"]) for a in ref.timeline.annotations]


# --------------------------------------------------------------------------
# the acceptance regime: cluster-brownout through the JSON export
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def brownout_export(tmp_path_factory):
    """One shortened cluster-brownout run in each package ->
    write_timeline -> read back by the other package -> fleetview."""
    sc = get_scenario("cluster-brownout").replace(**BROWNOUT)
    rep = run_scenario(sc, ("join_shortest_queue",), device="cpu", timeline=True)
    r = rep.results["join_shortest_queue"]
    d = tmp_path_factory.mktemp("fv")
    path, ref_path = str(d / "flight.json"), str(d / "ref_flight.json")
    write_timeline(path, [{"policy": "join_shortest_queue", "seed": 0,
                           "timeline": r.timelines[0]}], meta={"scenario": sc.name})
    ref_rep = ref_run_scenario(ref_get_scenario("cluster-brownout").replace(**BROWNOUT),
                               ("join_shortest_queue",), timeline=True)
    ref_r = ref_rep.results["join_shortest_queue"]
    ref_timeline.write_timeline(ref_path, [{"policy": "join_shortest_queue", "seed": 0,
                                            "timeline": ref_r.timelines[0]}],
                                meta={"scenario": sc.name})
    doc = ref_timeline.read_timeline(path)          # the port's file, read by the reference
    return {"doc": doc, "summary": fleetview.summarize(doc), "result": r, "ref": ref_r,
            "path": path, "ref_path": ref_path}


def test_brownout_flight_files_cross_between_packages(brownout_export):
    """Each package reads the other's file; both files hold the same
    record (the port's cluster path is the reference's bit for bit)."""
    e = brownout_export
    assert read_timeline(e["ref_path"]) == ref_timeline.read_timeline(e["path"])
    assert_same_timeline(e["ref"].timelines[0], e["result"].timelines[0])
    assert e["result"].slo == e["ref"].slo
    with open(e["path"]) as f:
        assert json.load(f)["type"] == "timeline"
    with pytest.raises(ValueError, match="not a timeline file"):
        read_timeline(_write_json(e["path"] + ".x", {"type": "x"}))


def _write_json(path, doc):
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def test_brownout_regime_switch_annotations(brownout_export):
    run = brownout_export["summary"]["runs"][0]
    switches = [a for a in run["annotations"] if a["kind"] == "regime_switch"]
    assert [s["epoch"] for s in switches] == [8, 20]
    assert run["annotation_counts"]["regime_switch"] == 2
    regimes = brownout_export["doc"]["runs"][0]["timeline"]["columns"]["regime"]
    assert regimes[7] == 0 and regimes[10] == 1 and regimes[-1] == 2


def test_brownout_autoscale_decision_with_measured_trigger(brownout_export):
    run = brownout_export["summary"]["runs"][0]
    decisions = [a for a in run["annotations"] if a["kind"] == "autoscale"]
    assert decisions, "autoscaler never moved"
    for d in decisions:
        assert d["action"] in ("dvfs_up", "dvfs_down", "replica_up", "replica_down")
        assert isinstance(d["queue"], (int, float))
    assert any(d["action"] in ("dvfs_up", "replica_up") for d in decisions)


def test_brownout_per_server_series(brownout_export):
    summ = brownout_export["summary"]
    srv = summ["runs"][0]["servers"]
    assert srv["n"] == 4 and len(srv["names"]) == 4
    epochs = summ["runs"][0]["epochs"]
    for key in ("srv_queue", "srv_dvfs", "srv_replicas", "srv_power_w"):
        assert len(srv[key]) == 4 and all(len(s) == epochs for s in srv[key])
    dvfs = np.asarray(srv["srv_dvfs"], float)
    assert (dvfs.max(axis=1) > dvfs.min(axis=1)).any()


def test_brownout_burn_alert_fires_and_clears(brownout_export):
    summ = brownout_export["summary"]
    slo = summ["runs"][0]["slo"]
    assert slo["alerts"] >= 1
    a = slo["alerts_detail"][0]
    assert 8 <= a["start"] <= 20 and a["end"] is not None and a["end"] > 20
    assert a["peak_burn_fast"] > slo["fast_burn"] and a["peak_burn_slow"] > slo["slow_burn"]
    assert summ["runs"][0]["annotation_counts"].get("slo_alert", 0) == slo["alerts"]


def test_brownout_scenario_report_carries_slo(brownout_export):
    r = brownout_export["result"]
    assert r.slo is not None and r.slo["mean"]["alerts"] >= 1
    assert r.slo["per_seed"][0]["target"] == pytest.approx(0.98)


def test_fleetview_renders_and_exports(brownout_export, tmp_path, capsys):
    doc, summ = brownout_export["doc"], brownout_export["summary"]
    text = fleetview.render(doc)
    assert "error budget" in text and "page #1" in text
    assert "regime_switch" in text and "tier0" in text
    html = fleetview.to_html(doc)
    assert "<svg" in html and "flight recorder" in html
    json.loads(json.dumps(summ))
    assert summ["type"] == "fleetview"
    # the command line: text, the JSON export, the HTML export, both files
    js, page = str(tmp_path / "s.json"), str(tmp_path / "d.html")
    fleetview.main([brownout_export["path"], "--json", js, "--html", page])
    out = capsys.readouterr().out
    assert "fleet flight recorder" in out and "wrote" in out
    with open(js) as f:
        assert json.load(f) == json.loads(json.dumps(summ, default=str))
    fleetview.main([brownout_export["ref_path"], "--json", "-"])
    assert json.loads(capsys.readouterr().out)["type"] == "fleetview"


def test_fleetview_sparkline_handles_nan_and_flat():
    assert fleetview.spark(np.array([np.nan, np.nan]), 10) == "··"
    assert fleetview.spark(np.array([1.0, 1.0, 1.0]), 10) == "▄▄▄"
    s = fleetview.spark(np.linspace(0, 1, 64), 8)
    assert len(s) == 8 and s[0] == "▁" and s[-1] == "█"


# --------------------------------------------------------------------------
# the CLI's recorders; events files both ways; report; build accounting
# --------------------------------------------------------------------------

def test_cli_trace_and_timeline_out(tmp_path, capsys, monkeypatch):
    """--trace-out and --timeline-out write files both packages read;
    --timeline-out - streams the JSON alone on stdout."""
    ev, fl = str(tmp_path / "e.jsonl"), str(tmp_path / "f.json")
    base = ["--scenario", "diurnal-fleet", "--device", "cpu", "--requests", "3000",
            "--seeds", "0", "--compare", "device_only,full_offload"]
    rep = cli.main(base + ["--trace-out", ev, "--timeline-out", fl])
    out = capsys.readouterr().out
    assert "wrote obs trace" in out and "wrote timeline" in out
    doc = ref_timeline.read_timeline(fl)
    assert [r["policy"] for r in doc["runs"]] == ["device_only", "full_offload"]
    assert doc["meta"]["slo_target"] == get_scenario("diurnal-fleet").slo_target
    assert rep.results["device_only"].slo is not None
    ref_rep = ref_report.load(ev)
    assert ref_rep["phases"]["fleet.epoch"]["count"] == \
        sum(r.per_seed[0]["epochs"] for r in rep.results.values())
    assert report.load(ev) == ref_rep
    cli.main(base + ["--engine", "scan", "--timeline-out", "-"])
    streamed = capsys.readouterr()
    doc = json.loads(streamed.out)
    assert doc["type"] == "timeline" and doc["runs"][0]["timeline"]["engine"] == "scan"
    assert "device_only" in streamed.err
    monkeypatch.setattr(sys, "stdin", __import__("io").StringIO(streamed.out))
    fleetview.main(["-"])
    assert "engine=scan" in capsys.readouterr().out


def _record(path, rec_mod):
    with rec_mod.recording(path, meta={"tool": "test"}):
        for i in range(3):
            with rec_mod.span("fleet.epoch", epoch=i):
                with rec_mod.span("fleet.decide"):
                    pass
        rec_mod.event("drift.trigger", n=1)
        rec_mod.event("online.hotswap", epoch=2)
        rec_mod.inc("served", 10)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_report_fold_and_render(tmp_path, writer, capsys):
    """An events file written by either package folds in both to the
    same report; the port renders it and obsview prints it."""
    path = str(tmp_path / "r.jsonl")
    _record(path, obs if writer == "port" else ref_obs)
    rep = report.load(path)
    assert rep == ref_report.load(path)
    assert rep["phases"]["fleet.epoch"]["count"] == 3
    assert rep["phases"]["fleet.decide"]["count"] == 3
    assert rep["phases"]["fleet.epoch"]["total_s"] >= rep["phases"]["fleet.decide"]["total_s"]
    assert [e["name"] for e in rep["timeline"]] == ["drift.trigger", "online.hotswap"]
    assert rep["wall_s"] > 0
    text = report.render(rep)
    for needle in ("per-phase timing:", "fleet.epoch", "drift/online timeline:",
                   "drift.trigger", "metrics:", "build accounting:"):
        assert needle in text
    json.dumps(rep, default=str)
    obsview.main([path])
    assert "per-phase timing:" in capsys.readouterr().out
    obsview.main([path, "--json", "-"])
    assert json.loads(capsys.readouterr().out)["phases"]["fleet.epoch"]["count"] == 3


def _fake_nvcc(tmp_path):
    """A stand-in for nvcc that writes its -o file (the CPU has none)."""
    script = tmp_path / "nvcc"
    script.write_text(f"#!{sys.executable}\nimport sys\n"
                      "open(sys.argv[sys.argv.index('-o') + 1], 'w').write('lib')\n")
    script.chmod(0o755)
    return str(script)


def test_build_accounting_counts_each_kernel_build(tmp_path, monkeypatch):
    """tracemon counts and times each library build as a build.kernel
    event; a cached library counts nothing; a Recorder's summary event
    carries the delta and the report renders it."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_nvcc", lambda: _fake_nvcc(tmp_path))
    path = str(tmp_path / "b.jsonl")
    with recording(path) as rec:
        with tracemon.track_compiles() as d1:
            seconds = _build.build(["rglru_scan", "mamba_scan"])
        with tracemon.track_compiles() as d2:
            _build.build(["rglru_scan"])              # built already
    assert d1["nvcc_build_n"] == 2 and d1["nvcc_build_s"] == pytest.approx(
        sum(seconds.values()))
    assert d2 == {}
    builds = [e for e in rec.events if e.get("name") == "build.kernel"]
    assert sorted(e["attrs"]["kernel"] for e in builds) == ["mamba_scan", "rglru_scan"]
    _, events = read_events(path)
    summary = next(e for e in events if e["type"] == "jax")
    assert summary["compile"]["nvcc_build_n"] == 2
    rep = report.load(path)
    assert rep["jax"]["compile"]["nvcc_build_n"] == 2
    assert "nvcc_build         n=    2" in report.build_table(rep)
    assert tracemon.compile_stats()["nvcc_build_n"] >= 2
