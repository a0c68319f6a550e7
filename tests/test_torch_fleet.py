"""repro_torch's fleet loop against repro's on the CPU: the analytical
backend's prices, ``simulate``'s SimResult bit for bit (static policies
and an a2c loaded from a reference artifact, on paper-exact,
paper-mmpp-burst and the reduced tpu-execute world, both host engines),
the execute backend's bytes at the cut, the scenarios, trainable-policy
artifacts in both directions, the CLI, and the options that are not
ported yet. Inputs come from numpy seeds."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core as R  # noqa: E402
from repro.checkpointing import save_tree as jax_save_tree  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import init as ref_init  # noqa: E402
from repro.policies import A2CPolicy as RefA2CPolicy  # noqa: E402
from repro.policies import build_policy as ref_build_policy  # noqa: E402
from repro.scenarios import get_scenario as ref_get_scenario  # noqa: E402
from repro.scenarios import run_scenario as ref_run_scenario  # noqa: E402
from repro.scenarios import scenario_names as ref_scenario_names  # noqa: E402
from repro.sim import ExecuteBackend as RefExecuteBackend  # noqa: E402
from repro.sim import FleetConfig as RefFleetConfig  # noqa: E402
from repro.sim import megafleet as ref_megafleet  # noqa: E402
from repro.sim import simulate as ref_simulate  # noqa: E402
from repro.sim.backends import AnalyticalBackend as RefAnalyticalBackend  # noqa: E402

import repro_torch.core as T  # noqa: E402
from repro_torch.checkpointing import load_tree  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import simulate as cli  # noqa: E402
from repro_torch.models import init, load_jax_params  # noqa: E402
from repro_torch.policies import A2CPolicy, build_policy, policy_names  # noqa: E402
from repro_torch.scenarios import (get_scenario, run_scenario,  # noqa: E402
                                   scenario_names, split_policy_name)
from repro_torch.serving import SplitServingEngine  # noqa: E402
from repro_torch.sim import (AnalyticalBackend, ExecuteBackend,  # noqa: E402
                             FleetConfig, megafleet, simulate)

# the engines held bit for bit against the reference (the scan engine
# draws its noise from torch: tests/test_torch_megafleet_scan.py)
HOST_ENGINES = ("loop", "vectorized")
SCENARIOS = ("paper-exact", "paper-mmpp-burst", "tpu-execute")
POLICIES = ("device_only", "full_offload", "greedy_oracle", "a2c")


def assert_same_result(a, b):
    """Two SimResults (reference, port) bit for bit: summary, selection
    histogram, every epoch-log column and the per-request arrays."""
    assert b.summary == a.summary
    assert b.selection_hist.dtype == np.int64
    np.testing.assert_array_equal(b.selection_hist, a.selection_hist)
    assert (b.epochs, b.served, b.duration_s) == (a.epochs, a.served, a.duration_s)
    ca, cb = a.epoch_log.columns, b.epoch_log.columns
    assert set(cb) == set(ca)
    for k in ca:
        assert cb[k].dtype == ca[k].dtype, k
        np.testing.assert_array_equal(cb[k], ca[k], err_msg=k)
    for attr in ("latencies_s", "energies_j", "devices"):
        np.testing.assert_array_equal(getattr(b.metrics, attr), getattr(a.metrics, attr),
                                      err_msg=attr)


@dataclasses.dataclass
class World:
    """One scenario's world in both packages, with their policies: the
    static ones by name, and an a2c that the reference trained briefly and
    saved, loaded into the port from that artifact."""
    sc: object
    ref_env: tuple
    env: tuple
    model_ids: np.ndarray
    ref_policies: dict
    policies: dict


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    cache = {}

    def get(name):
        if name not in cache:
            ref_sc, sc = ref_get_scenario(name), get_scenario(name)
            ref_cfg, ref_tables, ref_mids, _ = ref_sc.build_env()
            cfg, tables, mids, _ = sc.build_env(device="cpu")
            np.testing.assert_array_equal(mids, ref_mids)
            ref_pols = {p: ref_build_policy(p, ref_cfg, ref_tables) for p in POLICIES[:3]}
            pols = {p: build_policy(p, cfg, tables) for p in POLICIES[:3]}
            ref_a2c = ref_build_policy("a2c", ref_cfg, ref_tables, episodes=10,
                                       entropy_coef=ref_sc.entropy_coef, batch_envs=2)
            ref_a2c.train(seed=0, trace=ref_sc.build_train_trace())
            path = ref_a2c.save(str(tmp_path_factory.mktemp("a2c") / f"{name}.npz"))
            ref_pols["a2c"] = ref_a2c
            pols["a2c"] = build_policy("a2c", cfg, tables).load(path)
            cache[name] = World(sc, (ref_cfg, ref_tables), (cfg, tables), mids,
                                ref_pols, pols)
        return cache[name]

    return get


def _simulate_both(w, policy, engine, seed=None, n_requests=None):
    seed = w.sc.seeds[0] if seed is None else seed
    kw = dict(n_requests=n_requests or w.sc.n_requests, seed=seed, model_ids=w.model_ids)
    a = ref_simulate(*w.ref_env, w.ref_policies[policy], ref_get_scenario(w.sc.name)
                     .build_trace(), fleet=RefFleetConfig(slo_s=w.sc.slo_s, engine=engine),
                     **kw)
    b = simulate(*w.env, w.policies[policy], w.sc.build_trace(),
                 fleet=FleetConfig(slo_s=w.sc.slo_s, engine=engine), **kw)
    return a, b


# --------------------------------------------------------------------------
# the analytical backend, the Lindley core, measured states
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["paper", "tpu"])
def test_analytical_backend_prices_as_the_reference(kind):
    """Every PricingBreakdown field of ``AnalyticalBackend.price`` equal
    to the reference's, dtype and value, for int64 (port) and int32
    (reference) actions."""
    if kind == "paper":
        ref_cfg, ref_tables = R.make_paper_env(n_uavs=16, peak_rps=30.0)
        cfg, tables = T.make_paper_env(n_uavs=16, peak_rps=30.0, device="cpu")
    else:
        ref_cfg, ref_tables = R.make_tpu_env(["qwen2-0.5b"] * 16, reduced=True, seq_len=32)
        cfg, tables = T.make_tpu_env(["qwen2-0.5b"] * 16, reduced=True, seq_len=32,
                                     device="cpu")
    ref, port = RefAnalyticalBackend(ref_cfg, ref_tables), AnalyticalBackend(cfg, tables)
    r = np.random.default_rng(0)
    lp, pw = cfg.latency, cfg.power
    for _ in range(4):
        mids = r.integers(0, tables.n_models, 16).astype(np.int32)
        acts = np.stack([r.integers(0, tables.n_versions, 16),
                         r.integers(0, tables.n_cuts, 16)], -1)
        bw = r.uniform(lp.bw_min_bps, lp.bw_max_bps, 16)
        p_tx = r.uniform(pw.p_tx_min, pw.p_tx_max, 16)
        x = ref.price(mids, acts.astype(np.int32), bw, p_tx)
        y = port.price(mids, acts, bw, p_tx)
        for f in dataclasses.fields(x):
            a, b = np.asarray(getattr(x, f.name)), np.asarray(getattr(y, f.name))
            assert b.dtype == a.dtype, f.name
            np.testing.assert_array_equal(b, a, err_msg=f.name)
    assert port.cross_check() is None and port.maybe_execute(0, 0, 0) is None


def test_lindley_core_equals_the_reference():
    r = np.random.default_rng(2)
    counts = np.array([0, 3, 7, 1, 12])
    u = r.uniform(0.0, 10.0, counts.sum())
    offs, valid = megafleet.padded_offsets(counts, u, 10.0)
    ref_offs, ref_valid = ref_megafleet.padded_offsets(counts, u, 10.0)
    np.testing.assert_array_equal(offs, ref_offs)
    np.testing.assert_array_equal(valid, ref_valid)
    args = (offs + 50.0, r.uniform(40.0, 70.0, 5), r.uniform(0.1, 2.0, 5),
            r.uniform(0.0, 1.0, 5), np.array([True, False, True, True, False]), 0.37)
    for x, y in zip(ref_megafleet.lindley_core(np, *args), megafleet.lindley_core(*args)):
        np.testing.assert_array_equal(y, x)


@pytest.mark.parametrize("name", ["paper-mmpp-burst", "tpu-execute"])
def test_measured_state_observations_equal_the_reference(name, worlds):
    """The fleet's float64 measurements (battery, bandwidth, power,
    activity, load), its Python-float queue and int32 model ids, through
    ``measured_state`` and ``observe``: the same float32 observations."""
    w = worlds(name)
    (ref_cfg, ref_tables), (cfg, tables) = w.ref_env, w.env
    n, lp, pw = cfg.n_uavs, cfg.latency, cfg.power
    r = np.random.default_rng(5)
    for t in range(8):
        kw = dict(battery_j=r.uniform(0.0, pw.battery_j, n),
                  bandwidth=r.uniform(lp.bw_min_bps, lp.bw_max_bps, n),
                  p_tx=r.uniform(pw.p_tx_min, pw.p_tx_max, n),
                  queue_jobs=min(float(r.exponential(20.0)), 25.0),
                  load=np.clip(r.uniform(0.0, 40.0, n) / 30.0, 0.0, 1.0),
                  model_id=w.model_ids,
                  activity=r.dirichlet(np.ones(4), n)[:, :3], t=t)
        ref_s, s = R.measured_state(ref_cfg, ref_tables, **kw), T.measured_state(cfg, tables, **kw)
        assert s["queue"].dtype == torch.float32 and s["queue"].ndim == 0
        np.testing.assert_array_equal(T.observe(cfg, tables, s).numpy(),
                                      np.asarray(R.observe(ref_cfg, ref_tables, ref_s)))


# --------------------------------------------------------------------------
# simulate
# --------------------------------------------------------------------------

@pytest.mark.parametrize("engine", HOST_ENGINES)
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("name", SCENARIOS)
def test_simulate_equals_the_reference(name, policy, engine, worlds):
    """The preset's world, traffic and first seed (analytical pricing);
    the port also times each epoch's decide."""
    a, b = _simulate_both(worlds(name), policy, engine)
    assert a.epochs > 5
    assert_same_result(a, b)
    assert b.decide_s.shape == (b.epochs,) and np.all(b.decide_s > 0)


def test_vectorized_engine_equals_the_loop(worlds):
    """On paper-exact, where batteries die and requests drop, over two
    seeds."""
    w = worlds("paper-exact")
    for seed in (0, 3):
        res = [simulate(*w.env, w.policies["greedy_oracle"], w.sc.build_trace(),
                        n_requests=w.sc.n_requests, seed=seed, model_ids=w.model_ids,
                        fleet=FleetConfig(slo_s=w.sc.slo_s, engine=e)) for e in HOST_ENGINES]
        assert res[0].summary["dropped"] > 0
        assert_same_result(*res)


def test_request_stream_is_policy_independent(worlds):
    """Same seed => identical arrivals whatever the policy, so policy
    comparisons are paired."""
    w = worlds("paper-mmpp-burst")
    arrivals = [simulate(*w.env, w.policies[p], w.sc.build_trace(), n_requests=5000,
                         seed=5, model_ids=w.model_ids).epoch_log.column("arrivals")
                for p in POLICIES]
    for a in arrivals[1:]:
        np.testing.assert_array_equal(a, arrivals[0])


def test_policy_world_identity_is_checked(worlds):
    w = worlds("paper-mmpp-burst")
    other = T.make_paper_env(n_uavs=4, device="cpu")
    with pytest.raises(ValueError, match="different"):
        simulate(*other, w.policies["device_only"], w.sc.build_trace(), n_requests=100)


# --------------------------------------------------------------------------
# the execute backend and the scenarios
# --------------------------------------------------------------------------

def test_execute_backend_act_bytes_parity(tmp_path):
    """Every non-terminal (version, cut) of reduced qwen2-0.5b at S = 8,
    over the reference's weights carried across as .npz: the measured
    bytes at the cut equal the table's (plus w8's row scales), and the
    expected bytes equal the reference backend's."""
    arch, S = "qwen2-0.5b", 8
    ref_env = R.make_tpu_env([arch], reduced=True, seq_len=S)
    env_cfg, tables = T.make_tpu_env([arch], reduced=True, seq_len=S, device="cpu")
    ref_cfg, cfg = ref_get_config(arch).reduced(), get_config(arch).reduced()
    ref_prof, prof = R.transformer_profile(ref_cfg, seq_len=S), T.transformer_profile(cfg, seq_len=S)
    params = ref_init(ref_cfg, jax.random.key(0))
    path = jax_save_tree(str(tmp_path / "qwen.npz"), params)
    model = load_jax_params(cfg, load_tree(path)[0], device="cpu")
    ref_be = RefExecuteBackend(*ref_env, [ref_cfg], [ref_prof], [params], seq_len=S, sample=64)
    versions = tuple(v.version for v in prof.versions)
    eng = SplitServingEngine(cfg, model, versions, device="cpu")
    be = ExecuteBackend(env_cfg, tables, [cfg], [prof], [eng], seq_len=S, sample=64)
    assert be._batches[0]["tokens"].dtype == torch.int64
    np.testing.assert_array_equal(be._batches[0]["tokens"].numpy(),
                                  np.asarray(ref_be._batches[0]["tokens"]))
    nonterminal = 0
    for j in range(tables.n_versions):
        for k in range(tables.n_cuts):
            assert be.expected_act_bytes(0, j, k) == ref_be.expected_act_bytes(0, j, k)
            be.maybe_execute(0, j, k)
            v = prof.versions[min(j, len(prof.versions) - 1)]
            nonterminal += v.cut_points[min(k, len(v.cut_points) - 1)] < v.n_layers
    cc = be.cross_check()
    assert cc["samples"] == nonterminal > 0
    assert cc["bytes_exact"] and cc["bytes_mismatches"] == 0, cc["records"]
    assert {r["version"] for r in cc["records"]} == {"bf16", "w8", "w4"}
    assert all(r["logits_finite"] for r in cc["records"])
    assert np.isfinite(cc["latency_ratio_median"]) and np.isfinite(cc["latency_ratio_max"])
    # the passed engine serves every sample, each version's model built once
    assert be._engines[0] is eng and set(eng._vmodels) == set(versions)
    # an engine lacking a version the profile prices refuses to serve it
    narrow = ExecuteBackend(env_cfg, tables, [cfg], [prof],
                            [SplitServingEngine(cfg, model, ("bf16",), device="cpu")],
                            seq_len=S)
    with pytest.raises(KeyError, match="not enabled"):
        narrow.maybe_execute(0, versions.index("w8"), 0)


def test_run_scenario_tpu_execute_matches_the_reference():
    """The preset as the reference runs it (reduced qwen2-0.5b, 2,000
    requests, greedy_oracle): the same summary, and the cross-check
    executes the same (version, cut) samples with every byte count
    exact."""
    ref = ref_run_scenario(ref_get_scenario("tpu-execute"))
    port = run_scenario(get_scenario("tpu-execute"), device="cpu")
    assert list(port.results) == list(ref.results) == ["greedy_oracle"]
    x, y = ref.results["greedy_oracle"], port.results["greedy_oracle"]
    assert y.per_seed == x.per_seed and y.mean == x.mean
    cx, cy = x.cross_check, y.cross_check
    assert cy["bytes_exact"] and cx["bytes_exact"] and cy["samples"] == cx["samples"] > 0
    keys = ("version", "cut", "j", "k", "expected_bytes", "measured_bytes")
    assert [{k: r[k] for k in keys} for r in cy["records"]] \
        == [{k: r[k] for k in keys} for r in cx["records"]]
    out = port.to_json()
    assert "records" not in out["policies"]["greedy_oracle"]["cross_check"]
    json.dumps(out)
    assert port.table().splitlines()[1].startswith("greedy_oracle")


def test_scenario_presets_equal_the_reference():
    assert scenario_names() == ref_scenario_names()
    for name in scenario_names():
        a = dataclasses.asdict(ref_get_scenario(name))
        b = dataclasses.asdict(get_scenario(name))
        assert b == a, name


# --------------------------------------------------------------------------
# trainable policies
# --------------------------------------------------------------------------

SMALL = dict(hidden1=64, hidden2=32, uav_head=16)


def test_a2c_policy_trains_on_a_trace_and_its_artifact_loads_in_the_reference(tmp_path):
    """A port-trained a2c (trace-driven, through ``make_task_sampler``)
    saved by the port, loaded by the reference's ``A2CPolicy.load``: the
    reference decides the port's actions on 16 measured states."""
    ref_cfg, ref_tables = R.make_paper_env(n_uavs=3, peak_rps=30.0)
    cfg, tables = T.make_paper_env(n_uavs=3, peak_rps=30.0, device="cpu")
    pol = A2CPolicy(cfg, tables, episodes=3, batch_envs=2, **SMALL)
    with pytest.raises(RuntimeError, match="train"):
        pol.act({})
    hist = pol.train(seed=1, trace=get_scenario("paper-mmpp-burst").build_train_trace())
    assert len(hist) == 3 and np.isfinite([h["loss"] for h in hist]).all()
    path = pol.save(str(tmp_path / "port.npz"))
    assert load_tree(path)[1] == {"schema": 1, "policy": "a2c"}
    ref = RefA2CPolicy(ref_cfg, ref_tables, **SMALL).load(path)
    ref_act = jax.jit(ref.act)
    r = np.random.default_rng(3)
    lp, pw = cfg.latency, cfg.power
    for _ in range(16):
        kw = dict(battery_j=r.uniform(0.0, pw.battery_j, 3),
                  bandwidth=r.uniform(lp.bw_min_bps, lp.bw_max_bps, 3),
                  p_tx=r.uniform(pw.p_tx_min, pw.p_tx_max, 3),
                  queue_jobs=float(r.uniform(0.0, 25.0)), load=r.uniform(0.0, 1.0, 3))
        np.testing.assert_array_equal(
            pol.act(T.measured_state(cfg, tables, **kw)).numpy(),
            np.asarray(ref_act(R.measured_state(ref_cfg, ref_tables, **kw))))
    # a port artifact round-trips into the port, and a name mismatch raises
    again = A2CPolicy(cfg, tables, **SMALL).load(path)
    for k, v in again.params.flat_params().items():
        assert torch.equal(v, pol.params.flat_params()[k])
    from repro_torch.checkpointing import save_tree
    bad = save_tree(str(tmp_path / "ppo.npz"), load_tree(path)[0],
                    meta={"schema": 1, "policy": "ppo"})
    with pytest.raises(ValueError, match="ppo"):
        A2CPolicy(cfg, tables, **SMALL).load(bad)
    with pytest.raises(ValueError, match="shape"):
        A2CPolicy(*T.make_paper_env(n_uavs=4, device="cpu"), **SMALL).load(path)


def test_a2c_policy_exploration_mixes_sampled_and_greedy_actions():
    cfg, tables = T.make_paper_env(n_uavs=64, device="cpu")
    pol = A2CPolicy(cfg, tables, episodes=1, **SMALL)
    pol.train(seed=0)
    state = T.env_reset(cfg, tables, torch.Generator().manual_seed(0))
    greedy = pol.act(state, torch.Generator().manual_seed(1))
    np.testing.assert_array_equal(greedy.numpy(), T.decide(pol.params, cfg, tables, state).numpy())
    pol.set_explore(1.0)
    sampled = pol.act(state, torch.Generator().manual_seed(1))
    nv = tables.version_valid[state["model_id"]].sum(-1)
    assert bool((sampled[:, 0] < nv).all()) and not torch.equal(sampled, greedy)
    pol.set_explore(0.5)
    mixed = [pol.act(state, torch.Generator().manual_seed(s)) for s in (2, 2, 3)]
    assert torch.equal(mixed[0], mixed[1])      # one generator seed, one draw
    rows_greedy = (mixed[0] == greedy).all(-1)
    assert 0 < int(rows_greedy.sum()) < 64
    assert torch.equal(pol.act(state, None), greedy)   # no generator: greedy
    pol.set_explore(0.0).set_params(pol.params)
    assert torch.equal(pol.act(state, torch.Generator()), greedy)


def test_policy_roster():
    from repro.policies import policy_names as ref_policy_names
    assert policy_names() == ref_policy_names() == (
        "a2c", "device_only", "full_offload", "greedy_oracle", "join_shortest_queue",
        "local_only", "ppo", "random", "round_robin")


# --------------------------------------------------------------------------
# what is not ported yet, the device rule, the CLI
# --------------------------------------------------------------------------

def test_unported_options_raise(worlds, tmp_path):
    """What stays refused: an unknown engine, the scan engine over a
    cluster (the reference refuses it too, in these words) and the CLI's
    ad-hoc-scenario flags; the vlm execute backend, refused until the
    cross-attention families were ported, now builds its zero-media batch. The scan engine
    and the flight recorder are ported (tests/test_torch_megafleet_scan.py,
    tests/test_torch_timeline.py)."""
    w = worlds("paper-mmpp-burst")
    pol, trace = w.policies["device_only"], w.sc.build_trace()
    res = simulate(*w.env, pol, trace, n_requests=100, fleet=FleetConfig(timeline=True))
    assert res.timeline is not None and len(res.timeline) == res.epochs
    with pytest.raises(ValueError, match="unknown fleet engine"):
        simulate(*w.env, pol, trace, n_requests=100, fleet=FleetConfig(engine="warp"))
    with pytest.raises(ValueError, match="cluster-mode env"):
        simulate(*w.env, pol, trace, n_requests=100, autoscaler=object())
    from repro_torch.cluster import build_cluster, get_pool
    from repro.cluster import get_topology
    cl = T.make_paper_env(n_uavs=4, device="cpu",
                          cluster=build_cluster(get_pool("hetero-4"), get_topology("near-far", 4, 4)))
    with pytest.raises(ValueError, match="cluster pools keep per-server state"):
        simulate(*cl, build_policy("device_only", *cl), trace, n_requests=100,
                 fleet=FleetConfig(engine="scan"))
    sc = get_scenario("tpu-submesh")
    rep = run_scenario(sc, ("device_only",), device="cpu", n_requests=400, timeline=True)
    assert len(rep.results["device_only"].timelines) == len(sc.seeds)
    assert split_policy_name("a2c+online") == ("a2c", True)
    with pytest.raises(ValueError, match="without a server pool"):
        sc.replace(autoscale="hysteresis").build_autoscaler()
    assert sc.build_schedule() is None and sc.build_cluster() is None \
        and sc.build_autoscaler() is None
    env_cfg, tables = T.make_tpu_env(["qwen2-0.5b"], reduced=True, seq_len=8, device="cpu")
    vlm = dataclasses.replace(get_config("qwen2-0.5b").reduced(), cross_attn_every=2)
    small = get_config("qwen2-0.5b").reduced()
    # the vlm execute backend is no longer refused: it feeds zero media
    # beside the tokens, as the reference's does
    vlm = dataclasses.replace(vlm, family="vlm")
    backend = ExecuteBackend(env_cfg, tables, [vlm], [T.transformer_profile(small, seq_len=8)],
                             [SplitServingEngine(vlm, init(small, torch.Generator().manual_seed(0),
                                                           device="cpu"), device="cpu")],
                             seq_len=8)
    batch = backend._batches[0]
    assert sorted(batch) == ["media", "tokens"] and tuple(batch["tokens"].shape) == (1, 8)
    assert tuple(batch["media"].shape) == (1, vlm.n_media_tokens, vlm.d_model)
    assert not batch["media"].any()
    # the reference's own refusals: a rate flag its trace does not take,
    # replay without a file
    for flag, words in ((["--rate-low", "3"], "not applicable to trace 'poisson'"),
                        (["--trace", "replay"], "needs --replay-file")):
        with pytest.raises(SystemExit, match=words):
            cli.main(["--scenario", "tpu-submesh", "--device", "cpu", *flag])
    # no --scenario: the ad-hoc scenario of the reference's defaults (A2C
    # trained for 300 episodes, 100,000 requests), on one torch thread so
    # that it does not spin against the other test workers
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        report = cli.main(["--device", "cpu", "--quiet"])
    finally:
        torch.set_num_threads(threads)
    assert report.scenario == "custom" and list(report.results) == ["a2c"]
    assert report.results["a2c"].mean["count"] > 0
    with pytest.raises(SystemExit):
        cli.main(["--scenario", "tpu-submesh", "--engine", "warp"])


def test_fleet_entry_points_raise_without_cuda_unless_cpu_is_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc = get_scenario("tpu-submesh")
    for call in (sc.build_env, lambda: run_scenario(sc, n_requests=100),
                 lambda: cli.main(["--scenario", "tpu-submesh", "--quiet"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    env_cfg, tables, _, factory = sc.build_env(device="cpu")
    assert tables.device == torch.device("cpu") and isinstance(factory(), AnalyticalBackend)
    ex = get_scenario("tpu-execute").build_env(device="cpu")[3]()
    assert isinstance(ex, ExecuteBackend) and ex._engines[0].device == torch.device("cpu")


def test_cli_runs_tpu_submesh_on_the_cpu(tmp_path, capsys):
    """``--scenario tpu-submesh --device cpu``: the preset's roster over
    its two seeds, the reference's numbers, the table and the JSON."""
    out = tmp_path / "r.json"
    report = cli.main(["--scenario", "tpu-submesh", "--device", "cpu", "--requests", "4000",
                       "--engine", "vectorized", "--json", str(out)])
    text = capsys.readouterr().out
    assert "greedy_oracle" in text and "full_offload" in text and "wrote" in text
    ref = ref_run_scenario(ref_get_scenario("tpu-submesh"), n_requests=4000)
    for name, r in ref.results.items():
        assert report.results[name].per_seed == r.per_seed, name
    saved = json.loads(out.read_text())
    assert saved["seeds"] == [0, 1] and saved["config"]["engine"] == "vectorized"
    assert set(saved["policies"]) == {"greedy_oracle", "device_only", "full_offload"}
    cli.main(["--list-scenarios", "--quiet"])


def test_cli_saves_and_loads_a_policy(tmp_path):
    """--save-policy, then --load-policy: the loaded run repeats the
    trained run's numbers without training."""
    path = str(tmp_path / "a2c.npz")
    base = ["--scenario", "tpu-submesh", "--device", "cpu", "--requests", "1000",
            "--seeds", "3", "--compare", "a2c,device_only", "--episodes", "2", "--quiet"]
    trained = cli.main(base + ["--save-policy", path])
    loaded = cli.main(base + ["--load-policy", path])
    assert trained.results["a2c"].trained and loaded.results["a2c"].loaded_from == path
    assert loaded.results["a2c"].per_seed == trained.results["a2c"].per_seed
    with pytest.raises(SystemExit):
        cli.main(base[:-5] + ["--compare", "device_only", "--save-policy", path])
