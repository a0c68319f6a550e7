"""repro_torch.cluster and the fleet loop's cluster branch against
repro's on the CPU: the registries, topologies, ``ServerPool`` and the
``Autoscaler`` on the same tick and queue sequences, the routers'
actions on measured states, the degenerate 1-server pool against the
classic fleet, ``simulate`` over the edge-cluster and (shortened)
cluster-brownout worlds bit for bit (routers, device_only and an A2C the
reference trained, both engines, ``server_hist`` and the pool's summary
included), the online loop over a pool from that artifact, the server
axis of pricing, env and agent, the scenarios and the CLI. Each test of
``tests/test_cluster.py`` has its counterpart here. Inputs come from
numpy seeds."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
from repro import cluster as ref_cluster  # noqa: E402
from repro.core.latency import LatencyParams as RefLatencyParams  # noqa: E402
from repro.online import OnlineConfig as RefOnlineConfig  # noqa: E402
from repro.online import get_schedule as ref_get_schedule  # noqa: E402
from repro.policies import build_policy as ref_build_policy  # noqa: E402
from repro.scenarios import get_scenario as ref_get_scenario  # noqa: E402
from repro.scenarios import run_scenario as ref_run_scenario  # noqa: E402
from repro.sim import FleetConfig as RefFleetConfig  # noqa: E402
from repro.sim import simulate as ref_simulate  # noqa: E402

import repro_torch.core as T  # noqa: E402
from repro_torch.cluster import (Autoscaler, AutoscalerConfig, ServerPool,  # noqa: E402
                                 ServerSpec, build_cluster, get_pool, get_topology,
                                 pool_names, topology_names)
from repro_torch.core import pricing  # noqa: E402
from repro_torch.core.actor_critic import greedy_actions, sample_actions  # noqa: E402
from repro_torch.core.env import OBS_FEATURES, observe  # noqa: E402
from repro_torch.core.latency import LatencyParams  # noqa: E402
from repro_torch.launch import simulate as cli  # noqa: E402
from repro_torch.online import OnlineConfig, get_schedule  # noqa: E402
from repro_torch.policies import build_policy, get_policy_spec, policy_names  # noqa: E402
from repro_torch.scenarios import get_scenario  # noqa: E402
from repro_torch.sim import AnalyticalBackend, FleetConfig, get_trace, simulate  # noqa: E402

# the engines held bit for bit against the reference (the scan engine
# draws its noise from torch: tests/test_torch_megafleet_scan.py)
HOST_ENGINES = ("loop", "vectorized")
ROUTERS = ("round_robin", "join_shortest_queue", "local_only")
# cluster-brownout with its flash crowd inside 10,000 requests (~640 a
# epoch): the preset's onset 50 and relax 220 moved to 5 and 10
BROWNOUT_KW = {"onset": 5, "relax": 10, "scale": 1.75, "queue_scale": 6.0}
WORLDS = {"edge-cluster": dict(n_requests=4000),
          "cluster-brownout": dict(n_requests=10_000, drift_kw=BROWNOUT_KW)}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the port's ops here are small, and one thread
    does not spin against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cluster(pool="single", topology="uniform", devices=4):
    servers = get_pool(pool)
    return build_cluster(servers, get_topology(topology, devices, len(servers)))


def _cluster_env(pool="hetero-4", topology="near-far", devices=4, **kw):
    return T.make_paper_env(
        n_uavs=devices,
        latency=LatencyParams(server_flops=devices * 0.55e12, bw_max_bps=1e9),
        slot_seconds=10.0, peak_rps=30.0, frames_per_slot=300.0,
        cluster=_cluster(pool, topology, devices), device="cpu", **kw)


def assert_same_result(a, b):
    """Two SimResults (reference, port) bit for bit: summary (the pool's
    keys included), histograms, epoch log, per-request arrays and
    ``adaptation``."""
    assert b.summary == a.summary
    np.testing.assert_array_equal(b.selection_hist, a.selection_hist)
    if a.server_hist is None:
        assert b.server_hist is None
    else:
        assert b.server_hist.dtype == np.int64
        np.testing.assert_array_equal(b.server_hist, a.server_hist)
    assert (b.epochs, b.served, b.duration_s) == (a.epochs, a.served, a.duration_s)
    ca, cb = a.epoch_log.columns, b.epoch_log.columns
    assert set(cb) == set(ca)
    for k in ca:
        np.testing.assert_array_equal(cb[k], ca[k], err_msg=k)
    for attr in ("latencies_s", "energies_j", "devices"):
        np.testing.assert_array_equal(getattr(b.metrics, attr), getattr(a.metrics, attr),
                                      err_msg=attr)
    assert b.adaptation == a.adaptation


# --------------------------------------------------------------------------
# registries: the KeyError-listing convention
# --------------------------------------------------------------------------

def test_pool_registry_miss_lists_valid_names():
    assert pool_names() == ref_cluster.pool_names()
    with pytest.raises(KeyError) as e:
        get_pool("no-such-pool")
    for name in pool_names():
        assert name in str(e.value)


def test_topology_registry_miss_lists_valid_names():
    assert topology_names() == ref_cluster.topology_names() == ("near-far", "tiered",
                                                                "uniform")
    with pytest.raises(KeyError) as e:
        get_topology("no-such-topology", 4, 2)
    for name in topology_names():
        assert name in str(e.value)


@pytest.mark.parametrize("n,S", [(1, 1), (4, 4), (8, 4), (5, 3)])
@pytest.mark.parametrize("name", ["uniform", "near-far", "tiered"])
def test_topologies_equal_the_reference(name, n, S):
    a, b = ref_cluster.get_topology(name, n, S), get_topology(name, n, S)
    assert dataclasses.asdict(b) == dataclasses.asdict(a)
    assert (b.n_devices, b.n_servers) == (n, S)


def test_build_cluster_rejects_server_count_mismatch():
    servers = get_pool("hetero-4")
    with pytest.raises(ValueError, match="4 servers"):
        build_cluster(servers[:2], get_topology("uniform", 4, 4))


def test_routers_registered_as_policies():
    assert {"round_robin", "join_shortest_queue", "local_only"} <= set(policy_names())
    for name in ROUTERS:
        spec = get_policy_spec(name)
        assert spec.needs_cluster and not spec.trainable


def test_router_rejects_non_cluster_env():
    env_cfg, tables = T.make_paper_env(device="cpu")
    for name in ROUTERS:
        with pytest.raises(ValueError, match="cluster-mode env"):
            get_policy_spec(name).build(env_cfg, tables)


# --------------------------------------------------------------------------
# pool / autoscaler units
# --------------------------------------------------------------------------

def test_pool_effective_matches_nominal_at_initial_state():
    cluster = _cluster("hetero-4", "near-far")
    env_cfg, _ = _cluster_env()
    pool = ServerPool(cluster)
    eff = pool.effective(env_cfg.latency, env_cfg)
    flops, service = cluster.nominal(env_cfg.latency, xp=np)
    np.testing.assert_array_equal(eff.flops, flops)
    np.testing.assert_array_equal(eff.service_s, service)


def test_pool_meters_replica_energy_cubed_in_dvfs():
    spec = ServerSpec(dvfs=(0.5, 1.0), p_replica_w=40.0, replicas=2, max_replicas=2)
    cluster = build_cluster((spec,), get_topology("uniform", 1, 1))
    pool = ServerPool(cluster)
    pool.tick(np.zeros(1), slot_seconds=10.0)   # 2 replicas at dvfs 1.0
    assert pool.energy_j == pytest.approx(40.0 * 2 * 1.0 ** 3 * 10.0)
    pool.dvfs_idx[:] = 0                        # walk down the ladder
    pool.tick(np.zeros(1), slot_seconds=10.0)
    assert pool.energy_j == pytest.approx(40.0 * 2 * 10.0 + 40.0 * 2 * 0.5 ** 3 * 10.0)
    assert pool.summary()["mean_replicas"] == 2.0


def _queue_sequence(seed, S, epochs=60):
    """Measured per-server depths that cross both thresholds: calm,
    bursts and recoveries."""
    r = np.random.default_rng(seed)
    level = np.repeat(r.choice([0.5, 5.0, 20.0], size=(epochs // 6, 1, S)), 6, axis=0)
    return (level.reshape(-1, S) * r.uniform(0.5, 1.5, (epochs // 6 * 6, S)))


@pytest.mark.parametrize("pool", ["uniform-4", "hetero-4"])
@pytest.mark.parametrize("policy", ["threshold", "hysteresis"])
def test_pool_and_autoscaler_equal_the_reference_on_queue_sequences(policy, pool):
    """``ServerPool.tick`` (and the autoscaler it owns) driven by the same
    seeded queue sequence in both packages: identical decision lists,
    replicas, DVFS steps, snapshots and energy every epoch, and
    ``effective`` under the paper env's physics at each state."""
    ref_c = ref_cluster.build_cluster(ref_cluster.get_pool(pool),
                                      ref_cluster.get_topology("near-far", 4, 4))
    c = _cluster(pool, "near-far")
    env_cfg, _ = _cluster_env(pool=pool)
    ref_env, _ = R.make_paper_env(
        n_uavs=4, latency=RefLatencyParams(server_flops=4 * 0.55e12, bw_max_bps=1e9),
        slot_seconds=10.0, peak_rps=30.0, frames_per_slot=300.0, cluster=ref_c)
    cfg = ref_cluster.AutoscalerConfig(policy=policy, patience=2, cooldown=3)
    a = ref_cluster.ServerPool(ref_c, cfg)
    b = ServerPool(c, AutoscalerConfig(policy=policy, patience=2, cooldown=3))
    moved = 0
    for q in _queue_sequence(7, 4):
        ea, eb = a.effective(ref_env.latency, ref_env), b.effective(env_cfg.latency, env_cfg)
        for f in dataclasses.fields(eb):
            np.testing.assert_array_equal(getattr(eb, f.name), getattr(ea, f.name))
        a.tick(q, 10.0)
        b.tick(q, 10.0)
        assert b.last_decisions == a.last_decisions
        moved += len(b.last_decisions)
        for attr in ("replicas", "dvfs_idx", "last_dvfs", "last_replicas", "last_power_w"):
            np.testing.assert_array_equal(getattr(b, attr), getattr(a, attr), err_msg=attr)
        assert b.energy_j == a.energy_j
    assert moved > 0 and b.summary() == a.summary()
    # the autoscaler alone, on its own pools: the same decisions
    pa, pb = ref_cluster.ServerPool(ref_c), ServerPool(c)
    sa, sb = ref_cluster.Autoscaler(cfg, 4), Autoscaler(AutoscalerConfig(
        policy=policy, patience=2, cooldown=3), 4)
    for q in _queue_sequence(8, 4):
        assert sb.step(pb, q) == sa.step(pa, q)
        np.testing.assert_array_equal(pb.replicas, pa.replicas)
        np.testing.assert_array_equal(pb.dvfs_idx, pa.dvfs_idx)


def test_autoscaler_threshold_scales_dvfs_first_then_replicas():
    spec = ServerSpec(dvfs=(0.6, 1.0), max_replicas=2, p_replica_w=45.0)
    cluster = build_cluster((spec,), get_topology("uniform", 1, 1))
    pool = ServerPool(cluster)
    pool.dvfs_idx[:] = 0    # start below the top DVFS step
    asc = Autoscaler(AutoscalerConfig(policy="threshold"), 1)
    deep = np.asarray([50.0])
    decisions = asc.step(pool, deep)
    assert [d["action"] for d in decisions] == ["dvfs_up"]
    assert decisions[0]["queue"] == 50.0    # measured-depth trigger
    assert pool.dvfs_idx[0] == 1 and pool.replicas[0] == 1   # DVFS first
    assert [d["action"] for d in asc.step(pool, deep)] == ["replica_up"]
    assert pool.replicas[0] == 2                             # then replica
    assert asc.step(pool, deep) == []                        # at capacity


def test_autoscaler_threshold_scales_down_replicas_first():
    spec = ServerSpec(dvfs=(0.6, 1.0), replicas=2, max_replicas=2)
    cluster = build_cluster((spec,), get_topology("uniform", 1, 1))
    pool = ServerPool(cluster)
    asc = Autoscaler(AutoscalerConfig(policy="threshold"), 1)
    idle = np.asarray([0.0])
    assert [d["action"] for d in asc.step(pool, idle)] == ["replica_down"]
    assert pool.replicas[0] == 1 and pool.dvfs_idx[0] == 1   # replica first
    assert [d["action"] for d in asc.step(pool, idle)] == ["dvfs_down"]
    assert pool.dvfs_idx[0] == 0                             # then DVFS
    assert asc.step(pool, idle) == []                        # at the floor


def test_autoscaler_hysteresis_waits_for_patience_then_cools_down():
    spec = ServerSpec(dvfs=(0.6, 1.0), max_replicas=2)
    cluster = build_cluster((spec,), get_topology("uniform", 1, 1))
    pool = ServerPool(cluster)
    pool.dvfs_idx[:] = 0
    asc = Autoscaler(AutoscalerConfig(policy="hysteresis", patience=3, cooldown=2), 1)
    deep = np.asarray([50.0])
    assert asc.step(pool, deep) == []     # breach 1
    assert asc.step(pool, deep) == []     # breach 2
    assert len(asc.step(pool, deep)) == 1     # breach 3: acts
    assert pool.dvfs_idx[0] == 1
    assert asc.step(pool, deep) == []     # cooldown epoch 1
    assert asc.step(pool, deep) == []     # cooldown epoch 2
    # the breach never cleared: the streak rode through the hold, so the
    # first post-cooldown epoch escalates (replica, DVFS already topped)
    assert len(asc.step(pool, deep)) == 1
    assert pool.replicas[0] == 2
    asc.step(pool, np.asarray([0.0]))     # a calm epoch resets the streak
    assert pool.replicas[0] == 2


def test_autoscaler_config_validates():
    with pytest.raises(ValueError, match="valid policies"):
        AutoscalerConfig(policy="magic")
    with pytest.raises(ValueError, match="down_queue"):
        AutoscalerConfig(up_queue=2.0, down_queue=2.0)


# --------------------------------------------------------------------------
# a 1-server pool at uniform topology is the classic single-server fleet,
# bit for bit
# --------------------------------------------------------------------------

def _fleet_run(cluster, policy_name, engine, n_requests=2500, seed=0):
    kw = {"cluster": cluster} if cluster is not None else {}
    env_cfg, tables = T.make_paper_env(
        n_uavs=4, latency=LatencyParams(server_flops=4 * 0.55e12, bw_max_bps=1e9),
        slot_seconds=10.0, peak_rps=30.0, frames_per_slot=300.0, device="cpu", **kw)
    model_ids = np.arange(4, dtype=np.int32) % tables.n_models
    policy = get_policy_spec(policy_name).build(env_cfg, tables)
    trace = get_trace("mmpp", rate_low_rps=2.0, rate_high_rps=25.0)
    return simulate(env_cfg, tables, model_ids=model_ids, policy=policy, trace=trace,
                    n_requests=n_requests, seed=seed,
                    backend=AnalyticalBackend(env_cfg, tables),
                    fleet=FleetConfig(slo_s=2.0, engine=engine))


@pytest.mark.parametrize("engine", HOST_ENGINES)
@pytest.mark.parametrize("policy", ["greedy_oracle", "full_offload"])
def test_degenerate_pool_bit_identical_to_single_server(engine, policy):
    """The whole cluster path (per-server queues, topology repricing,
    pool-effective service arrays) collapses to the classic
    single-server fleet when the pool is one baseline server behind a
    uniform topology: per-request latencies and every shared summary
    metric bitwise equal, offloading policies included."""
    legacy = _fleet_run(None, policy, engine)
    degen = _fleet_run(_cluster("single", "uniform"), policy, engine)
    np.testing.assert_array_equal(legacy.metrics.latencies_s, degen.metrics.latencies_s)
    shared = set(legacy.summary) & set(degen.summary)
    assert shared == set(legacy.summary) >= {"mean", "p95", "slo_attainment", "energy_j"}
    for k in sorted(shared):
        assert legacy.summary[k] == degen.summary[k], k
    np.testing.assert_array_equal(legacy.selection_hist, degen.selection_hist)
    for k in ("queue_jobs", "backlog_s", "slo_hits"):
        np.testing.assert_array_equal(legacy.epoch_log.column(k), degen.epoch_log.column(k))
    # cluster-only meters ride along without perturbing the physics
    assert {"server_energy_j", "scale_events", "mean_replicas"} <= set(degen.summary)
    assert legacy.server_hist is None and int(degen.server_hist.sum()) == degen.served


def test_cluster_fleet_bit_reproducible_with_autoscaler():
    cluster = _cluster("hetero-4", "near-far")
    runs = []
    for _ in range(2):
        env_cfg, tables = _cluster_env()
        model_ids = np.arange(4, dtype=np.int32) % tables.n_models
        policy = get_policy_spec("join_shortest_queue").build(env_cfg, tables)
        runs.append(simulate(env_cfg, tables, model_ids=model_ids, policy=policy,
                             trace=get_trace("poisson", rate_rps=8.0), n_requests=2000,
                             seed=0, backend=AnalyticalBackend(env_cfg, tables),
                             fleet=FleetConfig(slo_s=2.0),
                             autoscaler=AutoscalerConfig(policy="hysteresis")))
    a, b = runs
    assert a.summary == b.summary
    np.testing.assert_array_equal(a.metrics.latencies_s, b.metrics.latencies_s)
    assert a.server_hist is not None
    assert a.server_hist.shape == (cluster.n_servers,)
    assert a.server_hist.sum() > 0


def test_scan_engine_rejects_cluster_mode():
    """The scan engine refuses cluster mode with the reference's
    ValueError; the flight recorder runs over a pool (its per-server
    series: tests/test_torch_timeline.py)."""
    env_cfg, tables = _cluster_env()
    model_ids = np.arange(4, dtype=np.int32) % tables.n_models
    policy = get_policy_spec("device_only").build(env_cfg, tables)
    with pytest.raises(ValueError, match="cluster pools keep per-server state on the host"):
        simulate(env_cfg, tables, model_ids=model_ids, policy=policy,
                 trace=get_trace("poisson", rate_rps=8.0), n_requests=500, seed=0,
                 backend=AnalyticalBackend(env_cfg, tables), fleet=FleetConfig(engine="scan"))
    res = simulate(env_cfg, tables, model_ids=model_ids, policy=policy,
                   trace=get_trace("poisson", rate_rps=8.0), n_requests=500,
                   fleet=FleetConfig(timeline=True))
    assert res.timeline.n_servers == env_cfg.n_servers
    assert res.timeline.column("srv_queue").shape == (len(res.timeline), env_cfg.n_servers)


def test_autoscaler_without_cluster_and_topology_mismatch_raise():
    env_cfg, tables = T.make_paper_env(n_uavs=4, device="cpu")
    policy = build_policy("device_only", env_cfg, tables)
    with pytest.raises(ValueError, match="autoscaler needs a cluster-mode env"):
        simulate(env_cfg, tables, policy, get_trace("poisson", rate_rps=8.0),
                 n_requests=100, autoscaler=AutoscalerConfig())
    # a topology built for 3 devices over a 4-device fleet
    env_cfg, tables = T.make_paper_env(n_uavs=4, device="cpu",
                                       cluster=_cluster("hetero-4", "near-far", devices=3))
    policy = build_policy("device_only", env_cfg, tables)
    with pytest.raises(ValueError, match=r"\(3, 4\) \(devices x servers\)"):
        simulate(env_cfg, tables, policy, get_trace("poisson", rate_rps=8.0), n_requests=100)


@pytest.mark.parametrize("engine", HOST_ENGINES)
def test_routed_wait_flows_as_the_reference(engine):
    """One epoch of request flow with an (n,) per-device routed-server
    wait, through the port's engine and the reference's: the same
    latencies, energies, devices, drain times and SLO hits."""
    from types import SimpleNamespace

    from repro.sim import fleet as ref_fleet
    from repro.sim import megafleet as ref_megafleet
    from repro.sim.metrics import FleetMetrics as RefFleetMetrics
    from repro_torch.sim import fleet, megafleet
    from repro_torch.sim.metrics import FleetMetrics
    r = np.random.default_rng(6)
    n = 6
    pr = SimpleNamespace(head_s=r.uniform(0.01, 0.2, n), tx_s=r.uniform(0.0, 0.1, n),
                         tail_s=r.uniform(0.0, 0.5, n), energy_j=r.uniform(0.1, 2.0, n),
                         offloaded=np.array([True, False, True, True, False, True]))
    counts = np.array([3, 0, 7, 1, 12, 4])
    alive = np.array([True, True, True, False, True, True])
    wait = r.uniform(0.0, 3.0, n)
    fns = {"loop": (fleet._queues_loop, ref_fleet._queues_loop),
           "vectorized": (megafleet.numpy_queues, ref_megafleet.numpy_queues)}[engine]
    out = []
    for fn, metrics in zip(fns, (FleetMetrics(slo_s=1.0), RefFleetMetrics(slo_s=1.0))):
        free_at = np.full(n, 20.0)
        hits = fn(counts, alive, free_at, pr, wait, 20.0, 10.0,
                  np.random.default_rng(3), metrics, 1.0)
        out.append((hits, free_at, metrics))
    (hits, free_at, m), (ref_hits, ref_free_at, ref_m) = out
    assert hits == ref_hits
    np.testing.assert_array_equal(free_at, ref_free_at)
    for attr in ("latencies_s", "energies_j", "devices"):
        np.testing.assert_array_equal(getattr(m, attr), getattr(ref_m, attr))


# --------------------------------------------------------------------------
# pricing: the server axis, numpy = torch
# --------------------------------------------------------------------------

def _cluster_view_actions(cfg, tables, seed, n):
    r = np.random.default_rng(seed)
    lp, pw = cfg.latency, cfg.power
    S = cfg.cluster.n_servers
    srv_flops, srv_service_s = cfg.cluster.nominal(lp, xp=np)
    view = pricing.StateView(
        model_id=r.integers(0, tables.n_models, n).astype(np.int64),
        bandwidth=r.uniform(lp.bw_min_bps, lp.bw_max_bps, n).astype(np.float32),
        p_tx=r.uniform(pw.p_tx_min, pw.p_tx_max, n).astype(np.float32),
        queue=r.uniform(0.0, 12.0, S).astype(np.float32),
        load=r.uniform(0.0, 1.0, n).astype(np.float32),
        srv_flops=srv_flops.astype(np.float32),
        srv_service_s=srv_service_s.astype(np.float32),
        link_scale=np.asarray(cfg.cluster.link_scale, np.float32),
        link_rtt_s=np.asarray(cfg.cluster.link_rtt_s, np.float32))
    actions = np.stack([r.integers(0, tables.n_versions, n), r.integers(0, tables.n_cuts, n),
                        r.integers(0, S, n)], axis=-1).astype(np.int64)
    return view, actions


@pytest.mark.parametrize("n", [1, 8])
def test_pricing_server_axis_numpy_torch_parity(n):
    """Per-server tables + a server action column through xp=numpy and
    xp=torch agree to 1e-6 on every PricingBreakdown field."""
    cfg, tables = _cluster_env(devices=n)
    np_tables = pricing.numpy_tables(tables)
    for seed in (0, 1):
        view, actions = _cluster_view_actions(cfg, tables, seed, n)
        br_np = pricing.price_actions(cfg, np_tables, view, actions, xp=np)
        tview = pricing.StateView(
            **{f.name: (None if getattr(view, f.name) is None
                        else torch.as_tensor(getattr(view, f.name)))
               for f in dataclasses.fields(view)})
        br_t = pricing.price_actions(cfg, tables, tview, torch.as_tensor(actions), xp=torch)
        for f in dataclasses.fields(pricing.PricingBreakdown):
            x = np.asarray(getattr(br_np, f.name))
            y = getattr(br_t, f.name).numpy()
            if f.name == "offloaded":
                np.testing.assert_array_equal(x, y, err_msg=f.name)
            else:
                np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-6, err_msg=f.name)


def test_pricing_view_defaults_to_nominal_cluster_arrays():
    """A cluster view without per-server arrays prices at the nominal
    operating point (ClusterParams.nominal + the static link matrices),
    what env training sees."""
    cfg, tables = _cluster_env()
    np_tables = pricing.numpy_tables(tables)
    view, actions = _cluster_view_actions(cfg, tables, 2, 4)
    bare = dataclasses.replace(view, srv_flops=None, srv_service_s=None,
                               link_scale=None, link_rtt_s=None)
    br_full = pricing.price_actions(cfg, np_tables, view, actions, xp=np)
    br_bare = pricing.price_actions(cfg, np_tables, bare, actions, xp=np)
    np.testing.assert_allclose(np.asarray(br_bare.t_total), np.asarray(br_full.t_total),
                               rtol=1e-6, atol=1e-6)


def test_pricing_queue_gated_on_chosen_server_tail():
    """A terminal cut runs no tail on the chosen server: even a deep
    per-server queue charges no queue wait to that action."""
    cfg, tables = _cluster_env()
    np_tables = pricing.numpy_tables(tables)
    view, _ = _cluster_view_actions(cfg, tables, 0, 4)
    view = dataclasses.replace(view, queue=np.full(cfg.cluster.n_servers, 500.0, np.float32))
    terminal = np.stack([np.zeros(4, np.int64), np.full(4, tables.n_cuts - 1, np.int64),
                         np.arange(4)], -1)
    br = pricing.price_actions(cfg, np_tables, view, terminal, xp=np)
    assert not np.any(np.asarray(br.offloaded))
    np.testing.assert_array_equal(np.asarray(br.queue_s), 0.0)
    split = np.stack([np.zeros(4, np.int64), np.zeros(4, np.int64), np.arange(4)], -1)
    br2 = pricing.price_actions(cfg, np_tables, view, split, xp=np)
    assert np.all(np.asarray(br2.queue_s)[np.asarray(br2.offloaded)] > 0)


def test_pricing_server_axis_reprices_link_per_target():
    """Identical (version, cut) to a far server pays the degraded link
    and its RTT: tx_s strictly above the near server's."""
    cfg, tables = _cluster_env(pool="hetero-4", topology="near-far")
    np_tables = pricing.numpy_tables(tables)
    view, _ = _cluster_view_actions(cfg, tables, 1, 4)
    near = np.asarray(cfg.cluster.link_scale).argmax(axis=1)
    far = np.asarray(cfg.cluster.link_scale).argmin(axis=1)
    zeros = np.zeros(4, np.int64)
    tx_near = pricing.price_actions(cfg, np_tables, view, np.stack([zeros, zeros, near], -1),
                                    xp=np).tx_s
    tx_far = pricing.price_actions(cfg, np_tables, view, np.stack([zeros, zeros, far], -1),
                                   xp=np).tx_s
    assert np.all(np.asarray(tx_far) > np.asarray(tx_near))


# --------------------------------------------------------------------------
# env + controller: the widened action space
# --------------------------------------------------------------------------

def test_env_widens_obs_and_action_space():
    cfg, tables = _cluster_env()
    S = cfg.cluster.n_servers
    assert cfg.n_servers == S and cfg.action_dim == 3
    assert cfg.obs_dim_per_uav == len(OBS_FEATURES) + S - 1
    state = T.env_reset(cfg, tables, torch.Generator().manual_seed(0))
    assert state["queue"].shape == (S,)
    obs_flat = observe(cfg, tables, state)
    assert obs_flat.shape == (cfg.n_uavs, cfg.obs_dim_per_uav)


def test_agent_learns_server_head_and_samples_triples():
    cfg, tables = _cluster_env()
    agent = T.init_agent(cfg, tables, T.A2CConfig(), torch.Generator().manual_seed(0))
    assert "actor/srv/w" in agent.flat_params()
    state = T.env_reset(cfg, tables, torch.Generator().manual_seed(1))
    obs_flat = observe(cfg, tables, state).reshape(-1)
    valid = tables.version_valid[state["model_id"]]
    acts = sample_actions(agent, obs_flat, valid, torch.Generator().manual_seed(2))
    assert acts.shape == (cfg.n_uavs, 3) and acts.dtype == torch.int64
    assert bool((acts[:, 2] >= 0).all()) and bool((acts[:, 2] < cfg.n_servers).all())
    assert greedy_actions(agent, obs_flat, valid).shape == (cfg.n_uavs, 3)
    _, reward, _ = T.env_step(cfg, tables, state, acts, torch.Generator().manual_seed(3))
    assert np.isfinite(float(reward.mean()))


def test_routers_route_where_their_rule_says():
    cfg, tables = _cluster_env(devices=8)
    S = cfg.cluster.n_servers
    state = T.env_reset(cfg, tables, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(9)
    rr = get_policy_spec("round_robin").build(cfg, tables)
    acts = rr.act(state, g)
    assert acts.dtype == torch.int64
    t = int(state["t"])
    np.testing.assert_array_equal(acts[:, 2].numpy(), (np.arange(8) + t) % S)
    deep = dict(state)
    deep["queue"] = torch.tensor([9.0, 1.0, 5.0, 7.0])
    jsq = get_policy_spec("join_shortest_queue").build(cfg, tables)
    np.testing.assert_array_equal(jsq.act(deep, g)[:, 2].numpy(), 1)
    deep["queue"] = torch.tensor([3.0, 1.0, 1.0, 7.0])      # a tie: the first server
    np.testing.assert_array_equal(jsq.act(deep, g)[:, 2].numpy(), 1)
    lo = get_policy_spec("local_only").build(cfg, tables)
    lacts = lo.act(state, g)
    np.testing.assert_array_equal(lacts[:, 1].numpy(), tables.n_cuts - 1)
    assert not np.any(np.asarray(pricing.price_actions(
        cfg, pricing.numpy_tables(tables), pricing.view_from_state(
            {k: v.numpy() for k, v in state.items()}), lacts.numpy(), xp=np).offloaded))


@pytest.mark.parametrize("router", ROUTERS)
def test_router_actions_equal_the_reference(router):
    """Each router on 12 seeded measured states of the edge-cluster
    world (per-server depths with ties, epochs 0-11): the reference's
    (version, cut, server) for every device."""
    ref_cfg, ref_tables, _, _ = ref_get_scenario("edge-cluster").build_env()
    cfg, tables, mids, _ = get_scenario("edge-cluster").build_env(device="cpu")
    ref_pol = ref_build_policy(router, ref_cfg, ref_tables)
    pol = build_policy(router, cfg, tables)
    r = np.random.default_rng(11)
    n, lp, pw = cfg.n_uavs, cfg.latency, cfg.power
    for t in range(12):
        q = r.integers(0, 4, 4).astype(np.float64) if t % 2 else r.uniform(0.0, 25.0, 4)
        kw = dict(battery_j=r.uniform(0.0, pw.battery_j, n),
                  bandwidth=r.uniform(lp.bw_min_bps, lp.bw_max_bps, n),
                  p_tx=r.uniform(pw.p_tx_min, pw.p_tx_max, n), queue_jobs=q,
                  load=r.uniform(0.0, 1.0, n), model_id=mids, t=t)
        want = np.asarray(ref_pol.act(R.measured_state(ref_cfg, ref_tables, **kw), None))
        got = pol.act(T.measured_state(cfg, tables, **kw))
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------
# simulate over the cluster worlds against the reference
# --------------------------------------------------------------------------

@dataclasses.dataclass
class World:
    """One cluster preset's world in both packages, with an A2C the
    reference trained briefly and saved, loaded into the port."""
    ref_sc: object
    sc: object
    ref_env: tuple
    env: tuple
    model_ids: np.ndarray
    artifact: str


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    cache = {}

    def get(name):
        if name not in cache:
            repl = {"drift_kw": WORLDS[name]["drift_kw"]} if "drift_kw" in WORLDS[name] else {}
            ref_sc = ref_get_scenario(name).replace(**repl)
            sc = get_scenario(name).replace(**repl)
            ref_cfg, ref_tables, ref_mids, _ = ref_sc.build_env()
            cfg, tables, mids, _ = sc.build_env(device="cpu")
            np.testing.assert_array_equal(mids, ref_mids)
            ref_a2c = ref_build_policy("a2c", ref_cfg, ref_tables, episodes=3,
                                       entropy_coef=ref_sc.entropy_coef, batch_envs=2)
            ref_a2c.train(seed=0, trace=ref_sc.build_train_trace())
            path = ref_a2c.save(str(tmp_path_factory.mktemp("a2c") / f"{name}.npz"))
            cache[name] = World(ref_sc, sc, (ref_cfg, ref_tables), (cfg, tables), mids, path)
        return cache[name]

    return get


def _policies(w, name):
    if name == "a2c":
        return (ref_build_policy("a2c", *w.ref_env).load(w.artifact),
                build_policy("a2c", *w.env).load(w.artifact))
    return ref_build_policy(name, *w.ref_env), build_policy(name, *w.env)


@pytest.mark.parametrize("engine", HOST_ENGINES)
@pytest.mark.parametrize("policy", ROUTERS[:2] + ("device_only", "a2c") + ROUTERS[2:])
@pytest.mark.parametrize("name", sorted(WORLDS))
def test_cluster_simulate_equals_the_reference(name, policy, engine, worlds):
    """The preset's world, traffic, autoscaler and first seed (the
    brownout's flash crowd moved inside the run): the reference's
    SimResult bit for bit, ``server_hist``, the pool's summary keys and
    ``adaptation`` included."""
    w = worlds(name)
    ref_pol, pol = _policies(w, policy)
    kw = dict(n_requests=WORLDS[name]["n_requests"], seed=w.sc.seeds[0], model_ids=w.model_ids)
    a = ref_simulate(*w.ref_env, ref_pol, w.ref_sc.build_trace(),
                     fleet=RefFleetConfig(slo_s=w.sc.slo_s, engine=engine),
                     schedule=w.ref_sc.build_schedule(), autoscaler=w.ref_sc.build_autoscaler(),
                     **kw)
    b = simulate(*w.env, pol, w.sc.build_trace(),
                 fleet=FleetConfig(slo_s=w.sc.slo_s, engine=engine),
                 schedule=w.sc.build_schedule(), autoscaler=w.sc.build_autoscaler(), **kw)
    assert a.epochs >= 5 and a.server_hist.sum() == a.served - a.summary["dropped"]
    assert {"server_energy_j", "scale_events", "mean_replicas"} <= set(b.summary)
    if name == "cluster-brownout":
        assert len(a.adaptation["regimes"]) == 3
    assert_same_result(a, b)


def test_cluster_autoscaler_moves_and_events_are_recorded(worlds):
    """Under the brownout's surge the hysteresis autoscaler moves, each
    decision lands as an ``autoscale.decision`` event, and the pool's
    meters enter the summary."""
    from repro_torch import obs
    w = worlds("cluster-brownout")
    pol = build_policy("join_shortest_queue", *w.env)
    with obs.recording(None) as rec:
        res = simulate(*w.env, pol, w.sc.build_trace(), n_requests=20_000, seed=0,
                       model_ids=w.model_ids, fleet=FleetConfig(slo_s=w.sc.slo_s),
                       schedule=w.sc.build_schedule(), autoscaler=w.sc.build_autoscaler())
    events = [e for e in rec.events if e.get("name") == "autoscale.decision"]
    assert res.summary["scale_events"] == len(events) > 0
    assert {e["attrs"]["action"] for e in events} <= {"dvfs_up", "dvfs_down", "replica_up",
                                                      "replica_down"}
    assert res.summary["server_energy_j"] > 0 and res.summary["mean_replicas"] >= 1.0


def _record_decisions(policy, ref):
    seen = []
    if ref:
        jitted = policy.jitted

        def wrapped():
            fn = jitted()

            def call(state, key):
                out = fn(state, key)
                seen.append(np.asarray(out))
                return out
            return call
        policy.jitted = wrapped
    else:
        act = policy.act

        def call(state, generator=None):
            out = act(state, generator)
            seen.append(out.numpy().copy())
            return out
        policy.act = call
    return seen


def test_online_loop_over_a_pool_equals_the_reference(worlds):
    """The shortened cluster-brownout world with its autoscaler, the A2C
    from the reference's artifact adapted online (``gate="always"``,
    ``explore_eps=0``: the exploration draws are the port's own): the
    reference's decision at every epoch, the same learner counters, the
    per-regime oracle over (version, cut, server) triples, the SimResult
    bit for bit, and the adapted parameters within 1e-5 per update."""
    import jax
    w = worlds("cluster-brownout")
    ref_pol, pol = _policies(w, "a2c")
    ref_seen, seen = _record_decisions(ref_pol, True), _record_decisions(pol, False)
    oc = dict(gate="always", explore_eps=0.0, window=16, min_window=4)
    kw = dict(n_requests=14_000, seed=1, model_ids=w.model_ids)
    a = ref_simulate(*w.ref_env, ref_pol, w.ref_sc.build_trace(),
                     fleet=RefFleetConfig(slo_s=w.sc.slo_s),
                     schedule=ref_get_schedule("flash-crowd", **BROWNOUT_KW),
                     autoscaler=w.ref_sc.build_autoscaler(), online=RefOnlineConfig(**oc), **kw)
    b = simulate(*w.env, pol, w.sc.build_trace(), fleet=FleetConfig(slo_s=w.sc.slo_s),
                 schedule=get_schedule("flash-crowd", **BROWNOUT_KW),
                 autoscaler=w.sc.build_autoscaler(), online=OnlineConfig(**oc), **kw)
    for epoch, (x, y) in enumerate(zip(ref_seen, seen)):
        if not np.array_equal(x, y):
            print(f"decisions part at epoch {epoch}: reference {x.tolist()}, port {y.tolist()}")
    assert len(seen) == len(ref_seen) == b.epochs
    assert all(np.array_equal(x, y) for x, y in zip(ref_seen, seen))
    assert b.adaptation["online"] == a.adaptation["online"]
    assert b.adaptation["online"]["updates"] > 5
    assert_same_result(a, b)
    leaves = jax.tree_util.tree_flatten_with_path(ref_pol.params)[0]
    want = {"/".join(str(k.key) for k in path): np.asarray(v) for path, v in leaves}
    for k, p in pol.params.flat_params().items():
        np.testing.assert_allclose(p.detach().numpy(), want[k], err_msg=k,
                                   rtol=1e-5, atol=1e-5 * b.adaptation["online"]["updates"])


# --------------------------------------------------------------------------
# scenarios: presets + builders, and the CLI
# --------------------------------------------------------------------------

def test_cluster_presets_registered_and_build():
    for name in ("edge-cluster", "cluster-brownout"):
        sc, ref_sc = get_scenario(name), ref_get_scenario(name)
        cluster = sc.build_cluster()
        assert cluster.n_servers == 4
        assert cluster.n_devices == sc.devices
        assert dataclasses.asdict(cluster) == dataclasses.asdict(ref_sc.build_cluster())
        assert dataclasses.asdict(sc.build_autoscaler()) \
            == dataclasses.asdict(ref_sc.build_autoscaler())
        cfg, tables, _, factory = sc.build_env(device="cpu")
        assert cfg.cluster == cluster and cfg.action_dim == 3
        assert isinstance(factory(), AnalyticalBackend)


def test_autoscale_without_pool_rejected():
    sc = get_scenario("edge-cluster").replace(pool=None)
    with pytest.raises(ValueError, match="without a server pool") as e:
        sc.build_autoscaler()
    with pytest.raises(ValueError) as ref_e:
        ref_get_scenario("edge-cluster").replace(pool=None).build_autoscaler()
    assert str(e.value) == str(ref_e.value)


def test_tpu_env_rejects_pool():
    sc = get_scenario("tpu-submesh").replace(pool="hetero-4")
    with pytest.raises(ValueError, match="single shared server") as e:
        sc.build_env(device="cpu")
    with pytest.raises(ValueError) as ref_e:
        ref_get_scenario("tpu-submesh").replace(pool="hetero-4").build_env()
    assert str(e.value) == str(ref_e.value)


def test_cli_cluster_flags_give_the_reference_numbers(capsys):
    """``--scenario edge-cluster --pool uniform-4 --topology tiered
    --autoscale threshold`` over the static roster at 3,000 requests: the
    numbers the reference CLI's run of the same overrides gives; bad
    names are refused with the registry's list."""
    argv = ["--scenario", "edge-cluster", "--pool", "uniform-4", "--topology", "tiered",
            "--autoscale", "threshold", "--compare", ",".join(ROUTERS), "--requests", "3000",
            "--seeds", "0,1"]
    report = cli.main(argv + ["--device", "cpu"])
    text = capsys.readouterr().out
    assert all(name in text for name in ROUTERS)
    ref_sc = ref_get_scenario("edge-cluster").replace(
        pool="uniform-4", topology="tiered", autoscale="threshold", pool_kw={},
        topology_kw={}, autoscale_kw={}, n_requests=3000, seeds=(0, 1))
    ref = ref_run_scenario(ref_sc, ROUTERS)
    for name, r in ref.results.items():
        assert report.results[name].per_seed == r.per_seed, name
        assert report.results[name].per_seed[0]["scale_events"] \
            == r.per_seed[0]["scale_events"]
    # the preset's own roster minus a2c, without overrides, at 2,000 requests
    report = cli.main(["--scenario", "cluster-brownout", "--compare",
                       "round_robin,join_shortest_queue,device_only", "--requests", "2000",
                       "--device", "cpu", "--quiet"])
    ref = ref_run_scenario(ref_get_scenario("cluster-brownout"),
                           ("round_robin", "join_shortest_queue", "device_only"),
                           n_requests=2000)
    for name, r in ref.results.items():
        assert report.results[name].per_seed == r.per_seed, name
    for flag in (["--pool", "no-such-pool"], ["--topology", "no-such-topology"]):
        with pytest.raises(SystemExit):
            cli.main(["--scenario", "edge-cluster", "--device", "cpu", *flag])
    with pytest.raises(SystemExit):          # an autoscaler without a pool
        cli.main(["--scenario", "paper-mmpp-burst", "--autoscale", "threshold",
                  "--device", "cpu"])
