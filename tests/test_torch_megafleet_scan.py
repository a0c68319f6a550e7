"""repro_torch's scan engine (``sim.megafleet.simulate_scan``) against
repro's on the CPU: ``lindley_core``'s torch branch against ``jnp``'s bit
for bit in float32, ``_hist_percentile``, determinism, the shard
identity, the reference's refusals in its words, and the scan's contract
against the port's vectorized engine and the reference's scan.

The scan draws its world noise from a ``torch.Generator`` (the reference
from a jax key), so the contract is the reference's own
(tests/test_megafleet.py): exact workload accounting (``epochs``,
``served``, the epoch log's arrivals, and under state-independent
policies ``selection_hist``), statistical agreement of the metrics (SLO
attainment within 0.05 absolute, mean latency within 15 %, energy within
1 % relative), and identical results on one device under one seed.
Policies whose actions read the noisy state (greedy_oracle, an A2C) are
held to the statistical contract at the 100,000-device ``megafleet``
world, where the noise averages out: there the selection histogram's
totals are exact and its shares within 0.05. In the 8-device
``diurnal-fleet`` world one noise path decides such a policy's run, so an
A2C there is held to what stays exact and to its SLO attainment within
0.05. Inputs come from numpy seeds."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.policies import build_policy as ref_build_policy  # noqa: E402
from repro.scenarios import get_scenario as ref_get_scenario  # noqa: E402
from repro.sim import FleetConfig as RefFleetConfig  # noqa: E402
from repro.sim import megafleet as ref_megafleet  # noqa: E402
from repro.sim import simulate as ref_simulate  # noqa: E402

from repro_torch.launch import simulate as cli  # noqa: E402
from repro_torch.online import OnlineConfig, get_schedule  # noqa: E402
from repro_torch.policies import build_policy  # noqa: E402
from repro_torch.scenarios import get_scenario, run_scenario  # noqa: E402
from repro_torch.sim import (ENGINES, AnalyticalBackend, FleetConfig,  # noqa: E402
                             megafleet, simulate, simulate_scan)

SLO_ABS, MEAN_REL, ENERGY_REL, SHARE_ABS = 0.05, 0.15, 0.01, 0.05
# the megafleet world cut only in requests: three epochs of ~540k
MEGA_REQUESTS = 1_500_000


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread, as the other port test files: the suite runs
    its files in parallel workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _world(name):
    sc = get_scenario(name)
    env_cfg, tables, mids, bf = sc.build_env(device="cpu")
    return sc, env_cfg, tables, mids, bf


def _run(sc, env_cfg, tables, mids, policy, engine, *, n_requests, seed=0, **fl_kw):
    return simulate(env_cfg, tables, policy, sc.build_trace(), n_requests=n_requests,
                    seed=seed, model_ids=mids,
                    fleet=FleetConfig(slo_s=sc.slo_s, engine=engine, **fl_kw))


def _ref_run(name, policy_name, engine, *, n_requests, seed=0, world=None, **fl_kw):
    """The reference's run; ``world`` = (env_cfg, tables, policy) built
    once by the caller, else built here."""
    sc = ref_get_scenario(name)
    env_cfg, tables, mids, _ = sc.build_env()
    if world is not None:
        env_cfg, tables, pol = world
    else:
        pol = ref_build_policy(policy_name, env_cfg, tables)
    return ref_simulate(env_cfg, tables, pol, sc.build_trace(), n_requests=n_requests,
                        seed=seed, model_ids=mids,
                        fleet=RefFleetConfig(slo_s=sc.slo_s, engine=engine, **fl_kw))


def assert_same_workload(a, b):
    """Exact workload accounting: the trace rng stream is shared."""
    assert (a.epochs, a.served, a.duration_s) == (b.epochs, b.served, b.duration_s)
    np.testing.assert_array_equal(a.epoch_log.column("arrivals"),
                                  b.epoch_log.column("arrivals"))
    assert a.selection_hist.sum() == b.selection_hist.sum()


def assert_statistically_close(a, b, shares=True):
    """The reference's statistical contract (tests/test_megafleet.py)."""
    assert abs(a.summary["slo_attainment"] - b.summary["slo_attainment"]) < SLO_ABS
    assert a.summary["mean"] == pytest.approx(b.summary["mean"], rel=MEAN_REL)
    assert a.summary["energy_j"] == pytest.approx(b.summary["energy_j"], rel=ENERGY_REL)
    if shares:
        ha, hb = a.selection_hist, b.selection_hist
        np.testing.assert_allclose(ha / ha.sum(), hb / hb.sum(), rtol=0, atol=SHARE_ABS)


# --------------------------------------------------------------------------
# the Lindley core's torch branch, the histogram readout
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,C,srv_wait", [(1, 1, 0.0), (8, 25, 0.37), (300, 7, 2.5),
                                          (64, 40, 0.0)])
def test_lindley_core_torch_equals_jnp_bit_for_bit(n, C, srv_wait):
    """The same padded float32 inputs through jnp's branch and torch's:
    latencies and completion times identical bit for bit."""
    r = np.random.default_rng(n * 1000 + C)
    slot = 10.0
    counts = r.integers(0, C + 1, n)
    u = r.uniform(0.0, slot, (n, C)).astype(np.float32)
    valid = np.arange(C)[None, :] < counts[:, None]
    offs = np.sort(np.where(valid, u, np.float32(2 * slot)), axis=1).astype(np.float32)
    free = np.where(r.random(n) < 0.5, 0.0, r.uniform(0.0, 3.0, n)).astype(np.float32)
    head_tx = r.uniform(1e-3, 0.5, n).astype(np.float32)
    tail = r.uniform(0.0, 0.2, n).astype(np.float32)
    off = r.random(n) < 0.5
    sw = np.float32(srv_wait)
    want_lat, want_done = ref_megafleet.lindley_core(
        jnp, *(jnp.asarray(x) for x in (offs, free, head_tx, tail, off)), jnp.asarray(sw))
    lat, done = megafleet.lindley_core(
        *(torch.from_numpy(x) for x in (offs, free, head_tx, tail, off)), torch.tensor(sw))
    assert lat.dtype == done.dtype == torch.float32
    np.testing.assert_array_equal(lat.numpy(), np.asarray(want_lat))
    np.testing.assert_array_equal(done.numpy(), np.asarray(want_done))


@pytest.mark.parametrize("q", [0.0, 0.5, 0.95, 0.99, 1.0])
def test_hist_percentile_equals_the_reference(q):
    edges = np.geomspace(megafleet._LAT_LO, megafleet._LAT_HI, megafleet._NBINS - 1)
    assert megafleet._NBINS == ref_megafleet._NBINS
    assert (megafleet._LAT_LO, megafleet._LAT_HI) == (ref_megafleet._LAT_LO,
                                                      ref_megafleet._LAT_HI)
    r = np.random.default_rng(7)
    for hist in (np.zeros(megafleet._NBINS, np.int32),
                 r.integers(0, 50, megafleet._NBINS).astype(np.int32),
                 np.eye(megafleet._NBINS, dtype=np.int32)[0] * 9,
                 np.eye(megafleet._NBINS, dtype=np.int32)[-1] * 3):
        count = int(hist.sum())
        assert megafleet._hist_percentile(hist, edges, count, q) == \
            ref_megafleet._hist_percentile(hist, edges, count, q)


# --------------------------------------------------------------------------
# the scan engine's contract
# --------------------------------------------------------------------------

def test_scan_deterministic_and_close_to_vectorized():
    """The counterpart of the reference's test, on diurnal-fleet."""
    sc, env_cfg, tables, mids, _ = _world("diurnal-fleet")
    pol = build_policy("device_only", env_cfg, tables)
    s1 = _run(sc, env_cfg, tables, mids, pol, "scan", n_requests=15_000)
    s2 = _run(sc, env_cfg, tables, mids, pol, "scan", n_requests=15_000)
    assert s1.summary == s2.summary
    np.testing.assert_array_equal(s1.selection_hist, s2.selection_hist)
    assert s1.selection_hist.dtype == np.int64

    v = _run(sc, env_cfg, tables, mids, pol, "vectorized", n_requests=15_000)
    assert_same_workload(s1, v)
    np.testing.assert_array_equal(s1.selection_hist, v.selection_hist)
    assert_statistically_close(s1, v)
    assert len(s1.epoch_log) == s1.epochs
    assert s1.epoch_log[0]["arrivals"] == v.epoch_log[0]["arrivals"]
    assert s1.metrics.dropped == 0 and s1.metrics.latencies_s.size == 0
    assert s1.decide_s.size == 0 and s1.timeline is None


@pytest.mark.parametrize("policy", ["device_only", "full_offload"])
def test_scan_equals_the_reference_scan_on_diurnal_fleet(policy):
    """device_only at the reference's 15,000 requests: exact accounting,
    summary keys and epoch-log columns (names and dtypes) as the
    reference's scan, metrics statistically close. full_offload prices the
    noisy link, which one noise path decides in an 8-device world: held
    exact and to its selection histogram."""
    sc, env_cfg, tables, mids, _ = _world("diurnal-fleet")
    a = _ref_run(sc.name, policy, "scan", n_requests=15_000)
    b = _run(sc, env_cfg, tables, mids, build_policy(policy, env_cfg, tables), "scan",
             n_requests=15_000)
    assert_same_workload(a, b)
    np.testing.assert_array_equal(b.selection_hist, a.selection_hist)
    assert set(b.summary) == set(a.summary)
    assert b.summary["requests"] == a.summary["requests"]
    assert b.summary["count"] == a.summary["count"]
    ca, cb = a.epoch_log.columns, b.epoch_log.columns
    assert {k: v.dtype for k, v in cb.items()} == {k: v.dtype for k, v in ca.items()}
    if policy == "device_only":
        assert_statistically_close(b, a)
        # device_only's energy is state-independent: equal up to f32 sums
        assert b.summary["energy_j"] == pytest.approx(a.summary["energy_j"], rel=1e-5)


def test_scan_a2c_loaded_from_a_reference_artifact(tmp_path):
    """An A2C the reference trained briefly and saved, loaded into the
    port, under the scan at the preset's three seeds: workload and
    selection totals exact against the reference's scan, SLO attainment
    within 0.05; deterministic."""
    rsc = ref_get_scenario("diurnal-fleet")
    r_env, r_tables, _, _ = rsc.build_env()
    ref_a2c = ref_build_policy("a2c", r_env, r_tables, episodes=10,
                               entropy_coef=rsc.entropy_coef, batch_envs=2)
    ref_a2c.train(seed=0, trace=rsc.build_train_trace())
    path = ref_a2c.save(str(tmp_path / "a2c.npz"))
    sc, env_cfg, tables, mids, _ = _world("diurnal-fleet")
    a2c = build_policy("a2c", env_cfg, tables).load(path)
    assert sc.seeds == (0, 1, 2)
    for seed in sc.seeds:
        a = _ref_run(sc.name, "a2c", "scan", n_requests=15_000, seed=seed,
                     world=(r_env, r_tables, ref_a2c))
        b = _run(sc, env_cfg, tables, mids, a2c, "scan", n_requests=15_000, seed=seed)
        assert_same_workload(a, b)
        assert b.selection_hist.sum() == b.served - b.metrics.dropped
        assert abs(a.summary["slo_attainment"] - b.summary["slo_attainment"]) < SLO_ABS
    again = _run(sc, env_cfg, tables, mids, a2c, "scan", n_requests=15_000, seed=seed)
    assert again.summary == b.summary
    np.testing.assert_array_equal(again.selection_hist, b.selection_hist)


def test_scan_shard_matches_unsharded():
    """shard=True on one device runs the same program: bit-identical."""
    sc, env_cfg, tables, mids, _ = _world("diurnal-fleet")
    pol = build_policy("device_only", env_cfg, tables)
    a = _run(sc, env_cfg, tables, mids, pol, "scan", n_requests=6000)
    b = _run(sc, env_cfg, tables, mids, pol, "scan", n_requests=6000, shard=True)
    assert a.summary == b.summary
    np.testing.assert_array_equal(a.selection_hist, b.selection_hist)
    assert list(a.epoch_log) == list(b.epoch_log)


def _refusal(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_scan_rejects_unsupported_modes_with_the_reference_words():
    """Each refusal raised by both packages, the messages equal."""
    from repro.online import get_schedule as ref_get_schedule
    from repro.sim import ExecuteBackend as RefExecuteBackend
    rsc = ref_get_scenario("link-brownout")
    r_env, r_tables, r_mids, _ = rsc.build_env()
    r_pol = ref_build_policy("device_only", r_env, r_tables)
    sc, env_cfg, tables, mids, _ = _world("link-brownout")
    pol = build_policy("device_only", env_cfg, tables)
    r_a2c = ref_build_policy("a2c", r_env, r_tables, episodes=1)
    r_a2c.train(seed=0)
    a2c = build_policy("a2c", env_cfg, tables, episodes=1)
    a2c.train(seed=0)

    def both(ref_kw, kw, ref_pol=r_pol, pol=pol, engine="scan", **fl):
        want = _refusal(lambda: ref_simulate(
            r_env, r_tables, ref_pol, rsc.build_trace(), n_requests=1000,
            model_ids=r_mids, fleet=RefFleetConfig(engine=engine, **fl), **ref_kw))
        got = _refusal(lambda: simulate(
            env_cfg, tables, pol, sc.build_trace(), n_requests=1000, model_ids=mids,
            fleet=FleetConfig(engine=engine, **fl), **kw))
        assert got == want
        return got

    assert "stationary" in both(dict(schedule=rsc.build_schedule()),
                                dict(schedule=sc.build_schedule()))
    assert "stationary" in both(dict(online=object()), dict(online=OnlineConfig()))
    assert "valid engines" in both({}, {}, engine="warp")
    assert "shard" in both({}, {}, engine="loop", shard=True)
    assert "decomposable" in both({}, {}, ref_pol=r_a2c, pol=a2c, shard=True)
    assert "cluster-mode" in both(dict(autoscaler=object()), dict(autoscaler=object()))
    assert get_schedule("link-brownout").name == ref_get_schedule("link-brownout").name
    # a backend that is not the analytical one (the execute cross-check)
    want = _refusal(lambda: ref_simulate(
        r_env, r_tables, r_pol, rsc.build_trace(), n_requests=100, model_ids=r_mids,
        backend=RefExecuteBackend.__new__(RefExecuteBackend),
        fleet=RefFleetConfig(engine="scan")))
    from repro_torch.sim import ExecuteBackend
    got = _refusal(lambda: simulate(
        env_cfg, tables, pol, sc.build_trace(), n_requests=100, model_ids=mids,
        backend=ExecuteBackend.__new__(ExecuteBackend), fleet=FleetConfig(engine="scan")))
    assert got == want and "execute cross-check" in got
    # an analytical backend passes; zero epochs raise
    res = simulate(env_cfg, tables, pol, sc.build_trace(), n_requests=100, model_ids=mids,
                   backend=AnalyticalBackend(env_cfg, tables), fleet=FleetConfig(engine="scan"))
    assert res.served >= 100
    with pytest.raises(ValueError, match="zero epochs"):
        simulate_scan(env_cfg, tables, pol, sc.build_trace(), n_requests=0)
    assert ENGINES == ("loop", "vectorized", "scan")


def test_scan_refuses_several_cards_for_shard(monkeypatch):
    """shard=True shards over the ranks of a torch.distributed group: with
    several visible cards and no group it raises (one process would leave
    all but one card unused) and says to start one process per card; on
    the CPU the card count does not matter and it runs at world size 1,
    equal to shard=False."""
    sc, env_cfg, tables, mids, _ = _world("diurnal-fleet")
    pol = build_policy("device_only", env_cfg, tables)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    res = _run(sc, env_cfg, tables, mids, pol, "scan", n_requests=2000, shard=True)
    base = _run(sc, env_cfg, tables, mids, pol, "scan", n_requests=2000)
    assert res.epochs > 0 and res.summary == base.summary
    assert not torch.distributed.is_initialized()
    monkeypatch.setattr(type(tables), "device", property(lambda self: torch.device("cuda", 0)),
                        raising=False)
    with pytest.raises(ValueError, match="one process per card") as e:
        simulate_scan(env_cfg, tables, pol, sc.build_trace(), n_requests=2000,
                      fleet=FleetConfig(engine="scan", shard=True))
    assert "4 cards" in str(e.value) and "torchrun" in str(e.value)


def test_scan_raises_without_cuda_unless_cpu_is_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc = get_scenario("diurnal-fleet").replace(engine="scan")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_scenario(sc, ("device_only",), n_requests=1000)
    rep = run_scenario(sc, ("device_only",), device="cpu", n_requests=1000, seeds=(0,))
    assert rep.results["device_only"].per_seed[0]["epochs"] >= 1


# --------------------------------------------------------------------------
# the 100,000-device megafleet world, cut only in requests
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mega():
    sc = get_scenario("megafleet")
    assert sc.devices == 100_000 and sc.slot_seconds == 1.0
    env_cfg, tables, mids, _ = sc.build_env(device="cpu")
    return sc, env_cfg, tables, mids


@pytest.mark.parametrize("policy", ["device_only", "full_offload", "greedy_oracle"])
def test_megafleet_scan_close_to_vectorized(policy, mega):
    """At 100,000 devices: the workload exact, the selection histogram
    exact for the static policies and its shares within 0.05 for
    greedy_oracle, the metrics within the statistical limits."""
    sc, env_cfg, tables, mids = mega
    pol = build_policy(policy, env_cfg, tables)
    s = _run(sc, env_cfg, tables, mids, pol, "scan", n_requests=MEGA_REQUESTS)
    v = _run(sc, env_cfg, tables, mids, pol, "vectorized", n_requests=MEGA_REQUESTS)
    assert s.epochs >= 3 and s.served >= MEGA_REQUESTS
    assert_same_workload(s, v)
    if policy != "greedy_oracle":
        np.testing.assert_array_equal(s.selection_hist, v.selection_hist)
    assert_statistically_close(s, v)


def test_megafleet_scan_close_to_the_reference_scan(mega):
    sc, env_cfg, tables, mids = mega
    a = _ref_run(sc.name, "device_only", "scan", n_requests=MEGA_REQUESTS)
    b = _run(sc, env_cfg, tables, mids, build_policy("device_only", env_cfg, tables), "scan",
             n_requests=MEGA_REQUESTS)
    assert_same_workload(a, b)
    np.testing.assert_array_equal(b.selection_hist, a.selection_hist)
    assert_statistically_close(b, a)


def test_cli_runs_the_scan_engine_on_the_cpu(capsys):
    report = cli.main(["--scenario", "diurnal-fleet", "--engine", "scan", "--device", "cpu",
                       "--compare", "device_only,full_offload", "--requests", "6000",
                       "--seeds", "0"])
    assert "full_offload" in capsys.readouterr().out
    sc, env_cfg, tables, mids, _ = _world("diurnal-fleet")
    direct = _run(sc, env_cfg, tables, mids, build_policy("device_only", env_cfg, tables),
                  "scan", n_requests=6000)
    assert report.results["device_only"].per_seed[0] == direct.summary
