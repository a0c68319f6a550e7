"""repro_torch.online against repro.online on the CPU: the drift world
bit for bit (static policies and a loaded A2C under all four schedules,
both engines, ``adaptation`` included), the pieces one by one (patches,
schedules, ``scale_counts``, Page-Hinkley, the per-regime oracle, the
replay window, ``_bucket``), one online update (A2C and PPO objectives,
trunk frozen and not) and the capture against the reference's, the
whole online loop from a loaded artifact against the reference's, the
port's own determinism and hot-swap, the scenarios and the CLI. Inputs
come from numpy seeds."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core as R  # noqa: E402
from repro.online import OnlineConfig as RefOnlineConfig  # noqa: E402
from repro.online import adapt as ref_adapt  # noqa: E402
from repro.online import drift as ref_drift  # noqa: E402
from repro.online import monitor as ref_monitor  # noqa: E402
from repro.policies import build_policy as ref_build_policy  # noqa: E402
from repro.scenarios import get_scenario as ref_get_scenario  # noqa: E402
from repro.scenarios import run_scenario as ref_run_scenario  # noqa: E402
from repro.sim import FleetConfig as RefFleetConfig  # noqa: E402
from repro.sim import PoissonTrace as RefPoissonTrace  # noqa: E402
from repro.sim import simulate as ref_simulate  # noqa: E402

import repro_torch.core as T  # noqa: E402
from repro_torch.core import pricing  # noqa: E402
from repro_torch.launch import simulate as cli  # noqa: E402
from repro_torch.online import (EnvPatch, OnlineConfig, OnlineLearner,  # noqa: E402
                                PageHinkley, ReplayWindow, WorldSchedule,
                                apply_env_patch, get_schedule, oracle_reward,
                                scale_counts, schedule_names)
from repro_torch.online import adapt, monitor  # noqa: E402
from repro_torch.policies import build_policy  # noqa: E402
from repro_torch.scenarios import get_scenario, run_scenario  # noqa: E402
from repro_torch.sim import (ExecuteBackend, FleetConfig,  # noqa: E402
                             PoissonTrace, simulate)

# the engines held bit for bit against the reference (the scan engine
# draws its noise from torch: tests/test_torch_megafleet_scan.py)
HOST_ENGINES = ("loop", "vectorized")
SMALL = dict(hidden1=64, hidden2=32, uav_head=16)
TOL = dict(rtol=1e-5, atol=1e-5)
# every schedule at small onsets: each regime is reached in a ~30-epoch run
SCHEDULES = {"link-brownout": dict(onset=5, recover=14),
             "flash-crowd": dict(onset=5, relax=14, scale=2.5),
             "battery-cliff": dict(at=5, recover=14),
             "device-churn": dict(leave_at=4, rejoin_at=12)}
STATIC = ("device_only", "full_offload", "greedy_oracle")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the port's ops here are small, so one thread
    is as fast alone, and it does not spin against the other test
    workers' threads when the suite runs in parallel."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_flat(params):
    """The reference's parameter tree as {``actor/l1/w``: ndarray}."""
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    return {"/".join(str(k.key) for k in path): np.asarray(v) for path, v in leaves}


def assert_same_result(a, b):
    """Two SimResults (reference, port) bit for bit, ``adaptation``
    included."""
    assert b.summary == a.summary
    np.testing.assert_array_equal(b.selection_hist, a.selection_hist)
    assert (b.epochs, b.served, b.duration_s) == (a.epochs, a.served, a.duration_s)
    ca, cb = a.epoch_log.columns, b.epoch_log.columns
    assert set(cb) == set(ca)
    for k in ca:
        np.testing.assert_array_equal(cb[k], ca[k], err_msg=k)
    for attr in ("latencies_s", "energies_j", "devices"):
        np.testing.assert_array_equal(getattr(b.metrics, attr), getattr(a.metrics, attr),
                                      err_msg=attr)
    assert b.adaptation == a.adaptation


@dataclasses.dataclass
class Tiny:
    """The reference tests' tiny world (3 paper-env devices, Poisson 6
    rps) in both packages, with A2C and PPO artifacts the reference
    trained briefly."""
    ref: tuple
    port: tuple
    artifacts: dict


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    kw = dict(n_uavs=3, slot_seconds=10.0, peak_rps=20.0)
    ref, port = R.make_paper_env(**kw), T.make_paper_env(device="cpu", **kw)
    artifacts = {}
    for algo in ("a2c", "ppo"):
        pol = ref_build_policy(algo, *ref, episodes=2)
        pol.train(seed=0)
        artifacts[algo] = pol.save(str(tmp_path_factory.mktemp(algo) / f"{algo}.npz"))
    return Tiny(ref, port, artifacts)


def _trace(ref):
    return (RefPoissonTrace if ref else PoissonTrace)(rate_rps=6.0)


def _record_decisions(policy, ref):
    """Wrap a policy so every decide is appended to the returned list."""
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


# --------------------------------------------------------------------------
# the drift model, piece by piece
# --------------------------------------------------------------------------

def test_env_patch_set_scale_and_reset_equal_the_reference():
    cfg, _ = T.make_paper_env(device="cpu")
    ref_cfg, _ = R.make_paper_env()
    p = dict(at_epoch=5, env={"latency.bw_max_bps": 6e6, "peak_rps": 40.0},
             env_scale={"power.p_compute": 3.0, "queue_arrival_rate": 2.0})
    cfg2 = apply_env_patch(cfg, EnvPatch(**p))
    ref2 = ref_drift.apply_env_patch(ref_cfg, ref_drift.EnvPatch(**p))
    assert dataclasses.asdict(cfg2) == dataclasses.asdict(ref2)
    assert cfg2.latency.bw_max_bps == 6e6 and cfg2.peak_rps == 40.0
    assert cfg2.power.p_compute == cfg.power.p_compute * 3
    assert cfg.latency.bw_max_bps != 6e6            # the original is unchanged
    with pytest.raises(KeyError, match="no field"):
        apply_env_patch(cfg, EnvPatch(at_epoch=1, env={"latency.bogus": 1.0}))


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedule_compile_equals_the_reference(name, tiny):
    """Every factory's patches (each dotted path the port's EnvConfig
    must accept), compiled over the paper and the tpu env: the same
    regimes, each with a backend of the port for a patched config."""
    for ref_env, env in (
            (tiny.ref, tiny.port),
            (R.make_tpu_env(["qwen2-0.5b"] * 2, reduced=True, seq_len=32),
             T.make_tpu_env(["qwen2-0.5b"] * 2, reduced=True, seq_len=32, device="cpu"))):
        for kw in ({}, SCHEDULES[name]):
            sched, ref_sched = get_schedule(name, **kw), ref_drift.get_schedule(name, **kw)
            assert (sched.name, sched.boundaries, sched.n_regimes) \
                == (ref_sched.name, ref_sched.boundaries, ref_sched.n_regimes)
            regs, ref_regs = sched.compile(env[0], env[1]), ref_sched.compile(*ref_env)
            for r, rr in zip(regs, ref_regs):
                assert dataclasses.asdict(r.env_cfg) == dataclasses.asdict(rr.env_cfg)
                assert (r.index, r.start_epoch, r.name, r.trace_scale, r.battery_scale,
                        r.kill_devices, r.revive_devices) \
                    == (rr.index, rr.start_epoch, rr.name, rr.trace_scale, rr.battery_scale,
                        rr.kill_devices, rr.revive_devices)
                assert (r.backend is None) == (rr.backend is None)
                assert r.backend is None or r.backend.env_cfg is r.env_cfg


def test_world_schedule_cumulative_reset_and_errors():
    cfg, _ = T.make_paper_env(device="cpu")
    sched = WorldSchedule((
        EnvPatch(at_epoch=10, name="a", env={"peak_rps": 40.0}, trace_scale=2.0),
        EnvPatch(at_epoch=20, name="b", env_scale={"latency.server_flops": 0.5}),
        EnvPatch(at_epoch=30, name="back", reset=True)))
    assert sched.n_regimes == 4 and sched.boundaries == (10, 20, 30)
    assert [sched.regime_at(e) for e in (0, 9, 10, 25, 30, 99)] == [0, 0, 1, 2, 3, 3]
    regs = sched.compile(cfg)
    assert regs[0].env_cfg is cfg and regs[3].env_cfg is cfg
    assert regs[2].env_cfg.peak_rps == 40.0 and regs[2].trace_scale == 2.0
    assert regs[2].env_cfg.latency.server_flops == cfg.latency.server_flops * 0.5
    assert regs[3].trace_scale == 1.0
    with pytest.raises(ValueError):
        WorldSchedule((EnvPatch(at_epoch=0),))
    with pytest.raises(ValueError):
        WorldSchedule((EnvPatch(at_epoch=10), EnvPatch(at_epoch=10)))
    with pytest.raises(KeyError) as e:
        get_schedule("no-such-drift")
    assert schedule_names() == ref_drift.schedule_names()
    for name in schedule_names():
        assert name in str(e.value)


@pytest.mark.parametrize("scale", [0.0, 0.3, 1.0, 2.5])
def test_scale_counts_equals_the_reference(scale):
    counts = np.random.default_rng(1).poisson(8.0, 500)
    a = scale_counts(np.random.default_rng(3), counts, scale)
    b = ref_drift.scale_counts(np.random.default_rng(3), counts, scale)
    np.testing.assert_array_equal(a, b)
    assert a.dtype == b.dtype
    with pytest.raises(ValueError):
        scale_counts(np.random.default_rng(0), counts, -1.0)


# --------------------------------------------------------------------------
# the monitor, the oracle, the window
# --------------------------------------------------------------------------

def test_page_hinkley_and_drift_monitor_trigger_as_the_reference():
    r = np.random.default_rng(0)
    stream = np.concatenate([0.6 + 0.05 * r.normal(size=200), -0.5 + 0.05 * r.normal(size=60),
                             0.2 + 0.3 * r.normal(size=200)])
    ph, ref_ph = PageHinkley(delta=0.01, lambda_=0.5), ref_monitor.PageHinkley(0.01, 0.5)
    fired = [ph.update(x) for x in stream]
    assert fired == [ref_ph.update(x) for x in stream]
    assert not any(fired[:200]) and any(fired[200:210])
    dm, ref_dm = monitor.DriftMonitor(), ref_monitor.DriftMonitor()
    out = [(dm.update(x), dm.level, dm.residual) for x in stream]
    assert out == [(ref_dm.update(x), ref_dm.level, ref_dm.residual) for x in stream]
    assert dm.triggers == ref_dm.triggers > 0


def test_oracle_reward_equals_the_reference_per_regime(tiny):
    """The numpy per-regime oracle, port against reference, on random
    measured views of every regime of every schedule."""
    (ref_cfg, ref_tables), (cfg, tables) = tiny.ref, tiny.port
    np_t, ref_np_t = pricing.numpy_tables(tables), R.numpy_tables(ref_tables)
    r = np.random.default_rng(2)
    for name, kw in SCHEDULES.items():
        for reg, ref_reg in zip(get_schedule(name, **kw).compile(cfg),
                                ref_drift.get_schedule(name, **kw).compile(ref_cfg)):
            lp, pw = reg.env_cfg.latency, reg.env_cfg.power
            for _ in range(3):
                view = dict(model_id=np.arange(3, dtype=np.int32) % 3,
                            bandwidth=r.uniform(lp.bw_min_bps, lp.bw_max_bps, 3),
                            p_tx=r.uniform(pw.p_tx_min, pw.p_tx_max, 3),
                            queue=float(r.uniform(0.0, 25.0)), load=r.uniform(0.0, 1.0, 3))
                alive = (r.uniform(size=3) > 0.2).astype(np.float64)
                got = oracle_reward(reg.env_cfg, np_t, pricing.StateView(**view), alive)
                want = ref_monitor.oracle_reward(ref_reg.env_cfg, ref_np_t,
                                                 R.StateView(**view), alive)
                assert got == want, (name, reg.name)


def test_adaptation_tracker_equals_the_reference():
    r = np.random.default_rng(4)
    tr, ref_tr = monitor.AdaptationTracker(), ref_monitor.AdaptationTracker()
    for e in range(50):
        reg = 0 if e < 12 else (1 if e < 40 else 2)
        o = 0.8 - 0.3 * (reg == 1) + 0.02 * r.normal()
        x = o - (0.5 if reg == 1 and e < 22 else 0.02) + 0.02 * r.normal()
        for t in (tr, ref_tr):
            t.record(e, reg, f"r{reg}", x, o)
    assert tr.summary(include_series=True) == ref_tr.summary(include_series=True)
    assert tr.summary()["regimes"][1]["recovery_epochs"] > 0


def test_replay_window_flush_and_bucket_equal_the_reference():
    win, ref_win = ReplayWindow(capacity=4), ref_adapt.ReplayWindow(capacity=4)
    for i, regime in enumerate([0] * 6 + [1, 1, 2]):
        for w in (win, ref_win):
            w.push({"x": np.float32(i), "y": np.full(2, i, np.int32)}, regime=regime)
        assert len(win) == len(ref_win) and win.regime == ref_win.regime
        for n in (1, 2, 4):
            a, b = win.tail(n), ref_win.tail(n)
            assert set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)
    assert len(win) == 1 and win.tail(4)["x"].tolist() == [8.0]
    for n in range(1, 200):
        for mw, cap in ((4, 16), (8, 64), (3, 50)):
            assert adapt._bucket(n, mw, cap) == ref_adapt._bucket(n, mw, cap)


# --------------------------------------------------------------------------
# the drift world bit for bit
# --------------------------------------------------------------------------

@pytest.mark.parametrize("engine", HOST_ENGINES)
@pytest.mark.parametrize("policy", STATIC + ("a2c",))
@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_drift_simulate_equals_the_reference(name, policy, engine, tiny):
    """A static policy, or an A2C the reference trained and the port
    loaded (frozen, no online), under each schedule on both engines: the
    reference's SimResult bit for bit, adaptation included."""
    if policy == "a2c":
        ref_pol = ref_build_policy("a2c", *tiny.ref).load(tiny.artifacts["a2c"])
        pol = build_policy("a2c", *tiny.port).load(tiny.artifacts["a2c"])
    else:
        ref_pol, pol = ref_build_policy(policy, *tiny.ref), build_policy(policy, *tiny.port)
    kw = dict(n_requests=5000, seed=3)
    a = ref_simulate(*tiny.ref, ref_pol, _trace(True), fleet=RefFleetConfig(slo_s=2.0, engine=engine),
                     schedule=ref_drift.get_schedule(name, **SCHEDULES[name]), **kw)
    b = simulate(*tiny.port, pol, _trace(False), fleet=FleetConfig(slo_s=2.0, engine=engine),
                 schedule=get_schedule(name, **SCHEDULES[name]), **kw)
    assert a.epochs >= 15 and len(a.adaptation["regimes"]) == 3
    assert_same_result(a, b)


def test_drift_changes_the_world(tiny):
    """Regime side effects land: churned devices drop requests and come
    back, the crowd scales arrivals on the epoch clock for every policy."""
    res = simulate(*tiny.port, build_policy("device_only", *tiny.port), _trace(False),
                   n_requests=8000, seed=0, fleet=FleetConfig(slo_s=2.0),
                   schedule=get_schedule("device-churn", leave_at=4, rejoin_at=10))
    alive = dict(zip(res.epoch_log.column("epoch"), res.epoch_log.column("alive")))
    assert alive[3] == 3 and alive[4] == 1 and alive[10] == 3
    assert res.summary["dropped"] > 0
    assert [r["name"] for r in res.adaptation["regimes"]] == ["base", "churn-out", "churn-in"]
    sched = get_schedule("flash-crowd", onset=5, relax=0, scale=2.5)
    arr = [simulate(*tiny.port, build_policy(p, *tiny.port), _trace(False), n_requests=6000,
                    seed=9, schedule=sched).epoch_log.column("arrivals")
           for p in ("device_only", "full_offload")]
    np.testing.assert_array_equal(arr[0], arr[1])
    assert arr[0][8:].mean() > 1.5 * arr[0][:5].mean()


def test_schedule_with_the_execute_backend_raises(tiny):
    cfg, tables = T.make_tpu_env(["qwen2-0.5b"], reduced=True, seq_len=8, device="cpu")
    be = ExecuteBackend.__new__(ExecuteBackend)
    with pytest.raises(ValueError, match="analytical"):
        simulate(cfg, tables, build_policy("device_only", cfg, tables), _trace(False),
                 n_requests=100, backend=be, schedule=get_schedule("link-brownout"))


# --------------------------------------------------------------------------
# one online update and one capture against the reference's
# --------------------------------------------------------------------------

def _learners(tiny, algo, **oc_kw):
    """A learner in each package over the same loaded artifact, windows
    filled with the same 20 random same-regime transitions."""
    ref_pol = ref_build_policy(algo, *tiny.ref).load(tiny.artifacts[algo])
    pol = build_policy(algo, *tiny.port).load(tiny.artifacts[algo])
    oc = dict(algo=algo, window=16, min_window=4, **oc_kw)
    mids = np.arange(3, dtype=np.int32)
    ref_l = ref_adapt.OnlineLearner(ref_pol, RefOnlineConfig(**oc), mids)
    lrn = OnlineLearner(pol, OnlineConfig(**oc), mids)
    cfg, tables = tiny.port
    r = np.random.default_rng(7)
    obs_dim = cfg.n_uavs * cfg.obs_dim_per_uav
    for _ in range(20):
        item = {"obs": r.uniform(0.0, 1.0, obs_dim).astype(np.float32),
                "actions": np.stack([r.integers(0, tables.n_versions, 3),
                                     r.integers(0, tables.n_cuts, 3)], -1).astype(np.int32),
                "logp": r.uniform(-4.0, -0.1, 3).astype(np.float32),
                "reward": r.normal(0.5, 2.0, 3).astype(np.float32),
                "mask": (r.uniform(size=3) > 0.15).astype(np.float32)}
        ref_l.window.push(item, 0)
        lrn.window.push(item, 0)
    return ref_l, lrn


@pytest.mark.parametrize("adapt_trunk", [False, True])
@pytest.mark.parametrize("algo", ["a2c", "ppo"])
def test_one_online_update_matches_the_reference(algo, adapt_trunk, tiny):
    """Same loaded parameters, same window: every parameter after one
    update (two, with ``updates_per_step=2``) within 1e-5 of the
    reference's; the trunk moves only when adapted; the caller's agent is
    never written."""
    ref_l, lrn = _learners(tiny, algo, adapt_trunk=adapt_trunk, gate="always",
                           updates_per_step=2)
    before = {k: v.clone() for k, v in lrn.policy.params.flat_params().items()}
    caller_agent = lrn.policy.params
    for step in (ref_l.step, lrn.step):
        assert step(0, 0.5) is True
    assert lrn.updates == ref_l.updates == 1
    want = ref_flat(ref_l.policy.params)
    got = lrn.policy.params.flat_params()
    for k, p in got.items():
        np.testing.assert_allclose(p.detach().numpy(), want[k], err_msg=k, **TOL)
        trunk = k.startswith(("actor/l1/", "actor/l2/"))
        assert torch.equal(p, before[k]) == (trunk and not adapt_trunk), k
    assert lrn.policy.params is not caller_agent
    for k, p in caller_agent.flat_params().items():
        assert torch.equal(p, before[k]), k
    assert int(lrn._opt_state["step"]) == 2


@pytest.mark.parametrize("eps", [0.0, 0.25])
def test_capture_matches_the_reference(eps, tiny):
    """The captured observation and behavior log-density on measured
    states, greedy and exploratory actions: within 1e-6."""
    ref_l, lrn = _learners(tiny, "a2c")
    ref_l.policy.set_explore(eps)
    lrn.policy.set_explore(eps)
    (ref_cfg, ref_tables), (cfg, tables) = tiny.ref, tiny.port
    r = np.random.default_rng(9)
    lp, pw = cfg.latency, cfg.power
    for i in range(8):
        kw = dict(battery_j=r.uniform(0.0, pw.battery_j, 3),
                  bandwidth=r.uniform(lp.bw_min_bps, lp.bw_max_bps, 3),
                  p_tx=r.uniform(pw.p_tx_min, pw.p_tx_max, 3),
                  queue_jobs=float(r.uniform(0.0, 25.0)), load=r.uniform(0.0, 1.0, 3),
                  model_id=np.arange(3, dtype=np.int32), t=i)
        s = T.measured_state(cfg, tables, **kw)
        acts = lrn.policy.act(s).numpy() if i % 2 else np.stack(
            [r.integers(0, 2, 3), r.integers(0, tables.n_cuts, 3)], -1)
        ref_l.observe_transition(R.measured_state(ref_cfg, ref_tables, **kw),
                                 acts.astype(np.int32), np.zeros(3), np.ones(3), 1)
        lrn.observe_transition(s, acts, np.zeros(3), np.ones(3), 1)
        a, b = ref_l.window.tail(1), lrn.window.tail(1)
        assert b["obs"].dtype == b["logp"].dtype == np.float32
        np.testing.assert_allclose(b["obs"], a["obs"], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(b["logp"], a["logp"], rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(b["actions"], a["actions"])


# --------------------------------------------------------------------------
# the whole online loop against the reference's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("algo,gate", [("a2c", "always"), ("a2c", "drift"),
                                       ("ppo", "always")])
def test_online_loop_equals_the_reference(algo, gate, tiny, capsys):
    """link-brownout(onset=5, recover=0) over the tiny world, from one
    loaded reference artifact, ``explore_eps=0`` (the exploration draws
    are the port's own): the same decision every epoch, the same learner
    counters, the SimResult bit for bit, and the adapted parameters
    within 1e-5 per update taken. A decision that parts is printed with
    its epoch and the two logits' margin."""
    ref_pol = ref_build_policy(algo, *tiny.ref).load(tiny.artifacts[algo])
    pol = build_policy(algo, *tiny.port).load(tiny.artifacts[algo])
    ref_seen, seen = _record_decisions(ref_pol, True), _record_decisions(pol, False)
    oc = dict(algo=algo, gate=gate, explore_eps=0.0, window=16, min_window=4)
    kw = dict(n_requests=6000, seed=4)
    a = ref_simulate(*tiny.ref, ref_pol, _trace(True), fleet=RefFleetConfig(slo_s=2.0),
                     schedule=ref_drift.get_schedule("link-brownout", onset=5, recover=0),
                     online=RefOnlineConfig(**oc), **kw)
    b = simulate(*tiny.port, pol, _trace(False), fleet=FleetConfig(slo_s=2.0),
                 schedule=get_schedule("link-brownout", onset=5, recover=0),
                 online=OnlineConfig(**oc), **kw)
    for epoch, (x, y) in enumerate(zip(ref_seen, seen)):
        if not np.array_equal(x, y):
            print(f"decisions part at epoch {epoch}: reference {x.tolist()}, port {y.tolist()}")
    assert len(seen) == len(ref_seen) == b.epochs
    assert all(np.array_equal(x, y) for x, y in zip(ref_seen, seen))
    assert b.adaptation["online"] == a.adaptation["online"]
    assert b.adaptation["online"]["updates"] > 10
    assert_same_result(a, b)
    want = ref_flat(ref_pol.params)
    for k, p in pol.params.flat_params().items():
        np.testing.assert_allclose(p.detach().numpy(), want[k], err_msg=k,
                                   rtol=1e-5, atol=1e-5 * b.adaptation["online"]["updates"])


# --------------------------------------------------------------------------
# the port's own behaviour
# --------------------------------------------------------------------------

def test_online_adaptation_bit_reproducible_and_hot_swaps(tiny):
    """The full drift+adapt loop (capture, incremental updates, hot-swap,
    exploration from the fleet's generator) is bit-reproducible under a
    fixed seed and updates the policy; the caller's snapshot is untouched,
    and the run leaves the policy serving greedily."""
    cfg, tables = tiny.port
    a2c = build_policy("a2c", cfg, tables, episodes=2)
    a2c.train(seed=0)
    snap = a2c.params
    snap_values = {k: v.clone() for k, v in snap.flat_params().items()}
    kw = dict(n_requests=6000, seed=4, fleet=FleetConfig(slo_s=2.0),
              schedule=get_schedule("link-brownout", onset=5, recover=0),
              online=OnlineConfig(algo="a2c", gate="always", window=16, min_window=4))
    r1 = simulate(cfg, tables, a2c, _trace(False), **kw)
    p1 = {k: v.clone() for k, v in a2c.params.flat_params().items()}
    assert a2c.params is not snap
    a2c.set_params(snap)
    r2 = simulate(cfg, tables, a2c, _trace(False), **kw)
    p2 = a2c.params.flat_params()
    a2c.set_params(snap)
    assert r1.summary == r2.summary and r1.adaptation == r2.adaptation
    assert r1.adaptation["online"]["updates"] > 0
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    assert any(not torch.equal(p1[k], snap_values[k]) for k in p1)
    assert all(torch.equal(v, snap_values[k]) for k, v in snap.flat_params().items())
    assert a2c.explore == 0.0


def test_online_ppo_objective_runs_and_is_deterministic(tiny):
    cfg, tables = tiny.port
    ppo = build_policy("ppo", cfg, tables, episodes=2)
    ppo.train(seed=0)
    snap = ppo.params
    assert ppo.algo == "ppo"
    kw = dict(n_requests=4000, seed=2, fleet=FleetConfig(slo_s=2.0),
              online=OnlineConfig(algo=ppo.algo, gate="always", window=16, min_window=4))
    r1 = simulate(cfg, tables, ppo, _trace(False), **kw)
    ppo.set_params(snap)
    r2 = simulate(cfg, tables, ppo, _trace(False), **kw)
    ppo.set_params(snap)
    assert r1.adaptation["online"]["updates"] > 0
    assert r1.adaptation["online"]["algo"] == "ppo"
    assert r1.adaptation["schedule"] is None and len(r1.adaptation["regimes"]) == 1
    assert r1.summary == r2.summary


def test_online_requires_a_trainable_policy(tiny):
    pol = build_policy("device_only", *tiny.port)
    with pytest.raises(ValueError, match="trainable"):
        simulate(*tiny.port, pol, _trace(False), n_requests=500, online=OnlineConfig())


# --------------------------------------------------------------------------
# scenarios and the CLI
# --------------------------------------------------------------------------

def test_run_scenario_rejects_bad_online_rosters():
    sc = get_scenario("paper-mmpp-burst")
    with pytest.raises(KeyError, match="not trainable"):
        run_scenario(sc, ("device_only+online",), device="cpu")
    with pytest.raises(KeyError, match="modifier"):
        run_scenario(sc, ("a2c+turbo",), device="cpu")
    assert sc.build_online("ppo") == OnlineConfig(algo="ppo")
    lb = get_scenario("link-brownout")
    assert lb.build_schedule().boundaries == (60, 240)
    assert lb.replace(online_kw={"window": 8}).build_online().window == 8


def test_frozen_sibling_shares_the_pre_drift_agent(tiny, tmp_path):
    """``a2c+online`` and ``a2c`` from one loaded artifact on
    link-brownout (onset moved inside the run): the frozen entry shares
    the agent, which the online run never writes, so the frozen results
    are those of ``a2c`` run alone and equal the reference's; device_only
    matches too, adaptation included."""
    sc = get_scenario("link-brownout").replace(drift_kw={"onset": 6, "recover": 14})
    ref_sc = ref_get_scenario("link-brownout").replace(drift_kw={"onset": 6, "recover": 14})
    pol = ref_build_policy("a2c", *ref_sc.build_env()[:2], episodes=2, batch_envs=2)
    pol.train(seed=0)
    path = pol.save(str(tmp_path / "a2c.npz"))
    kw = dict(n_requests=4000, seeds=(0,), load_policies={"a2c": path})
    both = run_scenario(sc, ("a2c+online", "a2c", "device_only"), device="cpu", **kw)
    alone = run_scenario(sc, ("a2c",), device="cpu", **kw)
    ref = ref_run_scenario(ref_sc, ("a2c", "device_only"), **kw)
    assert both.results["a2c"].loaded_from == both.results["a2c+online"].loaded_from == path
    assert both.results["a2c+online"].adaptation["online"]["updates"] > 0
    for name in ("a2c", "device_only"):
        assert both.results[name].per_seed == ref.results[name].per_seed, name
        assert both.results[name].adaptation == ref.results[name].adaptation, name
    assert alone.results["a2c"].per_seed == both.results["a2c"].per_seed
    assert both.schedule == "link-brownout" and "regime 1 (brownout)" in both.adaptation_table()
    out = both.to_json()
    assert out["schedule"] == "link-brownout" and "adaptation" in out["policies"]["a2c+online"]


@pytest.mark.parametrize("preset", ["link-brownout", "flash-crowd", "battery-cliff",
                                    "device-churn"])
def test_drift_presets_run_through_run_scenario_and_the_cli(preset, tmp_path):
    """Each drift preset's own roster (``+online`` included) at tiny
    ``--requests`` and a 2-update training, through the CLI; the static
    entries equal the reference's run of the same preset."""
    import json
    out = tmp_path / "r.json"
    report = cli.main(["--scenario", preset, "--device", "cpu", "--requests", "1500",
                       "--seeds", "0", "--episodes", "2", "--quiet", "--json", str(out)])
    sc = get_scenario(preset)
    assert list(report.results) == list(sc.policies)
    online = [n for n in sc.policies if n.endswith("+online")]
    assert online and all(report.results[n].adaptation["online"]["algo"] == "a2c"
                          for n in online)
    ref = ref_run_scenario(ref_get_scenario(preset), ("device_only",), n_requests=1500,
                           seeds=(0,))
    assert report.results["device_only"].per_seed == ref.results["device_only"].per_seed
    assert report.results["device_only"].adaptation == ref.results["device_only"].adaptation
    saved = json.loads(out.read_text())
    assert saved["schedule"] == sc.drift


def test_cli_online_and_drift_schedule_flags(capsys):
    """``--drift-schedule`` applies a schedule to a stationary preset,
    ``--online`` adds the adapted twin of every trainable entry, ``-v``
    is accepted; an unknown schedule is refused by name."""
    report = cli.main(["--scenario", "tpu-submesh", "--device", "cpu", "--requests", "1500",
                       "--seeds", "0", "--compare", "ppo,device_only", "--episodes", "2",
                       "--drift-schedule", "link-brownout", "--online", "-v"])
    assert list(report.results) == ["ppo+online", "ppo", "device_only"]
    assert report.schedule == "link-brownout"
    assert report.results["ppo+online"].adaptation["online"]["algo"] == "ppo"
    text = capsys.readouterr().out
    assert "adaptation metrics (per regime)" in text and "ppo+online" in text
    with pytest.raises(SystemExit):
        cli.main(["--scenario", "tpu-submesh", "--device", "cpu", "--drift-schedule", "bogus"])
    assert "link-brownout" in capsys.readouterr().err
