"""repro_torch.core against repro.core on the CPU: profiles and tables,
the quantization probe, the pricing core under xp=torch and xp=numpy, and
the EdgeEnv's observation and step. Inputs come from numpy seeds."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as R  # noqa: E402
from repro.cluster import build_cluster as ref_build_cluster  # noqa: E402
from repro.cluster import get_pool as ref_get_pool  # noqa: E402
from repro.cluster import get_topology  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core import pricing as ref_pricing  # noqa: E402
from repro.core import transformer_cost as ref_cost  # noqa: E402
from repro.core.latency import LatencyParams as RefLatencyParams  # noqa: E402
from repro.quant import versions as ref_versions  # noqa: E402

import repro_torch.core as T  # noqa: E402
from repro_torch.cluster import build_cluster, get_pool, pool_names  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import pricing, transformer_cost  # noqa: E402
from repro_torch.core.env import action_breakdown  # noqa: E402
from repro_torch.core.latency import LatencyParams  # noqa: E402
from repro_torch.quant import versions  # noqa: E402

ARCHS = ("qwen2-0.5b", "falcon-mamba-7b", "recurrentgemma-2b")
TOL = 1e-6


def _tables_eq(ref, port):
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(port, f.name)
        if hasattr(a, "shape"):
            a = np.asarray(a)
            assert b.dtype == torch.float32, f.name
            assert a.dtype == np.float32, f.name
            np.testing.assert_array_equal(b.numpy(), a, err_msg=f.name)
        else:
            assert a == b, f.name


def _cluster_pair(devices=4):
    """The reference's cluster and the port's, from the same pool and
    topology."""
    topo = get_topology("near-far", devices, 4)
    ref = ref_build_cluster(ref_get_pool("hetero-4"), topo)
    port = build_cluster(get_pool("hetero-4"), topo)
    return ref, port


def _cluster_envs(devices=4):
    ref_c, port_c = _cluster_pair(devices)
    kw = dict(n_uavs=devices, slot_seconds=10.0, peak_rps=30.0, frames_per_slot=300.0)
    ref = R.make_paper_env(latency=RefLatencyParams(server_flops=devices * 0.55e12,
                                                    bw_max_bps=1e9),
                           cluster=ref_c, **kw)
    port = T.make_paper_env(latency=LatencyParams(server_flops=devices * 0.55e12,
                                                  bw_max_bps=1e9),
                            cluster=port_c, device="cpu", **kw)
    return ref, port


ENVS = {
    "paper": (lambda: R.make_paper_env(),
              lambda: T.make_paper_env(device="cpu")),
    "qwen2-0.5b": (lambda: R.make_tpu_env(["qwen2-0.5b"]),
                   lambda: T.make_tpu_env(["qwen2-0.5b"], device="cpu")),
    "falcon-mamba-7b": (lambda: R.make_tpu_env(["falcon-mamba-7b"]),
                        lambda: T.make_tpu_env(["falcon-mamba-7b"], device="cpu")),
    "recurrentgemma-2b": (lambda: R.make_tpu_env(["recurrentgemma-2b"]),
                          lambda: T.make_tpu_env(["recurrentgemma-2b"], device="cpu")),
    "qwen2-0.5b-reduced": (lambda: R.make_tpu_env(["qwen2-0.5b"], reduced=True),
                           lambda: T.make_tpu_env(["qwen2-0.5b"], reduced=True,
                                                  device="cpu")),
    "qwen2-0.5b-seq512": (lambda: R.make_tpu_env(["qwen2-0.5b"], seq_len=512),
                          lambda: T.make_tpu_env(["qwen2-0.5b"], seq_len=512,
                                                 device="cpu")),
}


# --------------------------------------------------------------------------
# the version registry, the probe, costs, profiles and tables
# --------------------------------------------------------------------------

def test_probe_constants_equal_the_reference():
    for bits in ((8, 8), (4, 0), (16, 0)):
        assert versions.relative_quant_error(*bits) == ref_versions.relative_quant_error(*bits)
    with pytest.raises(ValueError, match="probe"):
        versions.relative_quant_error(8, 0)
    with pytest.raises(ValueError, match="probe"):
        versions.relative_quant_error(8, 8, seed=1)


def test_version_registry_matches_the_reference():
    ref, port = ref_versions.list_versions(), versions.list_versions()
    assert list(port) == list(ref)
    for name, rv in ref.items():
        pv = port[name]
        for attr in ("mode", "bytes_per_param", "act_itemsize", "matmul_cost_scale"):
            assert getattr(pv, attr) == getattr(rv, attr), (name, attr)
        for frac in (1.0, 0.37):
            assert versions.accuracy_proxy(pv, dense_frac=frac) \
                == ref_versions.accuracy_proxy(rv, dense_frac=frac)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_transformer_cost_matches_the_reference(arch, reduced):
    ref, port = ref_get_config(arch), get_config(arch)
    if reduced:
        ref, port = ref.reduced(), port.reduced()
    assert port.layer_kinds() == ref.layer_kinds()
    assert port.pdtype.itemsize == ref.pdtype.itemsize == 4
    assert port.cdtype.itemsize == ref.cdtype.itemsize == 4
    for fn in ("block_params", "block_dense_flops"):
        assert getattr(transformer_cost, fn)(port) == getattr(ref_cost, fn)(ref)
    for ctx in (None, 512):
        assert transformer_cost.block_flops_per_token(port, ctx) \
            == ref_cost.block_flops_per_token(ref, ctx)


@pytest.mark.parametrize("env", list(ENVS))
def test_profile_tables_equal_the_reference(env):
    (ref_cfg, ref_tables), (cfg, tables) = (f() for f in ENVS[env])
    _tables_eq(ref_tables, tables)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)


def test_cluster_params_and_pools_equal_the_reference():
    from repro.cluster import pool_names as ref_pool_names
    assert pool_names() == ref_pool_names()
    for name in pool_names():
        assert [dataclasses.asdict(s) for s in get_pool(name)] \
            == [dataclasses.asdict(s) for s in ref_get_pool(name)]
    ref, port = _cluster_pair()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    lp = LatencyParams()
    for xp in (np, torch):
        for a, b in zip(port.nominal(lp, xp), ref.nominal(RefLatencyParams(), np)):
            np.testing.assert_allclose(np.asarray(a), b, rtol=1e-7)
    with pytest.raises(KeyError, match="hetero-4"):
        get_pool("no-such-pool")


# --------------------------------------------------------------------------
# pricing
# --------------------------------------------------------------------------

def _random_view_actions(cfg, tables, seed, n, cluster=False):
    r = np.random.default_rng(seed)
    lp, pw = cfg.latency, cfg.power
    S = cfg.n_servers
    view = ref_pricing.StateView(
        model_id=r.integers(0, tables.n_models, n).astype(np.int32),
        bandwidth=r.uniform(lp.bw_min_bps, lp.bw_max_bps, n).astype(np.float32),
        p_tx=r.uniform(pw.p_tx_min, pw.p_tx_max, n).astype(np.float32),
        queue=(r.uniform(0.0, 12.0, S).astype(np.float32) if cluster
               else np.float32(r.uniform(0.0, 12.0))),
        load=r.uniform(0.0, 1.0, n).astype(np.float32))
    cols = [r.integers(0, tables.n_versions, n), r.integers(0, tables.n_cuts, n)]
    if cluster:
        cols.append(r.integers(0, S, n))
    return view, np.stack(cols, axis=-1).astype(np.int32)


def _port_view(view, xp):
    """The reference's numpy view as the port's, in ``xp``; the optional
    cluster fields stay None."""
    if xp is np:
        return pricing.StateView(**dataclasses.asdict(view))
    kw = {f.name: None if getattr(view, f.name) is None
          else torch.as_tensor(getattr(view, f.name))
          for f in dataclasses.fields(view)}
    kw["model_id"] = kw["model_id"].long()
    return pricing.StateView(**kw)


def _assert_breakdowns_match(ref, port):
    for f in dataclasses.fields(ref_pricing.PricingBreakdown):
        x = np.asarray(getattr(ref, f.name))
        y = getattr(port, f.name)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert x.shape == y.shape, f.name
        if f.name == "offloaded":
            np.testing.assert_array_equal(y, x, err_msg=f.name)
        else:
            np.testing.assert_allclose(y, x, rtol=TOL, atol=TOL, err_msg=f.name)


def _price_both(ref_env, port_env, view, actions, xp):
    (ref_cfg, ref_tables), (cfg, tables) = ref_env, port_env
    ref = ref_pricing.price_actions(ref_cfg, ref_pricing.numpy_tables(ref_tables), view,
                                    actions, xp=np)
    if xp is np:
        port = pricing.price_actions(cfg, pricing.numpy_tables(tables), _port_view(view, np),
                                     actions, xp=np)
    else:
        port = pricing.price_actions(cfg, tables, _port_view(view, torch),
                                     torch.as_tensor(actions).long(), xp=torch)
    return ref, port


@pytest.mark.parametrize("xp", [torch, np], ids=["torch", "numpy"])
@pytest.mark.parametrize("env_kind", ["paper", "tpu_ship"])
@pytest.mark.parametrize("n", [1, 16])
def test_pricing_matches_the_reference(env_kind, n, xp):
    """Every PricingBreakdown field within 1e-6 (relative) of the
    reference's numpy path, on the paper env and the weight-shipping
    transformer env, in both of the port's namespaces."""
    if env_kind == "paper":
        ref_env = R.make_paper_env(peak_rps=20.0)
        port_env = T.make_paper_env(peak_rps=20.0, device="cpu")
    else:
        ref_env = R.make_tpu_env(["qwen2-0.5b"], weight_ship_slots=8.0, peak_rps=50.0)
        port_env = T.make_tpu_env(["qwen2-0.5b"], weight_ship_slots=8.0, peak_rps=50.0,
                                  device="cpu")
        assert port_env[0].weight_ship_slots > 0
    for seed in (0, 1):
        view, actions = _random_view_actions(ref_env[0], ref_env[1], seed, n)
        ref, port = _price_both(ref_env, port_env, view, actions, xp)
        _assert_breakdowns_match(ref, port)
        if xp is np:
            assert isinstance(port.t_total, np.ndarray)
        else:
            assert port.t_total.dtype == torch.float32


@pytest.mark.parametrize("xp", [torch, np], ids=["torch", "numpy"])
def test_cluster_pricing_matches_the_reference(xp):
    """Server-column actions on the hetero-4 pool: the link, queue and
    tail terms repriced per chosen server; the None cluster fields of the
    view pass through to the nominal operating point."""
    ref_env, port_env = _cluster_envs()
    for seed in (0, 1, 2):
        view, actions = _random_view_actions(ref_env[0], ref_env[1], seed, 4, cluster=True)
        assert view.srv_flops is None and view.link_scale is None
        ref, port = _price_both(ref_env, port_env, view, actions, xp)
        _assert_breakdowns_match(ref, port)


def test_pricing_prices_a_batch_of_states_as_each_alone():
    """Leading axes: two env states priced at once equal each priced alone
    (classic queue (E,), cluster queue (E, S))."""
    for cfg, tables in (T.make_paper_env(peak_rps=20.0, device="cpu"), _cluster_envs()[1]):
        cluster = cfg.cluster is not None
        views, acts = zip(*(_random_view_actions(cfg, tables, s, cfg.n_uavs, cluster)
                            for s in (3, 4)))
        views = [_port_view(v, torch) for v in views]
        acts = [torch.as_tensor(a).long() for a in acts]
        batched = pricing.StateView(**{
            f.name: torch.stack([getattr(v, f.name) for v in views])
            for f in dataclasses.fields(pricing.StateView)
            if getattr(views[0], f.name) is not None})
        both = pricing.price_actions(cfg, tables, batched, torch.stack(acts))
        for e in range(2):
            one = pricing.price_actions(cfg, tables, views[e], acts[e])
            for f in dataclasses.fields(pricing.PricingBreakdown):
                torch.testing.assert_close(getattr(both, f.name)[e], getattr(one, f.name),
                                           rtol=0, atol=0)


# --------------------------------------------------------------------------
# the env
# --------------------------------------------------------------------------

def _random_state(cfg, tables, seed):
    """A reference env state (jnp) from a numpy seed, and the port's."""
    r = np.random.default_rng(seed)
    n, lp, pw = cfg.n_uavs, cfg.latency, cfg.power
    act = r.uniform(0.0, 0.6, (n, 3)).astype(np.float32)
    ref = {
        "battery_j": jnp.asarray(r.uniform(0.0, pw.battery_j, n).astype(np.float32)
                                 * (r.uniform(size=n) > 0.2)),
        "task": jnp.asarray(r.uniform(0.0, 1.0, n).astype(np.float32)
                            * (r.uniform(size=n) > 0.3)),
        "p_tx": jnp.asarray(r.uniform(pw.p_tx_min, pw.p_tx_max, n).astype(np.float32)),
        "model_id": jnp.asarray(r.integers(0, tables.n_models, n).astype(np.int32)),
        "activity": jnp.asarray(act / np.maximum(act.sum(-1, keepdims=True), 1.0)),
        "bandwidth": jnp.asarray(r.uniform(lp.bw_min_bps, lp.bw_max_bps, n)
                                 .astype(np.float32)),
        "queue": (jnp.float32(r.uniform(0.0, 12.0)) if cfg.cluster is None
                  else jnp.asarray(r.uniform(0.0, 12.0, cfg.n_servers).astype(np.float32))),
        "t": jnp.int32(5),
    }
    port = {k: torch.tensor(np.array(v)) for k, v in ref.items()}
    port["model_id"] = port["model_id"].long()
    return ref, port


def _actions(cfg, tables, seed):
    r = np.random.default_rng(seed)
    n = cfg.n_uavs
    cols = [r.integers(0, tables.n_versions, n), r.integers(0, tables.n_cuts, n)]
    if cfg.cluster is not None:
        cols.append(r.integers(0, cfg.n_servers, n))
    return np.stack(cols, -1).astype(np.int32)


ENV_STEP_CASES = ("paper", "qwen2-0.5b", "cluster")


def _env_pair(kind):
    if kind == "cluster":
        return _cluster_envs()
    return ENVS[kind][0](), ENVS[kind][1]()


@pytest.mark.parametrize("kind", ENV_STEP_CASES)
def test_observe_matches_the_reference(kind):
    (ref_cfg, ref_tables), (cfg, tables) = _env_pair(kind)
    for seed in range(4):
        ref_s, s = _random_state(ref_cfg, ref_tables, seed)
        np.testing.assert_array_equal(T.observe(cfg, tables, s).numpy(),
                                      np.asarray(R.observe(ref_cfg, ref_tables, ref_s)))


@pytest.mark.parametrize("kind", ENV_STEP_CASES)
def test_env_step_matches_the_reference(kind):
    """With the arrivals and the next task injected, the step's reward,
    every info field, the battery, the queue and the task agree within
    1e-6; the random-walk fields (the port's own draws) stay in their
    clip ranges."""
    (ref_cfg, ref_tables), (cfg, tables) = _env_pair(kind)
    g = torch.Generator().manual_seed(0)
    lp, pw = cfg.latency, cfg.power
    for seed in range(4):
        ref_s, s = _random_state(ref_cfg, ref_tables, seed)
        a = _actions(ref_cfg, ref_tables, seed)
        r = np.random.default_rng(100 + seed)
        arrivals = float(r.poisson(4.0))
        nxt = r.uniform(-0.2, 1.2, cfg.n_uavs).astype(np.float32)
        ref_s2, ref_r, ref_info = R.env_step(ref_cfg, ref_tables, ref_s, jnp.asarray(a),
                                             jax.random.key(seed), arrivals=arrivals,
                                             next_task=nxt)
        s2, rew, info = T.env_step(cfg, tables, s, torch.as_tensor(a).long(), g,
                                   arrivals=arrivals, next_task=nxt)
        np.testing.assert_allclose(rew.numpy(), np.asarray(ref_r), rtol=TOL, atol=TOL)
        assert set(info) == set(ref_info)
        for k in ref_info:
            np.testing.assert_allclose(info[k].numpy(), np.asarray(ref_info[k]),
                                       rtol=TOL, atol=TOL, err_msg=k)
        for k in ("battery_j", "queue", "task", "model_id", "t"):
            np.testing.assert_allclose(s2[k].numpy(), np.asarray(ref_s2[k]),
                                       rtol=TOL, atol=TOL, err_msg=k)
        assert bool(((s2["bandwidth"] >= lp.bw_min_bps)
                     & (s2["bandwidth"] <= lp.bw_max_bps)).all())
        assert bool(((s2["p_tx"] >= pw.p_tx_min) & (s2["p_tx"] <= pw.p_tx_max)).all())
        act = s2["activity"]
        assert bool(((act >= 0) & (act <= 1)).all() and (act.sum(-1) <= 1 + 1e-6).all())


def test_env_reset_and_random_dynamics_stay_in_range():
    cfg, tables = T.make_paper_env(device="cpu")
    g = torch.Generator().manual_seed(1)
    s = T.env_reset(cfg, tables, g, batch_shape=(4,))
    assert s["bandwidth"].shape == (4, 3) and s["queue"].shape == (4,)
    assert torch.equal(s["model_id"], torch.arange(3).expand(4, 3))
    for _ in range(20):
        s, r, info = T.env_step(cfg, tables, s, torch.zeros(4, 3, 2, dtype=torch.long), g)
        assert r.shape == (4,) and info["done"].shape == (4,)
        assert bool((s["queue"] >= 0).all()) and set(s["task"].unique().tolist()) <= {0.0, 1.0}
        assert bool(((s["bandwidth"] >= cfg.latency.bw_min_bps)
                     & (s["bandwidth"] <= cfg.latency.bw_max_bps)).all())


def test_env_step_steps_a_batch_as_each_alone():
    """A batch of two states steps as each alone (deterministic parts,
    arrivals and next task injected)."""
    for (_, _), (cfg, tables) in (_env_pair("paper"), _env_pair("cluster")):
        pairs = [_random_state(cfg, tables, s)[1] for s in (7, 8)]
        acts = [torch.as_tensor(_actions(cfg, tables, s)).long() for s in (7, 8)]
        nxt = torch.rand(2, cfg.n_uavs, generator=torch.Generator().manual_seed(0))
        batched = {k: torch.stack([p[k] for p in pairs]) for k in pairs[0]}
        g = torch.Generator().manual_seed(0)
        s2, r, info = T.env_step(cfg, tables, batched, torch.stack(acts), g,
                                 arrivals=torch.tensor([2.0, 6.0]), next_task=nxt)
        for e in range(2):
            one, re, ie = T.env_step(cfg, tables, pairs[e], acts[e], g,
                                     arrivals=[2.0, 6.0][e], next_task=nxt[e])
            torch.testing.assert_close(r[e], re, rtol=0, atol=0)
            for k in ("battery_j", "queue", "task", "t"):
                torch.testing.assert_close(s2[k][e], one[k], rtol=0, atol=0)
            for k in ("t_total", "e_infer", "acc_s", "lat_s", "en_s", "stab_s"):
                torch.testing.assert_close(info[k][e], ie[k], rtol=0, atol=0)


def test_action_breakdown_matches_the_reference():
    (ref_cfg, ref_tables), (cfg, tables) = _env_pair("qwen2-0.5b")
    ref_s, s = _random_state(ref_cfg, ref_tables, 11)
    a = _actions(ref_cfg, ref_tables, 11)
    _assert_breakdowns_match(R.action_breakdown(ref_cfg, ref_tables, ref_s, jnp.asarray(a)),
                             action_breakdown(cfg, tables, s, torch.as_tensor(a).long()))
