"""repro_torch's controller against repro's on the CPU: the actor-critic
on weights carried across, the return estimators, AdamW, the A2C loss and
its gradients, decide from a reference artifact, the baselines,
resolve_selection, learning, and the closed loop of
``repro_torch.launch.split_serving``. Inputs come from numpy seeds."""
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
from repro.core import actor_critic as ref_net  # noqa: E402
from repro.core import baselines as ref_baselines  # noqa: E402
from repro.obs import traindiag as ref_traindiag  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.policies import A2CPolicy  # noqa: E402

import repro_torch.core as T  # noqa: E402
from repro_torch.checkpointing import load_tree  # noqa: E402
from repro_torch.cluster import build_cluster, get_pool  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import a2c, baselines  # noqa: E402
from repro_torch.core import actor_critic as net  # noqa: E402
from repro_torch.launch import split_serving  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.policies import build_policy, policy_names  # noqa: E402

SMALL = dict(hidden1=64, hidden2=32, uav_head=16)


def _flat(tree):
    return {"/".join(str(p.key) for p in kp): np.asarray(leaf)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _cluster_envs(devices=3):
    topo = get_topology("near-far", devices, 4)
    return (R.make_paper_env(n_uavs=devices, cluster=ref_build_cluster(
                ref_get_pool("hetero-4"), topo)),
            T.make_paper_env(n_uavs=devices, device="cpu", cluster=build_cluster(
                get_pool("hetero-4"), topo)))


def _envs(kind):
    if kind == "paper":
        return R.make_paper_env(), T.make_paper_env(device="cpu")
    if kind == "qwen2-0.5b":
        return (R.make_tpu_env(["qwen2-0.5b"], seq_len=512),
                T.make_tpu_env(["qwen2-0.5b"], seq_len=512, device="cpu"))
    return _cluster_envs()


def _states(ref_env, port_env, n_states, seed):
    """``n_states`` measured states from a numpy seed, as the reference's
    and the port's ``measured_state`` build them."""
    (ref_cfg, ref_tables), (cfg, tables) = ref_env, port_env
    r = np.random.default_rng(seed)
    n, lp, pw = cfg.n_uavs, cfg.latency, cfg.power
    out = []
    for _ in range(n_states):
        kw = dict(battery_j=r.uniform(0.0, pw.battery_j, n),
                  bandwidth=r.uniform(lp.bw_min_bps, lp.bw_max_bps, n),
                  p_tx=r.uniform(pw.p_tx_min, pw.p_tx_max, n),
                  queue_jobs=(r.uniform(0.0, 15.0, cfg.n_servers) if cfg.cluster
                              else float(r.uniform(0.0, 15.0))),
                  load=r.uniform(0.0, 1.0, n),
                  model_id=r.integers(0, tables.n_models, n))
        out.append((R.measured_state(ref_cfg, ref_tables, **kw),
                    T.measured_state(cfg, tables, **kw)))
    return out


def _agents(ref_env, port_env, tmp_path, widths=None, seed=0):
    """A reference agent saved as ``TrainablePolicy.save`` writes it, and
    the port's agent loaded from that file."""
    (ref_cfg, ref_tables), (cfg, tables) = ref_env, port_env
    policy = A2CPolicy(ref_cfg, ref_tables, **(widths or {}))
    policy.params = R.init_agent(ref_cfg, ref_tables, policy.config, jax.random.key(seed))
    path = policy.save(str(tmp_path / f"a2c{seed}.npz"))
    flat, meta = load_tree(path)
    assert meta["policy"] == "a2c"
    agent = net.load_agent(cfg, tables, a2c.A2CConfig(**(widths or {})), flat)
    return policy.params, agent


# --------------------------------------------------------------------------
# networks, returns, optimizer, loss
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["paper", "cluster"])
def test_networks_match_the_reference_on_carried_weights(kind, tmp_path):
    ref_env, port_env = _envs(kind)
    (cfg, tables) = port_env
    params, agent = _agents(ref_env, port_env, tmp_path)
    assert set(agent.flat_params()) == set(_flat(params))
    for k, v in agent.flat_params().items():
        np.testing.assert_array_equal(v.detach().numpy(), _flat(params)[k])
    r = np.random.default_rng(0)
    n, F = cfg.n_uavs, cfg.obs_dim_per_uav
    ref_actor, ref_critic, ref_greedy, ref_logp = (
        jax.jit(f) for f in (ref_net.actor_apply, ref_net.critic_apply,
                             ref_net.greedy_actions, ref_net.device_logp_entropy))
    for _ in range(4):
        obs = r.uniform(-1, 2, n * F).astype(np.float32)
        valid = (r.uniform(size=(n, tables.n_versions)) > 0.3).astype(np.float32)
        valid[:, 0] = 1.0
        cols = [r.integers(0, tables.n_versions, n), r.integers(0, tables.n_cuts, n)]
        if cfg.cluster is not None:
            cols.append(r.integers(0, cfg.n_servers, n))
        acts = np.stack(cols, -1).astype(np.int32)
        ob, va, ac_ = torch.tensor(obs), torch.tensor(valid), torch.tensor(acts).long()
        with torch.no_grad():
            for got, want in zip(net.actor_apply(agent, ob),
                                 ref_actor(params, obs)):
                assert (got is None) == (want is None)
                if got is not None:
                    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                               rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(net.critic_apply(agent, ob).numpy(),
                                       np.asarray(ref_critic(params, obs)),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_array_equal(
                net.greedy_actions(agent, ob, va).numpy(),
                np.asarray(ref_greedy(params, obs, valid)))
            for got, want in zip(net.device_logp_entropy(agent, ob, ac_, va),
                                 ref_logp(params, obs, acts, valid)):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-5, atol=1e-5)
            # a leading batch axis computes each row as alone
            lv, _, _ = net.actor_apply(agent, torch.stack([ob, ob * 0.5]))
            torch.testing.assert_close(lv[0], net.actor_apply(agent, ob)[0])


def test_sampling_draws_valid_actions_from_the_generator():
    cfg, tables = T.make_paper_env(device="cpu")
    agent = net.init_agent(cfg, tables, a2c.A2CConfig(**SMALL),
                           torch.Generator().manual_seed(0))
    obs = torch.rand(5, cfg.n_uavs * cfg.obs_dim_per_uav)
    valid = torch.tensor([[1.0, 0.0], [1.0, 1.0], [1.0, 0.0]]).expand(5, 3, 2)
    a1 = net.sample_actions(agent, obs, valid, torch.Generator().manual_seed(4))
    a2 = net.sample_actions(agent, obs, valid, torch.Generator().manual_seed(4))
    assert torch.equal(a1, a2) and a1.shape == (5, 3, 2)
    assert bool((a1[:, [0, 2], 0] == 0).all()) and int(a1[..., 1].max()) < tables.n_cuts
    # fan-in normal weights, zero biases
    w = agent.flat_params()["actor/l1/w"].detach()
    assert abs(float(w.std()) * w.shape[0] ** 0.5 - 1.0) < 0.05
    assert float(agent.flat_params()["actor/l1/b"].detach().abs().max()) == 0.0


def test_return_estimators_match_the_reference():
    r = np.random.default_rng(0)
    rew = r.normal(size=(12, 3)).astype(np.float32)
    val = r.normal(size=(12, 3)).astype(np.float32)
    boot = r.normal(size=3).astype(np.float32)
    np.testing.assert_allclose(
        net.discounted_returns(torch.tensor(rew), torch.tensor(boot), 0.95).numpy(),
        np.asarray(jax.vmap(ref_net.discounted_returns, (1, 0, None), 1)(rew, boot, 0.95)),
        rtol=1e-6, atol=1e-6)
    got = net.gae(torch.tensor(rew), torch.tensor(val), torch.tensor(boot), 0.95, 0.9)
    want = jax.vmap(ref_net.gae, (1, 1, 0, None, None), 1)(rew, val, boot, 0.95, 0.9)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cfg", [
    adamw.AdamWConfig(lr=7e-4, weight_decay=0.0, warmup_steps=0, total_steps=300,
                      grad_clip=1.0, min_lr_ratio=1.0),
    adamw.AdamWConfig(warmup_steps=2, total_steps=5, grad_clip=0.5)],
    ids=["a2c", "decay-warmup-cosine"])
def test_adamw_update_matches_the_reference(cfg):
    r = np.random.default_rng(0)
    shapes = {"a/w": (7, 5), "a/b": (5,), "c": (3, 2, 4)}
    params = {k: r.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    ref_cfg = ref_adamw.AdamWConfig(**dataclasses.asdict(cfg))
    ref_p = {k: jnp.asarray(v) for k, v in params.items()}
    ref_state = ref_adamw.adamw_init(ref_p)
    ref_update = jax.jit(lambda *a: ref_adamw.adamw_update(ref_cfg, *a))
    p = {k: torch.tensor(v) for k, v in params.items()}
    state = adamw.adamw_init(p)
    for step in range(3):
        grads = {k: (r.normal(size=s) * 3).astype(np.float32) for k, s in shapes.items()}
        ref_p, ref_state, ref_m = ref_update(
            ref_p, {k: jnp.asarray(v) for k, v in grads.items()}, ref_state)
        p, state, m = adamw.adamw_update(cfg, p, {k: torch.tensor(v) for k, v in grads.items()},
                                         state)
        assert int(state["step"]) == int(ref_state["step"]) == step + 1
        for k in shapes:
            np.testing.assert_allclose(p[k].numpy(), np.asarray(ref_p[k]), rtol=1e-6, atol=1e-6)
            for mv in ("m", "v"):
                np.testing.assert_allclose(state[mv][k].numpy(), np.asarray(ref_state[mv][k]),
                                           rtol=1e-6, atol=1e-6)
        for key in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(ref_m[key]), rtol=1e-6)


def _ref_a2c_loss(params, traj, rets, ac, n):
    """The reference's A2C loss (repro/core/a2c.py, loss_fn), from its
    actor_critic and traindiag."""
    flat = jax.tree.map(lambda x: x.reshape((-1,) + x.shape[2:]), traj)

    def per_step(obs, actions, valid):
        lp, ent = ref_net.logp_entropy(params, obs, actions, valid)
        return lp, ent, ref_net.critic_apply(params, obs)
    lp, ent, values = jax.vmap(per_step)(flat["obs"], flat["actions"], flat["valid"])
    lp = lp.reshape(rets.shape)
    values = values.reshape(rets.shape)
    adv = rets - values
    adv_n = ((adv - jnp.mean(adv, axis=1, keepdims=True))
             / (jnp.std(adv, axis=1, keepdims=True) + 1e-6))
    actor_loss = -jnp.mean(lp * jax.lax.stop_gradient(adv_n))
    critic_loss = 0.5 * jnp.mean(jnp.square(adv))
    loss = actor_loss + ac.value_coef * critic_loss - ac.entropy_coef * jnp.mean(ent)
    return loss, {"actor_loss": actor_loss, "critic_loss": critic_loss,
                  "entropy": jnp.mean(ent) / n, "adv_mean": jnp.mean(adv),
                  "adv_std": jnp.std(adv),
                  "explained_var": ref_traindiag.explained_variance(rets, values)}


@pytest.mark.parametrize("kind", ["paper", "cluster"])
def test_a2c_loss_and_gradients_match_the_reference(kind, tmp_path):
    """On a fixed trajectory: the loss, its diagnostics and every gradient
    within 1e-5 relative of ``jax.value_and_grad`` of the reference's."""
    ref_env, port_env = _envs(kind)
    cfg, tables = port_env
    params, agent = _agents(ref_env, port_env, tmp_path, widths=SMALL)
    ac = a2c.A2CConfig(**SMALL)
    r = np.random.default_rng(1)
    E, Tn, n, A = 3, 6, cfg.n_uavs, cfg.action_dim
    cols = [r.integers(0, tables.n_versions, (E, Tn, n)), r.integers(0, tables.n_cuts, (E, Tn, n))]
    if A == 3:
        cols.append(r.integers(0, cfg.n_servers, (E, Tn, n)))
    traj = {"obs": r.uniform(0, 1, (E, Tn, n * cfg.obs_dim_per_uav)).astype(np.float32),
            "actions": np.stack(cols, -1).astype(np.int32),
            "valid": np.ones((E, Tn, n, tables.n_versions), np.float32)}
    rets = r.normal(size=(E, Tn)).astype(np.float32) * 2
    ref_fn = jax.jit(jax.value_and_grad(
        lambda p, tr, rt: _ref_a2c_loss(p, tr, rt, R.A2CConfig(**SMALL), n), has_aux=True))
    (ref_loss, ref_stats), ref_grads = ref_fn(params, traj, rets)
    port_traj = {k: torch.tensor(v) for k, v in traj.items()}
    port_traj["actions"] = port_traj["actions"].long()
    loss, stats = a2c.a2c_loss(agent, port_traj, torch.tensor(rets), ac, n)
    flat = agent.flat_params()
    grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-5)
    for k, v in ref_stats.items():
        np.testing.assert_allclose(float(stats[k].detach()), float(v), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    for k, g in _flat(ref_grads).items():
        scale = np.abs(g).max()
        np.testing.assert_allclose(grads[k].numpy(), g, rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=k)


# --------------------------------------------------------------------------
# the controller and the baselines
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["paper", "qwen2-0.5b", "cluster"])
def test_decide_from_a_reference_artifact_matches(kind, tmp_path):
    """A controller saved by the reference (``TrainablePolicy.save``) and
    loaded into the port decides the reference's actions on 32 measured
    states."""
    ref_env, port_env = _envs(kind)
    params, agent = _agents(ref_env, port_env, tmp_path, seed=3)
    ref_decide = jax.jit(lambda p, st: R.decide(p, *ref_env, st))
    for ref_s, s in _states(ref_env, port_env, 32, seed=5):
        for k in ref_s:
            np.testing.assert_array_equal(s[k].numpy(), np.asarray(ref_s[k]), err_msg=k)
        np.testing.assert_array_equal(
            T.decide(agent, port_env[0], port_env[1], s).numpy(),
            np.asarray(ref_decide(params, ref_s)))


@pytest.mark.parametrize("kind", ["paper", "qwen2-0.5b", "cluster"])
def test_baselines_match_the_reference(kind):
    ref_env, port_env = _envs(kind)
    names = ("device_only", "full_offload", "greedy_oracle")
    ref_fns = {fn: jax.jit(lambda st, fn=fn: getattr(ref_baselines, fn)(*ref_env, st))
               for fn in names}
    for ref_s, s in _states(ref_env, port_env, 16, seed=9):
        for fn in names:
            np.testing.assert_array_equal(getattr(baselines, fn)(*port_env, s).numpy(),
                                          np.asarray(ref_fns[fn](ref_s)), err_msg=fn)
    cfg, tables = port_env
    g = torch.Generator().manual_seed(0)
    s = _states(ref_env, port_env, 1, seed=1)[0][1]
    draws = torch.stack([baselines.random_policy(cfg, tables, s, g) for _ in range(200)])
    nv = tables.version_valid[s["model_id"]].sum(-1)
    assert bool((draws[..., 0] < nv).all()) and bool((draws >= 0).all())
    assert int(draws[..., 1].max()) == tables.n_cuts - 1


def test_policy_registry():
    assert policy_names() == ("a2c", "device_only", "full_offload", "greedy_oracle",
                              "join_shortest_queue", "local_only", "ppo", "random",
                              "round_robin")
    with pytest.raises(KeyError, match="greedy_oracle"):
        build_policy("no-such-policy", *T.make_paper_env(device="cpu"))


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "recurrentgemma-2b"])
def test_resolve_selection_matches_the_reference(arch):
    ref_cfg, cfg = ref_get_config(arch), get_config(arch)
    ref_prof = R.transformer_profile(ref_cfg)
    prof = T.transformer_profile(cfg)
    for j in range(len(prof.versions) + 1):
        for k in range(len(prof.versions[0].cut_points) + 1):
            assert T.resolve_selection(cfg, prof, j, k) \
                == R.resolve_selection(ref_cfg, ref_prof, j, k), (j, k)


def test_controller_entry_points_raise_without_cuda_unless_cpu_is_named(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda **kw: T.make_paper_env(**kw),
                 lambda **kw: T.make_tpu_env(["qwen2-0.5b"], reduced=True, **kw)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
        cfg, tables = make(device="cpu")
        assert tables.device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        split_serving.build(episodes=1, reduced=True, log=lambda *a: None)


def test_core_exports_the_reference_names():
    want = set(R.__all__) - {"PPOConfig"}
    assert want <= set(T.__all__)
    for name in T.__all__:
        assert getattr(T, name) is not None
    cfg, tables = T.make_paper_env(device="cpu")
    assert T.make_task_sampler(cfg, None, 0) is None
    with pytest.raises(ValueError, match="peak_rps"):
        T.make_task_sampler(cfg, object(), 0)


# --------------------------------------------------------------------------
# learning, evaluation, the closed loop
# --------------------------------------------------------------------------

def test_a2c_improves_over_training():
    """The reference's acceptance on the paper env (last 15 updates' mean
    reward above the first 15 by 0.05 at 80 episodes), on the mean of three
    seeds: one seed is one draw of a single-episode update, and the port
    draws other numbers than the reference."""
    cfg, tables = T.make_paper_env(device="cpu")
    gains = []
    for seed in range(3):
        _, hist = T.train_agent(cfg, tables, T.A2CConfig(episodes=80), seed=seed)
        r = np.array([h["mean_reward"] for h in hist])
        assert np.isfinite([h["loss"] for h in hist]).all()
        gains.append(r[-15:].mean() - r[:15].mean())
    assert np.mean(gains) > 0.05, gains


def test_train_episode_is_deterministic():
    cfg, tables = T.make_paper_env(device="cpu")
    ac = T.A2CConfig(episodes=2)
    agent = T.init_agent(cfg, tables, ac, torch.Generator().manual_seed(0))
    opt = adamw.adamw_init(agent.flat_params())
    step = T.make_train_episode(cfg, tables, ac)
    out = []
    for _ in range(2):
        clone = net.Agent({k: v.detach().clone() for k, v in agent.flat_params().items()})
        clone, _, stats = step(clone, opt, torch.Generator().manual_seed(7))
        out.append((float(stats["loss"]),
                    {k: v.detach().numpy() for k, v in clone.flat_params().items()}))
    assert out[0][0] == out[1][0]
    for k in out[0][1]:
        np.testing.assert_array_equal(out[0][1][k], out[1][1][k])
    assert set(stats) >= {"loss", "mean_reward", "entropy", "approx_kl", "grad_norm",
                          "explained_var", "adv_mean", "adv_std", "final_battery"}


def test_batched_cluster_training_with_task_sequences():
    """batch_envs > 1 in cluster mode (the server head), with each env's
    offered load injected through ``task_seq``: the rollout installs row t
    at slot t, and an update runs with finite stats."""
    _, (cfg, tables) = _cluster_envs()
    cfg = dataclasses.replace(cfg, episode_len=5)
    ac = a2c.A2CConfig(batch_envs=2, **SMALL)
    g = torch.Generator().manual_seed(0)
    agent = T.init_agent(cfg, tables, ac, g)
    seq = torch.rand(2, cfg.episode_len, cfg.n_uavs, generator=g)
    state_T, traj, boot = net.run_batched_episodes(cfg, tables, net.make_rollout(cfg, tables),
                                                   agent, g, 2, task_seq=seq)
    assert torch.equal(state_T["task"], seq[:, -1])
    assert traj["actions"].shape == (2, cfg.episode_len, cfg.n_uavs, 3)
    assert boot.shape == (2,) and state_T["queue"].shape == (2, cfg.n_servers)
    step = T.make_train_episode(cfg, tables, ac)
    _, opt, stats = step(agent, adamw.adamw_init(agent.flat_params()), g, seq.numpy())
    assert int(opt["step"]) == 1
    assert all(bool(torch.isfinite(v)) for v in stats.values())


def _slot_ops(cfg, tables, agent, state, g):
    """The ATen ops one rollout slot dispatches (each a launch on a card),
    by name."""
    import collections

    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[str(func)] += 1
            return func(*args, **(kwargs or {}))

    with torch.no_grad(), Count() as c:
        obs = T.observe(cfg, tables, state).flatten(1)
        actions = net.sample_actions(agent, obs, net.valid_versions(tables, state), g)
        T.env_step(cfg, tables, state, actions, g)
    return c.ops


def test_a_rollout_slot_is_a_few_hundred_small_ops():
    """What bounds an A2C update on the card: every op of a slot (observe,
    the actor, sampling, pricing, the env's dynamics) is dispatched on its
    own, whatever the number of envs."""
    cfg, tables = T.make_paper_env(device="cpu")
    g = torch.Generator().manual_seed(0)
    agent = T.init_agent(cfg, tables, T.A2CConfig(**SMALL), g)
    one, eight = (sum(_slot_ops(cfg, tables, agent,
                                T.env_reset(cfg, tables, g, batch_shape=(E,)), g).values())
                  for E in (1, 8))
    assert one == eight and 100 < one < 300, (one, eight)


def test_greedy_beats_random():
    cfg, tables = T.make_paper_env(device="cpu")
    res = {name: T.evaluate_policy(cfg, tables, build_policy(name, cfg, tables),
                                   torch.Generator().manual_seed(3), episodes=1)
           for name in ("greedy_oracle", "random")}
    assert res["greedy_oracle"]["reward"] > res["random"]["reward"]
    hist = res["random"]["selection_hist"]
    assert hist.shape == (3, 2, 4)
    assert hist.sum() == res["random"]["alive_slots"] * cfg.episode_len
    with pytest.raises(ValueError, match="different"):
        T.evaluate_policy(cfg, tables, build_policy("random", *T.make_paper_env(device="cpu")),
                          torch.Generator(), episodes=1)


def test_split_serving_loop_measures_the_tables_bytes():
    """The closed loop at the reduced size on the CPU: every slot's
    measured bytes equal the table's (a terminal cut, device-complete in
    the env, is flagged instead), and every non-terminal (version, cut) of
    the table measures its priced bytes through the same slot code."""
    loop = split_serving.build(episodes=3, batch=2, seq=32, device="cpu", reduced=True,
                               log=lambda *a: None)
    records = split_serving.serve(loop, 3, torch.Generator().manual_seed(7),
                                  log=lambda *a: None)
    for rec in records:
        assert rec["logits_finite"] and rec["logits_shape"] == (2, 32, loop.cfg.vocab_size)
        assert rec["terminal"] or rec["measured_bytes"] == rec["expected_bytes"], rec
    state = T.env_reset(loop.env_cfg, loop.tables, torch.Generator().manual_seed(0))
    compared = set()
    for j in range(loop.tables.n_versions):
        for k in range(loop.tables.n_cuts):
            rec = split_serving.serve_slot(loop.engine, loop.cfg, loop.profile, loop.env_cfg,
                                           loop.tables, state, torch.tensor([[j, k]]),
                                           loop.batch, loop.cut_bytes)
            assert rec["terminal"] == (k == loop.tables.n_cuts - 1)
            if not rec["terminal"]:
                assert rec["measured_bytes"] == rec["expected_bytes"], rec
                compared.add(rec["version"])
    assert compared == {"bf16", "w8", "w4"}
