"""repro_torch's PPO ablation against repro's on the CPU: the rollout's
recorded behavior logp/value, one ``train_episode`` update on a
trajectory the reference recorded (loss, stats and parameters within
1e-5), ``stack_task_seqs``, PPO artifacts read both ways, and learning
over three seeds. Inputs come from numpy seeds."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core as R  # noqa: E402
from repro.core import actor_critic as ref_net  # noqa: E402
from repro.core import ppo as ref_ppo  # noqa: E402
from repro.optim import adamw_init as ref_adamw_init  # noqa: E402
from repro.policies import PPOPolicy as RefPPOPolicy  # noqa: E402

import repro_torch.core as T  # noqa: E402
from repro_torch.core import actor_critic as net  # noqa: E402
from repro_torch.core import ppo  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.policies import A2CPolicy, PPOPolicy, build_policy, get_policy_spec  # noqa: E402
from repro_torch.sim.traces import PoissonTrace  # noqa: E402

SMALL = dict(hidden1=64, hidden2=32, uav_head=16)
TOL = dict(rtol=1e-5, atol=1e-5)


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


def _envs():
    kw = dict(n_uavs=3, slot_seconds=10.0, peak_rps=20.0)
    return R.make_paper_env(**kw), T.make_paper_env(device="cpu", **kw)


def test_rollout_records_behavior_logp_and_value():
    """With ``record_policy`` each step's logp (summed over the devices)
    and value are those of the acting agent on the recorded observation
    and actions; without it the trajectory has neither."""
    _, (cfg, tables) = _envs()
    g = torch.Generator().manual_seed(0)
    agent = net.init_agent(cfg, tables, T.A2CConfig(**SMALL), g)
    rollout = net.make_rollout(cfg, tables, record_policy=True)
    _, traj, boot = net.run_batched_episodes(cfg, tables, rollout, agent, g, 3)
    E, L = 3, cfg.episode_len
    assert traj["logp"].shape == traj["value"].shape == (E, L) and boot.shape == (E,)
    with torch.no_grad():        # recomputed step by step, at the rollout's batch shape
        lp = torch.stack([net.logp_entropy(agent, traj["obs"][:, t], traj["actions"][:, t],
                                           traj["valid"][:, t])[0] for t in range(L)], 1)
        v = torch.stack([net.critic_apply(agent, traj["obs"][:, t]) for t in range(L)], 1)
    assert torch.equal(traj["logp"], lp) and torch.equal(traj["value"], v)
    plain = net.make_rollout(cfg, tables)(agent, T.env_reset(cfg, tables, g), g)[1]
    assert "logp" not in plain and "value" not in plain
    assert set(traj) == set(plain) | {"logp", "value"}


def test_stack_task_seqs_equals_the_reference():
    """The episode-index convention A2C and PPO share: episode*E + e."""
    (ref_cfg, _), (cfg, _) = _envs()
    sampler = T.make_task_sampler(cfg, PoissonTrace(rate_rps=12.0), seed=5)
    for E in (1, 3):
        got = net.stack_task_seqs(sampler, 2, E)
        want = np.asarray(ref_net.stack_task_seqs(sampler, 2, E))
        assert got.dtype == np.float32 and got.shape == (E, cfg.episode_len, 3)
        np.testing.assert_array_equal(got.reshape(want.shape), want)


@pytest.mark.parametrize("batch_envs", [1, 3])
def test_ppo_update_on_a_reference_trajectory_matches_the_reference(batch_envs, monkeypatch):
    """The reference records a trajectory (behavior logp and value
    included) and updates on it; the port's ``make_update`` gets the same
    trajectory and the same parameters: loss, every stat and every
    parameter after the ``epochs`` surrogate passes within 1e-5."""
    (ref_cfg, ref_tables), (cfg, tables) = _envs()
    pc_ref = ref_ppo.PPOConfig(episodes=5, batch_envs=batch_envs, base=R.A2CConfig(**SMALL))
    pc = ppo.PPOConfig(episodes=5, batch_envs=batch_envs, base=T.A2CConfig(**SMALL))
    params = ref_net.init_agent(ref_cfg, ref_tables, pc_ref.base, jax.random.key(0))
    rollout = ref_net.make_rollout(ref_cfg, ref_tables, record_policy=True)
    _, traj, boot = jax.jit(lambda p, k: ref_net.run_batched_episodes(
        ref_cfg, ref_tables, rollout, p, k, batch_envs))(params, jax.random.key(1))
    monkeypatch.setattr(ref_net, "run_batched_episodes", lambda *a, **k: (None, traj, boot))
    step = ref_ppo.make_train_episode(ref_cfg, ref_tables, pc_ref)
    ref_params, _, ref_stats = step(params, ref_adamw_init(params), jax.random.key(1))

    agent = net.load_agent(cfg, tables, pc.base, ref_flat(params))
    t_traj = {k: torch.tensor(np.asarray(v)) for k, v in traj.items()}
    t_traj["actions"] = t_traj["actions"].long()
    agent, opt, stats = ppo.make_update(cfg, pc)(
        agent, adamw_init(agent.flat_params()), t_traj, torch.tensor(np.asarray(boot)))
    assert set(stats) == set(ref_stats)
    for k, v in ref_stats.items():
        np.testing.assert_allclose(float(stats[k]), float(v), err_msg=k, **TOL)
    assert int(opt["step"]) == pc.epochs
    want = ref_flat(ref_params)
    for k, p in agent.flat_params().items():
        np.testing.assert_allclose(p.detach().numpy(), want[k], err_msg=k, **TOL)


def test_ppo_train_episode_runs_on_a_trace_and_is_deterministic():
    """``train`` through ``make_task_sampler``: finite stats of the
    reference's keys, and a second run from the same seed repeats the
    first bit for bit."""
    _, (cfg, tables) = _envs()
    pol = PPOPolicy(cfg, tables, episodes=3, batch_envs=2, epochs=2, base=T.A2CConfig(**SMALL))
    trace = PoissonTrace(rate_rps=12.0)
    h1 = pol.train(seed=1, trace=trace)
    a1 = {k: v.clone() for k, v in pol.params.flat_params().items()}
    h2 = pol.train(seed=1, trace=trace)
    assert h1 == h2 and len(h1) == 3
    assert all(np.isfinite(list(h.values())).all() for h in h1)
    assert set(h1[0]) == {"actor_loss", "critic_loss", "entropy", "approx_kl", "adv_mean",
                          "adv_std", "explained_var", "loss", "grad_norm", "mean_reward",
                          "episode_reward"}
    for k, v in pol.params.flat_params().items():
        assert torch.equal(v, a1[k]), k


def test_ppo_artifacts_read_both_ways(tmp_path):
    """A reference-trained PPO loaded into the port decides the
    reference's actions on 16 measured states, and a port-trained PPO
    saved by the port does the same in the reference."""
    (ref_cfg, ref_tables), (cfg, tables) = _envs()
    base_ref, base = R.A2CConfig(**SMALL), T.A2CConfig(**SMALL)
    ref = RefPPOPolicy(ref_cfg, ref_tables, episodes=2, base=base_ref)
    ref.train(seed=0)
    path = ref.save(str(tmp_path / "ref.npz"))
    port = build_policy("ppo", cfg, tables, base=base).load(path)
    mine = PPOPolicy(cfg, tables, episodes=2, base=base)
    mine.train(seed=0)
    ref_mine = RefPPOPolicy(ref_cfg, ref_tables, base=base_ref).load(
        mine.save(str(tmp_path / "port.npz")))
    r = np.random.default_rng(3)
    lp, pw = cfg.latency, cfg.power
    ref_act, ref_mine_act = jax.jit(ref.act), jax.jit(ref_mine.act)
    for _ in range(16):
        kw = dict(battery_j=r.uniform(0.0, pw.battery_j, 3),
                  bandwidth=r.uniform(lp.bw_min_bps, lp.bw_max_bps, 3),
                  p_tx=r.uniform(pw.p_tx_min, pw.p_tx_max, 3),
                  queue_jobs=float(r.uniform(0.0, 25.0)), load=r.uniform(0.0, 1.0, 3))
        s, ref_s = T.measured_state(cfg, tables, **kw), R.measured_state(ref_cfg, ref_tables, **kw)
        np.testing.assert_array_equal(port.act(s).numpy(), np.asarray(ref_act(ref_s)))
        np.testing.assert_array_equal(mine.act(s).numpy(), np.asarray(ref_mine_act(ref_s)))
    with pytest.raises(ValueError, match="ppo"):
        A2CPolicy(cfg, tables, **SMALL).load(path)


def test_ppo_registry_and_objectives():
    spec = get_policy_spec("ppo")
    assert spec.trainable
    _, (cfg, tables) = _envs()
    p, a = build_policy("ppo", cfg, tables), build_policy("a2c", cfg, tables)
    assert (p.name, p.algo, a.algo) == ("ppo", "ppo", "a2c")
    assert isinstance(p.config, ppo.PPOConfig) and p.config == ppo.PPOConfig()
    assert dataclasses.asdict(ppo.PPOConfig()) == dataclasses.asdict(ref_ppo.PPOConfig())


def test_ppo_improves_over_training():
    """The port's A2C learning rule on PPO: last 15 updates' mean reward
    above the first 15, on the mean of seeds 0-2, by 0.05 at 80 episodes
    on the paper env. The port's draws are not the reference's, so one
    seed is one draw of the algorithm."""
    cfg, tables = T.make_paper_env(device="cpu")
    gains = []
    for seed in range(3):
        _, hist = ppo.train(cfg, tables, ppo.PPOConfig(episodes=80),
                            torch.Generator().manual_seed(seed))
        r = np.array([h["mean_reward"] for h in hist])
        assert np.isfinite([h["loss"] for h in hist]).all()
        gains.append(r[-15:].mean() - r[:15].mean())
    assert np.mean(gains) > 0.05, gains
