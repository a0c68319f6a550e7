"""PPO agent, the beyond-paper ablation (port of ``repro.core.ppo``).

The paper chooses A2C "for its efficiency and effectiveness"; PPO is the
natural modern baseline to test that choice. Built on the same networks
and batched rollout machinery as A2C (``repro_torch.core.actor_critic``;
the rollout records the behavior policy's logp/value for the clipped
surrogate); adds GAE and ``epochs`` surrogate passes per episode batch.
Each update rolls ``batch_envs`` envs, computes GAE per env, then runs
``epochs`` clipped-surrogate passes over the flattened (E*T) batch, each
one AdamW step (``repro_torch.optim``); the backward runs through
autograd. Advantages are normalized with the population std, as the
reference's ``jnp.std``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import actor_critic as net
from repro_torch.core.a2c import A2CConfig
from repro_torch.core.actor_critic import critic_apply, init_agent, logp_entropy
from repro_torch.core.env import EnvConfig, ProfileTables
from repro_torch.obs import traindiag
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    gamma: float = 0.95
    lam: float = 0.95           # GAE
    clip: float = 0.2
    epochs: int = 4             # surrogate epochs per episode
    lr: float = 3e-4
    entropy_coef: float = 0.01
    value_coef: float = 0.5
    episodes: int = 300         # update steps; each uses batch_envs episodes
    batch_envs: int = 1         # parallel env instances per update
    base: A2CConfig = dataclasses.field(default_factory=A2CConfig)


def ppo_loss(agent, flat, advs, rets, pc: PPOConfig, n_uavs: int):
    """Clipped surrogate over the flattened (E*T,) transition batch ->
    (loss, stats); advantages normalized across the whole batch. KL is
    measured against the recorded behavior logp, per device like the
    entropy."""
    lp, ent = logp_entropy(agent, flat["obs"], flat["actions"], flat["valid"])
    values = critic_apply(agent, flat["obs"])
    ratio = torch.exp(lp - flat["logp"])
    a_n = (advs - torch.mean(advs)) / (torch.std(advs, correction=0) + 1e-6)
    surr = torch.minimum(ratio * a_n, torch.clip(ratio, 1 - pc.clip, 1 + pc.clip) * a_n)
    actor_loss = -torch.mean(surr)
    critic_loss = 0.5 * torch.mean(torch.square(rets - values))
    loss = (actor_loss + pc.value_coef * critic_loss
            - pc.entropy_coef * torch.mean(ent))
    return loss, {"actor_loss": actor_loss, "critic_loss": critic_loss,
                  "entropy": torch.mean(ent) / n_uavs,
                  "approx_kl": traindiag.approx_kl(flat["logp"], lp) / n_uavs,
                  "adv_mean": torch.mean(advs), "adv_std": torch.std(advs, correction=0),
                  "explained_var": traindiag.explained_variance(rets, values)}


def make_update(env_cfg: EnvConfig, pc: PPOConfig):
    """Returns ``update(agent, opt_state, traj, bootstrap) -> (agent,
    opt_state, stats)``: GAE per env over a recorded (E, T) trajectory,
    then ``pc.epochs`` clipped-surrogate AdamW steps. ``agent`` is updated
    in place; the stats are those of the last pass (the policy and critic
    carried forward), 0-d tensors on the agent's device."""
    opt = AdamWConfig(lr=pc.lr, weight_decay=0.0, warmup_steps=0,
                      total_steps=pc.episodes * pc.epochs, grad_clip=1.0,
                      min_lr_ratio=1.0)
    n = env_cfg.n_uavs

    def update(agent, opt_state, traj, bootstrap):
        advs, rets = net.gae(traj["reward"].T, traj["value"].T, bootstrap,
                             pc.gamma, pc.lam)
        flat = {k: v.flatten(0, 1) for k, v in traj.items()}
        advs, rets = advs.T.reshape(-1), rets.T.reshape(-1)
        params = agent.flat_params()
        for _ in range(pc.epochs):
            loss, stats = ppo_loss(agent, flat, advs, rets, pc, n)
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
            with torch.no_grad():
                new, opt_state, om = adamw_update(
                    opt, {k: p.detach() for k, p in params.items()}, grads, opt_state)
                for k, p in params.items():
                    p.copy_(new[k])
        stats = {k: v.detach() for k, v in stats.items()}
        stats.update(loss=loss.detach(), grad_norm=om["grad_norm"],
                     mean_reward=torch.mean(traj["reward"]),
                     episode_reward=torch.mean(torch.sum(traj["reward"], -1)))
        return agent, opt_state, stats

    return update


def make_train_episode(env_cfg: EnvConfig, tables: ProfileTables,
                       pc: PPOConfig, model_ids=None):
    """Returns ``train_episode(agent, opt_state, generator[, task_seq]) ->
    (agent, opt_state, stats)``: one recorded rollout of ``batch_envs``
    envs and one PPO update (``make_update``)."""
    E = max(int(pc.batch_envs), 1)
    rollout = net.make_rollout(env_cfg, tables, record_policy=True)
    update = make_update(env_cfg, pc)

    def train_episode(agent, opt_state, generator, task_seq=None):
        task_seq = net.prepare_task_seq(task_seq, E, tables.device)
        _, traj, bootstrap = net.run_batched_episodes(
            env_cfg, tables, rollout, agent, generator, E,
            model_ids=model_ids, task_seq=task_seq)
        return update(agent, opt_state, traj, bootstrap)

    return train_episode


def train(env_cfg: EnvConfig, tables: ProfileTables, pc: PPOConfig,
          generator: torch.Generator, model_ids=None, log_every: int = 0,
          task_sampler=None):
    """Initialize an agent from ``generator`` (on the tables' device) and
    run ``pc.episodes`` updates. ``task_sampler(episode) -> (episode_len,
    n_uavs)`` offered-load sequences enable trace-driven training exactly
    like ``a2c.train`` (``actor_critic.stack_task_seqs``). Returns (agent,
    history): one dict of floats per update."""
    agent = init_agent(env_cfg, tables, pc.base, generator)
    opt_state = adamw_init(agent.flat_params())
    step = make_train_episode(env_cfg, tables, pc, model_ids=model_ids)
    E = max(int(pc.batch_envs), 1)
    history = []
    for ep in range(pc.episodes):
        seq = None if task_sampler is None else net.stack_task_seqs(task_sampler, ep, E)
        agent, opt_state, stats = step(agent, opt_state, generator, seq)
        # one copy to the host per update
        history.append(dict(zip(stats, torch.stack(list(stats.values())).tolist())))
        if log_every and (ep + 1) % log_every == 0:
            print(f"ppo ep {ep+1:4d} "
                  f"reward={history[-1]['mean_reward']:+.4f}", flush=True)
    return agent, history
