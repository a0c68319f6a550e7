"""Advantage Actor-Critic (A2C) agent, paper Sec. II-C/D (port of
``repro.core.a2c``).

Networks follow the paper: the critic has two fully connected layers of
512 and 256 features; the actor adapts the Multi-Discrete action structure
with an extra shared 128-wide layer per UAV device feeding the (version,
cut-point) logit pairs (``repro_torch.core.actor_critic``).

Training is episodic: one ``train_episode`` rolls ``batch_envs`` env
instances for ``episode_len`` slots along a leading batch axis, then
applies one mean-gradient A2C update (n-step discounted returns, per-env
advantage normalization, entropy bonus) with the reference's AdamW
(``repro_torch.optim``). The backward runs through autograd.
``batch_envs=1`` is the paper's single-episode update.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import actor_critic as net
from repro_torch.core.actor_critic import (actor_apply, critic_apply,  # noqa: F401
                                           greedy_actions, init_agent,
                                           logp_entropy, plan_agent,
                                           sample_actions)
from repro_torch.core.env import EnvConfig, ProfileTables
from repro_torch.obs import traindiag
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update


@dataclasses.dataclass(frozen=True)
class A2CConfig:
    gamma: float = 0.95
    lr: float = 7e-4
    entropy_coef: float = 0.01
    value_coef: float = 0.5
    episodes: int = 300         # update steps; each uses batch_envs episodes
    batch_envs: int = 1         # parallel env instances per update
    hidden1: int = 512      # paper
    hidden2: int = 256      # paper
    uav_head: int = 128     # paper: shared per-UAV layer


def a2c_loss(agent, traj, rets, ac: A2CConfig, n_uavs: int):
    """Mean A2C loss over the (E, T) batch of ``traj`` and its returns
    ``rets`` (E, T) -> (loss, stats). The networks run over one flat
    (E*T,) sample batch; the advantage baseline is normalized per env over
    its own episode (population std, as the reference's ``jnp.std``)."""
    E, T = rets.shape
    obs = traj["obs"].reshape(E * T, -1)
    actions = traj["actions"].reshape((E * T,) + traj["actions"].shape[2:])
    valid = traj["valid"].reshape((E * T,) + traj["valid"].shape[2:])
    lp, ent = logp_entropy(agent, obs, actions, valid)
    values = critic_apply(agent, obs)
    lp = lp.reshape(E, T)
    values = values.reshape(E, T)
    adv = rets - values
    adv_n = ((adv - torch.mean(adv, dim=1, keepdim=True))
             / (torch.std(adv, dim=1, keepdim=True, correction=0) + 1e-6))
    actor_loss = -torch.mean(lp * adv_n.detach())
    critic_loss = 0.5 * torch.mean(torch.square(adv))
    loss = (actor_loss + ac.value_coef * critic_loss
            - ac.entropy_coef * torch.mean(ent))
    return loss, {"actor_loss": actor_loss, "critic_loss": critic_loss,
                  "entropy": torch.mean(ent) / n_uavs,
                  # learner-health panel (repro_torch.obs.traindiag):
                  # pre-normalization advantage stats, critic fit, and the
                  # old-policy logp for the post-update KL
                  "adv_mean": torch.mean(adv), "adv_std": torch.std(adv, correction=0),
                  "explained_var": traindiag.explained_variance(rets, values),
                  "logp_old": lp}


def make_train_episode(env_cfg: EnvConfig, tables: ProfileTables,
                       ac: A2CConfig, model_ids=None):
    """Returns ``train_episode(agent, opt_state, generator[, task_seq]) ->
    (agent, opt_state, stats)``: one rollout of ``batch_envs`` envs and one
    update. ``agent`` is updated in place; ``opt_state`` is replaced;
    ``stats`` are 0-d tensors on the tables' device."""
    opt = AdamWConfig(lr=ac.lr, weight_decay=0.0, warmup_steps=0,
                      total_steps=ac.episodes, grad_clip=1.0,
                      min_lr_ratio=1.0)
    n = env_cfg.n_uavs
    E = max(int(ac.batch_envs), 1)
    rollout = net.make_rollout(env_cfg, tables)

    def train_episode(agent, opt_state, generator, task_seq=None):
        task_seq = net.prepare_task_seq(task_seq, E, tables.device)
        _, traj, bootstrap = net.run_batched_episodes(
            env_cfg, tables, rollout, agent, generator, E,
            model_ids=model_ids, task_seq=task_seq)
        rets = net.discounted_returns(traj["reward"].T, bootstrap, ac.gamma).T
        params = agent.flat_params()
        loss, stats = a2c_loss(agent, traj, rets, ac, n)
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        lp_old = stats.pop("logp_old").detach()
        with torch.no_grad():
            new, opt_state, om = adamw_update(
                opt, {k: p.detach() for k, p in params.items()}, grads, opt_state)
            for k, p in params.items():
                p.copy_(new[k])
            # approx-KL needs the updated policy's logp on the same batch
            lp_new, _ = logp_entropy(
                agent, traj["obs"].flatten(0, 1), traj["actions"].flatten(0, 1),
                traj["valid"].flatten(0, 1))
        stats = {k: v.detach() for k, v in stats.items()}
        stats.update(loss=loss.detach(),
                     episode_reward=torch.mean(torch.sum(traj["reward"], -1)),
                     mean_reward=torch.mean(traj["reward"]),
                     final_battery=torch.mean(traj["battery"][:, -1]),
                     grad_norm=om["grad_norm"],
                     approx_kl=traindiag.approx_kl(lp_old, lp_new.reshape(lp_old.shape)) / n)
        return agent, opt_state, stats

    return train_episode


def train(env_cfg: EnvConfig, tables: ProfileTables, ac: A2CConfig,
          generator: torch.Generator, model_ids=None, log_every: int = 0,
          task_sampler=None):
    """Initialize an agent from ``generator`` (on the tables' device) and
    run ``ac.episodes`` updates. ``task_sampler(episode) -> (episode_len,
    n_uavs)`` array, when given, supplies each env's offered-load sequence
    (episode indices ep*E .. ep*E+E-1). Returns (agent, history): one dict
    of floats per update."""
    agent = init_agent(env_cfg, tables, ac, generator)
    opt_state = adamw_init(agent.flat_params())
    step = make_train_episode(env_cfg, tables, ac, model_ids=model_ids)
    E = max(int(ac.batch_envs), 1)
    history = []
    for ep in range(ac.episodes):
        seq = None if task_sampler is None else net.stack_task_seqs(task_sampler, ep, E)
        agent, opt_state, stats = step(agent, opt_state, generator, seq)
        # one copy to the host per update
        history.append(dict(zip(stats, torch.stack(list(stats.values())).tolist())))
        if log_every and (ep + 1) % log_every == 0:
            print(f"ep {ep+1:4d} reward={history[-1]['mean_reward']:+.4f} "
                  f"loss={history[-1]['loss']:+.4f}", flush=True)
    return agent, history
