"""Actor-critic networks + batched rollout machinery (port of
``repro.core.actor_critic``).

- the paper's networks (critic 512/256, actor 512/256 with a shared
  128-wide per-UAV layer feeding the (version, cut) logit pairs, plus a
  server head in cluster mode) as one ``nn.Module`` whose parameters carry
  the reference's leaf paths (``actor/l1/w``, ...), and their sampling /
  log-prob / entropy math;
- ``make_rollout``: one episode of the env as a loop over
  ``episode_len`` slots, optionally recording the behavior policy's
  logp/value (PPO's surrogate needs them, A2C recomputes);
- ``run_batched_episodes``: ``batch_envs`` independent env instances
  stepped at once along a leading batch axis;
- ``stack_task_seqs``: one update's trace-driven load sequences;
- ``discounted_returns`` / ``gae``: the two return estimators.

Every network function takes leading batch axes on ``obs_flat``.
Sampling draws Gumbel noise from the caller's ``torch.Generator``, on the
generator's device.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from repro_torch.core.env import env_reset, env_step, observe
from repro_torch.models.params import P, materialize


# --------------------------------------------------------------------------
# networks (paper Sec. II-C)
# --------------------------------------------------------------------------

def plan_agent(cfg, tables, ac) -> Dict[str, P]:
    """{leaf path: P}; ``ac`` supplies hidden1/hidden2/uav_head widths."""
    n = cfg.n_uavs
    obs = n * cfg.obs_dim_per_uav
    V, K = tables.n_versions, tables.n_cuts
    h1, h2, hu = ac.hidden1, ac.hidden2, ac.uav_head

    def dense(i, o):
        return {"w": P((i, o), (None, None)), "b": P((o,), (None,), "zeros")}

    def per_uav(i, o):
        return {"w": P((n, i, o), (None, None, None)), "b": P((n, o), (None, None), "zeros")}

    plan = {
        "actor": {"l1": dense(obs, h1), "l2": dense(h1, h2),
                  "uav": per_uav(h2, hu),
                  "ver": per_uav(hu, V), "cut": per_uav(hu, K)},
        "critic": {"l1": dense(obs, h1), "l2": dense(h1, h2),
                   "out": dense(h2, 1)},
    }
    if cfg.cluster is not None:
        # cluster mode: a third per-UAV head routes requests
        plan["actor"]["srv"] = per_uav(hu, cfg.cluster.n_servers)
    return {f"{net}/{layer}/{leaf}": p for net, layers in plan.items()
            for layer, leaves in layers.items() for leaf, p in leaves.items()}


class Agent(nn.Module):
    """The actor and critic, built from a flat {``net/layer/leaf``: tensor}
    mapping (``plan_agent``'s paths, the reference's parameter tree)."""

    def __init__(self, flat: Mapping[str, torch.Tensor]):
        super().__init__()
        nets: Dict[str, Dict[str, Dict[str, nn.Parameter]]] = {}
        for path, t in flat.items():
            net, layer, leaf = path.split("/")
            nets.setdefault(net, {}).setdefault(layer, {})[leaf] = nn.Parameter(t)
        self.actor = nn.ModuleDict({k: nn.ParameterDict(v) for k, v in nets["actor"].items()})
        self.critic = nn.ModuleDict({k: nn.ParameterDict(v) for k, v in nets["critic"].items()})

    def flat_params(self) -> Dict[str, nn.Parameter]:
        """{``actor/l1/w``: parameter, ...} in sorted path order."""
        return dict(sorted((name.replace(".", "/"), p) for name, p in self.named_parameters()))


def init_agent(cfg, tables, ac, generator: torch.Generator) -> Agent:
    """Fan-in normal weights and zero biases, drawn from ``generator`` on
    the tables' device."""
    return Agent(materialize(plan_agent(cfg, tables, ac), generator,
                             torch.float32, tables.device))


def load_agent(cfg, tables, ac, flat: Mapping[str, np.ndarray]) -> Agent:
    """The agent from the reference's parameters (e.g. a
    ``repro.checkpointing.save_tree`` file of ``TrainablePolicy.save``,
    read back with ``repro_torch.checkpointing.load_tree``), on the
    tables' device; paths and shapes are checked against the plan."""
    plan = plan_agent(cfg, tables, ac)
    missing, extra = set(plan) - set(flat), set(flat) - set(plan)
    if missing or extra:
        raise ValueError(f"agent mismatch: missing={sorted(missing)[:5]} "
                         f"extra={sorted(extra)[:5]}")
    tensors = {}
    for path, p in plan.items():
        arr = np.asarray(flat[path])
        if arr.shape != p.shape:
            raise ValueError(f"{path}: shape {arr.shape} != {p.shape}")
        tensors[path] = torch.tensor(arr, dtype=torch.float32, device=tables.device)
    return Agent(tensors)


def _dense(p, x):
    return torch.nn.functional.linear(x, p["w"].t(), p["b"])


def _per_uav(p, x):
    """x (..., n, i), or (..., 1, i) shared by the UAVs -> (..., n, o):
    one (i, o) matrix per UAV, as one batched GEMM over the UAVs."""
    w = p["w"]
    n, i, o = w.shape
    xb = x.reshape(-1, x.shape[-2], i).transpose(0, 1).expand(n, -1, i)
    y = torch.baddbmm(p["b"][:, None, :], xb, w)            # (n, B, o)
    return y.transpose(0, 1).reshape(x.shape[:-2] + (n, o))


def actor_apply(agent: Agent, obs_flat):
    """obs_flat (..., obs_total) -> (logits_v (..., n, V), logits_c (...,
    n, K), logits_s (..., n, S) or None); the server head exists only in
    cluster-mode agents."""
    a = agent.actor
    h = torch.relu(_dense(a["l1"], obs_flat))
    h = torch.relu(_dense(a["l2"], h))
    hu = torch.relu(_per_uav(a["uav"], h[..., None, :]))    # (..., n, hu)
    lv = _per_uav(a["ver"], hu)
    lc = _per_uav(a["cut"], hu)
    ls = _per_uav(a["srv"], hu) if "srv" in a else None
    return lv, lc, ls


def critic_apply(agent: Agent, obs_flat):
    c = agent.critic
    h = torch.relu(_dense(c["l1"], obs_flat))
    h = torch.relu(_dense(c["l2"], h))
    return _dense(c["out"], h)[..., 0]


def mask_logits(logits, valid):
    return torch.where(valid > 0, logits, torch.full_like(logits, -1e9))


def _categorical(logits, generator):
    """One draw per row of the last axis (Gumbel-max). The uniforms come
    from ``generator`` on its own device, so a host generator gives the
    card and the CPU the same draws."""
    u = torch.rand(logits.shape, generator=generator, device=generator.device)
    return torch.argmax(logits - torch.log(-torch.log(u.to(logits.device))), dim=-1)


def sample_actions(agent: Agent, obs_flat, valid_v, generator: torch.Generator):
    lv, lc, ls = actor_apply(agent, obs_flat)
    cols = [_categorical(mask_logits(lv, valid_v), generator),
            _categorical(lc, generator)]
    if ls is not None:
        cols.append(_categorical(ls, generator))
    return torch.stack(cols, dim=-1)


def greedy_actions(agent: Agent, obs_flat, valid_v):
    lv, lc, ls = actor_apply(agent, obs_flat)
    cols = [torch.argmax(mask_logits(lv, valid_v), -1), torch.argmax(lc, -1)]
    if ls is not None:
        cols.append(torch.argmax(ls, -1))
    return torch.stack(cols, dim=-1)


def _logp_ent(logits, taken):
    logp = torch.log_softmax(logits, -1)
    return (torch.gather(logp, -1, taken[..., None])[..., 0],
            -torch.sum(torch.exp(logp) * logp, -1))


def device_logp_entropy(agent: Agent, obs_flat, actions, valid_v):
    """Per-device (log-prob, entropy) of the taken actions, (..., n) each;
    in cluster mode the factored policy adds the server head's terms."""
    lv, lc, ls = actor_apply(agent, obs_flat)
    lp_v, ent_v = _logp_ent(mask_logits(lv, valid_v), actions[..., 0])
    lp_c, ent_c = _logp_ent(lc, actions[..., 1])
    lp, ent = lp_v + lp_c, ent_v + ent_c
    if ls is not None:
        lp_s, ent_s = _logp_ent(ls, actions[..., 2])
        lp, ent = lp + lp_s, ent + ent_s
    return lp, ent


def logp_entropy(agent: Agent, obs_flat, actions, valid_v):
    """Summed over the devices: (...,) each."""
    lp, ent = device_logp_entropy(agent, obs_flat, actions, valid_v)
    return torch.sum(lp, -1), torch.sum(ent, -1)


def valid_versions(tables, state):
    return tables.version_valid[state["model_id"]]   # (..., n, V)


# --------------------------------------------------------------------------
# rollouts
# --------------------------------------------------------------------------

def make_rollout(env_cfg, tables, *, record_policy=False):
    """Returns ``rollout(agent, state0, generator, task_seq=None) ->
    (state_T, traj)``: one episode of ``episode_len`` slots; ``traj``
    leaves have the time axis after the state's batch axes. With
    ``record_policy`` the behavior policy's per-step logp (summed over
    the devices) and the critic's value are recorded too (PPO's clipped
    surrogate needs them fixed at sampling time). ``task_seq``, when
    given, is (..., episode_len, n) per-slot offered load fed through
    env_step's ``next_task`` hook."""

    @torch.no_grad()
    def rollout(agent, state0, generator, task_seq=None):
        lead = state0["t"].ndim
        state, steps = state0, []
        for t in range(env_cfg.episode_len):
            obs = observe(env_cfg, tables, state).flatten(lead)
            valid = valid_versions(tables, state)
            actions = sample_actions(agent, obs, valid, generator)
            step = {"obs": obs, "actions": actions, "valid": valid}
            if record_policy:
                step["logp"] = logp_entropy(agent, obs, actions, valid)[0]
                step["value"] = critic_apply(agent, obs)
            nxt = None if task_seq is None else task_seq[..., t, :]
            state, r, info = env_step(env_cfg, tables, state, actions,
                                      generator, next_task=nxt)
            step.update(reward=r, alive=info["alive"], battery=info["battery"])
            steps.append(step)
        traj = {k: torch.stack([s[k] for s in steps], dim=lead) for k in steps[0]}
        return state, traj

    return rollout


def run_batched_episodes(env_cfg, tables, rollout, agent, generator,
                         batch_envs, model_ids=None, task_seq=None):
    """Reset and roll ``batch_envs`` independent env instances along a
    leading batch axis. Returns ``(state_T, traj, bootstrap)`` with that
    axis on every leaf (``traj`` (E, T, ...)); ``bootstrap`` is the
    critic's value at the final state of each env."""
    state0 = env_reset(env_cfg, tables, generator, model_ids=model_ids,
                       batch_shape=(batch_envs,))
    if task_seq is not None:
        # slot t's load is task_seq[:, t]: seed state0 with row 0 and
        # let env_step's next_task install rows 1..T-1 (last repeats)
        state0 = dict(state0, task=task_seq[:, 0])
        task_seq = torch.cat([task_seq[:, 1:], task_seq[:, -1:]], dim=1)
    state_T, traj = rollout(agent, state0, generator, task_seq)
    with torch.no_grad():
        bootstrap = critic_apply(agent, observe(env_cfg, tables, state_T).flatten(1))
    return state_T, traj, bootstrap


def stack_task_seqs(task_sampler, episode, batch_envs):
    """One update's offered-load sequences from a task_sampler: episode
    indices ``episode*E .. episode*E+E-1`` (per-env domain
    randomization), stacked to (E, T, n) float32 numpy. Shared by the A2C
    and PPO training loops so the indexing convention cannot diverge."""
    return np.stack([np.asarray(task_sampler(episode * batch_envs + e), dtype=np.float32)
                     for e in range(batch_envs)])


def prepare_task_seq(task_seq, batch_envs, device):
    """Normalize a task sequence to the batched (E, T, n) layout: a 2-D
    (T, n) sequence is shared across all envs."""
    if task_seq is None:
        return None
    task_seq = torch.as_tensor(task_seq, dtype=torch.float32, device=device)
    if task_seq.ndim == 2:
        task_seq = task_seq[None].expand((batch_envs,) + task_seq.shape)
    return task_seq


# --------------------------------------------------------------------------
# return estimators
# --------------------------------------------------------------------------

def discounted_returns(rewards, bootstrap, gamma):
    """n-step discounted returns along the leading time axis."""
    out = torch.empty_like(rewards)
    g = bootstrap
    for t in range(rewards.shape[0] - 1, -1, -1):
        g = rewards[t] + gamma * g
        out[t] = g
    return out


def gae(rewards, values, bootstrap, gamma, lam):
    """Generalized advantage estimation along the leading time axis;
    returns (advantages, returns)."""
    advs = torch.empty_like(rewards)
    adv_next, v_next = torch.zeros_like(rewards[0]), bootstrap
    for t in range(rewards.shape[0] - 1, -1, -1):
        delta = rewards[t] + gamma * v_next - values[t]
        adv_next = delta + gamma * lam * adv_next
        v_next = values[t]
        advs[t] = adv_next
    return advs, advs + values
