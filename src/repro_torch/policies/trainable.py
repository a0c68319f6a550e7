"""Trainable policies behind the Policy protocol: A2C, the paper's
algorithm, and the PPO ablation (port of ``repro.policies.trainable``).

Lifecycle: ``build`` (untrained nets bound to one env) -> ``train(seed,
trace)`` (batched-env updates; a workload trace switches the task
feature to trace-driven offered load) -> ``save``/``load`` (one-file
.npz artifacts in the reference's format and meta, so either package
reads the other's) -> greedy ``act``. ``act`` runs eagerly on the
tables' device; there is no compiled decide to cache. ``algo`` names the
objective an online learner adapts the policy with
(``repro_torch.online.adapt``).
"""
from __future__ import annotations

import torch

from repro_torch.checkpointing import load_tree, save_tree
from repro_torch.core import a2c as A2C
from repro_torch.core import ppo as PPO
from repro_torch.core.actor_critic import greedy_actions, load_agent, sample_actions
from repro_torch.core.controller import make_task_sampler, train_agent
from repro_torch.core.env import observe
from repro_torch.policies.base import Policy, PolicySpec, register

_ARTIFACT_SCHEMA = 1


class TrainablePolicy(Policy):
    trainable = True
    algo = "a2c"            # online-update objective (repro_torch.online.adapt)

    def __init__(self, env_cfg, tables, config):
        super().__init__(env_cfg, tables)
        self.config = config
        self.params = None      # an actor_critic.Agent on the tables' device
        self.history = None
        self.explore = 0.0

    # -- subclass hooks ----------------------------------------------------
    @property
    def _net_config(self):
        """The config holding the nets' widths (hidden1/hidden2/uav_head)."""
        return self.config

    def _train(self, seed, trace, log_every):
        raise NotImplementedError

    # -- lifecycle ---------------------------------------------------------
    def train(self, seed: int = 0, trace=None, log_every: int = 0):
        """Train from scratch; returns the per-update stats history."""
        self.params, self.history = self._train(seed, trace, log_every)
        return self.history

    def set_params(self, params):
        """Swap the serving agent. The swap is by reference, and training
        updates an agent in place, so a snapshot to keep is a copy."""
        self.params = params
        return self

    def set_explore(self, explore: float):
        """Set the exploration rate in [0, 1]: each call, each device
        independently samples the masked logits with probability
        ``explore`` and acts greedily otherwise."""
        self.explore = float(explore)
        return self

    @torch.no_grad()
    def _act(self, params, state, generator, eps: float):
        """Greedy decide, epsilon-mixed with logit sampling per device
        when ``eps`` > 0: the mix is a Bernoulli(eps) draw per device from
        ``generator``, after the sampled actions' draws; every draw is made
        on the generator's device."""
        obs = observe(self.env_cfg, self.tables, state).flatten(-2)
        valid = self.tables.version_valid[state["model_id"]]
        greedy = greedy_actions(params, obs, valid)
        if eps <= 0.0 or generator is None:
            return greedy
        sampled = sample_actions(params, obs, valid, generator)
        if eps >= 1.0:
            return sampled
        pick = torch.bernoulli(torch.full((greedy.shape[0], 1), eps, device=generator.device),
                               generator=generator)
        return torch.where(pick.to(greedy.device) > 0, sampled, greedy)

    def act(self, state, generator=None):
        if self.params is None:
            raise RuntimeError(f"policy {self.name!r}: call train() or "
                               "load() before act()")
        return self._act(self.params, state, generator, self.explore)

    def save(self, path: str) -> str:
        """Write the agent as the reference's artifact: one array per
        ``actor/l1/w``-style leaf path, meta ``{"schema": 1, "policy":
        name}``."""
        if self.params is None:
            raise RuntimeError(f"policy {self.name!r}: nothing to save "
                               "before train() or load()")
        flat = {k: p.detach().cpu().numpy() for k, p in self.params.flat_params().items()}
        return save_tree(path, flat, meta={"schema": _ARTIFACT_SCHEMA,
                                           "policy": self.name})

    def load(self, path: str) -> "TrainablePolicy":
        """Restore a ``save``d artifact (this package's or the
        reference's). Paths and shapes are checked against this env's
        nets, so a controller trained for a different fleet fails
        loudly."""
        flat, meta = load_tree(path)
        saved_as = meta.get("policy")
        if saved_as is not None and saved_as != self.name:
            raise ValueError(f"artifact {path!r} holds a {saved_as!r} "
                             f"policy, not {self.name!r}")
        self.params = load_agent(self.env_cfg, self.tables, self._net_config, flat)
        return self


class A2CPolicy(TrainablePolicy):
    """The paper's controller (Sec. II-C/D)."""

    name = "a2c"        # artifacts stay loadable from direct construction
    algo = "a2c"

    def __init__(self, env_cfg, tables, **cfg_kw):
        super().__init__(env_cfg, tables, A2C.A2CConfig(**cfg_kw))

    def _train(self, seed, trace, log_every):
        return train_agent(self.env_cfg, self.tables, self.config, seed=seed,
                           log_every=log_every, trace=trace)


class PPOPolicy(TrainablePolicy):
    """Beyond-paper ablation: clipped-surrogate PPO on the same nets."""

    name = "ppo"
    algo = "ppo"

    def __init__(self, env_cfg, tables, **cfg_kw):
        super().__init__(env_cfg, tables, PPO.PPOConfig(**cfg_kw))

    @property
    def _net_config(self):
        return self.config.base

    def _train(self, seed, trace, log_every):
        generator = torch.Generator(device=self.tables.device).manual_seed(seed)
        return PPO.train(self.env_cfg, self.tables, self.config, generator,
                         log_every=log_every,
                         task_sampler=make_task_sampler(self.env_cfg, trace, seed))


register(PolicySpec(
    "a2c", A2CPolicy, trainable=True,
    description="A2C controller (the paper's algorithm); kwargs -> "
                "A2CConfig (episodes, entropy_coef, batch_envs, ...)"))
register(PolicySpec(
    "ppo", PPOPolicy, trainable=True,
    description="PPO ablation on the shared nets; kwargs -> PPOConfig"))
