"""Online adaptation: windowed replay + incremental updates + policy
hot-swap, closing the controller->serving loop under drift (port of
``repro.online.adapt``).

The fleet loop (``repro_torch.sim.fleet``) captures one *measured*
transition per decision epoch (the observation the controller actually
decided from, the actions it took, its behavior log-prob, and the epoch
reward priced under the **current regime's** physics) into a windowed
replay buffer. On the configured cadence an incremental update step (a
loss under autograd and one AdamW step, on the policy's device, for both
the A2C and PPO objectives on ``core.actor_critic``'s return/GAE and
log-prob machinery) improves the parameters on the recent window, and
the updated agent hot-swaps into the serving loop through
``TrainablePolicy.set_params``.

The learner never writes into an agent it was handed: the first update
copies the policy's serving agent, and every update after that works on
the copy. A frozen sibling sharing the pre-drift agent, or a caller's
snapshot of it, stays as it was.

Adaptation is gated by the drift monitor (``repro_torch.online.monitor``):
under ``gate="drift"`` a Page-Hinkley trigger opens a burst of
``burst_epochs`` during which the policy explores (per-device
epsilon-mix of logit sampling over argmax) and updates run; outside
bursts the policy serves greedily and spends zero update compute,
re-arming while the EWMA regret vs the per-regime oracle stays high.
``gate="always"`` adapts continuously; ``gate="off"`` only monitors.

Everything is deterministic given the simulation seed: updates consume
no RNG (recorded actions, no sampling inside the loss), exploration
draws use the fleet's generator, and the replay window flushes at
regime boundaries so stale-physics rewards never leak into the new
regime's gradient. The steps are built once per window bucket (update)
and per exploration rate (capture); ``repro_torch.obs.tracemon`` counts
the builds at ``online.update`` and ``online.capture``, where the
reference counts its re-traces.
"""
from __future__ import annotations

import collections
import copy
import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.obs import tracemon
from repro_torch.online.monitor import DriftMonitor

# the actor trunk: frozen (zero gradients) unless OnlineConfig.adapt_trunk
_TRUNK = ("actor/l1/", "actor/l2/")


def _normalize(x, mask):
    """Mask-weighted standardization (dead devices excluded), population
    variance."""
    denom = torch.clamp(torch.sum(mask), min=1.0)
    mean = torch.sum(x * mask) / denom
    var = torch.sum(torch.square(x - mean) * mask) / denom
    return (x - mean) / (torch.sqrt(var) + 1e-6)


@dataclasses.dataclass(frozen=True)
class OnlineConfig:
    """Update-cadence / compute-budget knobs for online adaptation."""
    window: int = 64            # replay window, epochs
    min_window: int = 8         # don't update on fewer transitions
    update_every: int = 1       # epochs between incremental updates
    updates_per_step: int = 1   # grad steps per update (compute budget)
    # Gentle steps: Adam moves ~lr per weight per step, and per-weight
    # shifts compound through the head layers into O(100x) logit swings;
    # 1e-3 re-aligns a regime in ~30 updates while 5e-3+ saturates the
    # softmax into an arbitrary action within a burst (the reference's
    # measurement).
    lr: float = 1e-3
    gamma: float = 0.5          # short horizon: slot scores are immediate
    entropy_coef: float = 0.02  # resists softmax saturation mid-burst
    # Freeze the actor trunk (l1/l2) and adapt only the light per-UAV
    # heads (+ the critic): Adam's scale-free steps over the highly
    # correlated sliding-window gradients otherwise walk *every* weight
    # ~lr per update, and after ~100 updates the 4-layer composition
    # blows the logits up. Head-only adaptation bounds the damage to one
    # linear map per device.
    adapt_trunk: bool = False
    value_coef: float = 0.5
    clip: float = 0.2           # PPO surrogate clip (algo="ppo")
    algo: str = "a2c"           # "a2c" | "ppo" (set from the policy)
    # drift gating
    gate: str = "drift"         # "drift" | "always" | "off"
    burst_epochs: int = 60      # adaptation burst length after a trigger
    # per-device probability of sampling (vs argmax) during a burst
    explore_eps: float = 0.25
    # Page-Hinkley only fires on reward *drops*; while the EWMA regret
    # exceeds regret_frac * |oracle|, expired bursts re-arm.
    regret_frac: float = 0.3
    ewma: float = 0.2
    ph_delta: float = 0.01
    ph_lambda: float = 0.5


class ReplayWindow:
    """Windowed buffer of measured transitions, flushed at regime
    boundaries: a transition priced under the old physics is a wrong
    label for the new regime's gradient, so the window only ever holds
    consecutive same-regime epochs (newest last)."""

    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self._buf = collections.deque(maxlen=self.capacity)
        self.regime: Optional[int] = None

    def push(self, item: Dict, regime: int):
        if regime != self.regime:
            self._buf.clear()
            self.regime = regime
        self._buf.append(item)

    def __len__(self) -> int:
        return len(self._buf)

    def tail(self, n: int) -> Dict[str, np.ndarray]:
        """Stack the newest ``n`` transitions into (T, ...) arrays."""
        items = list(self._buf)[-n:]
        return {k: np.stack([it[k] for it in items])
                for k in items[0]}


def _bucket(n: int, min_window: int, capacity: int) -> int:
    """Largest min_window * 2^k <= n (capped at capacity): the window
    lengths an update sees are quantized to a few power-of-two buckets,
    which decides which transitions enter each update (the newest
    ``_bucket`` of them)."""
    b = min_window
    while b * 2 <= min(n, capacity):
        b *= 2
    return b


class OnlineLearner:
    """Owns the window, the monitor, the optimizer state and the update
    step for one trainable policy inside one fleet simulation."""

    def __init__(self, policy, cfg: OnlineConfig, model_ids):
        if not policy.trainable:
            raise ValueError(f"online adaptation needs a trainable policy; "
                             f"{policy.name!r} is not")
        self.policy = policy
        self.cfg = cfg
        self.window = ReplayWindow(cfg.window)
        self.monitor = DriftMonitor(ewma=cfg.ewma, ph_delta=cfg.ph_delta,
                                    ph_lambda=cfg.ph_lambda)
        self.updates = 0
        self.bursts = 0
        self.burst_until = -1
        self._o_ew = None
        self._agent = None          # the learner's own copy of the agent
        self._opt_state = None
        self._update_fns: Dict[int, object] = {}
        self._capture_fns: Dict[float, object] = {}
        self._env_cfg, self._tables = policy.env_cfg, policy.tables
        self._device = policy.tables.device
        self._valid = policy.tables.version_valid[torch.as_tensor(
            np.asarray(model_ids), dtype=torch.long, device=self._device)]

    def _capture(self, eps: float):
        """Capture step, built once per exploration rate: the behavior
        density of the taken (version, cut) pair under the epsilon-mixed
        acting policy is eps * pi(a) + (1 - eps) * 1[a == argmax];
        recording the bare softmax log pi(a) instead would weight the
        mostly-argmax window as if it were sampled on-policy and bias the
        PPO ratio. Returns one float32 tensor: the flat observation, then
        the (n,) behavior log-densities."""
        if eps in self._capture_fns:
            return self._capture_fns[eps]
        from repro_torch.core.actor_critic import device_logp_entropy, greedy_actions
        from repro_torch.core.env import observe

        tracemon.count_trace("online.capture")
        env_cfg, tables, valid = self._env_cfg, self._tables, self._valid

        @torch.no_grad()
        def capture(agent, state, actions):
            ob = observe(env_cfg, tables, state).reshape(-1)
            lp, _ = device_logp_entropy(agent, ob, actions, valid)
            if eps <= 0.0:
                # deterministic argmax behavior: density 1 for the taken
                # action
                return torch.cat([ob, torch.zeros_like(lp)])
            greedy = greedy_actions(agent, ob, valid)
            is_greedy = torch.all(actions == greedy, dim=-1).to(lp.dtype)
            p = eps * torch.exp(lp) + (1.0 - eps) * is_greedy
            return torch.cat([ob, torch.log(torch.clamp(p, min=1e-30))])

        self._capture_fns[eps] = capture
        return capture

    # -- per-epoch hooks (called from the fleet loop) ----------------------

    def observe_transition(self, state, actions, rewards, mask,
                           regime: int):
        """Record one measured transition: the decided-from observation,
        the taken actions, *per-device* rewards (the per-UAV weighted
        scores before Eq. 8's fleet mean), the alive mask, and the
        behavior log-density fixed at capture time (the PPO surrogate
        needs it). One copy back to the host."""
        eps = float(getattr(self.policy, "explore", 0.0))
        acts = torch.as_tensor(np.asarray(actions), dtype=torch.long, device=self._device)
        host = self._capture(eps)(self.policy.params, state, acts).cpu().numpy()
        n = acts.shape[0]
        self.window.push({"obs": host[:-n],
                          "actions": np.asarray(actions, np.int32),
                          "logp": host[-n:],
                          "reward": np.asarray(rewards, np.float32),
                          "mask": np.asarray(mask, np.float32)}, regime)

    def step(self, epoch: int, reward: float,
             oracle_reward: Optional[float] = None) -> bool:
        """Advance gating and maybe run an incremental update; returns
        True when the policy's agent was hot-swapped this epoch.
        ``oracle_reward`` (the per-regime greedy oracle's epoch reward,
        supplied by the fleet loop) re-arms expired bursts while the
        policy is still far from the regime's achievable level."""
        cfg = self.cfg
        triggered = self.monitor.update(reward)
        if oracle_reward is not None:
            o = float(oracle_reward)
            self._o_ew = o if self._o_ew is None \
                else self._o_ew + cfg.ewma * (o - self._o_ew)
            # monitor.level is the same-alpha EWMA of the reward stream
            gap = self._o_ew - self.monitor.level
            if gap > cfg.regret_frac * max(abs(self._o_ew), 1e-9) and \
                    len(self.window) >= cfg.min_window:
                triggered = True
        # a trigger during an active burst does not extend it: each
        # burst's exploration cost is bounded, and if the regime is
        # still bad after the burst the gate simply re-arms
        if cfg.gate == "drift" and triggered and \
                epoch >= self.burst_until:
            self.burst_until = epoch + cfg.burst_epochs
            self.bursts += 1
            obs.event("online.burst_start", epoch=epoch,
                      until=self.burst_until, burst=self.bursts)
        active = cfg.gate == "always" or (
            cfg.gate == "drift" and epoch < self.burst_until)
        if hasattr(self.policy, "set_explore"):
            self.policy.set_explore(cfg.explore_eps if active else 0.0)
        if not active or epoch % cfg.update_every != 0:
            return False
        if len(self.window) < cfg.min_window:
            return False
        n = _bucket(len(self.window), cfg.min_window, cfg.window)
        with obs.span("online.update", window=n, algo=cfg.algo):
            batch = {k: torch.as_tensor(v, device=self._device)
                     for k, v in self.window.tail(n).items()}
            batch["actions"] = batch["actions"].long()
            if self._agent is None or self.policy.params is not self._agent:
                self._agent = copy.deepcopy(self.policy.params)
            update = self._update(n)
            for _ in range(cfg.updates_per_step):
                self._opt_state = update(self._agent, self._opt(), **batch)
            self.updates += 1
            self.policy.set_params(self._agent)
        obs.event("online.hotswap", epoch=epoch, updates=self.updates,
                  window=n)
        return True

    # -- update machinery --------------------------------------------------

    def _opt(self):
        if self._opt_state is None:
            from repro_torch.optim import adamw_init
            self._opt_state = adamw_init(self._agent.flat_params())
        return self._opt_state

    def _update(self, n: int):
        """Incremental update step, built once per window length ``n``:
        per-device n-step returns (A2C) or per-device GAE + clipped
        surrogate (PPO) over the (T, n_uavs) window (``core.actor_critic``'s
        estimators over the leading time axis, broadcast across the device
        axis), one AdamW step, constant LR. Per-device credit: the actor
        gradient weights each device's log-prob by that device's own
        advantage, masked by liveness. Updates the agent in place and
        returns the new optimizer state."""
        if n in self._update_fns:
            return self._update_fns[n]
        from repro_torch.core.actor_critic import (critic_apply, device_logp_entropy,
                                                   discounted_returns, gae)
        from repro_torch.optim import AdamWConfig, adamw_update

        tracemon.count_trace("online.update")
        cfg = self.cfg
        opt = AdamWConfig(lr=cfg.lr, weight_decay=0.0, warmup_steps=0,
                          total_steps=1, grad_clip=1.0, min_lr_ratio=1.0)
        valid = self._valid

        def loss_fn(agent, obs, actions, logp, reward, mask):
            lp, ent = device_logp_entropy(agent, obs, actions, valid)   # (T, n)
            values = critic_apply(agent, obs)                            # (T,)
            # Standardize rewards over the window: drift regimes swing
            # raw scores by orders of magnitude, and an O(100) critic
            # regression would dominate the global grad-norm clip and
            # starve the actor. Affine reward transforms leave the
            # normalized advantage, hence the policy gradient, intact.
            rewards = _normalize(reward, mask) * mask
            v = values.detach()
            boot = v[-1]
            denom = torch.clamp(torch.sum(mask), min=1.0)
            if cfg.algo == "ppo":
                advs, rets = gae(rewards, v[:, None], boot, cfg.gamma, cfg.gamma)
                a_n = _normalize(advs, mask)
                ratio = torch.exp(lp - logp)
                surr = torch.minimum(
                    ratio * a_n, torch.clip(ratio, 1 - cfg.clip, 1 + cfg.clip) * a_n)
                actor_loss = -torch.sum(surr * mask) / denom
            else:
                rets = discounted_returns(rewards, boot, cfg.gamma)
                a_n = _normalize(rets - v[:, None], mask)
                actor_loss = -torch.sum(lp * a_n * mask) / denom
            # the critic baselines the fleet-mean per-device return
            target = torch.sum(rets * mask, -1) \
                / torch.clamp(torch.sum(mask, -1), min=1.0)
            critic_loss = 0.5 * torch.mean(torch.square(target - values))
            entropy = torch.sum(ent * mask) / denom
            return (actor_loss + cfg.value_coef * critic_loss
                    - cfg.entropy_coef * entropy)

        def update(agent, opt_state, obs, actions, logp, reward, mask):
            params = agent.flat_params()
            loss = loss_fn(agent, obs, actions, logp, reward, mask)
            grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
            if not cfg.adapt_trunk:
                # zero gradients, not frozen parameters: the global-norm
                # clip and the AdamW moments see the reference's tree
                grads = {k: torch.zeros_like(g) if k.startswith(_TRUNK) else g
                         for k, g in grads.items()}
            with torch.no_grad():
                new, opt_state, _ = adamw_update(
                    opt, {k: p.detach() for k, p in params.items()}, grads, opt_state)
                for k, p in params.items():
                    p.copy_(new[k])
            return opt_state

        self._update_fns[n] = update
        return update

    # -- bookkeeping --------------------------------------------------------

    def summary(self) -> Dict:
        return {"updates": self.updates,
                "triggers": self.monitor.triggers,
                "bursts": self.bursts,
                "algo": self.cfg.algo, "gate": self.cfg.gate,
                "window": self.cfg.window,
                "update_every": self.cfg.update_every}
