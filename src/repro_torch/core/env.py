"""EdgeEnv: the paper's ad-hoc edge MDP over torch tensors (port of
``repro.core.env``).

State (Eq. 6) per UAV: battery level b in [0,10], task availability
alpha in {0,1} (generalized to measured offered load in [0,1] when a
workload trace drives the env, see env_step's next_task and
EnvConfig.peak_rps), transmit power P_tx, model id m, and the activity
mix (forward F, vertical V, rotation R) over the next slot. Shared
state: per-UAV link bandwidth and the edge-server queue length (Poisson
side workload by default, trace-injectable -> Eq. 4 queue term).

Action (Eq. 7) per UAV: (version j, cut-point index l) into the profile
tables. The state is a dict of tensors on the tables' device; every
function also takes leading batch axes (per-UAV fields (..., n), the
shared queue and the slot counter (...,)), which is how the A2C rollout
steps ``batch_envs`` environments at once. Random draws come from the
``torch.Generator`` the caller passes, so they differ from the
reference's ``jax.random`` draws; everything else matches it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.cluster.pool import ClusterParams
from repro_torch.core import energy as en
from repro_torch.core import latency as lat
from repro_torch.core import pricing
from repro_torch.core import reward as rw
from repro_torch.core.profiles import ModelProfile
from repro_torch.device import DeviceLike, resolve_device


# Per-UAV observation feature spec (Eq. 6 + bandwidth/queue, which the
# controller measures). ``observe`` emits exactly these features in this
# order, and the A2C input width is derived from it.
OBS_FEATURES: Tuple[str, ...] = (
    "battery", "task", "p_tx", "model_id",
    "act_forward", "act_vertical", "act_rotate",
    "bandwidth", "queue",
)


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    n_uavs: int = 3
    slot_seconds: float = 30.0        # paper: delta = 30 s
    episode_len: int = 96             # slots per episode (battery-bounded)
    frames_per_slot: float = 30.0     # 1 fps reconnaissance video
    queue_arrival_rate: float = 4.0   # Poisson jobs/slot (server side work)
    queue_service_per_slot: float = 5.0
    task_prob: float = 0.9
    # High activity profile (paper Sec. III-A): 80% fwd, 10% vert, 10% rot
    activity: Tuple[float, float, float] = (0.8, 0.1, 0.1)
    activity_jitter: float = 0.05
    # Slots a (version, cut) choice persists for, amortizing the shipping
    # of the tail weights (tables.tail_weight_bytes) over the link.
    # 0 disables the term (the paper's CNNs are pre-staged on the server).
    weight_ship_slots: float = 0.0
    # Request rate (per device, requests/s) that saturates the task/load
    # feature; > 0 makes the stability score read real utilization.
    peak_rps: float = 0.0
    # Heterogeneous server pool + device->server link matrix. None keeps
    # the classic single-server MDP with (version, cut) actions; set, it
    # widens actions to (version, cut, server) and makes the queue state
    # per-server.
    cluster: Optional[ClusterParams] = None
    power: en.DevicePower = dataclasses.field(default_factory=en.DevicePower)
    latency: lat.LatencyParams = dataclasses.field(
        default_factory=lat.LatencyParams)
    weights: rw.RewardWeights = dataclasses.field(
        default_factory=rw.RewardWeights)

    @property
    def n_servers(self) -> int:
        return 1 if self.cluster is None else self.cluster.n_servers

    @property
    def action_dim(self) -> int:
        return 2 if self.cluster is None else 3

    @property
    def obs_dim_per_uav(self) -> int:
        # cluster mode widens the single "queue" feature to one column
        # per server (the controller sees every server's depth)
        return len(OBS_FEATURES) + (self.n_servers - 1)


@dataclasses.dataclass(frozen=True)
class ProfileTables:
    """Dense (M, V, K) float32 lookup tables built from ModelProfiles, on
    one device."""
    head_flops: torch.Tensor      # (M, V, K)
    tail_flops: torch.Tensor      # (M, V, K)
    cut_bytes: torch.Tensor       # (M, V, K)
    tail_weight_bytes: torch.Tensor  # (M, V, K) server-side weight shipping
    acc: torch.Tensor             # (M, V)
    full_flops: torch.Tensor      # (M, V)  all-local FLOPs
    version_valid: torch.Tensor   # (M, V) 1.0 if version exists
    n_versions: int
    n_cuts: int
    names: Tuple[str, ...]

    @property
    def n_models(self) -> int:
        return self.head_flops.shape[0]

    @property
    def device(self) -> torch.device:
        return self.head_flops.device


def build_tables(profiles: Sequence[ModelProfile],
                 device: DeviceLike = None) -> ProfileTables:
    """Tables on ``device`` (the CUDA card unless named): built in float64
    on the host, rounded to float32 there, then copied."""
    dev = resolve_device(device)
    V = max(len(p.versions) for p in profiles)
    K = max(len(v.cut_points) for p in profiles for v in p.versions)
    M = len(profiles)
    head = np.zeros((M, V, K))
    tail = np.zeros((M, V, K))
    bts = np.zeros((M, V, K))
    wbts = np.zeros((M, V, K))
    acc = np.zeros((M, V))
    full = np.zeros((M, V))
    valid = np.zeros((M, V))
    for mi, p in enumerate(profiles):
        for vi in range(V):
            v = p.versions[min(vi, len(p.versions) - 1)]
            valid[mi, vi] = float(vi < len(p.versions))
            acc[mi, vi] = v.accuracy
            full[mi, vi] = v.total_flops
            cuts = list(v.cut_points) + [v.cut_points[-1]] * K
            for ki in range(K):
                c = cuts[ki]
                head[mi, vi, ki] = v.head_flops(c)
                tail[mi, vi, ki] = v.tail_flops(c)
                bts[mi, vi, ki] = v.cut_bytes(c)
                wbts[mi, vi, ki] = v.tail_weight_bytes(c)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    return ProfileTables(
        head_flops=t(head), tail_flops=t(tail), cut_bytes=t(bts),
        tail_weight_bytes=t(wbts), acc=t(acc), full_flops=t(full),
        version_valid=t(valid), n_versions=V, n_cuts=K,
        names=tuple(p.name for p in profiles))


def env_reset(cfg: EnvConfig, tables: ProfileTables,
              generator: torch.Generator, model_ids=None,
              batch_shape: Tuple[int, ...] = ()) -> Dict:
    """A fresh state on the tables' device; ``batch_shape`` prepends axes
    for a batch of independent environments."""
    n, dev = cfg.n_uavs, tables.device
    shape = tuple(batch_shape) + (n,)
    if model_ids is None:
        model_ids = torch.arange(n, device=dev) % tables.n_models
    model_ids = torch.as_tensor(model_ids, dtype=torch.long, device=dev)
    lp, pw = cfg.latency, cfg.power

    def uniform(lo, hi):
        u = torch.rand(shape, generator=generator, device=dev)
        return u * (hi - lo) + lo

    bw = uniform(lp.bw_min_bps, lp.bw_max_bps)
    ptx = uniform(pw.p_tx_min, pw.p_tx_max)
    queue_shape = tuple(batch_shape) + (() if cfg.cluster is None
                                        else (cfg.cluster.n_servers,))
    return {
        "battery_j": torch.full(shape, pw.battery_j, device=dev),
        "task": torch.ones(shape, device=dev),
        "p_tx": ptx,
        "model_id": model_ids.expand(shape).clone(),
        "activity": torch.tensor(cfg.activity, device=dev).expand(shape + (3,)).clone(),
        "bandwidth": bw,
        "queue": torch.zeros(queue_shape, device=dev),
        "t": torch.zeros(tuple(batch_shape), dtype=torch.int32, device=dev),
    }


def _obs_features(cfg: EnvConfig, tables: ProfileTables, state) -> Dict:
    """Normalized per-UAV features, keyed by OBS_FEATURES name."""
    p, l = cfg.power, cfg.latency
    b = state["battery_j"] / p.battery_j * 10.0
    task = state["task"]
    q = state["queue"] / 20.0
    # cluster mode: one column per server ((..., n, S)); classic: (..., n)
    q = (q[..., None].expand(task.shape) if cfg.cluster is None
         else q[..., None, :].expand(task.shape + (cfg.cluster.n_servers,)))
    return {
        "battery": b / 10.0,
        "task": task,
        "p_tx": (state["p_tx"] - p.p_tx_min) / (p.p_tx_max - p.p_tx_min),
        "model_id": state["model_id"].to(torch.float32)
        / max(tables.n_models - 1, 1),
        "act_forward": state["activity"][..., 0],
        "act_vertical": state["activity"][..., 1],
        "act_rotate": state["activity"][..., 2],
        "bandwidth": (state["bandwidth"] - l.bw_min_bps)
        / (l.bw_max_bps - l.bw_min_bps),
        "queue": q,
    }


def observe(cfg: EnvConfig, tables: ProfileTables, state) -> torch.Tensor:
    """(..., n_uavs, obs_dim_per_uav) normalized observation (Eq. 6 +
    bandwidth/queue). Feature order is OBS_FEATURES; in cluster mode the
    "queue" feature contributes one column per server."""
    feats = _obs_features(cfg, tables, state)
    assert set(feats) == set(OBS_FEATURES), (
        sorted(feats), sorted(OBS_FEATURES))
    n_dims = state["task"].ndim
    cols = [feats[k][..., None] if feats[k].ndim == n_dims else feats[k]
            for k in OBS_FEATURES]
    return torch.cat(cols, dim=-1)


def action_costs(cfg: EnvConfig, tables: ProfileTables, state, actions):
    """Per-UAV (acc_score, lat_score, energy_score, t_total, e_infer,
    stab_score) for actions (..., n, 2) = (version j, cut index l); a thin
    wrapper over ``pricing.price_actions``."""
    br = action_breakdown(cfg, tables, state, actions)
    return (br.acc_score, br.lat_score, br.energy_score, br.t_total,
            br.energy_j, br.stab_score)


def action_breakdown(cfg: EnvConfig, tables: ProfileTables, state,
                     actions) -> pricing.PricingBreakdown:
    """Full per-UAV PricingBreakdown for actions (..., n, 2) under ``state``."""
    return pricing.price_actions(cfg, tables, pricing.view_from_state(state),
                                 actions, xp=torch)


def env_step(cfg: EnvConfig, tables: ProfileTables, state, actions,
             generator: torch.Generator, arrivals=None, next_task=None):
    """One delta-slot. Returns (new_state, reward, info).

    ``arrivals`` injects this slot's server-side job arrivals (a scalar,
    or one per env of a batch) from an external workload trace; None
    keeps the Poisson(queue_arrival_rate) draw. ``next_task`` injects the
    next slot's per-device task/load feature ((..., n) in [0, 1]) in
    place of the Bernoulli(task_prob) draw."""
    dev = tables.device
    acc_s, lat_s, en_s, t_total, e_infer, stab_s = action_costs(
        cfg, tables, state, actions)

    alive = (state["battery_j"] > 0).to(torch.float32)
    active = alive * torch.sign(state["task"])
    r = rw.reward(cfg.weights, acc_s, lat_s, en_s, stab_s, mask=active)

    # energy drain: kinetics (always, while alive) + inference scaled by
    # the task/load level (identical to the paper's gate for {0,1} task)
    act = state["activity"]
    kin_p = en.kinetic_power(cfg.power, act[..., 0], act[..., 1], act[..., 2])
    e_kin = kin_p * cfg.slot_seconds
    drain = alive * (e_kin + state["task"] * e_infer * cfg.frames_per_slot)
    battery = torch.clamp(state["battery_j"] - drain, min=0.0)

    def randn(shape):
        return torch.randn(shape, generator=generator, device=dev)

    # dynamics: bandwidth random walk, queue M/M/1-ish, task Bernoulli
    lpar = cfg.latency
    bw = torch.clip(state["bandwidth"] * torch.exp(randn(state["bandwidth"].shape) * 0.15),
                    lpar.bw_min_bps, lpar.bw_max_bps)
    q = state["queue"]
    if cfg.cluster is None:
        if arrivals is None:
            arrivals = torch.poisson(torch.full(q.shape, cfg.queue_arrival_rate, device=dev),
                                     generator=generator)
        arrivals = torch.as_tensor(arrivals, device=dev).to(torch.float32)
        queue = torch.clamp(q + arrivals - cfg.queue_service_per_slot, min=0.0)
    else:
        # per-server background dynamics at the nominal operating point
        # (initial replicas / top DVFS): traces inject a *total* arrival
        # count, split across servers by bg_arrival_scale
        c = cfg.cluster
        bg_a = torch.tensor(c.bg_arrival_scale, device=dev)
        if arrivals is None:
            arrivals = torch.poisson((cfg.queue_arrival_rate * bg_a).expand(q.shape),
                                     generator=generator)
        else:
            arrivals = torch.as_tensor(arrivals, device=dev)
            arrivals = (arrivals[..., None] if arrivals.ndim else arrivals) * bg_a
        arrivals = arrivals.to(torch.float32)
        speed = torch.tensor([r_ * d[-1] for r_, d in zip(c.replicas, c.dvfs)],
                             device=dev)
        srv_drain = cfg.queue_service_per_slot \
            * torch.tensor(c.bg_service_scale, device=dev) * speed
        queue = torch.clamp(q + arrivals - srv_drain, min=0.0)
    if next_task is None:
        task = torch.bernoulli(torch.full(state["task"].shape, cfg.task_prob, device=dev),
                               generator=generator)
    else:
        task = torch.clip(torch.as_tensor(next_task, dtype=torch.float32, device=dev),
                          0.0, 1.0)
    ptx = torch.clip(state["p_tx"] + randn(state["p_tx"].shape) * 0.05,
                     cfg.power.p_tx_min, cfg.power.p_tx_max)
    act = torch.clip(act + randn(act.shape) * cfg.activity_jitter, 0.0, 1.0)
    act = act / torch.clamp(torch.sum(act, -1, keepdim=True), min=1.0)

    new_state = dict(state, battery_j=battery, bandwidth=bw, queue=queue,
                     task=task, p_tx=ptx, activity=act, t=state["t"] + 1)
    done = torch.all(battery <= 0.0, dim=-1)
    info = {"t_total": t_total, "e_infer": e_infer, "acc_s": acc_s,
            "lat_s": lat_s, "en_s": en_s, "stab_s": stab_s, "alive": alive,
            "done": done, "battery": battery}
    return new_state, r, info
