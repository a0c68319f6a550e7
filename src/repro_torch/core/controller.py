"""EdgeRL controller: the centralized decision-maker (paper Sec. II-D);
port of ``repro.core.controller``.

Wires profiles -> env -> A2C and exposes:
  - ``make_paper_env``: the faithful testbed (VGG/ResNet/DenseNet on
    Jetson-TX2-class UAVs + PowerEdge-class edge server).
  - ``make_tpu_env``: the reference's adaptation to the assigned
    transformer architectures, with its env constants unchanged.
  - ``train_agent`` / ``evaluate_policy`` / ``decide``.

Tables and states live on one device: the CUDA card unless the caller
names another (``device="cpu"``).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import a2c as A2C
from repro_torch.core.energy import DevicePower
from repro_torch.core.env import (EnvConfig, ProfileTables, build_tables,
                                  env_reset, env_step, observe)
from repro_torch.core.latency import LatencyParams
from repro_torch.core.profiles import paper_profiles, transformer_profile
from repro_torch.core.reward import RewardWeights
from repro_torch.device import DeviceLike


def make_paper_env(weights: RewardWeights = RewardWeights(),
                   n_uavs: int = 3, device: DeviceLike = None,
                   **env_kw) -> Tuple[EnvConfig, ProfileTables]:
    """The paper's testbed (3 UAVs); ``n_uavs`` scales the fleet, model
    assignment cycling through {vgg, resnet, densenet} like env_reset."""
    profs = paper_profiles()
    tables = build_tables([profs["vgg"], profs["resnet"], profs["densenet"]],
                          device=device)
    cfg = EnvConfig(n_uavs=n_uavs, weights=weights.normalized(), **env_kw)
    return cfg, tables


# The reference env's TPU v5e parameters, kept as they are so that the
# tables and prices match the reference: "device" = a head submesh of 8
# v5e chips, "server" = a shared tail submesh of 64, link = ICI. They are
# the model's constants, not measurements of, or claims about, the H100
# that serves the decisions.
_TPU_LATENCY = LatencyParams(
    device_flops=8 * 197e12 * 0.4,      # 8 chips at 40% MFU
    server_flops=64 * 197e12 * 0.4,
    job_service_s=0.01,
    bw_min_bps=8 * 50e9 * 8 * 0.25,     # congested ICI share
    bw_max_bps=8 * 50e9 * 8,            # 8 links x 50 GB/s
)
_TPU_POWER = DevicePower(
    p_forward=0.0, p_vertical=0.0, p_rotate=0.0, p_hover=0.0,   # no kinetics
    p_compute=8 * 200.0,                # ~200 W per v5e chip
    p_tx_min=5.0, p_tx_max=20.0,        # ICI/DCN interface power proxy
    battery_wh=1e9,                     # pods don't run on batteries
)


def make_tpu_env(arch_names: Sequence[str],
                 weights: RewardWeights = RewardWeights(),
                 seq_len: int = 2048,
                 reduced: bool = False,
                 device: DeviceLike = None,
                 **env_kw) -> Tuple[EnvConfig, ProfileTables]:
    """The transformer env whose version axis is the quant registry
    (bf16 / w8 / w4). ``reduced=True`` profiles the smoke-test variant of
    each arch so table indices line up with an executable reduced
    ``SplitServingEngine`` model; ``seq_len`` is the served sequence
    length, so a table's cut bytes address what the engine ships."""
    from repro_torch.configs import get_config

    cfgs = [get_config(a) for a in arch_names]
    if reduced:
        cfgs = [c.reduced() for c in cfgs]
    profs = [transformer_profile(c, seq_len=seq_len) for c in cfgs]
    tables = build_tables(profs, device=device)
    # weight shipping: a (version, cut) switch stages the tail weights on
    # the server; amortize over ~1/3 episode of request slots.
    env_kw.setdefault("weight_ship_slots", 32.0)
    cfg = EnvConfig(n_uavs=len(arch_names), latency=_TPU_LATENCY,
                    power=_TPU_POWER, weights=weights.normalized(),
                    frames_per_slot=1000.0,   # request batches per slot
                    **env_kw)
    return cfg, tables


def resolve_selection(model_cfg, profile, j: int, k: int):
    """Map a table action (version j, cut index k) to what the
    SplitServingEngine executes: (quant version name, partition cut).

    ``profile`` must be the ModelProfile the tables were built from (same
    cfg). Indices beyond this model's version/cut count clamp to the last
    entry, the padding rule of build_tables."""
    from repro_torch.core import partition

    v = profile.versions[min(j, len(profile.versions) - 1)]
    layer = v.cut_points[min(k, len(v.cut_points) - 1)]
    return v.version, partition.cut_for_layer(model_cfg, layer)


def make_task_sampler(cfg: EnvConfig, trace, seed: int):
    """Adapt a workload trace (``repro_torch.sim.traces.Trace``) into the
    ``task_sampler(episode) -> (episode_len, n_uavs)`` hook the batched
    trainer consumes: per-slot offered load counts / (slot * peak_rps),
    the normalization the fleet simulator feeds ``measured_state``, so
    the agent learns what bursts look like before it meets them online.
    Each episode draws from numpy PCG64 seeded by ``SeedSequence([seed,
    episode])``, as the reference does, so the sequences are its own.
    ``trace=None`` keeps the Bernoulli task draw; a trace needs
    cfg.peak_rps > 0 to normalize counts into the load feature."""
    if trace is None:
        return None
    if cfg.peak_rps <= 0:
        raise ValueError("trace-driven training needs cfg.peak_rps > 0 "
                         "to normalize counts into the load feature")

    def task_sampler(episode):
        rng = np.random.default_rng(np.random.SeedSequence([seed, episode]))
        gen = trace.stream(rng, cfg.n_uavs, cfg.slot_seconds)
        rows = [next(gen) for _ in range(cfg.episode_len)]
        return np.clip(np.asarray(rows, dtype=np.float32)
                       / (cfg.slot_seconds * cfg.peak_rps), 0.0, 1.0)

    return task_sampler


def train_agent(cfg: EnvConfig, tables: ProfileTables,
                ac: A2C.A2CConfig = A2C.A2CConfig(), seed: int = 0,
                log_every: int = 0, trace=None):
    """Train the A2C controller on the tables' device, drawing from a
    ``torch.Generator`` seeded with ``seed`` there. Returns (agent,
    history)."""
    generator = torch.Generator(device=tables.device).manual_seed(seed)
    return A2C.train(cfg, tables, ac, generator, log_every=log_every,
                     task_sampler=make_task_sampler(cfg, trace, seed))


@torch.no_grad()
def decide(agent, cfg: EnvConfig, tables: ProfileTables, state):
    """Greedy execution-profile decision for the current state: (n, 2)."""
    obs = observe(cfg, tables, state).flatten(-2)
    valid = tables.version_valid[state["model_id"]]
    return A2C.greedy_actions(agent, obs, valid)


def measured_state(cfg: EnvConfig, tables: ProfileTables, *,
                   battery_j, bandwidth, p_tx, queue_jobs, load,
                   model_id=None, activity=None, t: int = 0) -> Dict:
    """The env-state dict ``observe``/``decide`` consume, from quantities a
    fleet measures online: remaining battery (J), link bandwidth (bps),
    transmit power (W), server queue depth (jobs; one per server in
    cluster mode) and per-device offered load in [0, 1]. On the tables'
    device."""
    dev = tables.device

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    battery_j = f32(battery_j)
    n = battery_j.shape[0]
    if model_id is None:
        model_id = torch.arange(n, device=dev) % tables.n_models
    if activity is None:
        activity = f32(cfg.activity)[None].expand(n, 3)
    return {
        "battery_j": battery_j,
        "task": torch.clip(f32(load), 0.0, 1.0),
        "p_tx": f32(p_tx),
        "model_id": torch.as_tensor(model_id, dtype=torch.long, device=dev),
        "activity": f32(activity),
        "bandwidth": f32(bandwidth),
        "queue": f32(queue_jobs),
        "t": torch.as_tensor(t, dtype=torch.int32, device=dev),
    }


@torch.no_grad()
def evaluate_policy(cfg: EnvConfig, tables: ProfileTables, policy,
                    generator: torch.Generator, episodes: int = 5) -> Dict:
    """Roll a policy (a ``repro_torch.policies.Policy`` built against this
    env, or anything exposing ``act(state, generator) -> (n, 2)``) for
    ``episodes`` episodes, one slot at a time; aggregate the paper's
    reported metrics and the (version, cut) selection histogram (Table II
    reproduction). The sums stay on the device until the end."""
    if policy.env_cfg is not cfg or policy.tables is not tables:
        raise ValueError(
            f"policy {policy.name!r} was built against a different "
            "(env_cfg, tables) world than the one being evaluated; "
            "build it from the same objects")
    M, V, K = tables.n_models, tables.n_versions, tables.n_cuts
    dev = tables.device
    keys = ("reward", "latency", "energy", "acc_score", "lat_score",
            "en_score", "alive_slots")
    sums = torch.zeros(len(keys), device=dev)
    hist = torch.zeros((M, V, K), device=dev)
    for _ in range(episodes):
        state = env_reset(cfg, tables, generator)
        for _ in range(cfg.episode_len):
            actions = policy.act(state, generator)
            m = state["model_id"]
            state, r, info = env_step(cfg, tables, state, actions, generator)
            hist.index_put_((m, actions[:, 0], actions[:, 1]), info["alive"],
                            accumulate=True)
            sums += torch.stack([
                r, torch.mean(info["t_total"]), torch.mean(info["e_infer"]),
                torch.mean(info["acc_s"]), torch.mean(info["lat_s"]),
                torch.mean(info["en_s"]), torch.sum(info["alive"])])
    steps = episodes * cfg.episode_len
    out = {k: v / steps for k, v in zip(keys, sums.tolist())}
    hist = hist.cpu().numpy().astype(np.float64)
    out["selection_hist"] = hist
    # modal (version, cut index) per model: Table II analogue
    modal = {}
    for mi, name in enumerate(tables.names):
        if hist[mi].sum() > 0:
            j, c = np.unravel_index(np.argmax(hist[mi]), hist[mi].shape)
            modal[name] = (int(j), int(c))
    out["modal_selection"] = modal
    return out
