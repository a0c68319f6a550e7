"""Named scenario presets + registry (port of
``repro.scenarios.presets``; every preset of the reference, as data).

Each preset is a complete operating regime; ``python -m
repro_torch.launch.simulate --scenario <name>`` (flags still override
individual fields) and ``run_scenario`` consume them.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.core.reward import RewardWeights
from repro_torch.scenarios.base import Scenario

_REGISTRY: Dict[str, Scenario] = {}


def register_scenario(scenario: Scenario) -> Scenario:
    if scenario.name in _REGISTRY:
        raise ValueError(f"scenario {scenario.name!r} already registered")
    _REGISTRY[scenario.name] = scenario
    return scenario


def scenario_names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_scenario(name: str) -> Scenario:
    if name not in _REGISTRY:
        raise KeyError(f"unknown scenario {name!r}; valid names: "
                       f"{', '.join(scenario_names())}")
    return _REGISTRY[name]


# --------------------------------------------------------------------------
# presets
# --------------------------------------------------------------------------

register_scenario(Scenario(
    name="paper-exact",
    description="the paper's 3-UAV testbed, faithful reward (no "
                "stability term), 30 s slots, ~1 fps reconnaissance "
                "load per device",
    devices=3, models="cycle",
    weights=RewardWeights(),                 # thirds, w_stab = 0
    slot_seconds=30.0, peak_rps=0.0,         # paper-faithful
    server_flops_per_device=None, bw_max_bps=None,   # testbed latency
    trace="poisson", trace_kw={"rate_rps": 1.0},
    slo_s=5.0, seeds=(0, 1, 2), n_requests=10_000,
    policies=("a2c", "greedy_oracle", "device_only", "full_offload"),
    episodes=300, entropy_coef=0.01, train_trace=None))

register_scenario(Scenario(
    name="paper-mmpp-burst",
    description="4-device fleet under 2-state MMPP bursts (2 -> 30 "
                "rps/device); the stability-aware controller's "
                "acceptance regime",
    devices=4, models="vgg",
    trace="mmpp", trace_kw={"rate_low_rps": 2.0, "rate_high_rps": 30.0},
    slot_seconds=10.0, peak_rps=30.0, slo_s=2.0,
    seeds=(0, 2, 4), n_requests=20_000,
    policies=("a2c", "device_only", "full_offload"),
    episodes=500))

register_scenario(Scenario(
    name="diurnal-fleet",
    description="8-device fleet under a sinusoidal day/night load "
                "(2 -> 30 rps/device) with mixed model assignment",
    devices=8, models="cycle",
    trace="diurnal", trace_kw={"base_rps": 2.0, "peak_rps": 30.0},
    slot_seconds=10.0, peak_rps=30.0, slo_s=2.0,
    seeds=(0, 1, 2), n_requests=50_000,
    policies=("a2c", "device_only", "full_offload"),
    episodes=300))

register_scenario(Scenario(
    name="degraded-link",
    description="uplink collapse: WiFi ceiling cut to 64 Mb/s (floor "
                "4 Mb/s) under MMPP bursts — offloading must be "
                "re-earned per decision",
    devices=4, models="cycle",
    bw_max_bps=64e6, bw_min_bps=4e6,
    trace="mmpp", trace_kw={"rate_low_rps": 2.0, "rate_high_rps": 20.0},
    slot_seconds=10.0, peak_rps=20.0, slo_s=2.0,
    seeds=(0, 1, 2), n_requests=20_000,
    policies=("a2c", "device_only", "full_offload"),
    episodes=400))

# -- nonstationary worlds (repro_torch.online): each preset pairs the online-
# -- adapted controller against the same controller frozen at its
# -- pre-drift parameters, under a timed WorldSchedule ---------------------

register_scenario(Scenario(
    name="link-brownout",
    description="edge-infrastructure brownout: uplink collapses below "
                "the design floor (1 Gb/s -> 6 Mb/s) and the server's "
                "effective share degrades 10x from epoch 60, recovering "
                "at 240 — the online-adapted controller must re-learn "
                "local execution, then re-earn offloading",
    devices=4, models="vgg", battery_wh=200.0,
    trace="mmpp", trace_kw={"rate_low_rps": 2.0, "rate_high_rps": 15.0},
    slot_seconds=10.0, peak_rps=20.0, slo_s=2.0,
    drift="link-brownout", drift_kw={"onset": 60, "recover": 240},
    seeds=(0, 1), n_requests=70_000,
    policies=("a2c+online", "a2c", "device_only", "full_offload"),
    episodes=300, entropy_coef=0.03, batch_envs=4))

register_scenario(Scenario(
    name="flash-crowd",
    description="flash crowd: offered rate jumps 1.75x (8 -> 14 "
                "rps/device) and the server's background workload "
                "surges 8x from epoch 50, relaxing at 220 — offloading "
                "silently drowns in a queue the controller only sees "
                "clipped (resnet fleet: every local action stays "
                "FIFO-stable, so the mistake is recoverable)",
    devices=4, models="resnet", battery_wh=200.0,
    trace="poisson", trace_kw={"rate_rps": 8.0},
    slot_seconds=10.0, peak_rps=30.0, slo_s=2.0,
    drift="flash-crowd",
    drift_kw={"onset": 50, "relax": 220, "scale": 1.75,
              "queue_scale": 8.0},
    seeds=(0, 1), n_requests=140_000,
    policies=("a2c+online", "a2c", "device_only", "full_offload"),
    episodes=300, entropy_coef=0.03, batch_envs=4))

register_scenario(Scenario(
    name="battery-cliff",
    description="battery decay cliff: remaining charge drops to 25% at "
                "epoch 70 and degraded cells draw 3x compute power — "
                "the adapted controller shifts to energy-light actions "
                "to keep the fleet alive",
    devices=4, models="vgg", battery_wh=120.0,
    trace="mmpp", trace_kw={"rate_low_rps": 2.0, "rate_high_rps": 15.0},
    slot_seconds=10.0, peak_rps=20.0, slo_s=2.0,
    drift="battery-cliff",
    drift_kw={"at": 70, "battery_scale": 0.25, "compute_scale": 3.0},
    seeds=(0, 1), n_requests=60_000,
    policies=("a2c+online", "a2c", "device_only"),
    episodes=300, entropy_coef=0.03, batch_envs=4))

register_scenario(Scenario(
    name="device-churn",
    description="device churn: devices 0-1 drop out of a 6-device mixed "
                "fleet at epoch 60 and rejoin with fresh batteries at "
                "160; the schedule exercises per-regime metrics under "
                "fleet-composition drift",
    devices=6, models="cycle", battery_wh=200.0,
    trace="poisson", trace_kw={"rate_rps": 6.0},
    slot_seconds=10.0, peak_rps=20.0, slo_s=2.0,
    drift="device-churn",
    drift_kw={"leave_at": 60, "rejoin_at": 160, "leave": (0, 1)},
    seeds=(0, 1), n_requests=50_000,
    policies=("a2c+online", "a2c", "device_only", "full_offload"),
    episodes=300, entropy_coef=0.03, batch_envs=4))

# -- server clusters (repro_torch.cluster): heterogeneous pools, learned
# -- routing over the widened (version, cut, server) action space ----------

register_scenario(Scenario(
    name="edge-cluster",
    description="heterogeneous 4-server edge pool (1x..0.2x tiers) "
                "behind a near-far radio topology with hysteresis "
                "autoscaling; A2C learns (version, cut, server) "
                "end-to-end against the classic dispatch routers",
    devices=8, models="cycle",
    pool="hetero-4", topology="near-far",
    autoscale="hysteresis",
    trace="mmpp", trace_kw={"rate_low_rps": 2.0, "rate_high_rps": 25.0},
    slot_seconds=10.0, peak_rps=30.0, slo_s=2.0,
    seeds=(0, 1, 2), n_requests=20_000,
    policies=("a2c", "round_robin", "join_shortest_queue", "local_only"),
    episodes=400, entropy_coef=0.03, batch_envs=4))

register_scenario(Scenario(
    name="cluster-brownout",
    description="flash crowd over the heterogeneous pool: offered rate "
                "jumps 1.75x and the servers' background workload "
                "surges 6x from epoch 50, relaxing at 220 — job-count "
                "JSQ misreads the slow tiers as cheap while the learned "
                "router prices depth x service rate per target",
    devices=8, models="cycle", battery_wh=200.0,
    pool="hetero-4", topology="near-far",
    autoscale="hysteresis",
    trace="poisson", trace_kw={"rate_rps": 8.0},
    slot_seconds=10.0, peak_rps=30.0, slo_s=2.0,
    drift="flash-crowd",
    drift_kw={"onset": 50, "relax": 220, "scale": 1.75,
              "queue_scale": 6.0},
    seeds=(0, 1), n_requests=60_000,
    policies=("a2c", "round_robin", "join_shortest_queue",
              "device_only"),
    episodes=400, entropy_coef=0.03, batch_envs=4))

register_scenario(Scenario(
    name="megafleet",
    description="mega-fleet scale: 100k devices under a diurnal load "
                "through the vectorized epoch engine "
                "(sim.megafleet) — static policies only (the fused "
                "epoch is the product under test; trainable nets "
                "would dominate wall-clock at this width)",
    devices=100_000, models="cycle",
    trace="diurnal", trace_kw={"base_rps": 2.0, "peak_rps": 8.0},
    slot_seconds=1.0, peak_rps=10.0, slo_s=1.0,
    seeds=(0,), n_requests=5_000_000,
    policies=("greedy_oracle", "device_only", "full_offload"),
    engine="vectorized"))

register_scenario(Scenario(
    name="tpu-submesh",
    description="TPU adaptation: 2 head submeshes serving reduced "
                "qwen2-0.5b, version axis = {bf16, w8, w4}, ICI uplink, "
                "analytical pricing",
    env="tpu", devices=2, arch="qwen2-0.5b",
    trace="poisson", trace_kw={"rate_rps": 100.0},
    slot_seconds=1.0, peak_rps=200.0, slo_s=0.05,
    seeds=(0, 1), n_requests=20_000,
    policies=("greedy_oracle", "device_only", "full_offload"),
    episodes=200))

register_scenario(Scenario(
    name="tpu-execute",
    description="tpu-submesh plus the execute cross-check: a sampled "
                "subset of requests runs through the real "
                "SplitServingEngine (act-bytes must match exactly)",
    env="tpu", devices=2, arch="qwen2-0.5b",
    trace="poisson", trace_kw={"rate_rps": 100.0},
    slot_seconds=1.0, peak_rps=200.0, slo_s=0.05,
    seeds=(0,), n_requests=2_000,
    policies=("greedy_oracle",),
    episodes=200, execute=True, sample=8))
