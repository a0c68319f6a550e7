"""The declarative Scenario: one dataclass describing an experiment's
whole operating regime (env kind + fleet shape, reward weighting,
workload trace, SLO, training budget and evaluation seeds), so every
consumer enumerates requirements instead of re-plumbing
build_trace/build_env/build_policy by hand (port of
``repro.scenarios.base``).

Every field of the reference is declared, so its presets register here
unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core import make_paper_env, make_tpu_env, transformer_profile
from repro_torch.core.latency import LatencyParams
from repro_torch.core.reward import RewardWeights
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.sim import AnalyticalBackend, ExecuteBackend, get_trace
from repro_torch.sim.traces import Trace


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named, fully-specified operating regime.

    ``build_env()``/``build_trace()``/``build_train_trace()`` turn the
    declaration into live objects; ``run_scenario``
    (repro_torch.scenarios.run) is the single entry point that consumes
    them. ``replace(**kw)`` derives variants (CLI flags override preset
    fields through it).
    """
    name: str
    description: str = ""

    # --- world -----------------------------------------------------------
    env: str = "paper"                   # "paper" | "tpu"
    devices: int = 4
    arch: str = "qwen2-0.5b"             # tpu env: assigned transformer
    models: str = "cycle"                # paper env fleet composition
    weights: RewardWeights = dataclasses.field(
        default_factory=lambda: RewardWeights(w_acc=0.05, w_lat=0.10,
                                              w_energy=0.15, w_stab=0.70))
    slot_seconds: float = 10.0
    peak_rps: float = 30.0               # 0 -> paper-faithful reward
    # paper-env fleet provisioning; None keeps LatencyParams defaults
    # (the paper's 3-UAV testbed numbers)
    server_flops_per_device: Optional[float] = 0.55e12
    bw_max_bps: Optional[float] = 1e9
    bw_min_bps: Optional[float] = None

    # --- server cluster (repro_torch.cluster; paper env only) -------------
    # named pool preset (cluster.get_pool) -> heterogeneous server pool;
    # None keeps the classic single-server world with (version, cut)
    # actions. With a pool, actions widen to (version, cut, server) and
    # the topology preset prices each device->server link.
    pool: Optional[str] = None
    pool_kw: Dict = dataclasses.field(default_factory=dict)
    topology: str = "uniform"
    topology_kw: Dict = dataclasses.field(default_factory=dict)
    # named autoscaler policy over the pool ("threshold"|"hysteresis");
    # None pins replicas/DVFS at the nominal operating point
    autoscale: Optional[str] = None
    autoscale_kw: Dict = dataclasses.field(default_factory=dict)

    # --- workload ---------------------------------------------------------
    trace: str = "mmpp"
    trace_kw: Dict = dataclasses.field(default_factory=dict)

    # --- nonstationarity / online adaptation (repro_torch.online) ----------
    # named WorldSchedule factory (drift.get_schedule) + kwargs; None
    # keeps the world stationary
    drift: Optional[str] = None
    drift_kw: Dict = dataclasses.field(default_factory=dict)
    # OnlineConfig overrides for "+online" roster entries (the algo is
    # taken from the policy spec: a2c -> a2c objective, ppo -> ppo)
    online_kw: Dict = dataclasses.field(default_factory=dict)
    # device battery override (Wh); nonstationary runs need the fleet
    # to outlive the drift-recover cycle (paper env only)
    battery_wh: Optional[float] = None

    # --- evaluation -------------------------------------------------------
    slo_s: float = 2.0
    # SLO attainment objective the error-budget report (repro_torch.obs.
    # slo) burns against; run_scenario passes it to FleetConfig
    slo_target: float = 0.95
    seeds: Tuple[int, ...] = (0, 1, 2)   # paired across policies
    n_requests: int = 20_000
    policies: Tuple[str, ...] = ("a2c", "device_only", "full_offload")
    # fleet epoch-flow engine (FleetConfig.engine): "loop" per-device
    # oracle, "vectorized" fused numpy (bit-identical)
    engine: str = "loop"

    # --- training budget (trainable policies) -----------------------------
    episodes: int = 300
    entropy_coef: float = 0.03
    batch_envs: int = 1
    train_seed: int = 0
    train_trace: Optional[str] = "uniform"   # domain randomization
    train_trace_kw: Dict = dataclasses.field(default_factory=dict)

    # --- execute cross-check (tpu env) -------------------------------------
    execute: bool = False
    sample: int = 16
    exec_seq: int = 32

    def replace(self, **kw) -> "Scenario":
        return dataclasses.replace(self, **kw)

    # -- build_* methods ---------------------------------------------------
    def build_trace(self) -> Trace:
        return get_trace(self.trace, **self.trace_kw)

    def build_schedule(self):
        """The scenario's WorldSchedule, or None when stationary."""
        if self.drift is None:
            return None
        from repro_torch.online import get_schedule
        return get_schedule(self.drift, **self.drift_kw)

    def build_online(self, algo: str = "a2c"):
        """OnlineConfig for a '+online' roster entry; ``algo`` comes
        from the policy spec so A2C and PPO adapt with their own
        objective on the shared incremental-update machinery."""
        from repro_torch.online import OnlineConfig
        return OnlineConfig(algo=algo, **self.online_kw)

    def build_cluster(self):
        """ClusterParams from the pool/topology presets, or None."""
        if self.pool is None:
            return None
        from repro_torch.cluster import build_cluster, get_pool, get_topology
        servers = get_pool(self.pool, **self.pool_kw)
        topo = get_topology(self.topology, self.devices, len(servers),
                            **self.topology_kw)
        return build_cluster(servers, topo)

    def build_autoscaler(self):
        """AutoscalerConfig for the fleet's ServerPool, or None."""
        if self.autoscale is None:
            return None
        if self.pool is None:
            raise ValueError(f"scenario {self.name!r} sets autoscale="
                             f"{self.autoscale!r} without a server pool")
        from repro_torch.cluster import AutoscalerConfig
        return AutoscalerConfig(policy=self.autoscale,
                                **self.autoscale_kw)

    def build_train_trace(self) -> Optional[Trace]:
        """The load process trainable policies see; None under the
        paper-faithful reward (peak_rps == 0 -> Bernoulli task draws)."""
        if self.train_trace is None or self.peak_rps <= 0:
            return None
        kw = dict(self.train_trace_kw)
        if self.train_trace == "uniform" and not kw:
            kw = {"max_rps": self.peak_rps}   # cover the whole load range
        return get_trace(self.train_trace, **kw)

    def build_env(self, device: DeviceLike = None):
        """Returns (env_cfg, tables, model_ids, backend_factory), the
        tables (and an executed model) on ``device``: the CUDA card
        unless another is named."""
        dev = resolve_device(device)
        if self.env == "tpu":
            return self._build_tpu_env(dev)
        if self.execute:
            raise ValueError("execute=True needs env='tpu' (the "
                             "executable engine serves the transformer "
                             "stack)")
        lat_kw = {}
        if self.server_flops_per_device is not None:
            lat_kw["server_flops"] = self.server_flops_per_device \
                * self.devices
        if self.bw_max_bps is not None:
            lat_kw["bw_max_bps"] = self.bw_max_bps
        if self.bw_min_bps is not None:
            lat_kw["bw_min_bps"] = self.bw_min_bps
        env_kw = {}
        if self.battery_wh is not None:
            from repro_torch.core.energy import DevicePower
            env_kw["power"] = DevicePower(battery_wh=self.battery_wh)
        cluster = self.build_cluster()
        if cluster is not None:
            env_kw["cluster"] = cluster
        env_cfg, tables = make_paper_env(
            weights=self.weights, n_uavs=self.devices,
            latency=LatencyParams(**lat_kw),
            slot_seconds=self.slot_seconds, peak_rps=self.peak_rps,
            # one frame per request at saturation: env battery drain per
            # slot equals the fleet's per-request metering
            frames_per_slot=self.slot_seconds * max(self.peak_rps, 1.0),
            device=dev, **env_kw)
        if self.models == "cycle":
            model_ids = np.arange(self.devices,
                                  dtype=np.int32) % tables.n_models
        else:
            model_ids = np.full(self.devices,
                                tables.names.index(self.models), np.int32)
        return env_cfg, tables, model_ids, \
            lambda: AnalyticalBackend(env_cfg, tables)

    def _build_tpu_env(self, dev):
        import torch

        from repro_torch.configs import get_config
        from repro_torch.models import init
        from repro_torch.serving import SplitServingEngine

        if self.pool is not None:
            raise ValueError("server pools (Scenario.pool) model the "
                             "paper env's edge cluster; the tpu env's "
                             "tail submesh is a single shared server")
        archs = [self.arch] * self.devices
        env_cfg, tables = make_tpu_env(
            archs, weights=self.weights, reduced=True,
            seq_len=self.exec_seq, slot_seconds=self.slot_seconds,
            peak_rps=self.peak_rps, device=dev)
        model_ids = np.zeros(self.devices, np.int32)

        def backend_factory():
            if not self.execute:
                return AnalyticalBackend(env_cfg, tables)
            cfg = get_config(self.arch).reduced()
            prof = transformer_profile(cfg, seq_len=self.exec_seq)
            model = init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
            engine = SplitServingEngine(cfg, model, tuple(v.version for v in prof.versions),
                                        device=dev)
            return ExecuteBackend(env_cfg, tables, [cfg], [prof], [engine],
                                  seq_len=self.exec_seq, sample=self.sample)
        return env_cfg, tables, model_ids, backend_factory
