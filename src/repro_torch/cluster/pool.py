"""Heterogeneous edge-server pool: static description + runtime state
(port of ``repro.cluster.pool``; numpy only, copied).

``ServerSpec`` describes one server relative to the env's single-server
baseline (``LatencyParams.server_flops`` / ``job_service_s``): a FLOPs
scale for the tail compute the pricing core divides by, a service-time
scale for its background-job queue, a replica count, a DVFS ladder and a
per-replica power draw.

``ClusterParams`` is the frozen, hashable projection a cluster-mode
``EnvConfig`` carries (plain float tuples): per-server scales plus the
per device -> server link matrix of a topology. The pricing core
(``core/pricing.py``) reads it to reprice the Eq. 2/3 transmission terms
and the Eq. 4 queue/tail terms per chosen server when actions carry a
server column.

``ServerPool`` is the runtime object the fleet loop owns: live replica
counts and DVFS levels (moved per epoch by the autoscaler,
``repro_torch.cluster.autoscale``), the derived effective service arrays
pricing and the per-server Lindley backlog use, and the replica-energy
meter. A 1-server pool at uniform topology is bit-identical to the
classic single-server fleet: every derived quantity is the baseline
value multiplied by exactly 1.0.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from repro_torch.cluster.autoscale import Autoscaler


@dataclasses.dataclass(frozen=True)
class ServerSpec:
    """One edge server, relative to the baseline single server."""
    name: str = "edge"
    flops_scale: float = 1.0       # x LatencyParams.server_flops
    service_scale: float = 1.0     # x LatencyParams.job_service_s
    bg_arrival_scale: float = 1.0  # x EnvConfig.queue_arrival_rate
    bg_service_scale: float = 1.0  # x EnvConfig.queue_service_per_slot
    replicas: int = 1              # initial active replicas
    max_replicas: int = 1          # autoscaler ceiling
    # available frequency scalings, ascending; the env trains at the top step
    dvfs: Tuple[float, ...] = (1.0,)
    p_replica_w: float = 0.0       # per-replica power draw at dvfs = 1.0


@dataclasses.dataclass(frozen=True)
class ClusterParams:
    """Hashable cluster description carried by ``EnvConfig.cluster``.

    Per-server entries are indexed by server id s in [0, S); link
    matrices are (n_devices, S) row-major tuples. ``nominal`` derives
    the effective service arrays at initial replicas / top DVFS, the
    operating point trainable controllers price against.
    """
    flops_scale: Tuple[float, ...]
    service_scale: Tuple[float, ...]
    bg_arrival_scale: Tuple[float, ...]
    bg_service_scale: Tuple[float, ...]
    replicas: Tuple[int, ...]
    max_replicas: Tuple[int, ...]
    dvfs: Tuple[Tuple[float, ...], ...]
    p_replica_w: Tuple[float, ...]
    link_scale: Tuple[Tuple[float, ...], ...]   # (n, S) bandwidth x
    link_rtt_s: Tuple[Tuple[float, ...], ...]   # (n, S) round-trip s
    names: Tuple[str, ...]

    @property
    def n_servers(self) -> int:
        return len(self.flops_scale)

    @property
    def n_devices(self) -> int:
        return len(self.link_scale)

    def nominal(self, lp, xp=np):
        """(srv_flops, srv_service_s) at initial replicas / top DVFS, as
        ``xp`` arrays (``numpy`` or ``torch``).

        Multiplications keep the baseline factor first, so a 1.0-scaled
        single server reproduces ``lp.server_flops`` / ``job_service_s``
        bit-exactly.
        """
        speed = [r * d[-1] for r, d in zip(self.replicas, self.dvfs)]
        flops = xp.asarray([lp.server_flops * f * s
                            for f, s in zip(self.flops_scale, speed)])
        service = xp.asarray([lp.job_service_s * sc / s
                              for sc, s in zip(self.service_scale, speed)])
        return flops, service


def build_cluster(servers: Tuple[ServerSpec, ...], topology) -> ClusterParams:
    """Fuse a server tuple and a topology (any object with ``name``,
    ``n_servers`` and (n, S) ``link_scale`` / ``rtt_s`` matrices) into
    ``ClusterParams``."""
    S = len(servers)
    if topology.n_servers != S:
        raise ValueError(
            f"topology {topology.name!r} is built for "
            f"{topology.n_servers} servers, pool has {S}")
    return ClusterParams(
        flops_scale=tuple(s.flops_scale for s in servers),
        service_scale=tuple(s.service_scale for s in servers),
        bg_arrival_scale=tuple(s.bg_arrival_scale for s in servers),
        bg_service_scale=tuple(s.bg_service_scale for s in servers),
        replicas=tuple(int(s.replicas) for s in servers),
        max_replicas=tuple(int(s.max_replicas) for s in servers),
        dvfs=tuple(tuple(float(d) for d in s.dvfs) for s in servers),
        p_replica_w=tuple(s.p_replica_w for s in servers),
        link_scale=tuple(tuple(float(v) for v in row)
                         for row in topology.link_scale),
        link_rtt_s=tuple(tuple(float(v) for v in row)
                         for row in topology.rtt_s),
        names=tuple(s.name for s in servers))


@dataclasses.dataclass
class PoolEffective:
    """Live per-server service arrays at the pool's current replica /
    DVFS state (all (S,) float64)."""
    flops: np.ndarray         # tail FLOP/s the pricing core divides by
    service_s: np.ndarray     # background-job service seconds
    bg_drain: np.ndarray      # background jobs drained per slot
    cap_scale: np.ndarray     # fleet-backlog drain multiplier


class ServerPool:
    """Runtime replica/DVFS state + replica-energy meter for one fleet
    simulation. ``tick`` advances the autoscaler (if any) on measured
    per-server queue depth and meters replica energy for the slot;
    ``effective`` derives the live service arrays under the *current
    regime's* physics (drift patches change ``lp`` mid-run)."""

    def __init__(self, cluster: ClusterParams, autoscaler=None):
        self.cluster = cluster
        S = cluster.n_servers
        self.replicas = np.asarray(cluster.replicas, dtype=np.int64)
        self.dvfs_idx = np.asarray([len(d) - 1 for d in cluster.dvfs],
                                   dtype=np.int64)
        self.energy_j = 0.0
        self.scale_events = 0
        self._replica_slots = 0.0   # sum over epochs of active replicas
        self._epochs = 0
        # last tick's snapshot: the state the epoch actually ran at (taken
        # *before* the autoscaler moves) plus its decisions
        self.last_dvfs = self._dvfs()
        self.last_replicas = self.replicas.copy()
        self.last_power_w = np.zeros(S)
        self.last_decisions: list = []
        self.autoscaler = None if autoscaler is None else Autoscaler(autoscaler, S)

    def _dvfs(self) -> np.ndarray:
        return np.asarray([self.cluster.dvfs[s][self.dvfs_idx[s]]
                           for s in range(self.cluster.n_servers)])

    def effective(self, lp, env_cfg) -> PoolEffective:
        # the reference's order of multiplication: a 1.0-scaled single
        # server reproduces the classic fleet's values bit for bit
        c = self.cluster
        speed = self.replicas * self._dvfs()
        flops = np.asarray(c.flops_scale) * speed * lp.server_flops
        service = lp.job_service_s * np.asarray(c.service_scale) / speed
        bg_drain = env_cfg.queue_service_per_slot \
            * np.asarray(c.bg_service_scale) * speed
        return PoolEffective(flops=flops, service_s=service,
                             bg_drain=bg_drain, cap_scale=speed)

    def tick(self, queue_jobs: np.ndarray, slot_seconds: float) -> None:
        """One epoch: meter replica energy at the current state, then
        let the autoscaler move replicas/DVFS for the next epoch."""
        d = self._dvfs()
        p = np.asarray(self.cluster.p_replica_w) * self.replicas * d ** 3
        self.energy_j += float(p.sum()) * slot_seconds
        self._replica_slots += float(self.replicas.sum())
        self._epochs += 1
        self.last_dvfs = d
        self.last_replicas = self.replicas.copy()
        self.last_power_w = p
        self.last_decisions = []
        if self.autoscaler is not None:
            self.last_decisions = self.autoscaler.step(self, np.asarray(queue_jobs))
            self.scale_events += len(self.last_decisions)

    def summary(self) -> Dict[str, float]:
        return {
            "server_energy_j": self.energy_j,
            "scale_events": float(self.scale_events),
            "mean_replicas": self._replica_slots / max(self._epochs, 1),
        }


# --------------------------------------------------------------------------
# pool preset registry (a miss lists every valid name)
# --------------------------------------------------------------------------

_POOLS: Dict[str, object] = {}


def register_pool(name: str, factory) -> None:
    if name in _POOLS:
        raise ValueError(f"server pool {name!r} already registered")
    _POOLS[name] = factory


def pool_names() -> Tuple[str, ...]:
    return tuple(sorted(_POOLS))


def get_pool(name: str, **kw) -> Tuple[ServerSpec, ...]:
    """Named pool preset -> server tuple; a miss lists every valid name."""
    if name not in _POOLS:
        raise KeyError(f"unknown server pool {name!r}; valid pools: "
                       f"{', '.join(pool_names())}")
    return tuple(_POOLS[name](**kw))


def _single():
    """The degenerate pool: one baseline server, no autoscaling room."""
    return (ServerSpec(name="edge"),)


def _uniform(n: int = 4, p_replica_w: float = 45.0, max_replicas: int = 2):
    """n identical baseline-rate servers splitting the background load."""
    return tuple(ServerSpec(name=f"edge{i}", bg_arrival_scale=1.0 / n,
                            max_replicas=max_replicas,
                            p_replica_w=p_replica_w)
                 for i in range(n))


def _hetero4(p_replica_w: float = 45.0):
    """Four-tier heterogeneous pool: one fast box down to a quarter-rate
    micro-edge. Service time scales inversely with FLOPs, and the fast
    servers carry most of the ambient background workload."""
    tiers = ((1.0, 1.0), (0.65, 0.75), (0.4, 0.5), (0.2, 0.25))
    return tuple(
        ServerSpec(name=f"tier{i}", flops_scale=f,
                   service_scale=1.0 / f, bg_arrival_scale=bg,
                   replicas=1, max_replicas=1 + i,
                   dvfs=(0.6, 0.8, 1.0), p_replica_w=p_replica_w * f)
        for i, (f, bg) in enumerate(tiers))


register_pool("single", _single)
register_pool("uniform-4", _uniform)
register_pool("hetero-4", _hetero4)
