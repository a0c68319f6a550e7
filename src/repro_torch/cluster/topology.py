"""Device -> server network topology: the per-target link matrix (port
of ``repro.cluster.topology``; numpy only, copied).

A ``Topology`` holds two (n_devices, n_servers) matrices: a bandwidth
multiplier on each device's measured uplink rate (``link_scale``) and a
per-transfer propagation delay (``rtt_s``). The pricing core applies
them to the *chosen* server, repricing the paper's Eq. 2/3 transmission
terms per target: T_trans = 8 D / (B * scale[d, s]) + rtt[d, s] and
E_trans = P_tx * 8 D / (B * scale[d, s]).

Presets are registered under the same KeyError-listing convention as
``get_trace``/``get_schedule``; each factory takes (n_devices,
n_servers) plus preset-specific kwargs and may be deterministic or
seeded (``seed`` kwarg): topologies are world *structure*, fixed for a
run, never drawn from the simulation's rng streams.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Topology:
    """Per device -> server link matrix (row-major float tuples, so a
    cluster-mode EnvConfig stays hashable)."""
    name: str
    link_scale: Tuple[Tuple[float, ...], ...]   # (n, S)
    rtt_s: Tuple[Tuple[float, ...], ...]        # (n, S)

    @property
    def n_devices(self) -> int:
        return len(self.link_scale)

    @property
    def n_servers(self) -> int:
        return len(self.link_scale[0]) if self.link_scale else 0


def _mat(a) -> Tuple[Tuple[float, ...], ...]:
    return tuple(tuple(float(v) for v in row) for row in np.asarray(a))


_TOPOLOGIES: Dict[str, object] = {}


def register_topology(name: str, factory) -> None:
    if name in _TOPOLOGIES:
        raise ValueError(f"topology {name!r} already registered")
    _TOPOLOGIES[name] = factory


def topology_names() -> Tuple[str, ...]:
    return tuple(sorted(_TOPOLOGIES))


def get_topology(name: str, n_devices: int, n_servers: int,
                 **kw) -> Topology:
    """Named topology preset -> (n_devices, n_servers) link matrix; a
    miss lists every valid name (the get_trace convention)."""
    if name not in _TOPOLOGIES:
        raise KeyError(f"unknown topology {name!r}; valid topologies: "
                       f"{', '.join(topology_names())}")
    return _TOPOLOGIES[name](n_devices, n_servers, **kw)


def _uniform(n: int, S: int) -> Topology:
    """Every link at the device's measured rate, zero added delay: the
    degenerate topology under which a 1-server pool is bit-identical to
    the classic fleet (x1.0 and +0.0 are exact float identities)."""
    return Topology(name="uniform",
                    link_scale=_mat(np.ones((n, S))),
                    rtt_s=_mat(np.zeros((n, S))))


def _near_far(n: int, S: int, far_scale: float = 0.35,
              far_rtt_s: float = 0.02, near_rtt_s: float = 0.002) -> Topology:
    """Each device is radio-adjacent to one server (round-robin by
    device index) and reaches the rest over a degraded multi-hop path:
    ``far_scale`` of its measured rate plus ``far_rtt_s`` per transfer."""
    scale = np.full((n, S), far_scale)
    rtt = np.full((n, S), far_rtt_s)
    near = np.arange(n) % S
    scale[np.arange(n), near] = 1.0
    rtt[np.arange(n), near] = near_rtt_s
    return Topology(name="near-far", link_scale=_mat(scale),
                    rtt_s=_mat(rtt))


def _tiered(n: int, S: int, backhaul_scale: float = 0.5,
            hop_rtt_s: float = 0.01) -> Topology:
    """Server 0 is the shared close micro-edge (full rate, negligible
    delay); servers 1.. sit progressively deeper behind the backhaul,
    each hop halving the rate again and adding ``hop_rtt_s``."""
    scale = np.ones((n, S))
    rtt = np.zeros((n, S))
    for s in range(1, S):
        scale[:, s] = backhaul_scale ** s
        rtt[:, s] = hop_rtt_s * s
    return Topology(name="tiered", link_scale=_mat(scale), rtt_s=_mat(rtt))


register_topology("uniform", _uniform)
register_topology("near-far", _near_far)
register_topology("tiered", _tiered)
