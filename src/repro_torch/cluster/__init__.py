"""repro_torch.cluster: heterogeneous edge-server pool with learned
routing (port of ``repro.cluster``; numpy only).

Widens the EdgeRL action space from (version, cut) to (version, cut,
server): a ``ServerPool`` of per-server service rates / DVFS / replicas
(pool.py), a device->server link ``Topology`` repricing the Eq. 2/3
transmission terms per target (topology.py), and an AutoScale-style
``Autoscaler`` trading replica energy against queue wait (autoscale.py).
The router baselines (round_robin / join_shortest_queue / local_only)
live in routers.py, in torch, and register themselves into the
``repro_torch.policies`` registry when that package is imported (not
here, so that ``core.env`` imports this package without a cycle).
"""
from repro_torch.cluster.autoscale import Autoscaler, AutoscalerConfig
from repro_torch.cluster.pool import (ClusterParams, PoolEffective, ServerPool,
                                      ServerSpec, build_cluster, get_pool,
                                      pool_names, register_pool)
from repro_torch.cluster.topology import (Topology, get_topology,
                                          register_topology, topology_names)

__all__ = [
    "Autoscaler", "AutoscalerConfig", "ClusterParams", "PoolEffective",
    "ServerPool", "ServerSpec", "Topology", "build_cluster", "get_pool",
    "get_topology", "pool_names", "register_pool", "register_topology",
    "topology_names",
]
