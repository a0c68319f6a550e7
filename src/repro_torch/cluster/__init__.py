"""repro_torch.cluster: the static description of a heterogeneous
edge-server pool that a cluster-mode ``EnvConfig`` carries."""
from repro_torch.cluster.pool import (ClusterParams, ServerSpec, build_cluster,
                                      get_pool, pool_names, register_pool)

__all__ = ["ClusterParams", "ServerSpec", "build_cluster", "get_pool",
           "pool_names", "register_pool"]
