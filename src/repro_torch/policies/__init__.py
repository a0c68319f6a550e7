"""repro_torch.policies: one Policy protocol + canonical name registry
(port of ``repro.policies``).

Importing this package registers:

- static:    ``device_only``, ``full_offload``, ``random``,
             ``greedy_oracle``
- routers:   ``round_robin``, ``join_shortest_queue``, ``local_only``
             (cluster-mode envs only; repro_torch.cluster.routers)
- trainable: ``a2c`` (the paper's controller), ``ppo`` (ablation)

``build_policy(name, env_cfg, tables, **kw)`` is the one entry point;
unknown names raise a KeyError listing every valid name.
"""
from repro_torch.policies.base import (Policy, PolicySpec, build_policy,
                                       get_policy_spec, policy_names, register)
from repro_torch.policies.static import StaticPolicy
from repro_torch.policies.trainable import A2CPolicy, PPOPolicy, TrainablePolicy

import repro_torch.cluster.routers  # noqa: F401,E402  (registers the router roster)

__all__ = [
    "Policy", "PolicySpec", "StaticPolicy", "TrainablePolicy", "A2CPolicy",
    "PPOPolicy",
    "register", "build_policy", "get_policy_spec", "policy_names",
]
