"""repro_torch.policies: one Policy protocol + canonical name registry
(port of ``repro.policies``).

Importing this package registers:

- static:    ``device_only``, ``full_offload``, ``random``,
             ``greedy_oracle``
- trainable: ``a2c`` (the paper's controller)

The reference's ``ppo`` ablation waits for ``core/ppo.py``, and its
cluster routers (``round_robin``, ``join_shortest_queue``,
``local_only``) for ``cluster/routers.py``.
``build_policy(name, env_cfg, tables, **kw)`` is the one entry point;
unknown names raise a KeyError listing every valid name.
"""
from repro_torch.policies.base import (Policy, PolicySpec, build_policy,
                                       get_policy_spec, policy_names, register)
from repro_torch.policies.static import StaticPolicy
from repro_torch.policies.trainable import A2CPolicy, TrainablePolicy

__all__ = [
    "Policy", "PolicySpec", "StaticPolicy", "TrainablePolicy", "A2CPolicy",
    "register", "build_policy", "get_policy_spec", "policy_names",
]
