"""repro_torch.policies: one Policy protocol + canonical name registry
(port of ``repro.policies``; the static roster so far).

Importing this package registers ``device_only``, ``full_offload``,
``random`` and ``greedy_oracle``. ``build_policy(name, env_cfg, tables,
**kw)`` is the one entry point; unknown names raise a KeyError listing
every valid name.
"""
from repro_torch.policies.base import (Policy, PolicySpec, build_policy,
                                       get_policy_spec, policy_names, register)
from repro_torch.policies.static import StaticPolicy

__all__ = [
    "Policy", "PolicySpec", "StaticPolicy",
    "register", "build_policy", "get_policy_spec", "policy_names",
]
