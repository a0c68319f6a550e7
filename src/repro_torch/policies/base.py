"""The Policy protocol + canonical name registry (port of
``repro.policies.base``).

    spec = get_policy_spec("greedy_oracle")    # canonical names only
    policy = spec.build(env_cfg, tables)       # bound to one env
    actions = policy.act(state, generator)     # (n, 2) int64 decide

``act`` runs eagerly on the env-state dict (tensors on the tables'
device); random policies draw from the ``torch.Generator`` they are given.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple


class Policy:
    """A controller bound to one (env_cfg, tables) world. Subclasses
    implement ``act``."""

    name: str = "policy"
    trainable: bool = False

    def __init__(self, env_cfg, tables):
        self.env_cfg = env_cfg
        self.tables = tables

    def act(self, state, generator=None):
        """(env-state dict, torch.Generator) -> (n_uavs, 2) (version, cut)."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class PolicySpec:
    """Registry entry: how to build one named policy for a given env."""
    name: str
    factory: Callable[..., Policy]
    trainable: bool = False
    description: str = ""
    needs_cluster: bool = False  # only buildable when EnvConfig.cluster set

    def build(self, env_cfg, tables, **kw) -> Policy:
        policy = self.factory(env_cfg, tables, **kw)
        policy.name = self.name
        return policy


_REGISTRY: Dict[str, PolicySpec] = {}


def register(spec: PolicySpec) -> PolicySpec:
    if spec.name in _REGISTRY:
        raise ValueError(f"policy {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    return spec


def policy_names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def get_policy_spec(name: str) -> PolicySpec:
    """Canonical-name lookup; a miss names every valid policy."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown policy {name!r}; valid names: "
                       f"{', '.join(policy_names())}")
    return _REGISTRY[name]


def build_policy(name: str, env_cfg, tables, **kw) -> Policy:
    return get_policy_spec(name).build(env_cfg, tables, **kw)
