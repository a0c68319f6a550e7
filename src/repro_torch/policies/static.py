"""Static (non-trainable) policies: the paper's implicit baselines,
wrapped from ``repro_torch.core.baselines`` into the Policy protocol and
registered under their canonical names (port of
``repro.policies.static``).
"""
from __future__ import annotations

from repro_torch.core import baselines
from repro_torch.policies.base import Policy, PolicySpec, register


class StaticPolicy(Policy):
    """Binds a pure baseline function ``fn(cfg, tables, state, generator)``
    to one env; stateless, so ``build`` is the whole lifecycle."""

    def __init__(self, env_cfg, tables, fn):
        super().__init__(env_cfg, tables)
        self._fn = fn

    def act(self, state, generator=None):
        return self._fn(self.env_cfg, self.tables, state, generator)


def _static(name: str, fn, description: str) -> PolicySpec:
    return register(PolicySpec(
        name=name,
        factory=lambda env_cfg, tables, **kw: StaticPolicy(env_cfg, tables,
                                                           fn),
        trainable=False, description=description))


_static("device_only", baselines.device_only,
        "lightweight version, everything local (last cut)")
_static("full_offload", baselines.full_offload,
        "heaviest valid version, cut as early as possible")
_static("random", baselines.random_policy,
        "uniform over valid (version, cut) pairs")
_static("greedy_oracle", baselines.greedy_oracle,
        "per-step per-UAV reward argmax over the (V, K) grid")
