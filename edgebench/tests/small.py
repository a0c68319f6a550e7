"""Small sizes for the CPU tests: each configuration at the port's
``.reduced()`` widths, and each traffic mix with short sequences."""
from __future__ import annotations

import copy

from edgebench import harness, workload


def small_config(name: str) -> dict:
    """The configuration file with its sizes replaced by the port's reduced
    configuration's."""
    from repro_torch.configs.base import get_config

    config = harness.load_config(name)
    reduced = get_config(config["arch"]).reduced()
    config = copy.deepcopy(config)
    config["model"] = {k: getattr(reduced, k) for k in config["model"]}
    return config


def small_mix(name: str) -> dict:
    mix = copy.deepcopy(workload.load_mix(name))
    body, tail = mix["seq"]["pieces"]
    mix["seq"] = dict(mix["seq"], pieces=[dict(body, min=16, max=48), dict(tail, min=48, max=96)])
    mix["max_rounds"] = 6
    return mix

