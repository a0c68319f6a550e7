"""repro_torch.scenarios: declarative experiment regimes + the one entry
point (port of ``repro.scenarios``).

A ``Scenario`` names a complete operating regime (env kind, fleet shape,
reward weights, workload trace, SLO, seeds, training budget); importing
this package registers the reference's presets (``scenario_names()``
lists them) and ``run_scenario(scenario, policies)`` runs any policy
roster against one with paired-seed comparisons built in.
"""
from repro_torch.scenarios.base import Scenario
from repro_torch.scenarios.presets import (get_scenario, register_scenario,
                                           scenario_names)
from repro_torch.scenarios.run import (ComparisonReport, PolicyResult,
                                       run_scenario, split_policy_name)

__all__ = [
    "Scenario", "ComparisonReport", "PolicyResult",
    "get_scenario", "register_scenario", "scenario_names", "run_scenario",
    "split_policy_name",
]
