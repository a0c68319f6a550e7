"""Fleet simulation via the scenario API (port of ``examples/fleet_sim.py``):
take the ``paper-mmpp-burst`` preset, train the stability-aware controller
under domain-randomized load, then stress it against bursty (MMPP)
traffic next to the static baselines, the same request stream for every
policy, and optionally persist the trained controller as a reusable
artifact. Runs on the CUDA card unless ``--device`` names another.

    PYTHONPATH=src python -m repro_torch.launch.fleet_sim [--devices 4] \\
        [--save-policy controller.npz] [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.scenarios import get_scenario, run_scenario


def main(argv=None):
    """Returns the ComparisonReport."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=4)
    ap.add_argument("--episodes", type=int, default=500)
    ap.add_argument("--requests", type=int, default=20_000)
    ap.add_argument("--save-policy", default=None,
                    help="persist the trained controller (.npz)")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the current CUDA card")
    args = ap.parse_args(argv)

    scenario = get_scenario("paper-mmpp-burst").replace(
        devices=args.devices, episodes=args.episodes, n_requests=args.requests)
    report = run_scenario(
        scenario, ("a2c", "device_only", "full_offload"), device=args.device,
        save_policies={"a2c": args.save_policy} if args.save_policy else None,
        verbose=True)

    best = max(report.results.values(), key=lambda r: r.mean["slo_attainment"])
    print(f"\nbest SLO attainment: {best.name} "
          f"({best.mean['slo_attainment']:.3f} over paired seeds "
          f"{list(report.seeds)})")
    return report


if __name__ == "__main__":
    main()
