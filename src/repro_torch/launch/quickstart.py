"""Quickstart (port of ``examples/quickstart.py``): train the EdgeRL A2C
controller on the paper's testbed env (3 UAVs running VGG / ResNet /
DenseNet against one edge server) and compare the learned policy with the
static baselines, all built through the policy registry. Runs on the CUDA
card unless ``--device`` names another.

    PYTHONPATH=src python -m repro_torch.launch.quickstart [--episodes 300] [--device cpu]
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.core import RewardWeights, evaluate_policy, make_paper_env
from repro_torch.device import resolve_device
from repro_torch.policies import build_policy, get_policy_spec, policy_names


def main(argv=None):
    """Returns {policy: evaluate_policy's metrics}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--episodes", type=int, default=300)
    ap.add_argument("--w-acc", type=float, default=1 / 3)
    ap.add_argument("--w-lat", type=float, default=1 / 3)
    ap.add_argument("--w-energy", type=float, default=1 / 3)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the current CUDA card")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    weights = RewardWeights(w_acc=args.w_acc, w_lat=args.w_lat, w_energy=args.w_energy)
    cfg, tables = make_paper_env(weights=weights, device=dev)
    print(f"env: {cfg.n_uavs} UAVs, models={tables.names}, "
          f"delta={cfg.slot_seconds}s, weights=({args.w_acc:.2f},"
          f"{args.w_lat:.2f},{args.w_energy:.2f}), device {dev}")

    print(f"\ntraining A2C for {args.episodes} episodes ...")
    a2c = build_policy("a2c", cfg, tables, episodes=args.episodes, entropy_coef=0.01)
    a2c.train(log_every=max(args.episodes // 6, 1))

    print("\npolicy comparison (2 eval episodes each):")
    statics = [n for n in policy_names()
               if not get_policy_spec(n).trainable and not get_policy_spec(n).needs_cluster]
    results = {}
    for name in statics + ["a2c"]:
        pol = a2c if name == "a2c" else build_policy(name, cfg, tables)
        m = results[name] = evaluate_policy(cfg, tables, pol,
                                            torch.Generator(device=dev).manual_seed(1),
                                            episodes=2)
        modal = " ".join(f"{k}=v{v[0]}c{v[1]}" for k, v in m["modal_selection"].items())
        print(f"  {name:14s} reward={m['reward']:+.3f} "
              f"lat={m['latency']*1e3:6.1f}ms E={m['energy']:.3f}J  {modal}")
    print("\n(v = model version index, c = cut-point index; see Table I)")
    return results


if __name__ == "__main__":
    main()
