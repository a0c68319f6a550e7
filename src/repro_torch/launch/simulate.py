"""Trace-driven fleet simulation CLI over the scenario/policy registries
(port of ``scripts/simulate.py``): run a registered policy roster against
a named scenario preset and report per-request latency percentiles, SLO
attainment, goodput and energy. Runs on the CUDA card unless ``--device``
names another.

    # what's on the menu
    PYTHONPATH=src python -m repro_torch.launch.simulate --list-scenarios

    # one preset, its default policy roster
    PYTHONPATH=src python -m repro_torch.launch.simulate --scenario paper-mmpp-burst

    # preset + overrides + explicit roster (paired request streams)
    PYTHONPATH=src python -m repro_torch.launch.simulate \\
        --scenario paper-mmpp-burst --compare a2c,device_only --requests 20000

    # train once, persist the controller, reload it later (identical
    # paired-seed metrics, no retraining); artifacts are the reference's
    PYTHONPATH=src python -m repro_torch.launch.simulate --scenario diurnal-fleet \\
        --compare a2c --save-policy controller.npz
    PYTHONPATH=src python -m repro_torch.launch.simulate --scenario diurnal-fleet \\
        --compare a2c,device_only --load-policy controller.npz

    # cross-check the analytical backend against real SplitServingEngine
    # execution on a reduced transformer, on the CPU
    PYTHONPATH=src python -m repro_torch.launch.simulate --scenario tpu-execute --device cpu

The reference script's other flags wait for modules not ported yet, and
are refused naming their ROADMAP item.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.policies import get_policy_spec
from repro_torch.scenarios import (get_scenario, run_scenario, scenario_names,
                                   split_policy_name)

# the reference script's flags this port refuses: flag -> (takes a value,
# what it waits for)
_ITEM3 = "ROADMAP section 1, item 3"
REFUSED = {
    "--online": (False, f"online adaptation, repro.online ({_ITEM3})"),
    "--drift-schedule": (True, f"drift schedules, repro.online ({_ITEM3})"),
    "--pool": (True, f"server pools, repro.cluster ({_ITEM3})"),
    "--topology": (True, f"topologies, repro.cluster ({_ITEM3})"),
    "--autoscale": (True, f"the autoscaler, repro.cluster ({_ITEM3})"),
    "--trace-out": (True, f"obs event recording, repro.obs ({_ITEM3})"),
    "--timeline-out": (True, f"the flight-recorder timeline, repro.obs ({_ITEM3})"),
    "--verbose": (False, f"obs verbosity levels, repro.obs ({_ITEM3})"),
    **{flag: (True, f"ad-hoc scenarios assembled from flags ({_ITEM3}, with the "
                    "reference CLI's remaining flags); use --scenario")
       for flag in ("--trace", "--devices", "--slo-ms", "--slot-seconds", "--rate",
                    "--rate-low", "--rate-high", "--peak-rps", "--replay-file",
                    "--models", "--w-acc", "--w-lat", "--w-energy", "--w-stab",
                    "--env", "--arch")},
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
        argument_default=argparse.SUPPRESS)
    ap.add_argument("--scenario", help="named preset; other flags override "
                    "its fields (see --list-scenarios)")
    ap.add_argument("--list-scenarios", action="store_true",
                    help="print registered scenario presets and exit")
    ap.add_argument("--requests", type=int)
    ap.add_argument("--engine", choices=("loop", "vectorized"),
                    help="fleet epoch-flow engine: loop = per-device oracle, "
                    "vectorized = fused numpy (bit-identical)")
    ap.add_argument("--policy", help="single policy (registry name)")
    ap.add_argument("--compare",
                    help="comma-separated policies; overrides --policy")
    ap.add_argument("--seeds",
                    help="comma-separated sim seeds; metrics average "
                    "over them (same seed = same request stream)")
    ap.add_argument("--episodes", type=int,
                    help="training budget for trainable policies")
    ap.add_argument("--train-seed", type=int)
    ap.add_argument("--save-policy", metavar="PATH",
                    help="write each trained policy as an .npz artifact "
                    "(name inserted before the extension when several "
                    "trainable policies run)")
    ap.add_argument("--load-policy", metavar="PATH",
                    help="load trainable policies from artifacts instead "
                    "of retraining (same PATH convention)")
    ap.add_argument("--execute", action="store_true",
                    help="cross-check a sampled subset through the real "
                    "SplitServingEngine (tpu env)")
    ap.add_argument("--sample", type=int)
    ap.add_argument("--exec-seq", type=int)
    ap.add_argument("--json", help="write results JSON here")
    ap.add_argument("--quiet", action="store_true",
                    help="print nothing but errors")
    ap.add_argument("--device",
                    help="torch device; default: the current CUDA card")
    for flag, (takes_value, _) in REFUSED.items():
        names = (flag, "-v") if flag == "--verbose" else (flag,)
        ap.add_argument(*names, action="store" if takes_value else "store_true",
                        help=argparse.SUPPRESS)
    return ap


def artifact_path(path: str, name: str, multi: bool) -> str:
    """One --save/--load path serves N trainable policies by inserting
    the policy name before the extension when N > 1."""
    if not multi:
        return path
    root, ext = os.path.splitext(path)
    return f"{root}.{name}{ext or '.npz'}"


def main(argv=None):
    ap = build_parser()
    provided = vars(ap.parse_args(argv))
    for flag, (_, waits_for) in REFUSED.items():
        if flag[2:].replace("-", "_") in provided:
            ap.error(f"{flag} is not ported yet: it waits for {waits_for}")
    say = (lambda *a, **k: None) if provided.get("quiet") else print

    if provided.get("list_scenarios"):
        for name in scenario_names():
            sc = get_scenario(name)
            say(f"{name:18s} {sc.description}")
            say(f"{'':18s}   env={sc.env} devices={sc.devices} "
                f"trace={sc.trace} slo={sc.slo_s}s "
                f"seeds={list(sc.seeds)} requests={sc.n_requests} "
                f"policies={','.join(sc.policies)}")
        return None
    if "scenario" not in provided:
        ap.error("--scenario is required: the ad-hoc scenario the reference "
                 f"assembles from flags waits for {_ITEM3}")
    try:
        sc = get_scenario(provided["scenario"])
    except KeyError as e:
        ap.error(str(e.args[0]))
    direct = {"requests": "n_requests", "engine": "engine", "episodes": "episodes",
              "train_seed": "train_seed", "execute": "execute", "sample": "sample",
              "exec_seq": "exec_seq"}
    repl = {field: provided[flag] for flag, field in direct.items() if flag in provided}
    if "seeds" in provided:
        repl["seeds"] = tuple(int(s) for s in provided["seeds"].split(","))
    sc = sc.replace(**repl)
    if sc.execute and sc.env != "tpu":
        ap.error("--execute needs a tpu-env scenario (the executable engine "
                 "serves the transformer stack)")

    if "compare" in provided:
        names = tuple(provided["compare"].split(","))
    elif "policy" in provided:
        names = (provided["policy"],)
    else:
        names = sc.policies
    try:
        specs = [get_policy_spec(split_policy_name(n)[0]) for n in names]
    except KeyError as e:
        ap.error(str(e.args[0]))
    trainable = sorted({n for n, s in zip(names, specs) if s.trainable})
    save, load = provided.get("save_policy"), provided.get("load_policy")
    if (save or load) and not trainable:
        ap.error("--save-policy/--load-policy need a trainable policy "
                 f"(a2c) in the roster; got {','.join(names)}")
    multi = len(trainable) > 1
    save_map = {n: artifact_path(save, n, multi) for n in trainable} if save else None
    load_map = {n: artifact_path(load, n, multi) for n in trainable} if load else None

    report = run_scenario(sc, names, device=provided.get("device"),
                          save_policies=save_map, load_policies=load_map,
                          verbose=not provided.get("quiet"))
    cross = next((r.cross_check for r in report.results.values()
                  if r.cross_check), None)
    if cross:
        say(f"\nexecute cross-check: {cross['samples']} requests "
            f"through SplitServingEngine; act-bytes "
            f"exact={cross['bytes_exact']} "
            f"({cross['bytes_mismatches']} mismatches); "
            f"wall/analytical latency ratio "
            f"median={cross['latency_ratio_median']:.2f} "
            f"max={cross['latency_ratio_max']:.2f} "
            f"(tolerance {cross['latency_tolerance']}x, within="
            f"{cross['latency_within_tolerance']})")
    if "json" in provided:
        out = report.to_json()
        out["config"] = {k: v for k, v in provided.items() if k != "json"}
        with open(provided["json"], "w") as f:
            json.dump(out, f, indent=2, default=str)
        say(f"\nwrote {provided['json']}")
    return report


if __name__ == "__main__":
    main()
