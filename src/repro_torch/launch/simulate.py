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

    # nonstationary world + closed-loop adaptation: the preset pairs the
    # online-adapted controller against the same controller frozen at
    # its pre-drift parameters (repro_torch.online)
    PYTHONPATH=src python -m repro_torch.launch.simulate --scenario link-brownout \\
        --device cpu --requests 4000

    # apply a named drift schedule + online adaptation to any preset
    PYTHONPATH=src python -m repro_torch.launch.simulate --scenario diurnal-fleet \\
        --drift-schedule link-brownout --online

    # cross-check the analytical backend against real SplitServingEngine
    # execution on a reduced transformer, on the CPU
    PYTHONPATH=src python -m repro_torch.launch.simulate --scenario tpu-execute --device cpu

    # heterogeneous edge-server pool: learned (version, cut, server)
    # routing against the classic routers (repro_torch.cluster)
    PYTHONPATH=src python -m repro_torch.launch.simulate --scenario edge-cluster
    PYTHONPATH=src python -m repro_torch.launch.simulate --scenario edge-cluster \
        --pool uniform-4 --topology tiered --autoscale threshold \
        --compare round_robin,join_shortest_queue,local_only --device cpu

    # the 100k-device world through the scan engine: the epoch loop on
    # the card (or, smaller, on the CPU)
    PYTHONPATH=src python -m repro_torch.launch.simulate --scenario megafleet --engine scan
    PYTHONPATH=src python -m repro_torch.launch.simulate --scenario megafleet --engine scan \
        --device cpu --requests 1500000

    # record an obs event trace and the flight recorder, then view them
    PYTHONPATH=src python -m repro_torch.launch.simulate --scenario cluster-brownout \
        --trace-out events.jsonl --timeline-out flight.json
    PYTHONPATH=src python -m repro_torch.launch.obsview events.jsonl
    PYTHONPATH=src python -m repro_torch.launch.fleetview flight.json

    # stream the flight recorder straight into the viewer
    PYTHONPATH=src python -m repro_torch.launch.simulate --scenario diurnal-fleet \
        --compare device_only --timeline-out - | PYTHONPATH=src python -m \
        repro_torch.launch.fleetview -

The reference script's ad-hoc-scenario flags wait for the rest of the
CLI, and are refused naming their ROADMAP item.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

from repro_torch import obs
from repro_torch.policies import get_policy_spec
from repro_torch.scenarios import (get_scenario, run_scenario, scenario_names,
                                   split_policy_name)
from repro_torch.sim import ENGINES

# the reference script's flags this port refuses: flag -> (takes a value,
# what it waits for)
_ITEM3 = "ROADMAP section 1, item 3"
REFUSED = {
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
    ap.add_argument("--engine", choices=ENGINES,
                    help="fleet epoch-flow engine: loop = per-device oracle, "
                    "vectorized = fused numpy (bit-identical), scan = the "
                    "epoch loop on the device (float32, statistical)")
    ap.add_argument("--policy", help="single policy (registry name)")
    ap.add_argument("--compare",
                    help="comma-separated policies; overrides --policy")
    ap.add_argument("--seeds",
                    help="comma-separated sim seeds; metrics average "
                    "over them (same seed = same request stream)")
    ap.add_argument("--online", action="store_true",
                    help="run every trainable policy in the roster with "
                    "online adaptation ('name+online') alongside its "
                    "frozen variant (repro_torch.online)")
    ap.add_argument("--drift-schedule", metavar="NAME",
                    help="apply a named WorldSchedule (link-brownout, "
                    "battery-cliff, flash-crowd, device-churn) to the "
                    "scenario; overrides a preset's own drift")
    ap.add_argument("--pool", metavar="NAME",
                    help="server-pool preset (repro_torch.cluster: single, "
                    "uniform-4, hetero-4); widens actions to (version, "
                    "cut, server)")
    ap.add_argument("--topology", metavar="NAME",
                    help="device->server link topology preset (uniform, "
                    "near-far, tiered); needs --pool")
    ap.add_argument("--autoscale", choices=("threshold", "hysteresis"),
                    help="pool autoscaler policy; needs --pool")
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
    ap.add_argument("--trace-out", metavar="PATH",
                    help="record an obs event trace (JSONL) of the run; "
                    "summarize with python -m repro_torch.launch.obsview")
    ap.add_argument("--timeline-out", metavar="PATH",
                    help="write the flight-recorder timeline (per-epoch "
                    "series, annotations, SLO error budgets) of every run; "
                    "'-' streams the JSON on stdout (the report goes to "
                    "stderr); render with python -m "
                    "repro_torch.launch.fleetview")
    ap.add_argument("--quiet", action="store_true",
                    help="warnings only on the console")
    ap.add_argument("-v", "--verbose", action="count",
                    help="more console detail (-v: debug narration)")
    ap.add_argument("--device",
                    help="torch device; default: the current CUDA card")
    for flag, (takes_value, _) in REFUSED.items():
        ap.add_argument(flag, action="store" if takes_value else "store_true",
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
    """Parse ``argv`` and run; returns the ComparisonReport (None for
    ``--list-scenarios``). The console verbosity it sets (0 with
    ``--quiet``, 1, 2 with ``-v``) is restored on return."""
    ap = build_parser()
    provided = vars(ap.parse_args(argv))
    for flag, (_, waits_for) in REFUSED.items():
        if flag[2:].replace("-", "_") in provided:
            ap.error(f"{flag} is not ported yet: it waits for {waits_for}")
    before = obs.get_verbosity()
    obs.set_verbosity(0 if provided.get("quiet") else 1 + provided.get("verbose", 0))
    try:
        return _run(ap, provided)
    finally:
        obs.set_verbosity(before)


def _run(ap, provided):
    say = obs.info
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
    if "drift_schedule" in provided:
        repl["drift"] = provided["drift_schedule"]
        if provided["drift_schedule"] != sc.drift:
            repl["drift_kw"] = {}    # new kind: factory defaults
    for field in ("pool", "topology", "autoscale"):
        if field in provided:
            repl[field] = provided[field]
            if provided[field] != getattr(sc, field):
                repl[f"{field}_kw"] = {}    # new kind: preset defaults
    sc = sc.replace(**repl)
    if sc.execute and sc.env != "tpu":
        ap.error("--execute needs a tpu-env scenario (the executable engine "
                 "serves the transformer stack)")
    try:
        sc.build_schedule()
        sc.build_cluster()
        sc.build_autoscaler()
    except (KeyError, ValueError) as e:
        ap.error(str(e.args[0]))

    if "compare" in provided:
        names = tuple(provided["compare"].split(","))
    elif "policy" in provided:
        names = (provided["policy"],)
    else:
        names = sc.policies
    try:
        parsed = [split_policy_name(n) for n in names]
        specs = [get_policy_spec(base) for base, _ in parsed]
    except KeyError as e:
        ap.error(str(e.args[0]))
    if provided.get("online"):
        # every trainable roster entry gains its '+online' adapted
        # variant (before the frozen one, matching the preset layout)
        expanded = []
        adapted = {b for (b, o) in parsed if o}
        for n, (base, is_online), spec in zip(names, parsed, specs):
            if spec.trainable and not is_online and base not in adapted:
                expanded.append(f"{base}+online")
            expanded.append(n)
        names = tuple(dict.fromkeys(expanded))
    trainable = sorted({split_policy_name(n)[0] for n in names
                        if get_policy_spec(split_policy_name(n)[0]).trainable})
    save, load = provided.get("save_policy"), provided.get("load_policy")
    if (save or load) and not trainable:
        ap.error("--save-policy/--load-policy need a trainable policy "
                 f"(a2c, ppo) in the roster; got {','.join(names)}")
    multi = len(trainable) > 1
    save_map = {n: artifact_path(save, n, multi) for n in trainable} if save else None
    load_map = {n: artifact_path(load, n, multi) for n in trainable} if load else None

    trace_out, timeline_out = provided.get("trace_out"), provided.get("timeline_out")
    rec_ctx = obs.recording(
        trace_out, meta={"tool": "simulate", "scenario": sc.name,
                         "policies": list(names), "seeds": list(sc.seeds)}) \
        if trace_out else contextlib.nullcontext()
    # `--timeline-out -` streams the flight-recorder JSON on stdout for
    # piping into fleetview; divert the human-facing report to stderr so
    # stdout stays pure JSON
    human_ctx = contextlib.redirect_stdout(sys.stderr) \
        if timeline_out == "-" else contextlib.nullcontext()
    with human_ctx:
        with rec_ctx:
            report = run_scenario(sc, names, device=provided.get("device"),
                                  save_policies=save_map, load_policies=load_map,
                                  verbose=True, timeline=bool(timeline_out))
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
        if trace_out:
            say(f"wrote obs trace {trace_out}; summarize with: python -m "
                f"repro_torch.launch.obsview {trace_out}")
    if timeline_out:
        runs = [{"policy": name, "seed": int(seed), "timeline": tl}
                for name, r in report.results.items()
                for seed, tl in zip(sc.seeds, r.timelines)
                if tl is not None]
        obs.write_timeline(timeline_out, runs,
                           meta={"tool": "simulate", "scenario": sc.name,
                                 "slo_target": sc.slo_target})
        if timeline_out != "-":
            say(f"wrote timeline {timeline_out}; render with: python -m "
                f"repro_torch.launch.fleetview {timeline_out}")
    return report


if __name__ == "__main__":
    main()
