"""Trace-driven fleet simulation CLI over the scenario/policy registries
(port of ``scripts/simulate.py``): run a registered policy roster against
a named scenario preset (or an ad-hoc scenario assembled from flags) and
report per-request latency percentiles, SLO attainment, goodput and
energy. Runs on the CUDA card unless ``--device`` names another.

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

    # no --scenario: flags assemble a custom scenario (the reference's
    # legacy behavior; default roster a2c)
    PYTHONPATH=src python -m repro_torch.launch.simulate --trace diurnal --devices 8 \
        --requests 100000
    PYTHONPATH=src python -m repro_torch.launch.simulate --env tpu --arch mixtral-8x22b \
        --execute --devices 2 --requests 400 --compare device_only,greedy_oracle --device cpu

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
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys

import numpy as np

from repro_torch import obs
from repro_torch.core import RewardWeights
from repro_torch.policies import get_policy_spec
from repro_torch.scenarios import (Scenario, get_scenario, run_scenario, scenario_names,
                                   split_policy_name)
from repro_torch.sim import ENGINES

# Flag defaults live here (not on the parser): the parser suppresses
# absent flags so a preset scenario only sees the overrides the user
# actually typed, while the no-scenario path fills in from this table.
DEFAULTS = dict(
    scenario=None, list_scenarios=False,
    trace="diurnal", devices=8, requests=100_000, engine="loop",
    policy=None, compare=None, seeds="0",
    online=False, drift_schedule=None,
    pool=None, topology=None, autoscale=None,
    episodes=300, train_seed=0, save_policy=None, load_policy=None,
    slo_ms=2000.0, slot_seconds=10.0,
    rate=6.0, rate_low=2.0, rate_high=30.0, peak_rps=30.0,
    replay_file=None, models="cycle",
    w_acc=0.05, w_lat=0.10, w_energy=0.15, w_stab=0.70,
    env="paper", arch="qwen2-0.5b", execute=False, sample=16, exec_seq=32,
    json=None, quiet=False, verbose=0, trace_out=None, timeline_out=None,
    device=None,
)

# which CLI rate flags feed which trace constructor kwargs
_TRACE_ARGS = {
    "poisson": {"rate": "rate_rps"},
    "mmpp": {"rate_low": "rate_low_rps", "rate_high": "rate_high_rps"},
    "diurnal": {"rate_low": "base_rps", "rate_high": "peak_rps"},
    "uniform": {"rate_high": "max_rps"},
    "replay": {},
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
    ap.add_argument("--trace", choices=tuple(_TRACE_ARGS))
    ap.add_argument("--devices", type=int)
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
    ap.add_argument("--slo-ms", type=float)
    ap.add_argument("--slot-seconds", type=float)
    ap.add_argument("--rate", type=float,
                    help="poisson rate (requests/s/device)")
    ap.add_argument("--rate-low", type=float,
                    help="mmpp calm rate / diurnal base rate")
    ap.add_argument("--rate-high", type=float,
                    help="mmpp burst rate / diurnal peak / uniform max")
    ap.add_argument("--peak-rps", type=float,
                    help="load-feature saturation rate; 0 disables the "
                    "stability reward term (paper-faithful)")
    ap.add_argument("--replay-file")
    ap.add_argument("--models", choices=("cycle", "vgg", "resnet", "densenet"),
                    help="paper-env fleet composition")
    ap.add_argument("--w-acc", type=float)
    ap.add_argument("--w-lat", type=float)
    ap.add_argument("--w-energy", type=float)
    ap.add_argument("--w-stab", type=float)
    ap.add_argument("--env", choices=("paper", "tpu"))
    ap.add_argument("--arch", help="tpu env: the transformer every device "
                    "serves (repro_torch.configs.ALL_ARCHS)")
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
    return ap


def replay_kw(replay_file, slot_seconds) -> dict:
    """The one spelling of the replay-trace kwargs (both the preset
    override path and the bare --trace replay path build them here)."""
    if not replay_file:
        raise SystemExit("--trace replay needs --replay-file (.npy)")
    return {"counts": np.load(replay_file),
            "slot_seconds_recorded": slot_seconds}


def trace_override(sc: Scenario, provided: dict, merged: dict) -> Scenario:
    """Apply --trace/--rate*/--replay-file on top of a scenario: a trace
    *kind* change rebuilds its kwargs from the merged flag values; rate
    flags alone patch only the matching kwargs of the current kind."""
    rate_flags = {"rate", "rate_low", "rate_high", "replay_file"}
    if not ({"trace"} | rate_flags) & set(provided):
        return sc
    name = merged["trace"] if "trace" in provided else sc.trace
    argmap = _TRACE_ARGS[name]
    applicable = set(argmap) | ({"replay_file"} if name == "replay" else set())
    stray = (rate_flags & set(provided)) - applicable
    if stray:
        flags = ", ".join("--" + f.replace("_", "-") for f in sorted(stray))
        expects = ", ".join("--" + f.replace("_", "-")
                            for f in sorted(applicable)) or "no rate flags"
        raise SystemExit(f"{flags}: not applicable to trace {name!r} "
                         f"(which takes {expects}); the override would "
                         "be silently ignored")
    if name == sc.trace:
        kw, src = dict(sc.trace_kw), provided
    else:
        kw, src = {}, merged     # fresh kind: every mapped kwarg from merged
    for flag, key in argmap.items():
        if flag in src:
            kw[key] = src[flag]
    if name == "replay":
        kw = replay_kw(merged.get("replay_file"),
                       merged["slot_seconds"] if "slot_seconds" in provided
                       else sc.slot_seconds)
    return sc.replace(trace=name, trace_kw=kw)


def apply_overrides(sc: Scenario, provided: dict, merged: dict) -> Scenario:
    """Explicitly-typed flags override preset fields, field by field."""
    direct = {"devices": "devices", "requests": "n_requests",
              "slot_seconds": "slot_seconds", "peak_rps": "peak_rps",
              "models": "models", "env": "env", "arch": "arch",
              "execute": "execute", "sample": "sample",
              "exec_seq": "exec_seq", "episodes": "episodes",
              "train_seed": "train_seed", "engine": "engine"}
    repl = {field: provided[flag] for flag, field in direct.items() if flag in provided}
    if "slo_ms" in provided:
        repl["slo_s"] = provided["slo_ms"] / 1e3
    if "seeds" in provided:
        repl["seeds"] = tuple(int(s) for s in provided["seeds"].split(","))
    wkw = {flag: provided[flag] for flag in ("w_acc", "w_lat", "w_energy", "w_stab")
           if flag in provided}
    if wkw:
        repl["weights"] = dataclasses.replace(sc.weights, **wkw)
    if "drift_schedule" in provided:
        repl["drift"] = provided["drift_schedule"]
        if provided["drift_schedule"] != sc.drift:
            repl["drift_kw"] = {}    # new kind: factory defaults
    for field in ("pool", "topology", "autoscale"):
        if field in provided:
            repl[field] = provided[field]
            if provided[field] != getattr(sc, field):
                repl[f"{field}_kw"] = {}    # new kind: preset defaults
    if repl:
        sc = sc.replace(**repl)
    return trace_override(sc, provided, merged)


def scenario_from_args(merged: dict) -> Scenario:
    """No --scenario: assemble an ad-hoc scenario from the flag values
    (the reference CLI's historical default behavior)."""
    trace = merged["trace"]
    kw = {key: merged[flag] for flag, key in _TRACE_ARGS[trace].items()}
    if trace == "replay":
        kw = replay_kw(merged["replay_file"], merged["slot_seconds"])
    return Scenario(
        name="custom",
        description="ad-hoc scenario assembled from CLI flags",
        env=merged["env"], devices=merged["devices"],
        arch=merged["arch"], models=merged["models"],
        weights=RewardWeights(w_acc=merged["w_acc"], w_lat=merged["w_lat"],
                              w_energy=merged["w_energy"], w_stab=merged["w_stab"]),
        slot_seconds=merged["slot_seconds"], peak_rps=merged["peak_rps"],
        slo_s=merged["slo_ms"] / 1e3,
        seeds=tuple(int(s) for s in merged["seeds"].split(",")),
        n_requests=merged["requests"], episodes=merged["episodes"],
        train_seed=merged["train_seed"], execute=merged["execute"],
        sample=merged["sample"], exec_seq=merged["exec_seq"],
        drift=merged["drift_schedule"], engine=merged["engine"],
        pool=merged["pool"], topology=merged["topology"] or "uniform",
        autoscale=merged["autoscale"],
        trace=trace, trace_kw=kw)


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
    merged = {**DEFAULTS, **provided}
    before = obs.get_verbosity()
    obs.set_verbosity(0 if merged["quiet"] else 1 + (merged["verbose"] or 0))
    try:
        return _run(ap, provided, merged)
    finally:
        obs.set_verbosity(before)


def _run(ap, provided, merged):
    say = obs.info
    if merged["list_scenarios"]:
        for name in scenario_names():
            sc = get_scenario(name)
            say(f"{name:18s} {sc.description}")
            say(f"{'':18s}   env={sc.env} devices={sc.devices} "
                f"trace={sc.trace} slo={sc.slo_s}s "
                f"seeds={list(sc.seeds)} requests={sc.n_requests} "
                f"policies={','.join(sc.policies)}")
        return None
    if merged["scenario"]:
        try:
            sc = get_scenario(merged["scenario"])
        except KeyError as e:
            ap.error(str(e.args[0]))
        sc = apply_overrides(sc, provided, merged)
    else:
        sc = scenario_from_args(merged)
    if sc.execute and sc.env != "tpu":
        ap.error("--execute needs --env tpu (the executable engine "
                 "serves the transformer stack)")
    try:
        sc.build_schedule()
        sc.build_cluster()
        sc.build_autoscaler()
    except (KeyError, ValueError) as e:
        ap.error(str(e.args[0]))

    if merged["compare"]:
        names = tuple(merged["compare"].split(","))
    elif merged["policy"]:
        names = (merged["policy"],)
    elif merged["scenario"]:
        names = sc.policies
    else:
        names = ("a2c",)
    try:
        parsed = [split_policy_name(n) for n in names]
        specs = [get_policy_spec(base) for base, _ in parsed]
    except KeyError as e:
        ap.error(str(e.args[0]))
    if merged["online"]:
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
    save, load = merged["save_policy"], merged["load_policy"]
    if (save or load) and not trainable:
        ap.error("--save-policy/--load-policy need a trainable policy "
                 f"(a2c, ppo) in the roster; got {','.join(names)}")
    multi = len(trainable) > 1
    save_map = {n: artifact_path(save, n, multi) for n in trainable} if save else None
    load_map = {n: artifact_path(load, n, multi) for n in trainable} if load else None

    trace_out, timeline_out = merged["trace_out"], merged["timeline_out"]
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
            report = run_scenario(sc, names, device=merged["device"],
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
        if merged["json"]:
            out = report.to_json()
            out["config"] = {k: v for k, v in merged.items()
                             if k not in ("json", "list_scenarios")}
            with open(merged["json"], "w") as f:
                json.dump(out, f, indent=2, default=str)
            say(f"\nwrote {merged['json']}")
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
