"""Render EXPERIMENTS.md from scenario runs (port of
``scripts/render_experiments.py``): any registered preset, stationary or
nonstationary, through ``repro_torch.scenarios.run_scenario``, or saved
``ComparisonReport`` JSONs (the port's or the reference's). Runs on the
CUDA card unless ``--device`` names another.

    # run presets and render their comparison tables
    PYTHONPATH=src python -m repro_torch.launch.render_experiments \\
        --scenarios paper-mmpp-burst,flash-crowd

    # cheaper budgets for a quick draft, on the CPU
    PYTHONPATH=src python -m repro_torch.launch.render_experiments --all \\
        --requests 4000 --episodes 60 --seeds 0 --device cpu

    # render previously saved reports (launch.simulate --json out)
    PYTHONPATH=src python -m repro_torch.launch.render_experiments \\
        --from-json results/brownout.json results/crowd.json
"""
from __future__ import annotations

import argparse
import json

from repro_torch.scenarios import get_scenario, run_scenario, scenario_names

_METRIC_COLS = (
    ("requests", "count", "{:.0f}"),
    ("p50 (s)", "p50", "{:.3f}"),
    ("p95 (s)", "p95", "{:.2f}"),
    ("p99 (s)", "p99", "{:.2f}"),
    ("SLO att.", "slo_attainment", "{:.3f}"),
    ("goodput (req/s)", "goodput", "{:.1f}"),
    ("energy/req (J)", "energy_per_request_j", "{:.3f}"),
    ("dropped", "dropped", "{:.0f}"),
)


def _md_table(header, rows):
    out = ["| " + " | ".join(header) + " |",
           "|" + "|".join("---" for _ in header) + "|"]
    out += ["| " + " | ".join(r) + " |" for r in rows]
    return "\n".join(out)


def render_report(data: dict) -> str:
    """One markdown section from a ComparisonReport.to_json() dict."""
    name = data["scenario"]
    lines = [f"## {name}", ""]
    try:
        lines += [get_scenario(name).description, ""]
    except KeyError:
        pass
    meta = (f"trace `{data['trace']}` · seeds {data['seeds']} · "
            f"{data['n_requests']} requests/seed")
    if data.get("schedule"):
        meta += f" · drift `{data['schedule']}`"
    lines += [meta, ""]

    rows = []
    for pname, entry in data["policies"].items():
        m = entry["mean"]
        rows.append([f"`{pname}`"] + [fmt.format(m[key]) for _, key, fmt in _METRIC_COLS])
    lines.append(_md_table(["policy"] + [h for h, _, _ in _METRIC_COLS], rows))
    lines.append("")

    adapt = {p: e["adaptation"] for p, e in data["policies"].items() if e.get("adaptation")}
    if adapt:
        lines += ["Per-regime adaptation metrics (reward vs the greedy "
                  "oracle re-solved under each regime's physics; "
                  "recovery = epochs until back within 10% of it):", ""]
        arows = []
        for pname, a in adapt.items():
            for reg in a["regimes"]:
                rec = reg["recovery_epochs"]
                arows.append([
                    f"`{pname}`", f"{reg['regime']} ({reg['name']})",
                    f"{reg['mean_reward']:+.3f}",
                    f"{reg['oracle_reward']:+.3f}",
                    f"{reg['regret']:.3f}",
                    "never" if rec is None else f"{rec:.0f}",
                ])
            onl = a.get("online")
            if onl:
                arows.append([f"`{pname}`", "(online totals)",
                              f"{a['mean_reward']:+.3f}", "",
                              f"{a['regret']:.3f}",
                              f"{onl['updates']:.0f} updates / "
                              f"{onl['bursts']:.0f} bursts"])
        lines.append(_md_table(["policy", "regime", "reward", "oracle", "regret",
                                "recovery (epochs)"], arows))
        lines.append("")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scenarios", help="comma-separated preset names to run")
    ap.add_argument("--all", action="store_true",
                    help="run every registered preset (execute presets skipped)")
    ap.add_argument("--from-json", nargs="+", metavar="PATH",
                    help="render saved ComparisonReport JSONs instead of running")
    ap.add_argument("--requests", type=int, default=None)
    ap.add_argument("--episodes", type=int, default=None)
    ap.add_argument("--seeds", default=None, help="comma-separated seed override")
    ap.add_argument("--out", default="EXPERIMENTS.md")
    ap.add_argument("--device", default=None,
                    help="torch device; default: the current CUDA card")
    args = ap.parse_args(argv)

    sections = []
    if args.from_json:
        for path in args.from_json:
            with open(path) as f:
                sections.append(render_report(json.load(f)))
    else:
        if args.scenarios:
            names = args.scenarios.split(",")
        elif args.all:
            names = [n for n in scenario_names() if not get_scenario(n).execute]
        else:
            ap.error("pick --scenarios, --all, or --from-json")
        seeds = tuple(int(s) for s in args.seeds.split(",")) if args.seeds else None
        for name in names:
            sc = get_scenario(name)      # KeyError lists valid names
            rep = run_scenario(sc, device=args.device, n_requests=args.requests,
                               episodes=args.episodes, seeds=seeds, verbose=True)
            sections.append(render_report(rep.to_json()))

    body = "\n".join(["# Experiments", "",
                      "Rendered by `python -m repro_torch.launch.render_experiments` from "
                      "`repro_torch.scenarios` ComparisonReports.", ""] + sections)
    with open(args.out, "w") as f:
        f.write(body)
    print(f"rendered {args.out} ({len(sections)} scenario sections, {len(body)} chars)")
    return body


if __name__ == "__main__":
    main()
