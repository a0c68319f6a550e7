"""Gate a benchmark run against the append-only perf history (port of
``scripts/benchgate.py``).

    # 1. measure: a results file, schema 2 -- {"schema": 2, "rows":
    #    runner.run(...).records, "fingerprint": history.fingerprint(),
    #    "git_sha": ..., "unix_time": ...}
    # 2. gate vs matching-fingerprint baselines, then append this run
    PYTHONPATH=src python -m repro_torch.launch.benchgate results.json \
        --history history.jsonl

Exit status: 1 when any case regresses (median slowdown beyond
--min-effect AND Mann-Whitney p < --alpha vs the pooled baseline of
the last --pool matching-fingerprint runs); 0 otherwise — including
when the gate *refuses* to compare because history only exists under
other environment fingerprints (pass --strict to make refusal/new
baselines exit 2). A failing report names the regressed case AND its
dominant regressed obs phase.

The run is appended to history after gating (so the next run baselines
on it) unless it failed the gate — a regression must not become its
own baseline. --append-always / --no-append override.
"""
from __future__ import annotations

import argparse
import json
from typing import List, Optional

from repro_torch.bench import gate as bgate
from repro_torch.bench import history as bhist


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.benchgate",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("results", nargs="?", default="BENCH_results.json",
                    help="a results file of schema 2")
    ap.add_argument("--history", default="BENCH_history.jsonl",
                    help="append-only history file (created if missing)")
    ap.add_argument("--min-effect", type=float, default=0.10,
                    help="minimum median slowdown to fail on (0.10 = "
                    "10%%; smaller significant shifts pass)")
    ap.add_argument("--alpha", type=float, default=0.05,
                    help="one-sided Mann-Whitney significance level")
    ap.add_argument("--pool", type=int, default=bhist.DEFAULT_POOL,
                    help="matching-fingerprint runs pooled as baseline")
    ap.add_argument("--min-samples", type=int, default=3,
                    help="fewer samples on either side -> case is "
                    "reported as 'insufficient', never gated")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the gate report as JSON ('-' = stdout)")
    ap.add_argument("--no-append", action="store_true",
                    help="never append this run to history")
    ap.add_argument("--append-always", action="store_true",
                    help="append even when the gate fails")
    ap.add_argument("--strict", action="store_true",
                    help="exit 2 when nothing could be gated (refused "
                    "fingerprint or all-new cases)")
    args = ap.parse_args(argv)

    try:
        with open(args.results) as f:
            results = json.load(f)
    except (OSError, ValueError) as e:
        raise SystemExit(f"benchgate: cannot read {args.results}: {e}")
    if results.get("schema") != 2:
        raise SystemExit(
            f"benchgate: {args.results} has schema "
            f"{results.get('schema')!r}, need 2")
    records = results.get("rows", [])
    fp = results.get("fingerprint") or bhist.fingerprint()

    hist_rows = bhist.load(args.history)
    report = bgate.gate_records(
        records, hist_rows, fp, min_effect=args.min_effect,
        alpha=args.alpha, pool=args.pool, min_samples=args.min_samples)
    print(bgate.render(report, records))

    if args.json:
        payload = json.dumps(report.to_json(), indent=2)
        if args.json == "-":
            print(payload)
        else:
            with open(args.json, "w") as f:
                f.write(payload + "\n")
            print(f"wrote {args.json}")

    do_append = not args.no_append and \
        (args.append_always or not report.failed)
    if do_append:
        run_id = f"{results.get('git_sha', 'unknown')}-" \
                 f"{results.get('unix_time', 0):.0f}"
        rows = bhist.stamp(records, run_id=run_id,
                           t_unix=float(results.get("unix_time", 0.0)),
                           sha=results.get("git_sha"), fp=fp)
        bhist.append(args.history, rows)
        print(f"appended {len(rows)} row(s) to {args.history}")
    elif report.failed:
        print(f"NOT appended to {args.history} (gate failed; a "
              f"regression must not become its own baseline — "
              f"--append-always to override)")

    if report.failed:
        return 1
    if args.strict and (report.refused or not any(
            v.status in ("ok", "improved", "regression", "insufficient")
            for v in report.verdicts)):
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
