"""Summarize an obs event trace (events.jsonl) into per-phase timing,
drift/online timeline, metrics and build accounting (port of
``scripts/obsview.py``; reads the port's files and the reference's).

    # record a trace, then view it
    PYTHONPATH=src python -m repro_torch.launch.simulate --scenario link-brownout \
        --trace-out events.jsonl
    PYTHONPATH=src python -m repro_torch.launch.obsview events.jsonl

    # machine-readable folded report alongside the text view
    PYTHONPATH=src python -m repro_torch.launch.obsview events.jsonl --json obs.json

    # or JSON only, to stdout
    PYTHONPATH=src python -m repro_torch.launch.obsview events.jsonl --json -
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs import report as obs_report


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("events", help="obs JSONL trace (launch.simulate "
                    "--trace-out)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="also write the folded report as JSON "
                    "('-' = JSON only, to stdout)")
    args = ap.parse_args(argv)

    try:
        rep = obs_report.load(args.events)
    except (OSError, ValueError) as e:
        raise SystemExit(f"obsview: {e}")
    if args.json == "-":
        json.dump(rep, sys.stdout, indent=2, default=str)
        print()
        return
    print(obs_report.render(rep))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rep, f, indent=2, default=str)
        print(f"\nwrote {args.json}")


if __name__ == "__main__":
    main()
