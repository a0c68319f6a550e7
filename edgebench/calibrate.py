"""Readings that the limits of ``correct`` are set from: the program's numbers
and the control's (``check.errors(with_control=True)``) over many seeds, in
one process, each seed through a whole run of the cell with a short window
(the window still serves every request the comparison holds).

    python3 edgebench/calibrate.py --workload <name> --seeds 11,12,13 [--seconds 2]
        [--out readings.jsonl]

Prints one JSON line a seed: the numbers, the seconds the reference took,
and the set-up seconds. Needs a CUDA card, as a run does.
"""
import argparse
import json
import sys
import time

import run  # noqa: F401  (the run's paths and cache directories)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    from edgebench import harness

    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.time()
        res = harness.run_cell(args.workload, seed, args.seconds, False, device="cuda:0",
                               setup_t0=t0, with_control=True,
                               log=lambda s: print(s, file=sys.stderr))
        row = {"workload": args.workload, "seed": seed,
               "numbers": {k: v["value"] for k, v in res["checks"].items()},
               "setup_s": res["metrics"].get("setup_s"), "reference_s": res["reference_s"],
               "run_s": time.time() - t0,
               "card": torch.cuda.get_device_name(0)}
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as out:
                out.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
