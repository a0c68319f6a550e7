"""A traced run of one cell with the program's spans recorded (``spans.py``):
the run's result line, with the metrics that read the spans, the idle gaps
named by them and the checks of the crediting, on the card.

    python3 edgebench/spanrun.py --workload <name> --seed <n> [--seconds 10]

The harness runs as ``run.py --trace 1`` runs it, with ``spans.Tracer`` in
place of ``harness.Tracer``: one ``obs.Recorder`` on the profiler's clock over
each traced slice. Against a program that records no spans the result holds
none of the three metrics and everything else as ``run.py`` gives it. Prints
one JSON line; exits 2 without a CUDA card.
"""
import argparse
import json
import sys

import run  # noqa: F401  (the run's paths and cache directories)

SPAN_METRICS = ("act_quant_ms", "act_quant_idle_pct", "w4_dequant_ms")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    t0 = run.process_start()
    import torch

    if not torch.cuda.is_available():
        print("spanrun: no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    from edgebench import costs, harness, metrics, spans

    made = []

    def tracer(n, device):
        made.append(spans.Tracer(n, device))
        return made[-1]

    harness.Tracer = tracer
    bench = harness.load_benchmark()
    lines = []
    res = harness.run_cell(args.workload, args.seed, args.seconds, True, device="cuda:0",
                           setup_t0=t0, bench=bench,
                           log=lambda s: (lines.append(s), print(s, file=sys.stderr)))
    tr = made[0]
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    config = harness.load_config(cell["config"])
    rec_a, rec_b = ([e for e in r.events if e["type"] == "span"] for r in tr.recorders)
    b = spans.from_profile(tr.done_b, tr.recorders[1], config, spans.batches_of(rec_b),
                           costs.peaks())
    a = spans.from_profile(tr.done_a, tr.recorders[0], config, spans.batches_of(rec_a),
                           costs.peaks(), window_s=res["device"]["window_s"],
                           bounds=tuple(tr.bounds_a))
    new = {m: metrics.reader(m)(a) for m in SPAN_METRICS}
    line = {"workload": args.workload, "seed": args.seed, "correct": res["correct"],
            "card": torch.cuda.get_device_name(0),
            "metrics": {**res["metrics"], **{k: v for k, v in new.items() if v is not None}},
            "device": res["device"],
            "same_readings": {k: metrics.reader(k)(a) == v for k, v in res["metrics"].items()},
            "breakdown": {"harness": res["breakdown"], "spans": spans.breakdown(a, b)},
            "idle_s_by_span": {"A": spans.idle_by_span(a), "B": spans.idle_by_span(b)},
            "spans": {"A": len(rec_a), "B": len(rec_b)},
            "crediting": {"A": spans.crediting(a), "B": spans.crediting(b)} if b.program else None,
            "log": lines, "checks": res["checks"]}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
