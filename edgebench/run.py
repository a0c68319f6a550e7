"""Run one cell of the port's benchmark once, on the card.

    python3 edgebench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints the result as the last line of standard output (one JSON object)
and, last on standard error, each number compared with its limit. Exits
non-zero, printing no result, without a CUDA card, with fewer cards than
the cell asks for, or when JAX or the JAX package is loaded once the window
has closed.
"""
import time

T_SCRIPT = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build"
# every build and kernel cache at a fixed place inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(BUILD / sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """The wall time this process started (from /proc), else this script's."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return T_SCRIPT


def forbidden_modules():
    return sorted(n for n in list(sys.modules) if n.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    t0 = process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"edgebench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"edgebench: the cell needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    from edgebench import harness

    res = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                           device="cuda:0", setup_t0=t0, bench=bench,
                           log=lambda s: print(s, file=sys.stderr))
    bad = forbidden_modules()
    if bad:
        print(f"edgebench: loaded in the measuring process: {', '.join(bad)}", file=sys.stderr)
        return 3
    line = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
            "metrics": {k: {"value": v, "unit": unit(bench, k)} for k, v in res["metrics"].items()},
            "device": res["device"]}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["checks"] = res["checks"]
    for text in res["check_lines"]:
        print(f"edgebench check: {text}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


def unit(bench, name: str) -> str:
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] == name:
            return m["unit"]
    raise KeyError(name)


if __name__ == "__main__":
    sys.exit(main())
