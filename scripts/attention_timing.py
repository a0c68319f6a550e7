"""Time the two attention kernels of one source tree at the serving paths'
shapes, to compare two versions of them on one card.

The shapes are ``chip_smoke.py``'s phase-7 paths (``FA_PATHS``,
``FD_PATHS``): ``flash_attention`` at qwen2-0.5b's split path, at
recurrentgemma-2b's split path and at its 2304-token prefill under the 2048
window; ``flash_decode`` at qwen2-0.5b's decode step (24 layers in turn) and
recurrentgemma-2b's (8 layers in turn). f32, q and k/v as views of the
models' layouts, inputs from ``torch.Generator`` seed 0. Each time is the
mean milliseconds of one call by ``chip_smoke``'s CUDA-event timers, eager
(``cuda_ms``: as a caller launches it, the wrapper's host work included)
and replayed as one CUDA graph (``graph_ms``: device time alone); for
``flash_decode`` also the host microseconds a call (the wrapper's path).

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (this
checkout's by default), so one call can time two commits in turn, each
built from its own sources:

    python3 scripts/attention_timing.py [--src OTHER/src]

Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# chip_smoke's timers and path shapes (importing it runs and imports nothing else)
from chip_smoke import FA_PATHS, FD_PATHS, cuda_ms, graph_ms  # noqa: E402


def _host_us(fn, iters: int = 20) -> float:
    """Mean host microseconds of ``fn()`` between launches: the calls are
    only enqueued (fewer launches than the device queue holds), then
    synchronised outside the clock."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / iters * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is timed")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("attention_timing: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(["flash_attention", "flash_decode"])
    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for B, H, HK, S, D, window in FA_PATHS:
        q = torch.randn(B, S, H, D, generator=g, device=dev).transpose(1, 2)
        k, v = (torch.randn(B, S, HK, D, generator=g, device=dev).transpose(1, 2)
                for _ in range(2))

        def call():
            fa.flash_attention(q, k, v, causal=True, window=window)
        rows.append({"kernel": "flash_attention", "shape": [B, H, HK, S, D, window],
                     "eager_ms": cuda_ms(call, 30), "device_ms": graph_ms(call, 30)})
    for B, H, HK, C, D, L, pos, window in FD_PATHS:
        q = torch.randn(B, H, D, generator=g, device=dev)
        kv = [tuple(torch.randn(B, C, HK, D, generator=g, device=dev).transpose(1, 2)
                    for _ in range(2)) for _ in range(L)]

        def step():
            for k, v in kv:
                fd.flash_decode(q, k, v, pos, window=window)
        rows.append({"kernel": "flash_decode", "shape": [B, H, HK, C, D, pos, window],
                     "layers": L, "eager_ms": cuda_ms(step, 50) / L,
                     "device_ms": graph_ms(step, 50) / L, "host_us": _host_us(step) / L})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"src": args.src, "card": smi, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
