"""Time the port's kernels of one source tree at the serving paths' shapes,
to compare two versions of them on one card.

The shapes are ``chip_smoke.py``'s phase-7 paths. ``flash_attention`` at
qwen2-0.5b's split path, at recurrentgemma-2b's split path and at its
2304-token prefill under the 2048 window (``FA_PATHS``); ``flash_decode``
at qwen2-0.5b's decode step (24 layers in turn) and recurrentgemma-2b's (8
layers in turn, ``FD_PATHS``); ``quant_matmul`` over qwen2-0.5b's seven w8
projections at the split path's M = 4096 and the decode step's M = 8, over
recurrentgemma-2b's at M = 2048 and at falcon-mamba-7b's head (M = 1024,
K = 4096, N = 65024), with the weights held K-major where the tree's
wrapper reads that layout, as its path holds them, else contiguous; ``mamba_scan`` at falcon-mamba-7b's
split path (2, 512, 8192, N 16); ``rglru_scan`` at recurrentgemma-2b's
split path, its 2304-token prefill, a scheduler cohort (``RS_PATHS``) and
a cohort of one request (1, 218, 2560); ``flash_attention``'s backward at
the training paths' shapes (``FA_BWD_PATHS``: qwen2-0.5b, qwen3-0.6b,
deepseek-v2-lite-16b's MLA and recurrentgemma-2b's (256, 256); a shape the
tree has no backward instance for is left out) in f32 and in bf16, with each of its kernels' device time by
CUDA events between its launches (``kernel_ms``, where the tree's wrapper
records them, else null), the backward of SDPA in the same dtype
(``library_ms``) and the bound (``bound_ms``, at the 3xTF32 or the bf16
rate). f32 (int8 codes for ``quant_matmul``; the backward also bf16),
inputs from ``torch.Generator`` seed 0. Each time is the mean milliseconds
of one call (of one layer's calls for ``quant_matmul``) by ``chip_smoke``'s
CUDA-event timers, eager (``eager_ms``: as a caller launches it, the
wrapper's host work included) and replayed as one CUDA graph
(``device_ms``: device time alone); for ``flash_decode`` and the decode
step's ``quant_matmul`` also the host microseconds a call (the wrapper's
path); for ``quant_matmul`` also ``torch._int_mm`` plus the rescale
(``library_ms``), at M = 8 on rows zero-padded to its least M, 17.

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (this
checkout's by default), so one call can time two commits in turn, each
built from its own sources:

    python3 scripts/kernel_timing.py [--src OTHER/src] [--only flash_attention_bwd,...]

``--only`` builds and times the named kernels alone. Prints one JSON line.
"""
from __future__ import annotations

import argparse
import inspect
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# chip_smoke's timers, inputs and path shapes (importing it runs and imports
# nothing else)
from chip_smoke import (BATCH, FA_BWD_PATHS, FA_PATHS, FD_PATHS, FM_ARCH,  # noqa: E402
                        FM_BATCH, FM_SEQ, INT_MM_MIN_M, QMM_LAYER, RG_QMM_LAYER, RG_SPLIT_BATCH,
                        RG_SPLIT_SEQ, RS_PATHS, SEQ, _bwd_kernel_ms, _int_mm_ms, _qmm_inputs,
                        _rglru_inputs, _scan_inputs, cuda_ms, fa_bwd_bound, graph_ms,
                        sdpa_bwd_ms)


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
    ap.add_argument("--only", default=None,
                    help="comma-separated kernels to build and time (default: all)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("kernel_timing: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import quant_matmul as qmm
    from repro_torch.kernels import rglru_scan as rs

    torch.backends.cuda.matmul.allow_tf32 = False
    only = set(args.only.split(",")) if args.only else set(_build.KERNELS)
    _build.build([k for k in _build.KERNELS if k in only])
    dev = torch.device("cuda", torch.cuda.current_device())
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    bwd_paths = FA_BWD_PATHS if "flash_attention_bwd" in only else ()
    for (B, H, HK, S, D, Dv, label), dtype in itertools.product(
            bwd_paths, (torch.float32, torch.bfloat16)):
        if (D, Dv) not in fa.BWD_HEAD_DIMS:
            continue
        q, do = (torch.randn(B, S, H, w, generator=g, device=dev).to(dtype).transpose(1, 2)
                 for w in (D, Dv))
        k, v = (torch.randn(B, S, HK, w, generator=g, device=dev).to(dtype).transpose(1, 2)
                for w in (D, Dv))
        o, lse = fa.flash_attention_fwd(q, k, v, with_lse=True)

        def bwd():
            fa.flash_attention_bwd(q, k, v, o, lse, do)
        events = "events" in inspect.signature(fa.flash_attention_bwd).parameters
        rows.append({"kernel": "flash_attention_bwd", "shape": [B, H, HK, S, D, Dv],
                     "dtype": str(dtype).split(".")[1], "path": label,
                     "eager_ms": cuda_ms(bwd, 20), "device_ms": graph_ms(bwd, 20),
                     "kernel_ms": _bwd_kernel_ms(fa, (q, k, v, o, lse, do)) if events else None,
                     "library_ms": sdpa_bwd_ms(q, k, v, do),
                     "bound_ms": fa_bwd_bound(B, H, HK, S, D, Dv, dtype)[0]})
        del q, k, v, o, lse, do
    for B, H, HK, S, D, window in FA_PATHS if "flash_attention" in only else ():
        q = torch.randn(B, S, H, D, generator=g, device=dev).transpose(1, 2)
        k, v = (torch.randn(B, S, HK, D, generator=g, device=dev).transpose(1, 2)
                for _ in range(2))

        def call():
            fa.flash_attention(q, k, v, causal=True, window=window)
        rows.append({"kernel": "flash_attention", "shape": [B, H, HK, S, D, window],
                     "eager_ms": cuda_ms(call, 30), "device_ms": graph_ms(call, 30)})
    for B, H, HK, C, D, L, pos, window in FD_PATHS if "flash_decode" in only else ():
        q = torch.randn(B, H, D, generator=g, device=dev)
        kv = [tuple(torch.randn(B, C, HK, D, generator=g, device=dev).transpose(1, 2)
                    for _ in range(2)) for _ in range(L)]

        def step():
            for k, v in kv:
                fd.flash_decode(q, k, v, pos, window=window)
        rows.append({"kernel": "flash_decode", "shape": [B, H, HK, C, D, pos, window],
                     "layers": L, "eager_ms": cuda_ms(step, 50) / L,
                     "device_ms": graph_ms(step, 50) / L, "host_us": _host_us(step) / L})
    fm = get_config(FM_ARCH)
    for what, M, shapes in (("qwen2-0.5b layer, split path", BATCH * SEQ, QMM_LAYER),
                            ("qwen2-0.5b layer, decode step", BATCH, QMM_LAYER),
                            ("recurrentgemma-2b layer, split path",
                             RG_SPLIT_BATCH * RG_SPLIT_SEQ, RG_QMM_LAYER),
                            ("falcon-mamba-7b head", FM_BATCH * FM_SEQ,
                             ((fm.d_model, fm.vocab_size),))):
        if "quant_matmul" not in only:
            break
        calls, library = [], []
        for K, N in shapes:
            x, w, xs, ws = _qmm_inputs(M, K, N, g, dev)
            library.append((x, w, xs, ws, None))
            try:     # a wrapper that takes no K-major weight refuses it
                qmm.quant_matmul(x, w.t().contiguous().t(), xs, ws)
                w = w.t().contiguous().t()
            except ValueError:
                pass
            calls.append((x, w, xs, ws))

        def layer():
            for args in calls:
                qmm.quant_matmul(*args)
        row = {"kernel": "quant_matmul", "shape": what, "M": M, "KN": shapes,
               "eager_ms": cuda_ms(layer, 30), "device_ms": graph_ms(layer, 30),
               "library_ms": _int_mm_ms(library, 30)}
        if M < INT_MM_MIN_M:
            row["library_padded_m"] = INT_MM_MIN_M
        if M == BATCH:   # the decode step: host-bound, so its host path too
            row["host_us"] = _host_us(layer) / len(shapes)
        rows.append(row)
    if "mamba_scan" in only:
        scan = _scan_inputs(FM_BATCH, FM_SEQ, fm.d_inner, fm.ssm_state, g, dev, falcon_a=True)
        rows.append({"kernel": "mamba_scan",
                     "shape": [FM_BATCH, FM_SEQ, fm.d_inner, fm.ssm_state],
                     "eager_ms": cuda_ms(lambda: ms.mamba_scan(*scan), 30),
                     "device_ms": graph_ms(lambda: ms.mamba_scan(*scan), 30)})
    for B, S, W in RS_PATHS + ((1, 218, 2560),) if "rglru_scan" in only else ():
        a, gx = _rglru_inputs(B, S, W, g, dev)
        rows.append({"kernel": "rglru_scan", "shape": [B, S, W],
                     "eager_ms": cuda_ms(lambda: rs.rglru_scan(a, gx), 50),
                     "device_ms": graph_ms(lambda: rs.rglru_scan(a, gx), 50)})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"src": args.src, "card": smi, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
