"""Where the time of a decode step goes: the PyTorch/CUDA port on one card.

Each model at full width (random weights, ``torch.Generator`` seed 0) at
the shape of ``chip_smoke.py``'s decode phase for it: qwen2-0.5b with
``BATCH`` prompts of ``SEQ`` tokens prefilled into rings of ``DEC_CACHE``
slots, falcon-mamba-7b with ``FM_BATCH`` prompts of ``FM_SEQ`` tokens,
recurrentgemma-2b with ``RG_BATCH`` prompts of ``RG_SEQ`` tokens (past its
2048-token local window, so the rings are full and wrap); then ``STEPS``
decode steps under ``torch.profiler`` (CPU and CUDA activities), one model
after the other. Prints, per step:
host wall time (host clock to ``synchronize()``), device busy time (the
sum of kernel and copy times; one stream, so they do not overlap), the
idle share of the profiled and of the unprofiled step, kernel launches,
and the kernels and host-side operators that take the most time; the
same for one prefill. On a machine with a CUDA card:

    PYTHONPATH=src python3 -m repro_torch.launch.profile_decode
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

# chip_smoke.py's decode shapes (a test holds them equal), and the steps timed
BATCH, SEQ, DEC_CACHE = 8, 512, 576        # qwen2-0.5b
FM_BATCH, FM_SEQ = 2, 512                  # falcon-mamba-7b
RG_BATCH, RG_SEQ = 2, 2304                 # recurrentgemma-2b
STEPS = 8


def _dev_us(e) -> float:
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)


def _idle_share(busy_ms: float, wall_ms: float) -> float:
    """Share of ``wall_ms`` in which the device ran nothing. Device time beyond
    the wall time is a counting error, not a busy device: it raises."""
    if busy_ms > wall_ms:
        raise ValueError(f"device busy {busy_ms:.3f} ms exceeds the wall time "
                         f"{wall_ms:.3f} ms: device time is counted twice")
    return 1 - busy_ms / wall_ms


def _summary(prof, n: int, wall_ms: float, label: str, top: int = 12) -> dict:
    from torch.autograd import DeviceType
    events = prof.key_averages()
    # kernels and copies only: an operator's device time repeats its kernels'
    device = [e for e in events if e.device_type == DeviceType.CUDA and _dev_us(e) > 0]
    busy_ms = sum(_dev_us(e) for e in device) / 1e3 / n
    launches = sum(e.count for e in events if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                                         "cudaLaunchKernelExC")) / n
    by_dev = sorted(device, key=_dev_us, reverse=True)[:top]
    by_cpu = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:top]
    out = {"label": label, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "idle_share": _idle_share(busy_ms, wall_ms), "launches": launches,
           "top_device_ms": [(e.key[:70], _dev_us(e) / 1e3 / n, e.count / n) for e in by_dev],
           "top_host_self_ms": [(e.key[:70], e.self_cpu_time_total / 1e3 / n, e.count / n)
                                for e in by_cpu]}
    print(f"== {label}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms "
          f"(idle {out['idle_share']:.1%}), {launches:.0f} kernel launches")
    print("  device time by kernel (ms per step, calls per step):")
    for k, ms, c in out["top_device_ms"]:
        print(f"    {ms:9.4f}  {c:6.1f}  {k}")
    print("  host self time by operator (ms per step, calls per step):")
    for k, ms, c in out["top_host_self_ms"]:
        print(f"    {ms:9.4f}  {c:6.1f}  {k}")
    return out


def profile_model(arch: str, batch: int, seq: int, cache_len, dev) -> dict:
    """Profile ``STEPS`` decode steps and one prefill of ``arch``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init, prefill

    cfg = get_config(arch)
    model = init(cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(2))
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    with torch.inference_mode():
        def run_prefill():
            return prefill(cfg, model, {"tokens": tokens}, total_len=cache_len)

        def run_steps(cache, tok, pos, n):
            for i in range(n):
                logits, cache = decode_step(cfg, model, cache, tok, pos + i)
                tok = torch.argmax(logits, dim=-1)
            return cache, tok

        logits, cache = run_prefill()                      # warm-up
        tok = torch.argmax(logits, dim=-1)
        cache, tok = run_steps(cache, tok, seq, 3)
        torch.cuda.synchronize()

        # unprofiled host clock, for the profiler's own cost
        plain = []
        for i in range(STEPS):
            t0 = time.perf_counter()
            cache, tok = run_steps(cache, tok, seq + 3 + i, 1)
            torch.cuda.synchronize()
            plain.append((time.perf_counter() - t0) * 1e3)
        pos = seq + 3 + STEPS

        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            run_steps(cache, tok, pos, STEPS)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / STEPS
        dec = _summary(prof, STEPS, wall, f"{arch} decode step (B={batch}, pos ~{pos})")

        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            run_prefill()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        pre = _summary(prof, 1, wall, f"{arch} prefill ({batch} x {seq})")

    median = statistics.median(plain)
    idle = _idle_share(dec["device_busy_ms"], median)
    print(f"{arch} decode step without the profiler: median {median:.3f} ms of "
          f"{[round(t, 3) for t in plain]}; idle {idle:.1%} of it at the profiled busy time")
    return {"decode": dec, "prefill": pre, "decode_unprofiled_ms": plain,
            "decode_unprofiled_idle_share": idle}


def main() -> int:
    import gc

    import torch

    if not torch.cuda.is_available():
        print("profile_decode: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    _build.build()
    out = {}
    for arch, batch, seq, cache_len in (("qwen2-0.5b", BATCH, SEQ, DEC_CACHE),
                                        ("falcon-mamba-7b", FM_BATCH, FM_SEQ, None),
                                        ("recurrentgemma-2b", RG_BATCH, RG_SEQ, None)):
        out[arch] = profile_model(arch, batch, seq, cache_len, dev)
        gc.collect()
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    print(json.dumps({**out, "card": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
