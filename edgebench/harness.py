"""One run of one cell: set-up, the closed-loop window over
``SplitServingEngine.infer``, the traced slice, the comparison that decides
``correct``, and the result line's numbers.

Everything a cell is made of is found by name: its configuration in
``configs/<config>.json``, its traffic in ``traffic/<traffic>.json``, its
per-layer metrics in ``metrics/<name>.py`` and its limits in
``limits/<workload>.json``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import time
from pathlib import Path
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from edgebench import check, costs, metrics, trace, weights, workload

ROOT = Path(__file__).resolve().parents[1]
CONFIG_DIR = Path(__file__).resolve().parent / "configs"
CHECK_REQUESTS = 8      # requests whose logits are held against the reference


@dataclasses.dataclass
class Served:
    batch: workload.Batch
    t0: float
    t1: float
    act_bytes: int
    logits_shape: tuple


def load_benchmark() -> Dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_config(name: str) -> Dict:
    path = CONFIG_DIR / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no configuration {name!r} ({path})")
    return json.loads(path.read_text())


def port_config(config: Mapping, override: bool = False):
    """The port's ModelConfig for ``config["arch"]``, held to every size the
    configuration file states. ``override`` (the CPU tests' small sizes)
    puts the file's sizes into the port's configuration first."""
    from repro_torch.configs.base import get_config

    cfg = get_config(config["arch"])
    if override:
        fields = {f.name for f in dataclasses.fields(cfg)}
        cfg = cfg.with_overrides(**{k: v for k, v in config["model"].items() if k in fields})
    wrong = {k: (v, getattr(cfg, k)) for k, v in config["model"].items() if getattr(cfg, k) != v}
    if wrong:
        raise ValueError(f"{config['name']}: the port's configuration differs: "
                         + ", ".join(f"{k} file {a!r} port {b!r}" for k, (a, b) in wrong.items()))
    return cfg


def build_model(cfg, config: Mapping, seed: int, device):
    """The port's model with the benchmark's weights: built on uninitialized
    tensors in the port's layout, then filled by ``assign_params`` from a tree
    that makes each stacked leaf when read."""
    from repro_torch.models.model import CausalLM
    from repro_torch.models.params import abstract_params, assign_params

    meta = abstract_params(cfg)
    ours = weights.tree_shapes(config)
    theirs = {k: tuple(v.shape) for k, v in meta.items()}
    if ours != theirs:
        raise ValueError(f"{config['name']}: the benchmark's leaves differ from the port's: "
                         f"{sorted(set(ours.items()) ^ set(theirs.items()))[:6]}")
    model = CausalLM(cfg, {k: torch.empty(v.shape, dtype=v.dtype, device=device)
                           for k, v in meta.items()})
    return assign_params(model, weights.LazyTree(config, seed, device))


def n_cuts(cfg) -> int:
    from repro_torch.core.profiles import transformer_profile

    counts = {len(v.cut_points) for v in transformer_profile(cfg).versions}
    if len(counts) != 1:
        raise ValueError(f"versions with different numbers of cut points: {counts}")
    return counts.pop()


def decide(cfg, batches: List[workload.Batch]) -> None:
    """Each batch's (version, cut) through ``resolve_selection`` over
    ``transformer_profile(cfg, seq_len=S)``, as the paper's loop maps a
    table action."""
    from repro_torch.core.controller import resolve_selection
    from repro_torch.core.profiles import transformer_profile

    profiles = {}
    for b in batches:
        if b.S not in profiles:
            profiles[b.S] = transformer_profile(cfg, seq_len=b.S)
        prof = profiles[b.S]
        j = [v.version for v in prof.versions].index(b.version)
        version, b.cut = resolve_selection(cfg, prof, j, b.k)
        if version != b.version:
            raise ValueError(f"resolve_selection gave {version} for {b.version}")


def syncer(device: torch.device) -> Callable[[], None]:
    if device.type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def serve(engine, batches: List[workload.Batch], seconds: float, keep: Mapping[int, int],
          sync, round_size: int, tracer: Optional["Tracer"] = None, min_batches: int = 0):
    """The closed loop: each batch issued when the one before is complete on
    the card. The window closes at the first completion, at or after
    ``seconds`` and ``min_batches``, that completes a round: every window
    holds whole rounds, so every run serves the same work in it, whatever the
    seed's order. Then the held requests not yet served are served (outside
    the window) so that each can be compared. Returns (served in the window,
    window seconds, {batch index: (batch, row, logits row)})."""
    served, held = [], {}
    start = time.perf_counter()
    end = None
    for b in batches:
        if tracer is not None:
            tracer.at(b.index)
        t0 = time.perf_counter()
        with tracer.span(b) if tracer is not None else contextlib.nullcontext():
            logits, act_bytes = engine.infer({"tokens": b.tokens}, b.cut, b.version)
            sync()
        t1 = time.perf_counter()
        if end is None:
            served.append(Served(b, t0, t1, int(act_bytes), tuple(logits.shape)))
        if b.index in keep:
            held[b.index] = (b, keep[b.index], logits[keep[b.index]].clone())
        del logits
        if (end is None and t1 - start >= seconds and len(served) >= min_batches
                and len(served) % round_size == 0):
            end = t1
        if end is not None and len(held) == len(keep):
            return served, end - start, held
    raise RuntimeError(f"the traffic's {len(batches)} batches ran out before the window "
                       f"closed: raise max_rounds")


class Tracer:
    """Two traced slices of the window, ``n`` batches each.

    Slice A, batches [0, n): ``torch.profiler`` with the device's activity
    alone, started in set-up; the per-layer metrics and the device's busy
    time are read from it, over its length by the host's clock. Slice B,
    batches [n, 2n): the host's ops as well, inside the benchmark's window
    span and with its span around each infer, for naming the idle gaps only:
    recording every host op slows the host, so B's idle time is longer than
    an untraced round's."""

    def __init__(self, n: int, device: torch.device):
        from torch.profiler import ProfilerActivity, profile

        self.n, self.cuda = n, device.type == "cuda"
        self.done_a = self.done_b = self.window = None
        self.prof = profile(activities=[ProfilerActivity.CUDA] if self.cuda
                            else [ProfilerActivity.CPU])
        self.prof.start()    # before the window: the tracer's own start-up is set-up

    def at(self, index: int) -> None:
        """Called before batch ``index`` is issued."""
        from torch.profiler import ProfilerActivity, profile

        if index == self.n:
            self.prof.stop()
            self.done_a = self.prof
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
            self.prof = profile(activities=acts)
            self.prof.start()
            self.window = torch.profiler.record_function(trace.WINDOW_SPAN)
            self.window.__enter__()
        elif index == 2 * self.n:
            self.close()

    def span(self, b: workload.Batch):
        """The benchmark's span around one infer, inside slice B."""
        if self.window is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(trace.INFER_SPAN + b.version)

    def close(self) -> None:
        if self.window is not None:
            self.window.__exit__(None, None, None)
            self.window = None
        if self.prof is not None:
            self.prof.stop()
            if self.done_a is None:
                self.done_a = self.prof
            else:
                self.done_b = self.prof
            self.prof = None


def percentile(values: List[float], weights_: List[int], q: float) -> float:
    """The q-th percentile (numpy's linear rule, as the program's
    ``sim.metrics.summarize_latencies``) of ``values`` each counted
    ``weights_`` times."""
    return float(np.percentile(np.repeat(np.asarray(values, dtype=np.float64), weights_), q))


def base(name: str) -> str:
    """The quantity a metric's name reads: ``split_tokens_per_s`` for
    ``split_tokens_per_s.<cell>``, one quantity given a bound of its own in
    each cell."""
    return name.split(".")[0]


def end_to_end(served: List[Served], window_s: float) -> Dict[str, float]:
    tokens = sum(s.batch.B * s.batch.S for s in served)
    lat = [(s.t1 - s.t0) * 1e3 for s in served]
    return {"split_tokens_per_s": tokens / window_s,
            "split_p95_ms": percentile(lat, [s.batch.B for s in served], 95.0)}


def per_layer(names: List[str], rec: trace.Record) -> Dict[str, float]:
    out = {}
    for name in names:
        value = metrics.reader(name)(rec)
        if value is not None:
            out[name] = float(value)
    return out


def run_cell(workload_name: str, seed: int, seconds: float, traced: bool, *,
             device, setup_t0: float, bench: Optional[Mapping] = None,
             config: Optional[Mapping] = None, mix: Optional[Mapping] = None,
             override: bool = False,
             break_path: Optional[Callable] = None, with_control: bool = False,
             log=print) -> Dict:
    """One run; returns the result's fields (no printing of the result).
    ``config``, ``mix`` and ``override`` replace the configuration and
    traffic files (the CPU tests' small sizes); ``break_path(engine)`` plants a fault under the
    timed path (the tests of the comparison); ``with_control`` adds the
    control's readings to the numbers (``check.errors``)."""
    bench = load_benchmark() if bench is None else bench
    cell = next((w for w in bench["workloads"] if w["name"] == workload_name), None)
    if cell is None:
        raise KeyError(f"no workload {workload_name!r} in BENCHMARK.json")
    config = load_config(cell["config"]) if config is None else config
    mix = workload.load_mix(cell["traffic"]) if mix is None else mix
    device = torch.device(device)
    sync = syncer(device)

    from repro_torch.serving import SplitServingEngine

    marks = [("start", time.time() - setup_t0)]
    cfg = port_config(config, override)
    batches = workload.schedule(mix, seed, n_cuts(cfg), config["model"]["vocab_size"], device)
    decide(cfg, batches)
    keep = workload.check_sample(batches, seed, CHECK_REQUESTS)
    versions = sorted(mix["versions"])
    marks.append(("traffic", time.time() - setup_t0))
    model = build_model(cfg, config, seed, device)
    engine = SplitServingEngine(cfg, model, versions=versions, device=device)
    sync()
    marks.append(("weights", time.time() - setup_t0))
    if break_path is not None:
        break_path(engine)
    for b in batches[:mix["round"]]:    # every shape, version and cut the window serves
        engine.infer({"tokens": b.tokens}, b.cut, b.version)
    sync()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.time() - setup_t0
    marks.append(("warm-up", setup_s))
    log("edgebench: set-up " + ", ".join(f"{k} at {v:.3f} s" for k, v in marks))

    metric_names = [m["name"] for m in bench["per_layer"]
                    if workload_name in m.get("workloads", [workload_name])]
    tracer = Tracer(mix["round"], device) if traced else None
    try:
        served, window_s, held = serve(engine, batches, seconds, keep, sync, mix["round"],
                                       tracer, 3 * mix["round"] if traced else 0)
    finally:
        if tracer is not None:
            tracer.close()
    peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    requests = sum(s.batch.B for s in served)
    log(f"edgebench: {len(served)} batches, {requests} requests completed in "
        f"{window_s:.3f} s of window")

    result = {"attempted": requests, "failed": 0,
              "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                         "kind": torch.cuda.get_device_name(device) if device.type == "cuda"
                         else "cpu",
                         "count": 1, "memory_peak_bytes": peak}}
    if traced:
        n = mix["round"]

        def shapes(lo, hi):
            return [{"B": s.batch.B, "S": s.batch.S, "version": s.batch.version}
                    for s in served[lo:hi]]
        slice_s = served[n - 1].t1 - served[0].t0
        rec = trace.from_profile(tracer.done_a, config, shapes(0, n), costs.peaks(),
                                 window_s=slice_s)
        named = trace.from_profile(tracer.done_b, config, shapes(n, 2 * n), costs.peaks())
        log(f"edgebench: traced slice A {slice_s:.4f} s (device activity only), slice B "
            f"{served[2 * n - 1].t1 - served[n].t0:.4f} s (host ops too), the next round "
            f"{served[3 * n - 1].t1 - served[2 * n].t0:.4f} s untraced")
        result["metrics"] = per_layer(metric_names, rec)
        result["device"].update(busy_s=trace.busy_s(rec), window_s=rec.window_s)
        result["breakdown"] = trace.breakdown(rec, named)
        del rec, named, tracer
    else:
        e2e = {**end_to_end(served, window_s), "setup_s": setup_s}
        result["metrics"] = {m["name"]: e2e[base(m["name"])] for m in bench["end_to_end"]
                             if workload_name in m.get("workloads", [workload_name])}

    del engine, model          # the reference runs on what the program frees
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = {"bad_answers": float(check.bad_answers(config, served)),
               **check.errors(config, seed, held, device, with_control)}
    result["reference_s"] = time.perf_counter() - t_ref
    log(f"edgebench: the comparison took {result['reference_s']:.3f} s")
    result["correct"], result["check_lines"] = check.verdict(numbers, check.load_limits(workload_name))
    result["checks"] = {k: {"value": v, "limit": check.load_limits(workload_name).get(k)}
                        for k, v in sorted(numbers.items())}
    return result

