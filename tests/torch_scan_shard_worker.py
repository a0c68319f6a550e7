"""The scan engine sharded over groups of gloo processes.

Run as a script: ``python tests/torch_scan_shard_worker.py OUT_DIR [WORLD
...]`` starts, for each WORLD (default 1 2 3 4), one group of WORLD CPU
processes and runs ``simulate(..., fleet=FleetConfig(engine="scan",
shard=True, timeline=True))`` on every case of ``CASES`` twice in it:
diurnal-fleet at its 8 devices, at its load and under ``BUSY``, and
megafleet cut to ``MEGA_DEVICES`` devices (a count that no world size
divides, so the fleet axis is padded).
The group of one also runs each case with shard=False, the baseline. The
timeline records per-epoch energy and latency; it only reads the state,
so the results are those of a run with it off. Every rank writes what it
returned, and the
number of ``torch.distributed.all_reduce`` calls each sharded run made, to
``OUT_DIR/w{WORLD}_r{RANK}.json``. ``tests/test_torch_scan_sharded.py`` runs
it in a subprocess, so no test process keeps a process group.
"""
from __future__ import annotations

import json
import os
import socket
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

MEGA_DEVICES, MEGA_REQUESTS = 30_001, 600_000
DIURNAL_REQUESTS = 15_000
# diurnal-fleet under a load its server cannot drain (30 -> 45 rps a device
# where the preset has 2 -> 30): full_offload's tail work outgrows the slot,
# so the server backlog, which the epoch's all-reduce feeds, builds
BUSY = {"trace_kw": {"base_rps": 30.0, "peak_rps": 45.0}, "peak_rps": 45.0}
# (label, scenario, its overrides, requests, policies)
CASES = (("diurnal-fleet", "diurnal-fleet", {}, DIURNAL_REQUESTS,
          ("device_only", "full_offload")),
         ("diurnal-fleet-busy", "diurnal-fleet", BUSY, DIURNAL_REQUESTS, ("full_offload",)),
         ("megafleet", "megafleet", {"devices": MEGA_DEVICES}, MEGA_REQUESTS,
          ("device_only", "full_offload", "greedy_oracle")))
LOG_COLUMNS = ("arrivals", "queue_jobs", "backlog_s", "dropped", "slo_hits", "alive")


def _plain(x):
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    return x


def _record(res) -> dict:
    """What a SimResult holds, as JSON (floats round-trip exactly)."""
    out = {"summary": {k: _plain(v) for k, v in res.summary.items()},
           "selection_hist": res.selection_hist.tolist(), "epochs": res.epochs,
           "served": res.served, "duration_s": res.duration_s,
           "dropped": res.metrics.dropped,
           "epoch_log": {k: _plain(res.epoch_log.column(k)) for k in LOG_COLUMNS},
           "timeline": res.timeline.to_json()}
    return out


def _run(name, overrides, n_requests, policy, shard):
    from repro_torch.policies import build_policy
    from repro_torch.scenarios import get_scenario
    from repro_torch.sim import FleetConfig, simulate

    sc = get_scenario(name).replace(**overrides)
    env_cfg, tables, mids, _ = sc.build_env(device="cpu")
    pol = build_policy(policy, env_cfg, tables)
    return simulate(env_cfg, tables, pol, sc.build_trace(), n_requests=n_requests,
                    seed=sc.seeds[0], model_ids=mids,
                    fleet=FleetConfig(slo_s=sc.slo_s, engine="scan", shard=shard,
                                      timeline=True))


def _worker(rank, world, port, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    calls = [0]
    all_reduce = dist.all_reduce

    def counted(*args, **kw):
        calls[0] += 1
        return all_reduce(*args, **kw)

    dist.all_reduce = counted
    results = []
    try:
        for label, name, overrides, n_requests, policies in CASES:
            for policy in policies:
                case = {"case": label, "policy": policy, "runs": [], "all_reduce": []}
                for _ in range(2):
                    calls[0] = 0
                    case["runs"].append(_record(_run(name, overrides, n_requests, policy, True)))
                    case["all_reduce"].append(calls[0])
                if world == 1:
                    calls[0] = 0
                    case["unsharded"] = _record(_run(name, overrides, n_requests, policy,
                                                     False))
                    case["unsharded_all_reduce"] = calls[0]
                results.append(case)
    except Exception:
        traceback.print_exc()
        raise
    finally:
        dist.all_reduce = all_reduce
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"w{world}_r{rank}.json"), "w") as f:
        json.dump(results, f)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


if __name__ == "__main__":
    worlds = [int(w) for w in sys.argv[2:]] or [1, 2, 3, 4]
    for w in worlds:
        mp.spawn(_worker, args=(w, _free_port(), sys.argv[1]), nprocs=w)
