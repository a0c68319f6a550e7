"""EdgeRL-routed split inference on a transformer: the paper's closed loop
(port of ``examples/split_serving.py``).

The controller trains on the transformer env (``make_tpu_env``: the
reference's env constants, its version axis the quant registry bf16 / w8 /
w4) with the served sequence length, so a table's cut bytes address what
the engine ships. Each slot then runs decide -> resolve_selection ->
``SplitServingEngine.infer`` on the version's model at the chosen cut ->
``action_costs`` -> ``env_step``, and prints the measured bytes that
crossed the cut beside the bytes the env's table priced for them: the
table entry times the batch, plus the f32 row scales that w8's int8 link
carries (``batch x seq x 4``). A terminal cut (the profile's last layer)
is device-complete inference in the env, which prices a class id; the
engine still finishes the logits server-side, so those bytes are not
compared, as in the reference's fleet backend.

Runs on the CUDA card at full width unless ``--device`` and ``--reduced``
say otherwise; random model weights from seed 0.

    PYTHONPATH=src python -m repro_torch.launch.split_serving
    PYTHONPATH=src python -m repro_torch.launch.split_serving --device cpu --reduced
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List

import torch

from repro_torch.configs import ALL_ARCHS, get_config
from repro_torch.core import (A2CConfig, decide, env_reset, env_step,
                              make_tpu_env, resolve_selection, train_agent,
                              transformer_profile)
from repro_torch.core.env import action_costs
from repro_torch.core.pricing import numpy_tables
from repro_torch.device import resolve_device
from repro_torch.models import init
from repro_torch.quant import DEFAULT_VERSIONS, get_version
from repro_torch.serving import SplitServingEngine


def is_terminal(profile, j: int, k: int) -> bool:
    """Whether table action (j, k) cuts after the profile's last layer."""
    v = profile.versions[min(j, len(profile.versions) - 1)]
    return v.cut_points[min(k, len(v.cut_points) - 1)] >= v.n_layers


def expected_act_bytes(cut_bytes, profile, j: int, k: int, batch: int, seq: int,
                       m: int = 0) -> int:
    """The bytes an executed (j, k) must measure at the cut: the table's
    per-request entry times the batch, plus the f32 per-row scales of
    w8's int8 link (the one term the tables fold away)."""
    v = profile.versions[min(j, len(profile.versions) - 1)]
    nbytes = int(cut_bytes[m, j, k]) * batch
    if get_version(v.version).act_bits == 8:
        nbytes += batch * seq * 4
    return nbytes


def serve_slot(engine: SplitServingEngine, cfg, profile, env_cfg, tables, state,
               actions, batch: Dict, cut_bytes) -> Dict:
    """Execute device 0's action of ``actions`` on ``batch`` and price it:
    the slot's record (version, cut, measured and expected bytes, the
    env's latency and energy estimates, the infer's wall time)."""
    j, k = int(actions[0, 0]), int(actions[0, 1])
    version, cut = resolve_selection(cfg, profile, j, k)
    B, S = batch["tokens"].shape
    t0 = time.perf_counter()
    logits, measured = engine.infer(batch, cut, version)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    wall_ms = (time.perf_counter() - t0) * 1e3
    costs = action_costs(env_cfg, tables, state, actions)
    terminal = is_terminal(profile, j, k)
    return {"j": j, "k": k, "version": version, "cut": cut, "terminal": terminal,
            "measured_bytes": int(measured),
            "expected_bytes": None if terminal else expected_act_bytes(
                cut_bytes, profile, j, k, B, S),
            "est_latency_s": float(costs[3][0]), "est_energy_j": float(costs[4][0]),
            "infer_ms": wall_ms, "logits_finite": bool(torch.isfinite(logits).all()),
            "logits_shape": tuple(logits.shape)}


def format_slot(t: int, rec: Dict) -> str:
    expected = "terminal" if rec["terminal"] else str(rec["expected_bytes"])
    return (f"{t:4d} {rec['version']:>5} {str(rec['cut']):>14} {rec['measured_bytes']:>11d} "
            f"{expected:>11} {rec['est_latency_s'] * 1e3:10.4f} {rec['est_energy_j']:9.4f} "
            f"{rec['infer_ms']:9.2f}")


HEADER = (f"{'slot':>4} {'ver':>5} {'cut':>14} {'meas_bytes':>11} {'exp_bytes':>11} "
          f"{'est_lat_ms':>10} {'est_E_J':>9} {'infer_ms':>9}")


@dataclasses.dataclass
class Loop:
    """What the closed loop holds: the env, the trained controller, the
    model's profile and the engine, and the request batch it serves."""
    env_cfg: object
    tables: object
    agent: object
    history: List[Dict]
    cfg: object
    profile: object
    engine: SplitServingEngine
    batch: Dict
    cut_bytes: object


def build(arch: str = "qwen2-0.5b", episodes: int = 60, batch: int = 8, seq: int = 512,
          device=None, reduced: bool = False, seed: int = 0, log=print) -> Loop:
    """Train the controller on the env of ``arch`` at the served ``seq``,
    and build the engine over random weights (seed ``seed``)."""
    dev = resolve_device(device)
    env_cfg, tables = make_tpu_env([arch], seq_len=seq, reduced=reduced, device=dev)
    log(f"training the controller on {dev} for {episodes} episodes ...")
    t0 = time.perf_counter()
    agent, hist = train_agent(env_cfg, tables, A2CConfig(episodes=episodes), seed=seed)
    log(f"trained in {time.perf_counter() - t0:.1f} s; mean reward first/last update "
        f"{hist[0]['mean_reward']:+.4f} / {hist[-1]['mean_reward']:+.4f}")
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    model = init(cfg, torch.Generator(device=dev).manual_seed(seed), device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(seed + 2))
    return Loop(env_cfg, tables, agent, hist, cfg, transformer_profile(cfg, seq_len=seq),
                SplitServingEngine(cfg, model, versions=DEFAULT_VERSIONS, device=dev),
                {"tokens": tokens}, numpy_tables(tables).cut_bytes)


def serve(loop: Loop, slots: int, generator: torch.Generator, log=print) -> List[Dict]:
    """``slots`` slots of decide -> resolve -> infer -> price -> env_step
    from a fresh env state; returns the slot records (``serve_slot``)."""
    state = env_reset(loop.env_cfg, loop.tables, generator)
    log(HEADER)
    records = []
    for t in range(slots):
        actions = decide(loop.agent, loop.env_cfg, loop.tables, state)
        rec = serve_slot(loop.engine, loop.cfg, loop.profile, loop.env_cfg, loop.tables,
                         state, actions, loop.batch, loop.cut_bytes)
        records.append(rec)
        log(format_slot(t, rec))
        state, _, _ = env_step(loop.env_cfg, loop.tables, state, actions, generator)
    log(f"logits shape: {records[-1]['logits_shape']}")
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b", choices=ALL_ARCHS)
    ap.add_argument("--episodes", type=int, default=60)
    ap.add_argument("--slots", type=int, default=6)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the current CUDA card")
    ap.add_argument("--reduced", action="store_true",
                    help="the arch's reduced variant (2 layers, narrow), for the CPU")
    args = ap.parse_args(argv)
    loop = build(args.arch, args.episodes, args.batch, args.seq, args.device, args.reduced)
    records = serve(loop, args.slots,
                    torch.Generator(device=loop.tables.device).manual_seed(7))
    bad = [t for t, r in enumerate(records)
           if not r["terminal"] and r["measured_bytes"] != r["expected_bytes"]]
    if bad:
        raise SystemExit(f"measured bytes differ from the table's at slots {bad}")
    return records


if __name__ == "__main__":
    main()
