"""EdgeRL profiles from the dry run's records (port of
``repro.core.roofline_env``).

The paper profiles its CNNs by running them on the testbed; the dry run
(``repro_torch.launch.dryrun``) is this repo's counterpart: per (arch,
shape) it has the step's counted FLOPs, fused HBM bytes and collective
bytes. ``dryrun_profile`` turns a record into an EdgeRL ``ModelProfile``
whose per-layer FLOPs are scaled so that the arch's total matches the
counted FLOPs, not the analytic estimate: the controller optimizes against
what the step really runs, remat and dispatch overheads included. One
record in the reference's schema feeds this module and the reference's
alike.

    cfg, tables = make_dryrun_tpu_env(["qwen2-0.5b", ...],
                                      results="results/dryrun_torch.jsonl")
"""
from __future__ import annotations

import json
from typing import Dict, Sequence, Tuple

from repro_torch.configs import SHAPES, get_config
from repro_torch.core.controller import _TPU_LATENCY, _TPU_POWER
from repro_torch.core.env import EnvConfig, ProfileTables, build_tables
from repro_torch.core.profiles import ModelProfile, build_quant_versions, spread_cuts
from repro_torch.core.reward import RewardWeights
from repro_torch.core.transformer_cost import block_flops_per_token
from repro_torch.device import DeviceLike


def _load_records(path: str) -> Dict[Tuple[str, str], dict]:
    out = {}
    with open(path) as f:
        for line in f:
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue
            if (r.get("status") == "ok" and r.get("mesh") == "single"
                    and r.get("variant", "baseline") == "baseline"):
                out[(r["arch"], r["shape"])] = r
    return out


def dryrun_profile(arch: str, records, *, shape: str = "prefill_32k",
                   n_cuts: int = 4) -> ModelProfile:
    """ModelProfile whose total FLOPs equal the counted FLOPs of the dry
    run's record (the analytic ones where ``records`` has none).

    The version axis is the quant registry, as in ``transformer_profile``:
    the bf16 FLOPs are calibrated to the counted FLOPs, then each quantized
    version applies its matmul cost scale on top of them
    (``profiles.build_quant_versions``)."""
    cfg = get_config(arch)
    rec = records.get((arch, shape))
    info = SHAPES[shape]
    tokens = info["global_batch"] * info["seq_len"]

    analytic = block_flops_per_token(cfg, seq_ctx=info["seq_len"])
    scale = 1.0
    if rec:
        # calibrate to the counted FLOPs per token
        measured_per_tok = rec["jaxpr_flops"] / tokens
        scale = measured_per_tok / max(sum(analytic), 1.0)
    versions = build_quant_versions(cfg, analytic,
                                    seq_len=info["seq_len"],
                                    cuts=spread_cuts(len(analytic), n_cuts),
                                    flops_scale=scale)
    return ModelProfile(arch, versions)


def make_dryrun_tpu_env(arch_names: Sequence[str],
                        results: str = "results/dryrun_torch.jsonl",
                        weights: RewardWeights = RewardWeights(),
                        device: DeviceLike = None,
                        **env_kw) -> Tuple[EnvConfig, ProfileTables]:
    """The transformer env priced from the dry run's records, its tables on
    ``device`` (the card unless the caller names the CPU)."""
    records = _load_records(results)
    profs = [dryrun_profile(a, records) for a in arch_names]
    tables = build_tables(profs, device=device)
    cfg = EnvConfig(n_uavs=len(arch_names), latency=_TPU_LATENCY,
                    power=_TPU_POWER, weights=weights.normalized(),
                    frames_per_slot=1000.0, **env_kw)
    return cfg, tables
