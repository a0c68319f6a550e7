"""Roofline over the dry run's records (port of ``repro.analysis.roofline``),
against one NVIDIA H100 SXM's peaks (``launch.mesh``; the card
``nvidia-smi`` reports as "NVIDIA H100 80GB HBM3" at 700 W).

Per (arch x shape x mesh):
  compute term    = FLOPs / (GPUs * 989 TFLOP/s bf16)
  memory term     = bytes  / (GPUs * 3.35 TB/s HBM)
  collective term = collective bytes / (GPUs * 450 GB/s NVLink)

FLOPs and bytes come from the op-by-op count of the unsharded step
(``analysis.op_cost``), the collective bytes from the sharded step
(``analysis.comm_cost``). These are predicted terms, not measured times.

MODEL_FLOPS = 6*N_active*D (train) or 2*N_active*D (inference); the ratio
MODEL_FLOPS / FLOPs flags remat and redundancy.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List

from repro_torch.configs import SHAPES, get_config
from repro_torch.core.transformer_cost import model_flops
from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16


def _advice(dom: str, rec: Dict) -> str:
    arch, shape = rec["arch"], rec["shape"]
    if dom == "compute":
        if "deepseek" in arch and "decode" in shape:
            return ("absorb w_uk/w_uv into q/out projections so the MLA "
                    "cache is attended in latent space (no per-step "
                    "re-expansion)")
        if rec.get("ratio", 1) < 0.5:
            return ("cut non-model FLOPs: masked-causal block skipping in "
                    "chunked attention / leaner MoE dispatch")
        return "fuse elementwise chains; raise arithmetic intensity per block"
    if dom == "memory":
        return ("shrink live activations: smaller loss/attention chunks, "
                "offload-friendly remat policy, bf16 master-weight split")
    return ("reduce gradient/param all-reduce volume: FSDP-style "
            "reduce-scatter + all-gather schedule, or overlap collectives "
            "with the backward")


def load(path: str) -> List[Dict]:
    recs = {}
    with open(path) as f:
        for line in f:
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue
            recs[(r["arch"], r["shape"], r["mesh"],
                  r.get("variant", "baseline"))] = r  # last wins
    return list(recs.values())


def enrich(rec: Dict) -> Dict:
    chips = rec["devices"]
    flops = rec.get("jaxpr_flops", 0.0)
    mbytes = rec.get("jaxpr_bytes_fused",
                     rec.get("jaxpr_bytes_min", rec.get("jaxpr_bytes", 0.0)))
    cbytes = rec.get("collectives", {}).get("total_bytes", 0.0)
    t_c = flops / (chips * PEAK_FLOPS_BF16)
    t_m = mbytes / (chips * HBM_BW)
    t_l = cbytes / (chips * NVLINK_BW)
    terms = {"compute": t_c, "memory": t_m, "collective": t_l}
    dom = max(terms, key=terms.get)
    info = SHAPES[rec["shape"]]
    cfg = get_config(rec["arch"])
    mf = model_flops(cfg, info["kind"], info["global_batch"], info["seq_len"])
    out = dict(rec)
    out.update(compute_s=t_c, memory_s=t_m, collective_s=t_l, dominant=dom,
               model_flops=mf, ratio=(mf / flops if flops else 0.0),
               bound_s=max(t_c, t_m, t_l))
    out["advice"] = _advice(dom, out)
    return out


def fmt_s(x: float) -> str:
    if x >= 1.0:
        return f"{x:8.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:7.2f}ms"
    return f"{x*1e6:7.1f}us"


def table(recs: List[Dict], mesh: str = "single",
          variant: str = "baseline") -> str:
    rows = [enrich(r) for r in recs
            if r["mesh"] == mesh and r["status"] == "ok"
            and r.get("variant", "baseline") == variant]
    rows.sort(key=lambda r: (r["shape"], -r["bound_s"]))
    lines = ["| arch | shape | compute | memory | collective | dominant |"
             " MODEL/counted | note |",
             "|---|---|---|---|---|---|---|---|"]
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(r['compute_s'])} "
            f"| {fmt_s(r['memory_s'])} | {fmt_s(r['collective_s'])} "
            f"| **{r['dominant']}** | {r['ratio']:.2f} | {r['advice']} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default="results/dryrun_torch.jsonl")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--json-out", default=None)
    args = ap.parse_args(argv)
    recs = load(args.results)
    print(table(recs, args.mesh))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump([enrich(r) for r in recs], f, indent=1)


if __name__ == "__main__":
    main()
