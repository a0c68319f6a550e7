"""Multi-pod dry run: every (arch x input shape x mesh) step, sharded over
256 or 512 virtual GPUs, with shapes only (port of
``repro.launch.dryrun``).

Proves the distribution plan is coherent without the hardware: a sharding
that DTensor cannot propagate, an op without a sharding strategy, or an op
that needs data (``.item()``, ``nonzero``, a shape that depends on values,
as the MoE capacity and gather dispatch do) is a ``fail`` record with its
error. Where the reference lowers and compiles under
``--xla_force_host_platform_device_count``, the port starts a fake process
group of that many ranks (``torch.testing._internal.distributed.fake_pg``:
collectives are no-ops), builds the production mesh on it and runs each
step under ``FakeTensorMode`` twice:

  1. unsharded, under ``analysis.op_cost.OpCost``: the whole program's
     FLOPs and byte bounds (the reference's pre-partition jaxpr count);
  2. with parameters, optimizer state, batch and caches as DTensors placed
     by ``steps.step_shardings``, under ``analysis.comm_cost.CommCost``:
     the collectives DTensor runs (the reference's compiled HLO), and
     the bytes of one device's argument and output shards.

Like the reference's ``XLA_FLAGS``, the process group is process-global,
so the dry run runs in a process of its own. Records are appended to a
JSONL file (default ``results/dryrun_torch.jsonl``), and reruns skip
the combos already ``ok`` there. The record keys are the reference's,
so one record feeds both packages' ``roofline`` and ``roofline_env``; the
reference's keys that have no torch counterpart (``hlo_flops``,
``hlo_bytes``, ``lower_s``, ``compile_s``, ``temp_size_in_bytes``,
``alias_size_in_bytes``, ``generated_code_size_in_bytes``, ``hlo_len``)
are not written.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh single|multi|both]
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.analysis.comm_cost import CommCost
from repro_torch.analysis.op_cost import OpCost
from repro_torch.configs import ALL_ARCHS, SHAPES, get_config
from repro_torch.launch import shardings as sh
from repro_torch.launch import steps as st
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import model as M
from repro_torch.models import params as pp
from repro_torch.optim import AdamWConfig, adamw_init

# Perf-iteration variants, the reference's: config-level overrides; "mbN"
# also switches the train step to N-way gradient accumulation.
VARIANTS = {
    "baseline": {},
    "mla_absorb": {"mla_absorb": True},
    "moe_gather": {"moe_impl": "gather"},
    "moe_chunk512": {"moe_chunk": 512},
    "moe_gather512": {"moe_impl": "gather", "moe_chunk": 512},
    "bigchunk": {"attn_q_chunk": 2048, "attn_kv_chunk": 4096},
    "hugechunk": {"attn_q_chunk": 4096, "attn_kv_chunk": 8192},
    "mb8": {},
    "mb16": {},
    "mb8_gather": {"moe_impl": "gather"},
    "noremat": {"train_remat": False},
    "causal_skip": {"attn_causal_skip": True},
    "noremat_skip": {"train_remat": False, "attn_causal_skip": True},
    "hugechunk_skip": {"attn_q_chunk": 4096, "attn_kv_chunk": 8192,
                       "attn_causal_skip": True},
    "fsdp": {"fsdp": True},
    "fsdp_skip": {"fsdp": True, "attn_causal_skip": True},
}

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "results", "dryrun_torch.jsonl")


def _dryrun_dtype(cfg):
    """Every model dry-runs in bf16 (the deployment dtype), as the
    reference's dry run does."""
    return cfg.with_overrides(param_dtype="bfloat16", compute_dtype="bfloat16")


def build_step(cfg, shape_name, variant="baseline"):
    info = SHAPES[shape_name]
    cfg = st.config_for_shape(cfg, shape_name)
    if info["kind"] == "train":
        mb = int(variant[2:].split("_")[0]) if variant.startswith("mb") else 1
        fn = st.make_train_step(cfg, AdamWConfig(), remat=cfg.train_remat,
                                microbatches=mb)
        order = ("params", "opt_state", "batch")
    elif info["kind"] == "prefill":
        fn = st.make_prefill_step(cfg)
        order = ("params", "batch")
    else:
        fn = st.make_serve_step(cfg)
        order = ("params", "cache", "token", "pos")
    return cfg, fn, order


def fake_group(world: int) -> None:
    """Make the default process group a fake one of ``world`` ranks (this
    process is rank 0), replacing one of another size."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _empty(t: torch.Tensor) -> torch.Tensor:
    """A tensor of ``t``'s shape and dtype on the CPU (a fake one under
    ``FakeTensorMode``)."""
    return torch.empty(t.shape, dtype=t.dtype)


def _tree(fn, tree):
    return {k: _tree(fn, v) for k, v in tree.items()} if isinstance(tree, dict) else fn(tree)


def step_inputs(cfg, shape_name, order, mesh=None):
    """The step's arguments in ``order`` as CPU tensors (fake ones under
    ``FakeTensorMode``): a model built from the abstract parameters, the
    optimizer state, batch, caches and token; pos the last position. With
    ``mesh``, each is placed as ``step_shardings`` says."""
    specs = st.input_specs(cfg, shape_name)
    model = M.CausalLM(st.config_for_shape(cfg, shape_name), _tree(_empty, specs["params"]))
    if mesh is not None:
        shard = st.step_shardings(cfg, shape_name, mesh)
        st.shard_model(model, mesh)
    args = {"params": model, "pos": SHAPES[shape_name]["seq_len"] - 1}
    for key in ("batch", "cache", "token"):
        if key in order:
            args[key] = _tree(_empty, specs[key])
            if mesh is not None:
                args[key] = sh.distribute(args[key], shard[key])
    if "opt_state" in order:
        with st.on_mesh(model):
            args["opt_state"] = adamw_init(pp.param_tree(model))
    return [args[k] for k in order]


def _local_bytes(tree) -> int:
    """Bytes of one device's shards of every tensor in ``tree`` (a model's
    parameters count once each)."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, torch.nn.Module):
        return _local_bytes(list(tree.parameters()))
    if isinstance(tree, dict):
        return _local_bytes(list(tree.values()))
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(t) for t in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.to_local() if isinstance(tree, DTensor) else tree
        return t.numel() * t.element_size()
    return 0


def run_one(arch: str, shape_name: str, mesh_kind: str, *, variant: str = "baseline"):
    from torch._subclasses.fake_tensor import FakeTensorMode

    t0 = time.time()
    cfg0 = _dryrun_dtype(get_config(arch)).with_overrides(**VARIANTS[variant])
    _, fn, order = build_step(cfg0, shape_name, variant)
    fake_group(512 if mesh_kind == "multi" else 256)
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"), device="cpu")
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "variant": variant,
           "devices": int(mesh.size()), "status": "ok"}
    try:
        with FakeTensorMode():
            args = step_inputs(cfg0, shape_name, order)
            with OpCost() as oc:
                fn(*args)
            rec["jaxpr_flops"] = oc.totals["flops"]
            rec["jaxpr_bytes"] = oc.totals["bytes"]
            rec["jaxpr_bytes_min"] = oc.totals["bytes_min"]
            rec["jaxpr_bytes_fused"] = oc.totals["bytes_fused"]
            del args
            args = step_inputs(cfg0, shape_name, order, mesh)
            rec["argument_size_in_bytes"] = _local_bytes(args)
            with CommCost() as cc:
                out = fn(*args)
            rec["output_size_in_bytes"] = _local_bytes(out)
            rec["collectives"] = cc.result()
    except Exception as e:       # noqa: BLE001 - record the failure
        rec["status"] = "fail"
        rec["error"] = "".join(traceback.format_exception_only(e))[:2000]
    rec["total_s"] = round(time.time() - t0, 2)
    return rec


def load_done(path):
    done = {}
    if os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                done[(r["arch"], r["shape"], r["mesh"],
                      r.get("variant", "baseline"))] = r
    return done


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=os.path.abspath(RESULTS))
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="baseline", choices=list(VARIANTS))
    args = ap.parse_args(argv)

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    archs = ALL_ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]

    done = {} if args.force else load_done(args.out)
    v = args.variant
    # one mesh at a time: each takes its own fake group
    todo = [(a, s, m) for m in meshes for a in archs for s in shapes
            if (a, s, m, v) not in done or done[(a, s, m, v)]["status"] != "ok"]
    print(f"dry-run: {len(todo)} combos to run "
          f"({len(done)} cached in {args.out})", flush=True)
    n_fail = 0
    for a, s, m in todo:
        rec = run_one(a, s, m, variant=args.variant)
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        ok = rec["status"] == "ok"
        n_fail += (not ok)
        msg = f"[{'OK' if ok else 'FAIL'}] {a} x {s} x {m} ({rec['total_s']}s)"
        if not ok:
            msg += f"\n    {rec['error'][:500]}"
        print(msg, flush=True)
    print(f"done; {n_fail} failures", flush=True)
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
