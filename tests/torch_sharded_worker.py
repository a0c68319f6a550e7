"""Sharded steps against unsharded ones over a group of gloo processes.

Run as a script: ``python tests/torch_sharded_worker.py OUT.json [WORLD]``
starts WORLD (default 4) CPU processes in one gloo group. On each mesh of
(data, model) = (1, W), (2, W/2), (W, 1) it runs one train step and one
serve step of reduced qwen2 (H 4, HK 2) and one train step of reduced
falcon-mamba; reduced mixtral and deepseek take one train step on the
meshes ``CASES`` names. Each runs on a model sharded by
``launch.steps.shard_model`` and on an unsharded copy of the same weights.
Rank 0 writes, per case, the losses and the largest difference of each
gradient leaf and of each parameter leaf after the step, relative to that
leaf's largest magnitude (or the logits'), to OUT.json.
``tests/test_torch_sharded.py`` runs it in a subprocess, so no test
process keeps a process group.
"""
from __future__ import annotations

import functools
import json
import socket
import sys
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

B, S = 4, 16


def _weights(cfg, seed):
    """A model whose every leaf is drawn from ``seed``: the reference's init
    plus normal noise of 0.02, so zero biases and unit norm scales are
    neither zero nor one (a leaf starting at zero would make one AdamW step
    a sign of a near-zero gradient)."""
    from repro_torch.models import params as pp
    model = pp.init(cfg, torch.Generator().manual_seed(seed), device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    flat = {k: v + 0.02 * torch.randn(v.shape, generator=g, dtype=torch.float32).to(v.dtype)
            for k, v in pp.param_tree(model).items()}
    return pp.assign_params(model, flat)


def _full(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _rel(a, b) -> float:
    a, b = _full(a).double(), _full(b).double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@functools.lru_cache(maxsize=None)
def _config(arch):
    """The reduced config of ``arch``, or of "<arch>/E<n>": with n experts."""
    from repro_torch.configs import get_config
    name, _, experts = arch.partition("/E")
    cfg = get_config(name).reduced()
    return cfg.with_overrides(n_experts=int(experts)) if experts else cfg


def _train_reference(arch):
    """(batch, parameters after one unsharded step, its loss): the same on
    every mesh, so taken once."""
    from repro_torch.launch import steps as st
    from repro_torch.models import params as pp
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = _config(arch)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(7))
    batch = {"tokens": tokens, "targets": torch.roll(tokens, -1, 1)}
    step = st.make_train_step(cfg, AdamWConfig(), remat=True)
    ref = _weights(cfg, 0)
    grads, _, _ = st.accumulate_grads(cfg, ref, batch, remat=True)
    ref, _, met = step(ref, adamw_init(pp.param_tree(ref)), batch)
    return batch, grads, pp.param_tree(ref), float(met["loss"])


def _train_case(arch, mesh):
    from repro_torch.launch import shardings as sh
    from repro_torch.launch import steps as st
    from repro_torch.models import params as pp
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = _config(arch)
    batch, want_grads, want, ref_loss = _train_reference(arch)
    step = st.make_train_step(cfg, AdamWConfig(), remat=True)
    model = st.shard_model(_weights(cfg, 0), mesh)
    rules = sh.logical_rules(cfg, mesh)
    dbatch = sh.distribute(batch, sh.tree_shardings(mesh, st.batch_axes(cfg), batch, rules))
    # the gradients alone: one AdamW step is blind to their scale
    with st.on_mesh(model):
        grads, _, _ = st.accumulate_grads(cfg, model, dbatch, remat=True)
        state = adamw_init(pp.param_tree(model))
    model, _, met = step(model, state, dbatch)
    got = pp.param_tree(model)
    return {"loss": [ref_loss, float(_full(met["loss"]))],
            "grads": {k: _rel(grads[k], want_grads[k]) for k in want_grads},
            "params": {k: _rel(got[k], want[k]) for k in want}}


def _serve_case(arch, mesh):
    from repro_torch.launch import shardings as sh
    from repro_torch.launch import steps as st
    from repro_torch.models import model as M

    cfg = _config(arch)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(8))
    ref = _weights(cfg, 0)
    logits0, cache = st.make_prefill_step(cfg)(ref, {"tokens": tokens})
    model = st.shard_model(_weights(cfg, 0), mesh)
    rules = sh.logical_rules(cfg, mesh)
    dcache = sh.distribute(cache, sh.tree_shardings(mesh, M.cache_axes(cfg), cache, rules))
    token = tokens[:, -1]
    dtoken = sh.distribute(token, sh.tree_shardings(mesh, ("batch",), token, rules))
    # the unsharded step writes its cache in place: the sharded one got a copy
    want, _ = st.make_serve_step(cfg)(ref, cache, token, S)
    got, _ = st.make_serve_step(cfg)(model, dcache, dtoken, S)
    return {"logits": _rel(got, want)}


ALL = None
# (kind, arch, case, meshes (None: all three)). The MoE cases: reduced
# mixtral's 4 experts split over the model axis with the batch over data
# (2, 2); with 3 experts on a model axis of 4 their hidden width is split
# instead (1, 4); reduced deepseek (shared experts, a dense first layer,
# MLA) on (2, 2)
CASES = (("train", "qwen2-0.5b", _train_case, ALL), ("serve", "qwen2-0.5b", _serve_case, ALL),
         ("train", "falcon-mamba-7b", _train_case, ALL),
         ("train", "mixtral-8x22b", _train_case, ((2, 2),)),
         ("train", "mixtral-8x22b/E3", _train_case, ((1, 4),)),
         ("train", "deepseek-v2-lite-16b", _train_case, ((2, 2),)))


def _worker(rank, world, port, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    from repro_torch.launch.mesh import make_mesh
    results = []
    try:
        for shape in ((1, world), (2, world // 2), (world, 1)):
            mesh = make_mesh(shape, ("data", "model"), device="cpu")
            for kind, arch, case, meshes in CASES:
                if meshes is ALL or shape in meshes:
                    results.append({"mesh": list(shape), "kind": kind, "arch": arch,
                                    **case(arch, mesh)})
    except Exception:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out, "w") as f:
            json.dump(results, f)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


if __name__ == "__main__":
    world = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    mp.spawn(_worker, args=(world, _free_port(), sys.argv[1]), nprocs=world)
