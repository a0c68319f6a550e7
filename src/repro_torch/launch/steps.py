"""Step functions for training, prefill and decode (port of
``repro.launch.steps``).

``make_train_step`` returns ``train_step(model, opt_state, batch) -> (model,
opt_state, metrics)``: the loss and its gradients through autograd
(``models.forward_train``), gradient accumulation over microbatches as the
reference accumulates them, then ``optim.adamw_update`` on the parameters
in the JAX package's flat, stacked layout (``models.param_tree``), written
back into the model in place. The optimizer state keeps that layout, the
one a checkpoint has: ``adamw_init(param_tree(model))``.

On the card a train step runs every kernel it reaches forward and backward
through hand-written kernels: every attention through the flash attention
kernels, falcon-mamba's selective scan through ``mamba_scan`` and its
backward, recurrentgemma's RG-LRU through ``rglru_scan`` and its backward
(its local attention at head_dim 256 through the (256, 256) instances).
All ten configs have every backward they need. A config whose attention
had a (D, Dv) without a backward instance would be refused before the
first step (``check_trainable_on_card``); nothing falls back to the plain
versions on the card.

The abstract inputs (``input_specs``: meta tensors, nothing allocated) and
their shardings (``step_shardings``) mirror the reference's, key by key.
``shard_model`` distributes a model's parameters over a ``DeviceMesh`` as
DTensors by their resolved specs, the counterpart of ``jax.jit``'s
``in_shardings``: the same step functions then run on the sharded model,
each kernel on its operands' local shards (``kernels.sharded``).
"""
from __future__ import annotations

import contextlib
from typing import Dict, List

import torch
from torch import nn

from repro_torch.configs import SHAPES
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import sharded
from repro_torch.kernels.flash_attention import BWD_HEAD_DIMS, BWD_MISSING
from repro_torch.models import model as M
from repro_torch.launch import shardings as sh
from repro_torch.models.params import (_slots, abstract_params, assign_params, export_grads,
                                       param_axes, param_tree, set_trainable)
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

LONG_WINDOW = 8192   # sliding window applied for long-context shapes


def config_for_shape(cfg: ModelConfig, shape_name: str) -> ModelConfig:
    """Shape-compatibility overrides for an input shape: long_500k needs
    sub-quadratic attention, so a config that declares no window (and is
    neither ssm nor hybrid) gets an 8k sliding window."""
    if shape_name == "long_500k" and not cfg.ssm:
        if cfg.sliding_window is None and not cfg.block_pattern:
            cfg = cfg.with_overrides(sliding_window=LONG_WINDOW)
    return cfg


def _attention_head_dims(cfg: ModelConfig):
    """(D, Dv) of the config's flash attention calls, or None without
    attention."""
    if cfg.ssm:
        return None
    if cfg.use_mla:
        return cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim
    return cfg.resolved_head_dim, cfg.resolved_head_dim


def kernels_without_backward(cfg: ModelConfig) -> List[str]:
    """The kernels that ``cfg``'s train path reaches on the card and that
    have no backward kernel: the flash attention at a (D, Dv) outside
    ``BWD_HEAD_DIMS`` (the scans' backward kernels take every shape the
    train path gives them). Empty for all ten configs."""
    missing = []
    dims = _attention_head_dims(cfg)
    if dims is not None and dims not in BWD_HEAD_DIMS:
        missing.append(f"flash_attention at (q/k, v) head dims {dims}")
    return missing


def check_trainable_on_card(cfg: ModelConfig) -> None:
    """Raise NotImplementedError, naming the kernels and the ROADMAP item,
    when ``cfg``'s train path on the card reaches a kernel without a
    backward."""
    missing = kernels_without_backward(cfg)
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: a train step on the card reaches {', '.join(missing)}, which "
            f"has no backward kernel yet ({BWD_MISSING}); train it with --device cpu")


def _slices(batch: Dict[str, torch.Tensor], n: int):
    """The batch cut into n microbatches along the batch dim."""
    return [{k: v[i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)] for k, v in batch.items()}
            for i in range(n)]


def accumulate_grads(cfg: ModelConfig, model: M.CausalLM, batch: Dict[str, torch.Tensor],
                     remat: bool = True, microbatches: int = 1):
    """The loss's gradients as the reference's train step takes them:
    (grads, loss, metrics). grads is {leaf path: stacked tensor}
    (``export_grads``); with microbatches > 1 the batch is cut into that
    many slices along its batch dim, their gradients summed and divided by
    n, the loss and the forward's metrics ({"lm_loss", "aux_loss"})
    averaged. The model's float parameters are made trainable, and their
    ``.grad`` is None again on return."""
    set_trainable(model)
    for p in model.parameters():
        p.grad = None
    n = microbatches
    losses, mets = [], []
    for mb in ([batch] if n == 1 else _slices(batch, n)):
        loss, met = M.forward_train(cfg, model, mb, remat=remat)
        loss.backward()
        losses.append(loss.detach())
        mets.append({k: v.detach() for k, v in met.items()})
    grads = export_grads(model)
    for p in model.parameters():
        p.grad = None
    if n > 1:
        grads = {k: g / n for k, g in grads.items()}
    loss = losses[0] if n == 1 else sum(losses) / n
    return grads, loss, {k: torch.stack([m[k] for m in mets]).mean() for k in mets[0]}


def make_train_step(cfg: ModelConfig, opt: AdamWConfig, remat: bool = True,
                    microbatches: int = 1):
    """``train_step(model, opt_state, batch) -> (model, opt_state, metrics)``:
    ``accumulate_grads``, then ``adamw_update`` on ``param_tree(model)``,
    written back into the model. On the card the config's train path is
    checked first (``check_trainable_on_card``). metrics: {"lm_loss",
    "aux_loss", "loss", "lr", "grad_norm"}, 0-d tensors on the model's
    device."""

    def train_step(model: M.CausalLM, opt_state: Dict, batch: Dict[str, torch.Tensor]):
        if model.tok_embed.is_cuda:
            check_trainable_on_card(cfg)
        with on_mesh(model):
            grads, loss, metrics = accumulate_grads(cfg, model, batch, remat, microbatches)
            new_params, opt_state, om = adamw_update(opt, param_tree(model), grads, opt_state)
            assign_params(model, new_params)
        return model, opt_state, dict(metrics, loss=loss, **om)

    return train_step


def make_prefill_step(cfg: ModelConfig):
    """``prefill_step(model, batch) -> (last-position logits, caches)``."""
    def prefill_step(model, batch):
        with torch.no_grad(), on_mesh(model):
            return M.prefill(cfg, model, batch)
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """``serve_step(model, caches, token, pos) -> (logits, caches)``; the
    caches are written in place."""
    def serve_step(model, cache, token, pos):
        with torch.no_grad(), on_mesh(model):
            return M.decode_step(cfg, model, cache, token, pos)
    return serve_step


# --------------------------------------------------------------------------
# sharded models
# --------------------------------------------------------------------------

def on_mesh(model: M.CausalLM):
    """The context a step runs a sharded model (``shard_model``) in: plain
    tensors that meet its DTensors (positions, masks, scalars, the
    optimizer's step) count as replicated over the mesh. A null context
    for a plain model."""
    if not sharded.is_dtensor(model.tok_embed):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def shard_model(model: M.CausalLM, mesh, rules=None) -> M.CausalLM:
    """Distribute every float parameter of ``model`` over ``mesh`` as a
    DTensor, placed by its leaf's resolved spec (``rules`` default
    ``logical_rules(model.cfg, mesh)``); a step's tensor takes its stacked
    leaf's spec without the "layers" dims in front, which are never
    sharded. The parameters must be on the mesh's device type and equal on
    every rank. Returns the model, changed in place."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    cfg = model.cfg
    rules = rules if rules is not None else sh.logical_rules(cfg, mesh)
    shapes = abstract_params(cfg)
    specs = {k: sh.resolve_spec(ax, tuple(shapes[k].shape), rules, mesh)
             for k, ax in param_axes(cfg).items()}
    owner = {id(t): (mod, name) for mod in model.modules()
             for name, t in mod.named_parameters(recurse=False)}
    for key, idx, t in _slots(model):
        if isinstance(t, DTensor):
            raise ValueError(f"{key} is sharded already")
        lead, spec = specs[key][:len(idx)], specs[key][len(idx):]
        if any(e is not None for e in lead):
            raise ValueError(f"{key}: a stacking dim is sharded ({specs[key]})")
        mod, name = owner[id(t)]
        d = distribute_tensor(t.detach(), mesh, sh.placements(spec, mesh))
        setattr(mod, name, nn.Parameter(d, requires_grad=t.requires_grad))
    return model


# --------------------------------------------------------------------------
# abstract inputs
# --------------------------------------------------------------------------

def _sds(shape, dtype) -> torch.Tensor:
    """A meta tensor: shape and dtype, nothing allocated."""
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, B: int, S: int) -> Dict:
    b = {"tokens": _sds((B, S), torch.int32), "targets": _sds((B, S), torch.int32)}
    if cfg.cross_attn_every:
        b["media"] = _sds((B, cfg.n_media_tokens, cfg.d_model), cfg.cdtype)
    if cfg.enc_dec:
        b["enc_frames"] = _sds((B, cfg.encoder_seq, cfg.d_model), cfg.cdtype)
    return b


def batch_axes(cfg: ModelConfig) -> Dict:
    b = {"tokens": ("batch", "seq"), "targets": ("batch", "seq")}
    if cfg.cross_attn_every:
        b["media"] = ("batch", None, None)
    if cfg.enc_dec:
        b["enc_frames"] = ("batch", None, None)
    return b


def prefill_batch_specs(cfg: ModelConfig, B: int, S: int) -> Dict:
    b = batch_specs(cfg, B, S)
    del b["targets"]
    return b


def prefill_batch_axes(cfg: ModelConfig) -> Dict:
    b = batch_axes(cfg)
    del b["targets"]
    return b


def cache_specs(cfg: ModelConfig, B: int, seq_len: int):
    return M.init_cache(cfg, B, seq_len, device="meta")


def input_specs(cfg: ModelConfig, shape_name: str) -> Dict:
    """All abstract inputs of one (arch x shape) dry run, keyed as the
    reference's: params and opt_state ({"m", "v", "step"}) in the flat
    leaf-path layout of ``param_tree``, batch, cache, token, pos."""
    info = SHAPES[shape_name]
    B, S = info["global_batch"], info["seq_len"]
    cfg = config_for_shape(cfg, shape_name)
    if info["kind"] == "train":
        params = abstract_params(cfg)
        return {"params": params, "opt_state": adamw_init(params),
                "batch": batch_specs(cfg, B, S)}
    if info["kind"] == "prefill":
        return {"params": abstract_params(cfg), "batch": prefill_batch_specs(cfg, B, S)}
    return {"params": abstract_params(cfg), "cache": cache_specs(cfg, B, S),
            "token": _sds((B,), torch.int32), "pos": _sds((), torch.int32)}


def step_shardings(cfg: ModelConfig, shape_name: str, mesh):
    """``NamedSharding`` trees matching ``input_specs``' structure."""
    cfg = config_for_shape(cfg, shape_name)
    rules = sh.logical_rules(cfg, mesh)
    info = SHAPES[shape_name]
    B, S = info["global_batch"], info["seq_len"]
    p_sh = sh.tree_shardings(mesh, param_axes(cfg), abstract_params(cfg), rules)
    if info["kind"] == "train":
        opt_sh = {"m": p_sh, "v": p_sh, "step": sh.replicated(mesh)}
        b_sh = sh.tree_shardings(mesh, batch_axes(cfg), batch_specs(cfg, B, S), rules)
        return {"params": p_sh, "opt_state": opt_sh, "batch": b_sh}
    if info["kind"] == "prefill":
        b_sh = sh.tree_shardings(mesh, prefill_batch_axes(cfg),
                                 prefill_batch_specs(cfg, B, S), rules)
        return {"params": p_sh, "batch": b_sh}
    c_sh = sh.tree_shardings(mesh, M.cache_axes(cfg), cache_specs(cfg, B, S), rules)
    tok_sh = sh.tree_shardings(mesh, ("batch",), _sds((B,), torch.int32), rules)
    return {"params": p_sh, "cache": c_sh, "token": tok_sh, "pos": sh.replicated(mesh)}
