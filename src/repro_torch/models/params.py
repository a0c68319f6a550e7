"""Parameter plan, init and weight exchange for every model family (port
of ``repro.models.params`` and ``plan_model`` in ``repro.models.model``).

The plan maps each leaf path of the JAX package's flattened parameters
(``tok_embed``, ``final_norm/scale``, ``stacks/main/blk/attn/wq``,
``stacks/main/blk/ssm/a_log``, ``stacks/period/s0/rec/w_a``,
``stacks/period/xattn/gate_attn``, ``enc_stacks/enc/blk/attn/wq``,
``enc_norm/scale``, ...) to its shape, initializer and, where it is fixed
whatever ``param_dtype`` is, its dtype; stacked leaves carry the stack's
step on dim 0, and a repeated sub's leaves (step, repeat) on dims 0 and 1.
Dense weights are (in, out).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, torch_dtype
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers import Dense
from repro_torch.models.model import CausalLM, enc_stack_defs, stack_defs
from repro_torch.models.rglru import LRU_C


@dataclasses.dataclass(frozen=True)
class P:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # one logical axis name (or None) a dim
    init: str = "fan_in"  # fan_in | zeros | ones | normal | constant | s4d_real | lru_lam
    scale: Optional[float] = None    # stddev: required by "normal", overrides fan-in
    value: float = 0.0               # the fill of "constant"
    dtype: Optional[str] = None      # overrides cfg.param_dtype

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


def _ssm_block_plan(cfg: ModelConfig) -> Dict[str, P]:
    """Mamba-1 mixer leaves with the reference's inits (``plan_ssm``)."""
    d, di = cfg.d_model, cfg.d_inner
    n, r, k = cfg.ssm_state, cfg.resolved_dt_rank, cfg.ssm_conv
    return {
        **_norm_plan(cfg, "norm"),
        "ssm/in_proj": P((d, 2 * di), ("embed", "inner")),
        "ssm/conv_w": P((k, di), (None, "inner"), "normal", 0.1),
        "ssm/conv_b": P((di,), ("inner",), "zeros"),
        "ssm/x_proj": P((di, r + 2 * n), ("inner", None)),
        "ssm/dt_proj": P((r, di), (None, "inner"), scale=r ** -0.5),
        "ssm/dt_bias": P((di,), ("inner",), "constant", value=-4.6),
        "ssm/a_log": P((di, n), ("inner", None), "s4d_real", dtype="float32"),
        "ssm/d_skip": P((di,), ("inner",), "ones", dtype="float32"),
        "ssm/out_proj": P((di, d), ("inner", "embed")),
    }


def _rec_block_plan(cfg: ModelConfig) -> Dict[str, P]:
    """RG-LRU block leaves with the reference's inits (``plan_rec``)."""
    d, w, k = cfg.d_model, cfg.resolved_lru_width, cfg.ssm_conv
    return {
        **_norm_plan(cfg, "norm1"),
        "rec/w_gate_branch": P((d, w), ("embed", "lru")),
        "rec/w_rec_branch": P((d, w), ("embed", "lru")),
        "rec/conv_w": P((k, w), (None, "lru"), "normal", 0.1),
        "rec/conv_b": P((w,), ("lru",), "zeros"),
        "rec/w_a": P((w, w), ("lru", None), scale=w ** -0.5),
        "rec/b_a": P((w,), (None,), "zeros"),
        "rec/w_x": P((w, w), ("lru", None), scale=w ** -0.5),
        "rec/b_x": P((w,), (None,), "zeros"),
        "rec/lam": P((w,), (None,), "lru_lam", dtype="float32"),
        "rec/w_out": P((w, d), ("lru", "embed")),
        **_norm_plan(cfg, "norm2"),
        **_mlp_plan(cfg),
    }


def _norm_plan(cfg: ModelConfig, name: str) -> Dict[str, P]:
    """A norm's leaves (``plan_norm``): scale, and a bias for a layernorm."""
    plan = {f"{name}/scale": P((cfg.d_model,), (None,), "ones")}
    if cfg.norm == "layernorm":
        plan[f"{name}/bias"] = P((cfg.d_model,), (None,), "zeros")
    return plan


def _mlp_plan(cfg: ModelConfig, bias: bool = False, prefix: str = "mlp",
              d_ff: Optional[int] = None) -> Dict[str, P]:
    """The MLP's leaves (``plan_mlp``) under ``prefix``: w_gate and w_up for
    SwiGLU and GeGLU, w_up alone for the plain gelu MLP; b_up and b_down
    with ``bias``; hidden width ``d_ff`` (default ``cfg.d_ff``)."""
    d, f = cfg.d_model, d_ff if d_ff is not None else cfg.d_ff
    plan = {f"{prefix}/w_up": P((d, f), ("embed", "ff")),
            f"{prefix}/w_down": P((f, d), ("ff", "embed"))}
    if cfg.mlp_act in ("swiglu", "geglu"):
        plan[f"{prefix}/w_gate"] = P((d, f), ("embed", "ff"))
    if bias:
        plan.update({f"{prefix}/b_up": P((f,), ("ff",), "zeros"),
                     f"{prefix}/b_down": P((d,), (None,), "zeros")})
    return plan


def _moe_plan(cfg: ModelConfig) -> Dict[str, P]:
    """The MoE's leaves (``plan_moe``): the router, the experts' stacked
    SwiGLU weights and, with ``n_shared_experts``, the shared experts' MLP
    of ``moe_d_ff * n_shared_experts``."""
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    plan = {"moe/router": P((d, E), ("embed", "experts"), scale=d ** -0.5),
            "moe/w_gate": P((E, d, f), ("experts", "embed", "ff")),
            "moe/w_up": P((E, d, f), ("experts", "embed", "ff")),
            "moe/w_down": P((E, f, d), ("experts", "ff", "embed"))}
    if cfg.n_shared_experts:
        plan.update(_mlp_plan(cfg, prefix="moe/shared", d_ff=f * cfg.n_shared_experts))
    return plan


def _mla_plan(cfg: ModelConfig) -> Dict[str, P]:
    """MLA's attention leaves (``plan_self_attn`` under ``use_mla``): q's
    projection, the latent's down projection and norm, its up projections
    to k's nope part and to v, and the output projection."""
    d, H = cfg.d_model, cfg.n_heads
    nope, rope = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    vd, R = cfg.v_head_dim, cfg.kv_lora_rank
    return {"attn/wq": P((d, H * (nope + rope)), ("embed", "heads")),
            "attn/w_dkv": P((d, R + rope), ("embed", None)),
            "attn/kv_norm": P((R,), (None,), "ones"),
            "attn/w_uk": P((R, H * nope), (None, "heads")),
            "attn/w_uv": P((R, H * vd), (None, "heads")),
            "attn/wo": P((H * vd, d), ("heads", "embed"))}


def _self_attn_plan(cfg: ModelConfig) -> Dict[str, P]:
    """GQA self-attention's leaves (``plan_self_attn``): the projections, QKV
    biases under ``qkv_bias``, the o bias under ``attn_bias``, qwen3's q/k
    norms under ``qk_norm``."""
    d, Dh = cfg.d_model, cfg.resolved_head_dim
    H, HK = cfg.n_heads, cfg.n_kv_heads
    plan = {"attn/wq": P((d, H * Dh), ("embed", "heads")),
            "attn/wk": P((d, HK * Dh), ("embed", "kv_heads")),
            "attn/wv": P((d, HK * Dh), ("embed", "kv_heads")),
            "attn/wo": P((H * Dh, d), ("heads", "embed"))}
    if cfg.qkv_bias:
        plan.update({"attn/bq": P((H * Dh,), ("heads",), "zeros"),
                     "attn/bk": P((HK * Dh,), ("kv_heads",), "zeros"),
                     "attn/bv": P((HK * Dh,), ("kv_heads",), "zeros")})
    if cfg.attn_bias:
        plan["attn/bo"] = P((d,), (None,), "zeros")
    if cfg.qk_norm:
        plan.update({"attn/q_norm": P((Dh,), (None,), "ones"),
                     "attn/k_norm": P((Dh,), (None,), "ones")})
    return plan


def _cross_attn_plan(cfg: ModelConfig) -> Dict[str, P]:
    """Cross-attention's leaves (``plan_cross_attn``) under ``xattn/``: the
    four projections, and under ``attn_bias`` the q, v and o biases (k has
    none)."""
    d, Dh = cfg.d_model, cfg.resolved_head_dim
    H, HK = cfg.n_heads, cfg.n_kv_heads
    plan = {"xattn/wq": P((d, H * Dh), ("embed", "heads")),
            "xattn/wk": P((d, HK * Dh), ("embed", "kv_heads")),
            "xattn/wv": P((d, HK * Dh), ("embed", "kv_heads")),
            "xattn/wo": P((H * Dh, d), ("heads", "embed"))}
    if cfg.attn_bias:
        plan.update({"xattn/bq": P((H * Dh,), ("heads",), "zeros"),
                     "xattn/bv": P((HK * Dh,), ("kv_heads",), "zeros"),
                     "xattn/bo": P((d,), (None,), "zeros")})
    return plan


def _block_plan(cfg: ModelConfig, kind: str, moe: bool = False) -> Dict[str, P]:
    """One block's leaves; ``moe`` puts the MoE's in place of the MLP's."""
    if kind == "ssm":
        return _ssm_block_plan(cfg)
    if kind == "rec":
        return _rec_block_plan(cfg)
    if kind == "xattn":
        # the gates start at zero, f32 whatever param_dtype is; the MLP has
        # no biases whatever attn_bias says
        gate = P((1,), (None,), "zeros", dtype="float32")
        return {**_norm_plan(cfg, "norm1"), **_cross_attn_plan(cfg), "gate_attn": gate,
                **_norm_plan(cfg, "norm2"), **_mlp_plan(cfg), "gate_mlp": gate}
    plan = {
        **_norm_plan(cfg, "norm1"),
        **(_mla_plan(cfg) if cfg.use_mla else _self_attn_plan(cfg)),
        **_norm_plan(cfg, "norm2"),
        # the reference's MLP biases ride along with the attention's
        **(_moe_plan(cfg) if moe else _mlp_plan(cfg, bias=cfg.attn_bias)),
    }
    if kind == "dec":
        plan.update({**_cross_attn_plan(cfg), **_norm_plan(cfg, "norm3")})
    elif kind not in ("attn", "enc"):
        raise ValueError(f"unknown block kind {kind!r}")
    return plan


def _stack_plans(cfg: ModelConfig, defs, prefix: str) -> Dict[str, P]:
    """The leaves of the stacks ``defs`` under ``<prefix>/<stack>/<sub>/``,
    each with the stack's steps, and a repeated sub's repeat, in front, on
    "layers" axes."""
    plan = {}
    for s in defs:
        for sub in s.subs:
            lead = (s.length,) if sub.repeat == 1 else (s.length, sub.repeat)
            for path, p in _block_plan(cfg, sub.kind, sub.moe).items():
                plan[f"{prefix}/{s.name}/{sub.name}/{path}"] = dataclasses.replace(
                    p, shape=lead + p.shape, axes=("layers",) * len(lead) + p.axes)
    return plan


def plan_model(cfg: ModelConfig) -> Dict[str, P]:
    """{leaf path: P}, in the JAX package's (sorted) flattening order."""
    plan = {"tok_embed": P((cfg.vocab_size, cfg.d_model), ("vocab", "embed"), "normal", 0.01),
            **_norm_plan(cfg, "final_norm"), **_stack_plans(cfg, stack_defs(cfg), "stacks")}
    if not cfg.tie_embeddings:
        plan["lm_head"] = P((cfg.d_model, cfg.vocab_size), ("embed", "vocab"))
    if cfg.enc_dec:
        plan.update({**_norm_plan(cfg, "enc_norm"),
                     **_stack_plans(cfg, enc_stack_defs(cfg), "enc_stacks")})
    return dict(sorted(plan.items()))


def param_axes(cfg: ModelConfig) -> Dict[str, Tuple[Optional[str], ...]]:
    """{leaf path: logical axes}: the reference's ``param_axes`` flattened
    to its leaf paths."""
    return {path: p.axes for path, p in plan_model(cfg).items()}


def abstract_params(cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """{leaf path: tensor on the meta device}: each leaf's shape and dtype,
    nothing allocated (the reference's ``abstract_params``)."""
    return {path: torch.empty(p.shape, dtype=_leaf_dtype(cfg, p), device="meta")
            for path, p in plan_model(cfg).items()}


def n_params(cfg: ModelConfig) -> int:
    """The number of parameters of ``cfg``'s plan."""
    return sum(int(np.prod(p.shape)) for p in plan_model(cfg).values())


def _leaf_dtype(cfg: ModelConfig, p: P) -> torch.dtype:
    return torch_dtype(p.dtype) if p.dtype else cfg.pdtype


def _init_leaf(p: P, generator: torch.Generator, dtype, device):
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dtype, device=device)
    if p.init == "constant":
        return torch.full(p.shape, p.value, dtype=dtype, device=device)
    if p.init == "s4d_real":
        # A_n = -(n + 1): log(1..N) along the last (state) dim
        a = torch.arange(1, p.shape[-1] + 1, dtype=torch.float32, device=device)
        return torch.log(a).expand(p.shape).to(dtype).contiguous()
    if p.init == "lru_lam":
        # a ~ U[0.9, 0.999]: Lambda = softplus^-1(-log a / c)
        u = torch.rand(p.shape, generator=generator, dtype=torch.float32,
                       device=device) * (0.999 - 0.9) + 0.9
        t = torch.clamp_min(-torch.log(u) / LRU_C, 1e-8)
        return torch.log(torch.expm1(t)).to(dtype)
    if p.init == "normal":
        std = p.scale
    elif p.init == "fan_in":
        # fan-in = second-to-last dim (the stacking dim is not counted)
        fan_in = p.shape[-2] if len(p.shape) >= 2 else max(p.shape[-1], 1)
        std = p.scale if p.scale is not None else fan_in ** -0.5
    else:
        raise ValueError(f"unknown init {p.init!r}")
    x = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return x.mul_(std).to(dtype)


def materialize(plan: Mapping[str, P], generator: torch.Generator,
                dtype: torch.dtype = torch.float32,
                device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """{leaf path: P} -> {leaf path: tensor}, drawn from ``generator`` (on
    ``device``) leaf by leaf in sorted path order; ``P.dtype`` overrides
    ``dtype``."""
    dev = resolve_device(device)
    return {path: _init_leaf(p, generator, torch_dtype(p.dtype) if p.dtype else dtype, dev)
            for path, p in sorted(plan.items())}


def init(cfg: ModelConfig, generator: torch.Generator,
         device: DeviceLike = None) -> CausalLM:
    """A model with the reference's init distributions (fan-in normal for
    matrices, std 0.01 normal for ``tok_embed``, ones for norm scales and
    qwen3's q/k norms, zeros for biases; the ssm and rec leaves as
    ``_ssm_block_plan`` and ``_rec_block_plan`` say), drawn
    from ``generator`` leaf by leaf in plan order.
    ``generator`` must live on ``device``. torch draws other numbers than
    JAX's threefry: weights cross between the packages through .npz files."""
    dev = resolve_device(device)
    flat = {path: _init_leaf(p, generator, _leaf_dtype(cfg, p), dev)
            for path, p in plan_model(cfg).items()}
    return CausalLM(cfg, flat)


def load_jax_params(cfg: ModelConfig, flat: Mapping[str, np.ndarray],
                    device: DeviceLike = None) -> CausalLM:
    """Build the port's model from the JAX package's flattened parameters
    (e.g. a ``repro.checkpointing.save_tree`` file read back with
    ``repro_torch.checkpointing.load_tree``). Keys and shapes are checked
    against the plan."""
    dev = resolve_device(device)
    plan = plan_model(cfg)
    missing, extra = set(plan) - set(flat), set(flat) - set(plan)
    if missing or extra:
        raise ValueError(f"parameter mismatch: missing={sorted(missing)[:5]} "
                         f"extra={sorted(extra)[:5]}")
    tensors = {}
    for path, p in plan.items():
        arr = np.asarray(flat[path])
        if arr.shape != p.shape:
            raise ValueError(f"{path}: shape {arr.shape} != {p.shape}")
        tensors[path] = torch.tensor(arr, dtype=_leaf_dtype(cfg, p), device=dev)
    return CausalLM(cfg, tensors)


def _slots(model: CausalLM):
    """Every float parameter of ``model`` as (leaf path, index, tensor): the
    JAX package's flat path, and the tensor's place in that leaf's stacked
    array: () at the top level, (step,) in a stack, (step, repeat) in a
    repeated sub. Slots of one leaf come in index order."""
    cfg = model.cfg
    yield "tok_embed", (), model.tok_embed
    for n, t in model.final_norm.named_parameters():
        yield f"final_norm/{n}", (), t
    if model.lm_head is not None:
        yield "lm_head", (), _leaf(model, "lm_head")
    stacks = [("stacks", model.stacks, stack_defs(cfg))]
    if model.enc_stacks is not None:
        for n, t in model.enc_norm.named_parameters():
            yield f"enc_norm/{n}", (), t
        stacks.append(("enc_stacks", model.enc_stacks, enc_stack_defs(cfg)))
    for prefix, modules, defs in stacks:
        for s in defs:
            for sub in s.subs:
                for path in _block_plan(cfg, sub.kind, sub.moe):
                    key = f"{prefix}/{s.name}/{sub.name}/{path}"
                    for i, step in enumerate(modules[s.name]):
                        blocks = getattr(step, sub.name)
                        if sub.repeat == 1:
                            yield key, (i,), _leaf(blocks, path)
                        else:
                            for r, b in enumerate(blocks):
                                yield key, (i, r), _leaf(b, path)


def _gather(model: CausalLM, get) -> Dict[str, torch.Tensor]:
    """{leaf path: the leaf's tensors ``get(t)``, stacked to its plan shape},
    in sorted path order."""
    per_key: Dict[str, list] = {}
    lead: Dict[str, Tuple[int, ...]] = {}
    for key, idx, t in _slots(model):
        per_key.setdefault(key, []).append(get(t))
        lead[key] = tuple(i + 1 for i in idx)
    return {k: (ts[0] if not lead[k] else torch.stack(ts).reshape(*lead[k], *ts[0].shape))
            for k, ts in sorted(per_key.items())}


def param_tree(model: CausalLM) -> Dict[str, torch.Tensor]:
    """The model's float parameters as the JAX package's flat {leaf path:
    tensor} on the model's device (detached copies), steps stacked on dim 0
    (and a repeated sub's blocks on dim 1): the layout of a checkpoint and
    of the optimizer's state."""
    return _gather(model, lambda t: t.detach())


def export_params(model: CausalLM) -> Dict[str, np.ndarray]:
    """The reverse of ``load_jax_params``: the model's float parameters as
    the JAX package's flat {leaf path: ndarray}, steps stacked on dim 0 (and
    a repeated sub's blocks on dim 1)."""
    return {k: v.cpu().numpy() for k, v in param_tree(model).items()}


def export_grads(model: CausalLM) -> Dict[str, torch.Tensor]:
    """The gradients of the model's float parameters under the JAX
    package's flat leaf paths, stacked as ``param_tree`` stacks the
    parameters (zeros for a parameter without a gradient), on the model's
    device: what ``jax.grad`` of the reference's loss gives, leaf by leaf."""
    return _gather(model, lambda t: t.grad if t.grad is not None else torch.zeros_like(t))


def assign_params(model: CausalLM, flat: Mapping[str, torch.Tensor]) -> CausalLM:
    """Write ``flat`` ({leaf path: stacked tensor or array}, as
    ``param_tree`` gives it) into the model's parameters in place; keys and
    shapes are checked against them. Returns the model."""
    want = {}
    for key, idx, t in _slots(model):
        want.setdefault(key, []).append((idx, t))
    missing, extra = set(want) - set(flat), set(flat) - set(want)
    if missing or extra:
        raise ValueError(f"parameter mismatch: missing={sorted(missing)[:5]} "
                         f"extra={sorted(extra)[:5]}")
    with torch.no_grad():
        for key, slots in want.items():
            src = torch.as_tensor(flat[key])
            shape = tuple(i + 1 for i in slots[-1][0]) + tuple(slots[0][1].shape)
            if tuple(src.shape) != shape:
                raise ValueError(f"{key}: shape {tuple(src.shape)} != {shape}")
            src = src.to(device=slots[0][1].device)
            for idx, t in slots:
                t.copy_(src[idx])
    return model


def set_trainable(model: CausalLM, trainable: bool = True) -> CausalLM:
    """Make the model's float parameters require gradients (or not). A
    quantized version's codes are buffers and stay out of it. Returns the
    model."""
    for t in model.parameters():
        if t.is_floating_point():
            t.requires_grad_(trainable)
    return model


def _leaf(block: torch.nn.Module, path: str) -> torch.Tensor:
    """The float tensor of ``block`` at the plan's leaf path (``attn/wq``,
    ``gate_attn``, ...)."""
    mod_path, _, leaf = path.rpartition("/")
    t = getattr(block.get_submodule(mod_path.replace("/", ".")) if mod_path else block, leaf)
    if isinstance(t, Dense):
        t = t.w
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{path} is quantized; export the float model")
    return t
