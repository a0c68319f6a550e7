"""Logical axis -> mesh axis resolution and DTensor placements (port of
``repro.launch.shardings``).

Every parameter, cache and batch leaf carries a tuple of logical axis names
(``models.params.param_axes``, ``models.cache_axes``, ``launch.steps``).
``resolve_spec`` greedily assigns mesh axes to dims left to right, honoring
divisibility and never reusing a mesh axis within one spec, exactly as the
reference does: mixtral's 8 experts fall back to ff sharding on a 16-wide
model axis, and batch-1 long-context decode falls through to context
(cache-sequence) parallelism. ``placements`` turns a spec into the
``Shard``/``Replicate`` placement of each mesh dim that ``DTensor`` takes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import axis_sizes, data_axes, model_axes


class PartitionSpec(tuple):
    """One entry a tensor dim, as ``jax.sharding.PartitionSpec`` holds them:
    None (replicated), one mesh axis name, or a tuple of names."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)


def logical_rules(cfg: ModelConfig, mesh):
    """logical axis name -> ordered tuple of candidate mesh axes."""
    model = model_axes(mesh)
    data = data_axes(mesh)
    msize = 1
    for a in model:
        msize *= axis_sizes(mesh)[a]
    return {
        "vocab": model,
        # FSDP: weight input dims shard over data (gathered at use, their
        # gradients reduce-scattered): ZeRO-3 through the same resolver
        "embed": data if cfg.fsdp else (),
        "heads": model,
        "kv_heads": model if cfg.n_kv_heads % msize == 0 else (),
        "ff": model,
        "experts": model if (cfg.n_experts and cfg.n_experts % msize == 0) else (),
        "inner": model,
        "lru": model,
        "layers": (),
        "batch": data,
        "kv_cache_seq": data,        # context parallelism when batch won't shard
        "seq": (),
    }


def resolve_spec(axes: Tuple[Optional[str], ...], shape: Tuple[int, ...],
                 rules, mesh) -> PartitionSpec:
    sizes = axis_sizes(mesh)
    used: set = set()
    out = []
    for name, dim in zip(axes, shape):
        want = tuple(rules.get(name, ()) if name is not None else ())
        # candidate assignments: the full tuple first, then single axes
        candidates = [want]
        if len(want) > 1:
            candidates += [(a,) for a in want]
        assigned = None
        for cand in candidates:
            if not cand or any(a in used for a in cand):
                continue
            prod = 1
            for a in cand:
                prod *= sizes[a]
            if dim % prod == 0:
                assigned = cand
                used.update(cand)
                break
        if assigned is None:
            out.append(None)
        elif len(assigned) == 1:
            out.append(assigned[0])
        else:
            out.append(assigned)
    return PartitionSpec(*out)


def placements(spec, mesh):
    """The DTensor placement of each mesh dim for ``spec``: ``Shard(d)``
    where tensor dim d's entry names that mesh axis, else ``Replicate()``.
    A dim sharded over several axes (("pod", "data")) is split over them
    major to minor in mesh order, as the reference's spec splits it."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(axis_sizes(mesh))
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's axis order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec, as ``jax.sharding.NamedSharding`` pairs them."""
    mesh: object
    spec: PartitionSpec

    @property
    def placements(self):
        return placements(self.spec, self.mesh)


def _is_leaf(x) -> bool:
    return not isinstance(x, dict)


def tree_shardings(mesh, axes_tree, shape_tree, rules):
    """axes_tree: dicts of logical-axes tuples; shape_tree: matching dicts of
    tensors (meta tensors do). Returns matching dicts of ``NamedSharding``."""
    if _is_leaf(shape_tree):
        return NamedSharding(mesh, resolve_spec(axes_tree, tuple(shape_tree.shape), rules,
                                                mesh))
    return {k: tree_shardings(mesh, axes_tree[k], v, rules) for k, v in shape_tree.items()}


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def distribute(tree, shardings):
    """Dicts of tensors -> the same dicts of DTensors, each placed by its
    ``NamedSharding`` in ``shardings`` (``tree_shardings``' output); the
    counterpart of ``jax.device_put`` with shardings. Every rank must hold
    the same values."""
    from torch.distributed.tensor import distribute_tensor
    if isinstance(tree, dict):
        return {k: distribute(v, shardings[k]) for k, v in tree.items()}
    return distribute_tensor(tree, shardings.mesh, shardings.placements)
