"""The benchmark's weights: every tensor made on the device from (seed, leaf
path, layer index), so that the harness can fill the port's model and the
plain reference can remake any one layer without holding a second copy.

Leaf paths and shapes follow the port's ``param_tree`` layout (the JAX
package's flat paths, steps stacked on dim 0). The values are drawn so that
every leaf matters: fan-in normal matrices, norm scales around 1 and biases
that are not zero, so that a layer left out or a bias dropped shows in the
logits.
"""
from __future__ import annotations

import hashlib
import importlib
from typing import Dict, Iterator, Mapping, Optional, Tuple

import torch

from edgebench.reference.layers import Spec, norm_leaves

STACK = "stacks/main/blk/"

def arch(config: Mapping):
    """The reference module that the configuration names: its layers and its
    block's leaves (``block_leaves``)."""
    return importlib.import_module(f"edgebench.reference.{config['reference']}")


def block_leaves(config: Mapping) -> Dict[str, Spec]:
    """{leaf name inside a block: (per-layer shape, init)}."""
    return arch(config).block_leaves(config["model"])


def top_leaves(config: Mapping) -> Dict[str, Spec]:
    """{top-level leaf path: (shape, init)}: embedding, final norm, head."""
    m = config["model"]
    leaves = {"tok_embed": ((m["vocab_size"], m["d_model"]), ("normal", 0.02)),
              **norm_leaves(m, "final_norm")}
    if not m["tie_embeddings"]:
        leaves["lm_head"] = ((m["d_model"], m["vocab_size"]), ("fan_in",))
    return leaves


def leaf_seed(seed: int, path: str, layer: Optional[int]) -> int:
    """A 63-bit generator seed from (run seed, leaf path, layer index)."""
    key = f"{int(seed)}|{path}|{'-' if layer is None else int(layer)}".encode()
    return int.from_bytes(hashlib.sha256(key).digest()[:8], "little") & (2 ** 63 - 1)


def make_leaf(seed: int, path: str, layer: Optional[int], spec: Spec,
              device) -> torch.Tensor:
    """One layer's tensor of one leaf, f32, drawn on ``device`` by one call of
    a generator that lives there. ``spec`` is (shape, init), init one of
    ("fan_in",), ("normal", std), ("around", centre, std), ("log_arange", std)."""
    shape, init = spec
    g = torch.Generator(device=device)
    g.manual_seed(leaf_seed(seed, path, layer))
    x = torch.randn(shape, generator=g, dtype=torch.float32, device=device)
    kind = init[0]
    if kind == "fan_in":
        return x.mul_(shape[-2] ** -0.5)
    if kind == "normal":
        return x.mul_(init[1])
    if kind == "around":
        return x.mul_(init[2]).add_(init[1])
    if kind == "log_arange":    # A_n = -(n + 1), jittered: log(1..N) + noise
        a = torch.arange(1, shape[-1] + 1, dtype=torch.float32, device=device).log()
        return x.mul_(init[1]).add_(a)
    raise ValueError(f"unknown init {init!r}")


def layer_weights(config: Mapping, seed: int, layer: int, device) -> Dict[str, torch.Tensor]:
    """Every tensor of block ``layer``, keyed by its name inside the block."""
    return {name: make_leaf(seed, STACK + name, layer, spec, device)
            for name, spec in block_leaves(config).items()}


def top_weight(config: Mapping, seed: int, path: str, device) -> torch.Tensor:
    return make_leaf(seed, path, None, top_leaves(config)[path], device)


def tree_shapes(config: Mapping) -> Dict[str, Tuple[int, ...]]:
    """{leaf path: stacked shape}, the port's ``param_tree`` layout."""
    L = config["model"]["n_layers"]
    out = {p: s for p, (s, _) in top_leaves(config).items()}
    out.update({STACK + n: (L,) + s for n, (s, _) in block_leaves(config).items()})
    return dict(sorted(out.items()))


class LazyTree(Mapping):
    """The whole tree as a mapping that makes each stacked leaf when it is
    read and keeps nothing: ``assign_params`` reads one leaf at a time, so at
    most one stacked leaf lives beside the model."""

    def __init__(self, config: Mapping, seed: int, device):
        self.config, self.seed, self.device = config, seed, device
        self.shapes = tree_shapes(config)

    def __getitem__(self, path: str) -> torch.Tensor:
        top = top_leaves(self.config)
        if path in top:
            return top_weight(self.config, self.seed, path, self.device)
        name = path[len(STACK):]
        spec = block_leaves(self.config)[name]
        out = torch.empty(self.shapes[path], dtype=torch.float32, device=self.device)
        for i in range(out.shape[0]):
            out[i].copy_(make_leaf(self.seed, path, i, spec, self.device))
        return out

    def __iter__(self) -> Iterator[str]:
        return iter(self.shapes)

    def __len__(self) -> int:
        return len(self.shapes)
