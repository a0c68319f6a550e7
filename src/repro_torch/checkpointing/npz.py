"""Flattened-tree ``.npz`` files, numpy only.

The same format as ``repro.checkpointing.npz``: one array per leaf, keyed
by the leaf's ``/``-joined path of dict keys, plus an optional JSON
``__meta__`` record stored as uint8 bytes. A file written by either
package loads into the other.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np

_META_KEY = "__meta__"


def flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    """Nested dicts of arrays -> {path: ndarray}."""
    if not isinstance(tree, dict):
        return {prefix: np.asarray(tree)}
    flat: Dict[str, np.ndarray] = {}
    for k in sorted(tree):
        flat.update(flatten(tree[k], f"{prefix}/{k}" if prefix else str(k)))
    return flat


def save_tree(path: str, tree: Any, meta: Optional[Dict] = None) -> str:
    """Save a tree (or an already flat ``{path: array}`` dict) as one .npz
    file, written to a temporary name and renamed into place."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    flat = flatten(tree)
    if _META_KEY in flat:
        raise ValueError(f"{_META_KEY!r} is a reserved key")
    if meta is not None:
        flat[_META_KEY] = np.frombuffer(
            json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)
    return path


def load_tree(path: str) -> Tuple[Dict[str, np.ndarray], Dict]:
    """Load a ``save_tree`` file as ``({path: ndarray}, meta)``.

    Structure and shape checks happen where the flat mapping is consumed
    (e.g. ``repro_torch.models.params.load_jax_params``)."""
    with np.load(path) as data:
        meta: Dict = {}
        if _META_KEY in data.files:
            meta = json.loads(bytes(data[_META_KEY]).decode("utf-8"))
        flat = {k: data[k] for k in data.files if k != _META_KEY}
    return flat, meta
