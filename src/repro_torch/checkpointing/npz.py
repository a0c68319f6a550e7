"""Flattened-tree ``.npz`` files, numpy only.

The same format as ``repro.checkpointing.npz``: one array per leaf, keyed
by the leaf's ``/``-joined path of dict keys, plus an optional JSON
``__meta__`` record stored as uint8 bytes. A file written by either
package loads into the other, and so does a step checkpoint
(``<name>_<step:08d>.npz`` in a directory).
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, Mapping, Optional, Tuple

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


def _as_numpy(tree: Any) -> Any:
    """Tensors (on any device) as numpy arrays, through nested dicts."""
    if isinstance(tree, dict):
        return {k: _as_numpy(v) for k, v in tree.items()}
    if hasattr(tree, "detach"):
        return tree.detach().cpu().numpy()
    return tree


def _step_path(ckpt_dir: str, step: int, name: str) -> str:
    return os.path.join(ckpt_dir, f"{name}_{step:08d}.npz")


def save_checkpoint(ckpt_dir: str, step: int, tree: Any, name: str = "state") -> str:
    """Save ``tree`` (nested dicts or a flat {path: array or tensor}) as
    ``<ckpt_dir>/<name>_<step:08d>.npz``, written to a temporary name and
    renamed into place. Returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = _step_path(ckpt_dir, step, name)
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flatten(_as_numpy(tree)))
    os.replace(tmp, path)
    return path


def latest_step(ckpt_dir: str, name: str = "state") -> Optional[int]:
    """The largest step with a checkpoint in ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := re.match(rf"{name}_(\d+)\.npz$", f))]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: int, like: Mapping[str, Any],
                       name: str = "state") -> Dict[str, np.ndarray]:
    """The checkpoint of ``step`` as a flat {path: ndarray}, checked against
    ``like`` (a flat {path: array or tensor}, e.g. ``models.param_tree``):
    the same keys, each of its shape, cast to its dtype."""
    like = flatten(_as_numpy(dict(like)))
    with np.load(_step_path(ckpt_dir, step, name)) as data:
        files = set(data.files) - {_META_KEY}
        missing, extra = set(like) - files, files - set(like)
        if missing or extra:
            raise ValueError(f"checkpoint mismatch: missing={sorted(missing)[:5]} "
                             f"extra={sorted(extra)[:5]}")
        out = {}
        for key, ref in like.items():
            arr = data[key]
            if arr.shape != ref.shape:
                raise ValueError(f"{key}: shape {arr.shape} != {ref.shape}")
            out[key] = arr.astype(ref.dtype)
    return out
