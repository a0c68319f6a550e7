"""Checkpointing: flattened-tree .npz files shared with the JAX package."""
from repro_torch.checkpointing.npz import flatten, load_tree, save_tree

__all__ = ["flatten", "load_tree", "save_tree"]
