"""Fault-tolerant checkpointing of the port: atomic, async, keep-K, in the
JAX package's on-disk layout."""
from repro_torch.checkpoint.store import (CheckpointManager, CheckpointMeta,
                                          load_pytree, named_to_tree,
                                          save_pytree, state_from_tree,
                                          state_to_tree, tree_to_named)

__all__ = ["CheckpointManager", "CheckpointMeta", "load_pytree",
           "named_to_tree", "save_pytree", "state_from_tree",
           "state_to_tree", "tree_to_named"]
