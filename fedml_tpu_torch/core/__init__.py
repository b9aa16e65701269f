"""Framework core of the port: device selection and flat adapter vectors."""

from fedml_tpu_torch.core.device import resolve_device
from fedml_tpu_torch.core.flat import (TreeSpec, stacked_tree_of,
                                       to_numpy_tree, tree_spec,
                                       tree_to_vector_np, vector_to_tree_np)

__all__ = ["TreeSpec", "resolve_device", "stacked_tree_of", "to_numpy_tree",
           "tree_spec", "tree_to_vector_np", "vector_to_tree_np"]
