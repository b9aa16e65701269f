"""Weights carried across from a flax ``transformer_lm`` param tree.

:func:`from_jax_params` takes the flax tree as a nested dict of numpy
arrays (with or without ``lora_*`` leaves) and returns ``(base_state_dict,
adapters)`` for the port's ``TransformerLM``:

- the module path keeps the flax names (``Block_0/MHA_0/Dense_0`` →
  ``Block_0.MHA_0.Dense_0``);
- ``Dense`` ``kernel [in, out]`` → ``weight [out, in]`` (transposed);
  ``Embed`` ``embedding`` and ``LayerNorm`` ``scale`` → ``weight``;
  ``bias`` stays ``bias``;
- ``lora_*`` leaves are not module params: they come back as the adapter
  tree, nested and named as flax nests them, in f32 — so its flat vector
  (``core.flat.tree_to_vector_np``) equals JAX's ``tree_to_vector_np``.

:func:`to_jax_params` is the inverse.
"""

from __future__ import annotations

import numpy as np
import torch

from fedml_tpu_torch.models.adapter import is_adapter_name, split_frozen

_LEAF_TO_TORCH = {"kernel": "weight", "embedding": "weight",
                  "scale": "weight", "bias": "bias"}


def _walk(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _walk(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def from_jax_params(params):
    """flax param tree → ``(base_state_dict, adapters)`` (torch f32)."""
    base, adapters = split_frozen(params)
    state = {}
    for path, leaf in _walk(base):
        name = path[-1]
        if name not in _LEAF_TO_TORCH:
            raise KeyError(f"unexpected flax leaf {'/'.join(path)}")
        arr = np.asarray(leaf, np.float32)
        if name == "kernel":
            arr = arr.T
        key = ".".join(path[:-1] + (_LEAF_TO_TORCH[name],))
        state[key] = torch.from_numpy(np.array(arr, order="C"))

    def to_torch(tree):
        return {k: to_torch(v) if isinstance(v, dict)
                else torch.from_numpy(np.array(v, np.float32))
                for k, v in tree.items()}

    return state, to_torch(adapters)


def _flax_leaf(module_path, torch_name):
    """The flax leaf name of ``<module>.<weight|bias>``: the module's own
    flax name says which kind of layer it is."""
    kind = module_path[-1].split("_")[0]
    if torch_name == "bias":
        return "bias"
    return {"Dense": "kernel", "Embed": "embedding",
            "LayerNorm": "scale"}[kind]


def to_jax_params(state_dict, adapters=None):
    """Inverse of :func:`from_jax_params`: a port state dict (+ adapter
    tree) → the flax param tree as nested numpy f32 arrays."""
    out = {}
    for key, val in state_dict.items():
        path = tuple(key.split("."))
        leaf = _flax_leaf(path[:-1], path[-1])
        arr = val.detach().to("cpu", torch.float32).numpy()
        if leaf == "kernel":
            arr = arr.T
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(arr)
    for path, leaf in _walk(adapters or {}):
        if not is_adapter_name(path[-1]):
            raise KeyError(f"adapter leaf {'/'.join(path)} lacks the "
                           "lora_ prefix")
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.asarray(
            leaf.detach().cpu() if isinstance(leaf, torch.Tensor) else leaf,
            np.float32)
    return out
