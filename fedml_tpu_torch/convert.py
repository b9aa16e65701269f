"""Weights carried across from a flax param tree: ``transformer_lm``, the
CIFAR ResNets (``CifarResNet``) and ``ResNetGN``, the split ResNets
(``resnet_split``), ``LogisticRegression``, the vertical-FL parties
(``models/vfl.py``), the DARTS search and genotype networks, ``UNet``,
``MNISTGan``, the FedAvg CNNs, the LSTMs (``models/rnn.py``), ``ViT``
(its ``patch_embed`` conv and ``head`` dense named as flax names them)
and the cross-silo CV zoo: ``MobileNetV1`` (``DepthwiseSeparable_12``),
``VGG`` (with BatchNorm's ``batch_stats``), ``MobileNetV3``
(``MobileBlock_3/SqueezeExcite_0/Dense_1``) and ``EfficientNet``
(``MBConv_15/Conv_2``).

:func:`from_jax_params` takes the flax tree as a nested dict of numpy
arrays (with or without ``lora_*`` leaves) and returns ``(base_state_dict,
adapters)`` for the port's model:

- the module path keeps the flax names (``Block_0/MHA_0/Dense_0`` →
  ``Block_0.MHA_0.Dense_0``, ``BottleneckBlock_3/Norm_2/GroupNorm_0`` →
  ``BottleneckBlock_3.Norm_2.GroupNorm_0``, ``…/downsample``);
- ``Dense`` ``kernel [in, out]`` → ``weight [out, in]`` (transposed);
  ``Conv`` ``kernel`` HWIO → ``weight`` OIHW (a depthwise ``[k, k, 1,
  c]`` → ``[c, 1, k, k]``);
  ``Embed`` ``embedding``, ``LayerNorm``, ``GroupNorm`` and
  ``BatchNorm`` ``scale`` → ``weight``; ``bias`` stays ``bias``; an LSTM
  cell's gate kernels (``ii`` … ``ho``) transpose as ``Dense`` ones; a leaf
  at the root (DARTS's ``alphas_normal``/``alphas_reduce``) keeps its name
  and layout;
- flax's ``batch_stats`` collection (BatchNorm's ``mean``/``var``) goes
  through the same function: ``from_jax_params(variables["batch_stats"])``
  gives the buffers of ``NetState.model_state`` under their dotted names
  (``Norm_0.BatchNorm_0.mean``), and ``to_jax_params(model_state)`` gives
  the collection back;
- ``lora_*`` leaves are not module params: they come back as the adapter
  tree, nested and named as flax nests them, in f32 — so its flat vector
  (``core.flat.tree_to_vector_np``) equals JAX's ``tree_to_vector_np``.

:func:`to_jax_params` is the inverse. :func:`stacked_from_jax_params` and
:func:`stacked_to_jax_params` carry a client-stacked tree (``[C, ...]``
leaves, as ``FedGKTAPI.client_nets`` and ``SplitNNAPI.client_nets`` hold
them), and :func:`vfl_party_from_jax` / :func:`vfl_party_to_jax` a
``VflParty``'s ``{"local": ..., "dense": ...}`` params.
"""

from __future__ import annotations

import numpy as np
import torch

from fedml_tpu_torch.models.adapter import is_adapter_name, split_frozen

_LEAF_TO_TORCH = {"kernel": "weight", "embedding": "weight",
                  "scale": "weight", "bias": "bias", "mean": "mean",
                  "var": "var"}
#: flax ``OptimizedLSTMCell``'s gate modules: ``Dense`` kernels by name.
_LSTM_GATES = {f"{a}{g}" for a in "ih" for g in "ifgo"}


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
        if len(path) == 1:  # a parameter of the root module itself
            state[name] = torch.from_numpy(np.array(leaf, np.float32))
            continue
        if name not in _LEAF_TO_TORCH:
            raise KeyError(f"unexpected flax leaf {'/'.join(path)}")
        arr = np.asarray(leaf, np.float32)
        if name == "kernel":
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
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
    if torch_name in ("bias", "mean", "var"):
        return torch_name
    if module_path[-1] in _LSTM_GATES:
        return "kernel"
    return {"Dense": "kernel", "Conv": "kernel", "downsample": "kernel",
            "linear": "kernel", "patch": "kernel", "head": "kernel",
            "Embed": "embedding", "LayerNorm": "scale",
            "GroupNorm": "scale", "BatchNorm": "scale"}[kind]


def to_jax_params(state_dict, adapters=None):
    """Inverse of :func:`from_jax_params`: a port state dict (+ adapter
    tree) → the flax param tree as nested numpy f32 arrays."""
    out = {}
    for key, val in state_dict.items():
        path = tuple(key.split("."))
        arr = val.detach().to("cpu", torch.float32).numpy()
        if len(path) == 1:  # a parameter of the root module itself
            out[key] = np.ascontiguousarray(arr)
            continue
        leaf = _flax_leaf(path[:-1], path[-1])
        if leaf == "kernel":
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
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


def stacked_from_jax_params(params):
    """A client-stacked flax tree (``[C, ...]`` leaves) → ``{name: [C,
    ...]}``, each client's row through :func:`from_jax_params`."""
    leaves = [leaf for _, leaf in _walk(params)]
    n = np.asarray(leaves[0]).shape[0]

    def row(tree, i):
        return {k: row(v, i) if isinstance(v, dict) else np.asarray(v)[i]
                for k, v in tree.items()}

    rows = [from_jax_params(row(params, i))[0] for i in range(n)]
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


def stacked_to_jax_params(stacked):
    """Inverse of :func:`stacked_from_jax_params`: ``{name: [C, ...]}`` →
    the stacked flax tree as nested numpy f32 arrays."""
    n = next(iter(stacked.values())).shape[0]
    rows = [to_jax_params({k: v[i] for k, v in stacked.items()})
            for i in range(n)]

    def stack(trees):
        first = trees[0]
        if isinstance(first, dict):
            return {k: stack([t[k] for t in trees]) for k in first}
        return np.stack(trees)

    return stack(rows)


def vfl_party_from_jax(params):
    """A JAX ``VflParty.params`` (``{"local": {"Dense_0"}, "dense":
    {"Dense_0"}}``) → the port's ``{"local": {...}, "dense": {...}}``."""
    return {part: from_jax_params(params[part])[0]
            for part in ("local", "dense")}


def vfl_party_to_jax(params):
    """Inverse of :func:`vfl_party_from_jax`."""
    return {part: to_jax_params(params[part]) for part in ("local", "dense")}
