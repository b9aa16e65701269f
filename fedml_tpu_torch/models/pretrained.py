"""Model weights to and from a file (port of
``fedml_tpu/models/pretrained.py``).

``save_params`` / ``load_params`` write and read a flat path-keyed
``.npz`` of a ``NetState`` (params and model state), with no pickle. The
keys and shapes are the JAX package's: the flax path of each leaf behind
``params::`` or ``state::`` (``state::batch_stats::…`` for BatchNorm's
running stats), in flax's layouts, through ``convert.to_jax_params`` /
``from_jax_params``, so a file written by either package loads in the
other. Whole-run state (optimizer, keys, client stacks) is
``obs/checkpoint.py``'s; this module is for the model alone.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from fedml_tpu_torch import convert  # a module: convert imports models
from fedml_tpu_torch.trainer.local import NetState

_SEP = "::"


def _jax_params(params):
    """The flax tree of a port params dict: dotted module leaves, and a
    nested adapter tree (FedAdapter's net) as ``lora_*`` leaves."""
    flat = {k: v for k, v in params.items() if not isinstance(v, dict)}
    nested = {k: v for k, v in params.items() if isinstance(v, dict)}
    return convert.to_jax_params(flat, nested)


def _jax_state(model_state):
    return ({"batch_stats": convert.to_jax_params(model_state)}
            if model_state else {})


def _flatten(tree, prefix: str, out: Dict[str, np.ndarray]) -> None:
    for key, val in tree.items():
        path = prefix + _SEP + str(key)
        if isinstance(val, dict):
            _flatten(val, path, out)
        else:
            out[path] = np.asarray(val)


def _flat_of(net: NetState) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    _flatten(_jax_params(net.params), "params", out)
    _flatten(_jax_state(net.model_state), "state", out)
    return out


def save_params(net: NetState, path: str) -> None:
    """Writes ``net`` as JAX's ``save_params`` would (``np.savez``)."""
    np.savez(path, **_flat_of(net))


def _unflatten(flat: Dict[str, np.ndarray], prefix: str):
    out: Dict = {}
    for key, arr in flat.items():
        parts = key.split(_SEP)
        if parts[0] != prefix:
            continue
        node = out
        for part in parts[1:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = arr
    return out


def _like(template, loaded):
    """``loaded`` (torch f32 leaves) in ``template``'s structure, dtypes
    and devices."""
    if isinstance(template, dict):
        return {k: _like(v, loaded[k]) for k, v in template.items()}
    return loaded.to(template.device, template.dtype)


def load_params(net: NetState, path: str) -> NetState:
    """Weights saved by :func:`save_params` (of either package) into
    ``net``'s structure. Keys and shapes must match IN BOTH DIRECTIONS: a
    missing key, a shape mismatch or an entry the model does not use (a
    wrong architecture whose common layers happen to match) raises with
    the offending key."""
    want = _flat_of(net)
    file = path if path.endswith(".npz") else path + ".npz"
    with np.load(file, allow_pickle=False) as data:
        got = {}
        for key, leaf in want.items():
            if key not in data.files:
                raise KeyError(f"checkpoint {path!r} is missing {key!r} "
                               f"(available: {sorted(data.files)[:5]}...)")
            arr = data[key]
            if arr.shape != leaf.shape:
                raise ValueError(f"{key!r}: checkpoint shape {arr.shape} != "
                                 f"model shape {leaf.shape}")
            got[key] = arr.astype(np.float32)
        leftover = set(data.files) - set(want)
        if leftover:
            raise ValueError(
                f"checkpoint {path!r} has {len(leftover)} entries the model "
                f"does not use (first: {sorted(leftover)[:3]}) — wrong "
                "architecture?")
    state_dict, adapters = convert.from_jax_params(
        _unflatten(got, "params"))
    params = {**state_dict, **adapters}
    stats = _unflatten(got, "state").get("batch_stats", {})
    model_state = (convert.from_jax_params(stats)[0] if stats
                   else {})
    return NetState(_like(net.params, params),
                    _like(net.model_state, model_state))
