"""Frozen base + per-client LoRA adapters (port of
``fedml_tpu/models/adapter.py``).

- :func:`split_frozen` / :func:`merge_params` partition a nested param tree
  into ``(base, adapters)`` by the ``lora_`` leaf-name convention and
  reassemble it losslessly.
- :func:`adapter_model_fns` is the apply surface over the ADAPTER tree:
  the frozen base is the ``nn.Module`` (``holder["base"]``), adapters are
  a plain nested dict passed per call.
- :class:`PersonalAdapterStore` keeps per-client adapters as ONE
  ``[n_clients, D]`` float32 host array (optionally a memmap on disk),
  rows in JAX's flat order, with copy-on-read locking for a serving plane
  that gathers while training scatters.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from fedml_tpu_torch.core.flat import (tree_spec, tree_to_vector_np,
                                       vector_to_tree_np)

#: Leaf-name prefix marking adapter params.
ADAPTER_PREFIX = "lora_"


def is_adapter_name(name) -> bool:
    return isinstance(name, str) and name.startswith(ADAPTER_PREFIX)


def split_frozen(params):
    """``(base, adapters)`` by leaf name; both keep their nesting and empty
    sub-dicts are dropped, so :func:`merge_params` rebuilds the tree."""
    base, adapters = {}, {}
    for k, v in params.items():
        if isinstance(v, dict):
            b, a = split_frozen(v)
            if b:
                base[k] = b
            if a:
                adapters[k] = a
        elif is_adapter_name(k):
            adapters[k] = v
        else:
            base[k] = v
    return base, adapters


def merge_params(base, adapters):
    """Inverse of :func:`split_frozen`; a key that is a leaf in both halves
    is a structure corruption and raises."""
    out = dict(base)
    for k, v in adapters.items():
        cur = out.get(k)
        if isinstance(v, dict) and isinstance(cur, dict):
            out[k] = merge_params(cur, v)
        elif k in out:
            raise ValueError(
                f"adapter/base trees collide at key {k!r}: the adapter "
                "tree was not split from this base")
        else:
            out[k] = v
    return out


class AdapterFns(NamedTuple):
    """The apply surface over the adapter tree: ``init(generator)`` →
    fresh adapters (A ~ N(0, 0.02), B = 0), ``apply(adapters, tokens)`` →
    f32 logits, ``holder["base"]`` the frozen ``nn.Module``."""

    init: Callable
    apply: Callable
    holder: dict


def adapter_model_fns(model, base_params=None) -> AdapterFns:
    """Adapter-level functions over ``model`` (built with
    ``adapter_rank > 0``). ``base_params`` — a state dict, e.g. from
    ``convert.from_jax_params`` — replaces the model's base weights
    (strict: the keys must match). Raises for a model without adapters."""
    if not getattr(model, "adapter_rank", 0):
        raise ValueError(
            "adapter finetuning needs a model with injected adapter params "
            f"(no '{ADAPTER_PREFIX}*' leaves) — build it with "
            "adapter_rank > 0")
    if base_params is not None:
        model.load_state_dict(base_params, strict=True)
    holder = {"base": model}

    def init(generator: Optional[torch.Generator] = None):
        return model.init_adapters(generator)

    def apply(adapters, tokens):
        with torch.inference_mode():
            return holder["base"](tokens, adapters)

    return AdapterFns(init=init, apply=apply, holder=holder)


class PersonalAdapterStore:
    """Per-client adapters as one ``[n_clients, D]`` float32 host array
    (a memmap under ``spill_dir`` when given), keyed by global client id.
    Never-personalized clients read as the caller's default (the live
    global adapters).

    All row access is copy-on-read under ``self._lock``: a gathered row is
    always one complete scatter's bytes and the returned array is private
    to the caller; the lock bounds only the memcpy."""

    def __init__(self, n_clients: int, template_params, *,
                 spill_dir: Optional[str] = None):
        self.n_clients = int(n_clients)
        self.spec = tree_spec(template_params)
        self.dim = int(sum(self.spec.sizes))
        self.memmapped = spill_dir is not None
        if self.memmapped:
            path = os.path.join(spill_dir, "personal_adapters.npy")
            self._data = np.lib.format.open_memmap(
                path, mode="w+", dtype=np.float32,
                shape=(self.n_clients, self.dim))
        else:
            self._data = np.zeros((self.n_clients, self.dim), np.float32)
        self.seen = np.zeros(self.n_clients, bool)
        self._lock = threading.Lock()

    def vec_of(self, params) -> np.ndarray:
        return tree_to_vector_np(params)

    def tree_of(self, vec: np.ndarray):
        return vector_to_tree_np(np.asarray(vec, np.float32), self.spec)

    def gather(self, idx, default_params) -> np.ndarray:
        """``[k, D]`` rows for the cohort; rows never scattered read as
        ``default_params``. A private copy taken under the lock."""
        idx = np.asarray(idx, np.int64)
        with self._lock:
            out = self._data[idx].astype(np.float32, copy=True)
            missing = ~self.seen[idx]
        if missing.any():
            out[missing] = self.vec_of(default_params)[None]
        return out

    def scatter(self, idx, vecs) -> None:
        idx = np.asarray(idx, np.int64)
        vecs = np.asarray(vecs, np.float32)
        with self._lock:
            self._data[idx] = vecs
            self.seen[idx] = True

    def state_dict(self) -> dict:
        with self._lock:
            return {"personal_vecs": np.array(self._data),
                    "personal_seen": np.array(self.seen)}

    def load_state_dict(self, state) -> None:
        vecs = np.asarray(state["personal_vecs"], np.float32)
        if vecs.shape != self._data.shape:
            raise ValueError(
                f"personal adapter checkpoint shape {vecs.shape} does not "
                f"match the store ({self._data.shape}) — different "
                "adapter rank/scope or client count")
        with self._lock:
            self._data[:] = vecs
            self.seen[:] = np.asarray(state["personal_seen"], bool)
