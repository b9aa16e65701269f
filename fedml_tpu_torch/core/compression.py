"""Update compression (port of ``fedml_tpu/core/compression.py``).

Two schemes over a flattened update vector, written in tensor ops so that
they run inside a captured round under ``vmap`` (the simulator's
``cfg.compress``) as well as on the host (the codecs):

- **top-k sparsification** (with error feedback in the codec): keep the
  ``k`` largest-|·| entries; the residual is what the codec carries into
  the client's next upload;
- **stochastic uniform quantization** (QSGD-style): ``2^(bits-1) - 1``
  levels each side of 0 with stochastic rounding, so that
  ``E[dequantize(quantize(x))] = x``. The codec quantizes per leaf (one
  scale per tensor).

:func:`tree_to_vector` flattens a nested dict of tensors in the tree's
own order (its keys as inserted, at every level): JAX's order for a tree
built with sorted keys, as flax builds its trees, and the order that
:func:`vector_to_tree` gives back, so a round's trees keep their
structure. The port's flat ``{"Conv_0.weight": ...}`` params flatten in
their module order and OIHW layouts, which top-k and the quantizer do not
see (each keeps or rounds entries one by one). The Bernoulli draws of
:func:`quantize_stochastic` come from ``core.keys``, not threefry:
``uniform`` takes other draws in their place (a test carries JAX's
across). The wire that uses the codecs is the federation plane
(``ROADMAP.md`` A10).
"""

from __future__ import annotations

import re
from typing import Any, NamedTuple, Tuple

import numpy as np
import torch

from fedml_tpu_torch.core import keys


def _leaf_paths(tree, prefix=()):
    """``(path, leaf)`` pairs of a nested dict, depth first, keys as
    inserted."""
    out = []
    for key, val in tree.items():
        if isinstance(val, dict):
            out.extend(_leaf_paths(val, prefix + (key,)))
        else:
            out.append((prefix + (key,), val))
    return out


class TreeSpec(NamedTuple):
    """A nested dict's leaf paths (in its order), shapes, dtypes and
    element counts."""

    paths: Tuple[Tuple[str, ...], ...]
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[Any, ...]
    sizes: Tuple[int, ...]


def tree_spec(tree) -> TreeSpec:
    pairs = _leaf_paths(tree)
    shapes = tuple(tuple(int(s) for s in leaf.shape) for _, leaf in pairs)
    return TreeSpec(tuple(p for p, _ in pairs), shapes,
                    tuple(leaf.dtype for _, leaf in pairs),
                    tuple(int(np.prod(s)) if s else 1 for s in shapes))


def tree_to_vector(tree) -> torch.Tensor:
    """One f32 vector of the tree's leaves in its order (an empty tree: a
    ``[0]`` vector)."""
    leaves = [leaf.reshape(-1).float() for _, leaf in _leaf_paths(tree)]
    return torch.cat(leaves) if leaves else torch.zeros(0)


def vector_to_tree(vec, spec: TreeSpec):
    """The tree of ``spec`` from ``vec``, each leaf in its own dtype."""
    out, off = {}, 0
    for path, shape, dtype, size in zip(spec.paths, spec.shapes,
                                        spec.dtypes, spec.sizes):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = vec[off:off + size].reshape(shape).to(dtype)
        off += size
    return out


# --- top-k sparsification ---------------------------------------------------


def topk_compress(vec, k: int):
    """The ``k`` largest-magnitude entries: ``(values [k], idx [k],
    residual)``, ``residual = vec`` with those entries zeroed (the error
    feedback's carry)."""
    k = max(1, min(int(k), vec.shape[0]))
    idx = torch.topk(vec.abs(), k).indices
    values = torch.gather(vec, 0, idx)
    residual = torch.scatter(vec, 0, idx, torch.zeros_like(values))
    return values, idx, residual


def topk_decompress(values, idx, n: int):
    return torch.zeros(n, dtype=values.dtype,
                       device=values.device).scatter(0, idx, values)


# --- stochastic uniform quantization ----------------------------------------


def _check_bits(bits: int) -> None:
    if not 2 <= bits <= 16:
        raise ValueError(f"bits must be in [2, 16], got {bits}")


def quantize_stochastic(vec, bits: int, key, uniform=None):
    """Symmetric uniform quantizer over one tensor with stochastic
    rounding: ``(levels in [-L, L] as int8/int16, f32 scale)``. Element
    ``i`` rounds up where its uniform draw is below its fractional part;
    the draws are ``keys.uniform(fold_in(key, i))``, or ``uniform`` (same
    shape as ``vec``) when given."""
    _check_bits(bits)
    levels = (1 << (bits - 1)) - 1  # 127 for 8 bits
    scale = torch.clamp(vec.abs().max(), min=1e-12) / levels
    scaled = vec / scale
    low = torch.floor(scaled)
    p_up = scaled - low  # P(round up) = the fractional part: unbiased
    if uniform is None:
        idx = torch.arange(vec.numel(), dtype=torch.int64,
                           device=vec.device)
        uniform = keys.uniform(keys.fold_in(key, idx)).view(vec.shape)
    up = (uniform < p_up).float()
    q = torch.clamp(low + up, -levels, levels)
    return q.to(torch.int8 if bits <= 8 else torch.int16), scale


def dequantize(q, scale):
    return q.float() * scale


# --- the codecs: host-side framing of the cross-silo uploads ----------------


class NoCompression:
    name = "none"

    def encode(self, update_tree, state, key):
        return update_tree, state

    def decode(self, payload, spec: TreeSpec):
        return payload


class TopKCompression:
    """``ratio`` = the fraction of entries kept (0.01: 100x sparser).
    ``state`` is the client's error-feedback residual vector, or None."""

    def __init__(self, ratio: float):
        if not 0 < ratio <= 1:
            raise ValueError(f"ratio must be in (0, 1], got {ratio}")
        self.ratio = ratio
        self.name = f"topk{ratio}"

    def encode(self, update_tree, state, key):
        vec = tree_to_vector(update_tree)
        if state is not None:
            vec = vec + state
        k = max(1, int(round(self.ratio * vec.shape[0])))
        values, idx, residual = topk_compress(vec, k)
        payload = {"kind": "topk", "n": int(vec.shape[0]),
                   "values": values.cpu().numpy(),
                   "idx": idx.to(torch.int32).cpu().numpy()}
        return payload, residual

    def decode(self, payload, spec: TreeSpec):
        vec = topk_decompress(torch.from_numpy(payload["values"]),
                              torch.from_numpy(payload["idx"]).long(),
                              payload["n"])
        return vector_to_tree(vec, spec)


class QuantizeCompression:
    """QSGD-style ``bits``-bit stochastic quantization, one scale per leaf
    (stateless); leaf ``i`` draws from ``keys.split(key, n_leaves)[i]``."""

    def __init__(self, bits: int):
        _check_bits(int(bits))  # fail at construction, not first upload
        self.bits = int(bits)
        self.name = f"q{bits}"

    def encode(self, update_tree, state, key):
        leaves = [leaf for _, leaf in _leaf_paths(update_tree)]
        leaf_keys = keys.split(key, max(len(leaves), 1))
        out = [quantize_stochastic(leaf.reshape(-1).float(), self.bits,
                                   leaf_keys[i])
               for i, leaf in enumerate(leaves)]
        payload = {"kind": "quant",
                   "qs": [q.cpu().numpy() for q, _ in out],
                   "scales": [float(s) for _, s in out]}
        return payload, state

    def decode(self, payload, spec: TreeSpec):
        parts = [dequantize(torch.from_numpy(q), s)
                 for q, s in zip(payload["qs"], payload["scales"])]
        vec = torch.cat(parts) if parts else torch.zeros(0)
        return vector_to_tree(vec, spec)


def make_compressor(name: str):
    """``none`` | ``topk<ratio>`` (topk0.05, topk1e-05) | ``q<bits>`` (q8):
    every name a compressor gives itself parses back."""
    if name in (None, "", "none"):
        return NoCompression()
    guidance = f"unknown compressor {name!r}; use none | topk<ratio> | q<bits>"
    if name.startswith("topk"):
        try:
            ratio = float(name[4:])
        except ValueError:
            raise ValueError(guidance) from None
        return TopKCompression(ratio)
    if re.fullmatch(r"q\d+", name):
        return QuantizeCompression(int(name[1:]))
    raise ValueError(guidance)
