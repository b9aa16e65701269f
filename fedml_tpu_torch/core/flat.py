"""Flat float32 vectors ↔ nested-dict adapter trees, in JAX's leaf order.

Port of ``fedml_tpu/core/compression.py`` ``TreeSpec``/``tree_spec`` and
``fedml_tpu/comm/codec.py`` ``tree_to_vector_np``/``vector_to_tree_np``.
A flattened leaf order is a storage format: rows of a
``PersonalAdapterStore`` written by either package must decode alike. JAX
flattens a dict by its keys sorted as strings at every level, so
``Block_10`` < ``Block_2`` and ``MHA_0`` < ``lora_*``; :func:`leaf_paths`
reproduces that order.

Leaves are numpy arrays or torch tensors. Vectors are numpy float32 on
the host; :func:`stacked_tree_of` turns ``[B, D]`` rows into ``[B, ...]``
torch leaves on a device with one host-to-device copy, and
:func:`stacked_vectors_np` turns them back.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch


class TreeSpec(NamedTuple):
    """Structure of a nested-dict tree: leaf key paths in JAX order, their
    shapes and element counts."""

    paths: Tuple[Tuple[str, ...], ...]
    shapes: Tuple[Tuple[int, ...], ...]
    sizes: Tuple[int, ...]


def leaf_paths(tree, prefix=()):
    """``(path, leaf)`` pairs in JAX's flatten order (sorted dict keys)."""
    out = []
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            out.extend(leaf_paths(val, prefix + (key,)))
        else:
            out.append((prefix + (key,), val))
    return out


def tree_spec(tree) -> TreeSpec:
    pairs = leaf_paths(tree)
    shapes = tuple(tuple(int(s) for s in leaf.shape) for _, leaf in pairs)
    return TreeSpec(tuple(p for p, _ in pairs), shapes,
                    tuple(int(np.prod(s)) if s else 1 for s in shapes))


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", torch.float32).numpy()
    return np.asarray(leaf)


def to_numpy_tree(tree):
    """The same nested dict with host numpy leaves."""
    return {k: to_numpy_tree(v) if isinstance(v, dict) else _to_numpy(v)
            for k, v in tree.items()}


def tree_to_vector_np(tree) -> np.ndarray:
    """Flatten a tree (numpy or torch leaves) into one float32 vector."""
    pairs = leaf_paths(tree)
    if not pairs:
        return np.zeros((0,), np.float32)
    return np.concatenate([np.ravel(_to_numpy(leaf)).astype(np.float32)
                           for _, leaf in pairs])


def _unflatten(paths, leaves):
    out = {}
    for path, leaf in zip(paths, leaves):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


def vector_to_tree_np(vec: np.ndarray, spec: TreeSpec):
    """Rebuild the tree (numpy float32 leaves) from a flat vector; raises
    on a length mismatch (a truncated or wrong-model row)."""
    total = int(sum(spec.sizes))
    if vec.shape != (total,):
        raise ValueError(f"vector has shape {vec.shape} but the spec "
                         f"declares {total} elements")
    leaves, off = [], 0
    for shape, size in zip(spec.shapes, spec.sizes):
        leaves.append(vec[off:off + size].reshape(shape).astype(np.float32))
        off += size
    return _unflatten(spec.paths, leaves)


def stacked_tree_of(vecs, spec: TreeSpec, device) -> dict:
    """``[B, D]`` flat rows → tree with ``[B, ...]`` float32 torch leaves
    on ``device``: one copy of the whole block, then per-leaf views."""
    vecs = np.asarray(vecs, np.float32)
    if vecs.ndim != 2:
        raise ValueError(f"expected [B, D] adapter vectors, got {vecs.shape}")
    total = int(sum(spec.sizes))
    if vecs.shape[1] != total:
        raise ValueError(f"adapter vectors have dim {vecs.shape[1]} but the "
                         f"spec declares {total}")
    block = torch.from_numpy(np.ascontiguousarray(vecs)).to(device)
    b = block.shape[0]
    leaves, off = [], 0
    for shape, size in zip(spec.shapes, spec.sizes):
        leaves.append(block[:, off:off + size].reshape((b,) + shape))
        off += size
    return _unflatten(spec.paths, leaves)


def stacked_vectors_np(tree) -> np.ndarray:
    """Inverse of :func:`stacked_tree_of`: a tree of ``[B, ...]`` torch
    leaves → ``[B, D]`` float32 rows on the host, one device-to-host copy."""
    leaves = [leaf for _, leaf in leaf_paths(tree)]
    b = leaves[0].shape[0]
    block = torch.cat([leaf.detach().reshape(b, -1).float()
                       for leaf in leaves], dim=1)
    return block.cpu().numpy()
