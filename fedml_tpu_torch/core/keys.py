"""Counter-based random keys in integer tensor ops.

The JAX package derives every stream from threefry keys with
``fold_in``/``split``; those bits cannot be reproduced in torch. The port
keeps the same structure with its own keys: a key is an int64 tensor
holding a 32-bit value, ``fold_in(key, i)`` hashes the pair, and a
uniform draw hashes the key once more. Everything is elementwise, so a
``[C]`` tensor of keys is C independent streams, and a child key depends
only on its parent and its index (the prefix-stability the JAX trainer's
shuffle relies on, ``fedml_tpu/trainer/local.py:125-134``).

``normal`` turns pairs of uniforms into Gaussians. No function here reads a tensor on the host or copies one from it (an
integer ``data`` is hashed in Python), so every one can run inside a
captured CUDA graph (``core/graph.py``).
"""

from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF
_SPLIT_TAG = 0x5EED


def _mul32(a, c: int):
    """``a·c mod 2^32`` for ``a`` in [0, 2^32) without int64 overflow."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x):
    """A 32-bit avalanche hash (xor-shift-multiply)."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def key(seed: int, device=None) -> torch.Tensor:
    """The root key of ``seed`` (a 0-d int64 tensor)."""
    return _mix32(torch.tensor(int(seed) & _M32, dtype=torch.int64,
                               device=device))


def fold_in(k, data):
    """Child key of ``k`` for ``data`` (int or int64 tensor), broadcast. An
    int is hashed on the host: the same bits as a 0-d tensor of it, without
    a host-to-device copy."""
    if torch.is_tensor(data):
        data = data.to(torch.int64)
    else:
        data = int(data) & ((1 << 64) - 1)
    return _mix32(_mix32(k) ^ _mix32(data + 0x9E3779B9))


def split(k, n: int = 2):
    """``n`` children of ``k`` along a new last dim (``[..., n]``)."""
    idx = torch.arange(n, dtype=torch.int64, device=k.device)
    return fold_in(fold_in(k, _SPLIT_TAG)[..., None], idx)


def uniform(k):
    """A float32 in [0, 1) per key (24 random bits)."""
    return (_mix32(k) >> 8).to(torch.float32) * (1.0 / (1 << 24))


def choice(k, n: int, size: int):
    """``size`` distinct indices of ``range(n)``, uniform without
    replacement (the port's ``jax.random.choice(k, n, (size,),
    replace=False)``): the first ``size`` of a stable argsort of one uniform
    draw per index. ``[..., size]`` int64 for keys ``k [...]``, on ``k``'s
    device; no host sync."""
    if not 0 < size <= n:
        raise ValueError(f"choice of {size} from {n}")
    idx = torch.arange(n, dtype=torch.int64, device=k.device)
    u = uniform(fold_in(k[..., None], idx))
    return torch.argsort(u, dim=-1, stable=True)[..., :size]


def normal(k, shape, dtype=torch.float32):
    """Standard normals of ``shape`` per key: ``[..., *shape]`` for keys
    ``k [...]``. Element ``i`` is a Box-Muller draw from the uniforms of
    ``fold_in(k, 2i)`` and ``fold_in(k, 2i + 1)``, so it depends only on
    the key and its index (24-bit uniforms: the tails end near 5.8σ)."""
    shape = tuple(shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=k.device)
    kk = k[..., None]
    u1 = uniform(fold_in(kk, 2 * idx))
    u2 = uniform(fold_in(kk, 2 * idx + 1))
    z = torch.sqrt(-2.0 * torch.log1p(-u1)) * torch.cos((2 * math.pi) * u2)
    return z.reshape(*k.shape, *shape).to(dtype)
