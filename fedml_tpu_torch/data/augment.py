"""Data augmentation on the device (port of ``fedml_tpu/data/augment.py``):
batched torch ops on whole NHWC batches, drawn from ``core.keys`` streams.

The reference augments on the host per sample through torchvision
transforms (cifar10/data_loader.py:58-76: RandomCrop(32, padding=4),
RandomHorizontalFlip, Normalize, Cutout(16)). Here each function takes a
key and a batch and keeps its shape; every draw is a hash of the key and
the sample's index, so a function runs under ``vmap`` over clients (a
``[C]`` tensor of keys is C streams) and inside a captured CUDA graph.
The draws are not JAX's threefry bits, but their structure: one crop
offset pair, one flip and one cutout centre per sample.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fedml_tpu_torch.core import keys


def _randint(k, n: int, high: int):
    """``n`` integers in ``[0, high)`` from key ``k``, one per index."""
    u = keys.uniform(keys.fold_in(k, torch.arange(n, device=k.device)))
    return torch.clamp((u * high).to(torch.int64), max=high - 1)


def random_crop(rng, x, padding: int = 4):
    """Pad + random-crop an NHWC batch, one offset per sample (a gather
    over the padded image keeps the shapes static)."""
    n, h, w, _ = x.shape
    xp = F.pad(x, (0, 0, padding, padding, padding, padding))
    pair = keys.split(rng)
    oy = _randint(pair[..., 0], n, 2 * padding + 1)
    ox = _randint(pair[..., 1], n, 2 * padding + 1)
    rows = (oy[:, None] + torch.arange(h, device=x.device))[:, :, None]
    cols = (ox[:, None] + torch.arange(w, device=x.device))[:, None, :]
    batch = torch.arange(n, device=x.device)[:, None, None]
    return xp[batch, rows, cols]


def random_flip(rng, x):
    """Horizontal flip with p = 0.5 per sample."""
    n = x.shape[0]
    u = keys.uniform(keys.fold_in(rng, torch.arange(n, device=x.device)))
    return torch.where((u < 0.5)[:, None, None, None], x.flip(2), x)


def cutout(rng, x, length: int = 16):
    """Zero a random ``length`` x ``length`` square per sample (DeVries &
    Taylor; the reference's Cutout, cifar10/data_loader.py:20-44: centres
    may fall near the edges, so the square is clipped)."""
    n, h, w, _ = x.shape
    pair = keys.split(rng)
    cy = _randint(pair[..., 0], n, h)[:, None, None]
    cx = _randint(pair[..., 1], n, w)[:, None, None]
    ys = torch.arange(h, device=x.device)[None, :, None]
    xs = torch.arange(w, device=x.device)[None, None, :]
    mask = ((ys - cy).abs() < length // 2) & ((xs - cx).abs() < length // 2)
    return x * (~mask[..., None]).to(x.dtype)


def cifar_train_augment(rng, x, use_cutout: bool = True):
    """The composed CIFAR policy (crop → flip → cutout) on a normalized
    batch: cutout's zeros are the channel mean after normalisation, as in
    the reference (which also cuts after ToTensor/Normalize)."""
    k = keys.split(rng, 3)
    x = random_crop(k[..., 0], x)
    x = random_flip(k[..., 1], x)
    if use_cutout:
        x = cutout(k[..., 2], x)
    return x
