"""The FedAvg-era CNNs (port of ``fedml_tpu/models/cnn.py``):

- :class:`CNNOriginalFedAvg`: McMahan'17's 2-conv (32, 64 channels, 5×5
  "SAME") + max-pools + FC-512 net for MNIST/FEMNIST;
- :class:`CNNDropOut`: Reddi'20's variant, 3×3 "VALID" convs, one
  max-pool, dropout 0.25 and 0.5, FC-128 — the ``"cnn"`` registry entry
  (``dropout=True`` by default).

Inputs are NHWC, as in the JAX package; a 3-dim ``[B, H, W]`` input gains
its channel dim. ``stem="s2d"`` is the 2×2 space-to-depth input (1 → 4
channels at half the side), ``widths`` overrides the conv widths; the
nets run in f32 (the JAX classes' ``dtype`` is not ported: its factory
drops it). The
``im2col`` stem belongs to the compute layouts of ``parallel/layout.py``,
which is not ported (ROADMAP.md A5): it is refused. The flatten before the
first ``Dense`` takes (H, W, C) order, as flax's reshape of NHWC does, so
``convert.from_jax_params`` carries the kernels as they are.

Dropout draws its masks from the step's key (``rng``, which
``trainer.local.model_fns`` passes in train mode) through ``core.keys``:
element ``i`` of layer ``l`` keeps its value where ``uniform(fold_in(
fold_in(rng, l), i)) < 1 − rate``, scaled by ``1 / (1 − rate)``. No
torch generator is read, so a captured step replays new masks for every
key it is given. The masks are not JAX's threefry bits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.core import keys
from fedml_tpu_torch.core.device import resolve_device
from fedml_tpu_torch.models.registry import register_model
from fedml_tpu_torch.models.resnet import Conv, _lecun_normal_, space_to_depth


def dense(cin, cout, generator=None):
    """flax ``nn.Dense``: ``weight [out, in]`` lecun-normal, zero
    ``bias``."""
    layer = nn.Linear(cin, cout)
    _lecun_normal_(layer.weight, cin, generator)
    nn.init.zeros_(layer.bias)
    return layer


def dropout(x, rate: float, key):
    """flax ``nn.Dropout(rate)`` in train mode with the masks of ``key``
    (a 0-d key tensor; under ``vmap`` one per client)."""
    keep = 1.0 - rate
    idx = torch.arange(x.numel(), dtype=torch.int64, device=x.device)
    u = keys.uniform(keys.fold_in(key, idx)).view(x.shape)
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


def _stem(x, stem: str):
    if x.dim() == 3:
        x = x[..., None]
    if stem == "s2d":
        return space_to_depth(x, 2)
    if stem != "conv":
        raise ValueError(f"unknown stem {stem!r}: expected conv|s2d")
    return x


def _flatten(x):
    """``[B, C, H, W]`` → ``[B, H·W·C]`` in flax's (H, W, C) order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class CNNOriginalFedAvg(nn.Module):
    """conv5(c1) → relu → pool → conv5(c2) → relu → pool → Dense(hidden) →
    relu → Dense(classes), for ``side``×``side`` single-channel images."""

    def __init__(self, num_classes: int = 62, only_digits: bool = False,
                 stem: str = "conv", widths=None, im2col: bool = False,
                 side: int = 28, generator=None):
        super().__init__()
        if im2col:
            raise NotImplementedError(
                "the im2col stem is a compute layout of parallel/layout.py, "
                "which is not ported yet (ROADMAP.md A5)")
        self.stem = stem
        c1, c2 = widths or (32, 64)
        cin, side = (4, side // 2) if stem == "s2d" else (1, side)
        self.Conv_0 = Conv(cin, c1, 5, 1, 2, generator=generator, bias=True)
        self.Conv_1 = Conv(c1, c2, 5, 1, 2, generator=generator, bias=True)
        self.Dense_0 = dense((side // 4) ** 2 * c2, 512, generator)
        self.Dense_1 = dense(512, 10 if only_digits else num_classes,
                             generator)

    def forward(self, x):  # x [B, H, W(, 1)]
        x = _stem(x, self.stem).permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(self.Conv_0(x)), 2, 2)
        x = F.max_pool2d(F.relu(self.Conv_1(x)), 2, 2)
        x = F.relu(self.Dense_0(_flatten(x)))
        return self.Dense_1(x)


class CNNDropOut(nn.Module):
    """conv3(c1) → relu → conv3(c2) → relu → pool → dropout 0.25 →
    Dense(128) → relu → dropout 0.5 → Dense(classes), "VALID" convs, for
    ``side``×``side`` single-channel images."""

    takes_rng = True  # model_fns passes the step's key in train mode

    def __init__(self, num_classes: int = 62, only_digits: bool = False,
                 stem: str = "conv", widths=None, side: int = 28,
                 generator=None):
        super().__init__()
        self.stem = stem
        c1, c2 = widths or (32, 64)
        cin, side = (4, side // 2) if stem == "s2d" else (1, side)
        self.Conv_0 = Conv(cin, c1, 3, 1, 0, generator=generator, bias=True)
        self.Conv_1 = Conv(c1, c2, 3, 1, 0, generator=generator, bias=True)
        self.Dense_0 = dense(((side - 4) // 2) ** 2 * c2, 128, generator)
        self.Dense_1 = dense(128, 10 if only_digits else num_classes,
                             generator)

    def forward(self, x, rng=None):  # x [B, H, W(, 1)]
        train = self.training
        if train and rng is None:
            raise ValueError("CNNDropOut in train mode needs the step's key "
                             "(rng) for its dropout masks")
        x = _stem(x, self.stem).permute(0, 3, 1, 2)
        x = F.relu(self.Conv_1(F.relu(self.Conv_0(x))))
        x = F.max_pool2d(x, 2, 2)
        if train:
            x = dropout(x, 0.25, keys.fold_in(rng, 0))
        x = F.relu(self.Dense_0(_flatten(x)))
        if train:
            x = dropout(x, 0.5, keys.fold_in(rng, 1))
        return self.Dense_1(x)


@register_model("cnn")
def cnn(num_classes: int = 62, only_digits: bool = False,
        dropout: bool = True, stem: str = "conv", device=None,
        generator=None, **_):
    """``CNNDropOut`` (``dropout=True``) or ``CNNOriginalFedAvg``, f32. As
    the JAX factory, ``widths`` and ``dtype`` are swallowed by ``**_``
    (the classes take ``widths``)."""
    cls = CNNDropOut if dropout else CNNOriginalFedAvg
    return cls(num_classes=num_classes, only_digits=only_digits, stem=stem,
               generator=generator).to(resolve_device(device))

