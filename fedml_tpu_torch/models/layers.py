"""Layers shared by the models whose flax originals use ``padding="SAME"``
and flax's per-kind auto-names: DARTS, the UNet head, MobileNet (v1 and
v3), VGG and EfficientNet.

- :func:`same_pad` is flax's (XLA's) ``padding="SAME"``: ``(low, high)``
  per spatial dim, asymmetric at stride 2 on an even size (a 3×3 conv at
  H 32 pads (0, 1), a 5×5 pads (1, 2)), where ``F.conv2d(padding=k // 2)``
  would pad (1, 1) or (2, 2) and give other values;
- :class:`Conv` is flax ``nn.Conv(padding="SAME")``: an OIHW weight with
  ``[c_in / groups]`` input channels, so a depthwise conv
  (``feature_group_count=c_in``) has weight ``[c_in, 1, k, k]``; an
  optional bias;
- :class:`Named` adds submodules under the names flax gives them,
  ``<Kind>_<n>`` counted per kind in creation order, so
  ``convert.from_jax_params`` maps the two trees one to one.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.models.resnet import _lecun_normal_


def same_pad(size: int, k: int, stride: int = 1,
             dilation: int = 1) -> Tuple[int, int]:
    """flax's (XLA's) ``padding="SAME"`` for one spatial dim: the output
    has ``ceil(size / stride)`` positions, and the padding they need is
    split with the odd cell at the high end."""
    out = -(-size // stride)
    span = (k - 1) * dilation + 1
    total = max((out - 1) * stride + span - size, 0)
    return total // 2, total - total // 2


def pad_same(x, k: int, stride: int = 1, dilation: int = 1,
             value: float = 0.0):
    """``x [N, C, H, W]`` padded for a SAME window of ``k``. (Always an
    explicit pad: a conv's own padding would keep a channels-last input
    channels-last, whose double backward under ``vmap`` torch does not
    implement.)"""
    (ht, hb), (wl, wr) = (same_pad(x.shape[d], k, stride, dilation)
                          for d in (2, 3))
    if ht or hb or wl or wr:
        x = F.pad(x, (wl, wr, ht, hb), value=value)
    return x


class Conv(nn.Module):
    """flax ``nn.Conv`` with ``padding="SAME"``: OIHW weight (``[c_in /
    groups]`` input channels), optional bias. ``forward``'s ``stride``
    replaces the built one for one call (MobileNet's stem picks its
    stride from the input's height, as the flax module does)."""

    def __init__(self, cin, cout, k, stride=1, dilation=1, groups=1,
                 bias=False, generator=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k, k))
        _lecun_normal_(self.weight, cin // groups * k * k, generator)
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.k, self.stride, self.dilation, self.groups = (k, stride,
                                                           dilation, groups)

    def forward(self, x, stride=None):
        stride = stride or self.stride
        x = pad_same(x, self.k, stride, self.dilation)
        return F.conv2d(x, self.weight, self.bias, stride, 0,
                        self.dilation, self.groups)


class Named(nn.Module):
    """Submodules named as flax names them: ``<Kind>_<n>``, counted per
    kind in creation order."""

    def __init__(self):
        super().__init__()
        self._counts = {}

    def named(self, kind: str, module: nn.Module) -> str:
        n = self._counts.get(kind, 0)
        self._counts[kind] = n + 1
        name = f"{kind}_{n}"
        self.add_module(name, module)
        return name
