"""The split ResNet-56 pair of FedGKT and split learning (port of
``fedml_tpu/models/resnet_split.py``).

- :class:`ResNetClientStump`: conv(3→16, 3×3) → norm → relu gives the
  **features** that cross the split; then ``n_blocks`` blocks of 16
  planes, the global mean and a ``Dense`` give the client's own logits.
  Returns ``(logits, features)``. ``resnet5_56`` (one ``BasicBlock``) and
  ``resnet8_56`` (two ``BottleneckBlock``\\ s).
- :class:`ResNetServerTail`: the features through three stages of 16, 32
  and 64 planes (stride 2 at the first block of stages 2 and 3), the
  global mean and a ``Dense``. ``resnet56_server`` (6-6-6 bottlenecks),
  ``resnet20_server`` (2-2-2) and ``resnet110_server`` (12-12-12).
- :class:`ResNetSplitBottom`: split learning's client bottom, the stump
  without its logits (``resnet_split_bottom``).

The blocks are ``models/resnet.py``'s and keep the flax names (``Conv_0``,
``Norm_0``, ``BasicBlock_i``/``BottleneckBlock_i``, ``Dense_0``), so
``convert.from_jax_params`` carries weights one to one. The JAX modules
have no compute dtype: both packages run them in f32. Images go in NHWC,
as in the JAX package. The features cross the split in the port's
internal layout, ``[B, 16, H, W]`` with channels-last memory (JAX's
``[B, H, W, 16]`` seen through a permute), so the boundary moves no
bytes; the tail takes them so.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.core.device import resolve_device
from fedml_tpu_torch.models.registry import register_model
from fedml_tpu_torch.models.resnet import (BasicBlock, BottleneckBlock, Conv,
                                           Norm, _lecun_normal_)

_BLOCKS = {"basic": BasicBlock, "bottleneck": BottleneckBlock}


def _dense(cin, num_classes, generator):
    """flax ``nn.Dense``: lecun-normal kernel, zero bias."""
    dense = nn.Linear(cin, num_classes)
    _lecun_normal_(dense.weight, cin, generator)
    nn.init.zeros_(dense.bias)
    return dense


class _Stem(nn.Module):
    """conv(3→16, 3×3, "SAME") → norm → relu, then ``n_blocks`` blocks of
    16 planes; ``forward`` returns (the stem's features, the blocks'
    output)."""

    def __init__(self, n_blocks, block, norm, gn_fn, generator):
        super().__init__()
        blk = _BLOCKS[block]
        self.Conv_0 = Conv(3, 16, 3, 1, 1, generator=generator)
        self.Norm_0 = Norm(norm, 16, gn_fn=gn_fn)
        cin = 16
        for i in range(n_blocks):
            self.add_module(f"{blk.__name__}_{i}",
                            blk(cin, 16, 1, norm, gn_fn=gn_fn,
                                generator=generator))
            cin = 16 * blk.expansion
        self.n_blocks, self.block_name, self.out_ch = n_blocks, blk.__name__, cin

    def forward(self, x):  # x [B, H, W, 3]
        x = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory
        features = F.relu(self.Norm_0(self.Conv_0(x)))
        x = features
        for i in range(self.n_blocks):
            x = getattr(self, f"{self.block_name}_{i}")(x)
        return features, x


class ResNetClientStump(_Stem):
    """Bottom-of-the-split client net: ``(logits, features)``."""

    def __init__(self, n_blocks: int = 1, block: str = "basic",
                 num_classes: int = 10, norm: str = "gn", gn_fn=None,
                 generator=None):
        super().__init__(n_blocks, block, norm, gn_fn, generator)
        self.num_classes = num_classes
        self.Dense_0 = _dense(self.out_ch, num_classes, generator)

    def forward(self, x):
        features, x = super().forward(x)
        return self.Dense_0(x.float().mean(dim=(2, 3))), features


class ResNetSplitBottom(_Stem):
    """Split learning's client bottom: the stump's layers, no logits; the
    last block's output crosses the split."""

    def __init__(self, n_blocks: int = 1, block: str = "basic",
                 norm: str = "gn", gn_fn=None, generator=None):
        super().__init__(n_blocks, block, norm, gn_fn, generator)

    def forward(self, x):
        return super().forward(x)[1]


class ResNetServerTail(nn.Module):
    """Top-of-the-split server net: features ``[B, cin, H, W]`` → logits."""

    def __init__(self, layers: Sequence[int] = (6, 6, 6),
                 block: str = "bottleneck", num_classes: int = 10,
                 norm: str = "gn", cin: int = 16, gn_fn=None,
                 generator=None):
        super().__init__()
        blk = _BLOCKS[block]
        i = 0
        for stage, (planes, n_blocks) in enumerate(zip((16, 32, 64),
                                                       layers)):
            for j in range(n_blocks):
                strides = 2 if (stage > 0 and j == 0) else 1
                self.add_module(f"{blk.__name__}_{i}",
                                blk(cin, planes, strides, norm, gn_fn=gn_fn,
                                    generator=generator))
                cin, i = planes * blk.expansion, i + 1
        self.n_blocks, self.block_name = i, blk.__name__
        self.num_classes = num_classes
        self.Dense_0 = _dense(cin, num_classes, generator)

    def forward(self, feats):
        x = feats
        for i in range(self.n_blocks):
            x = getattr(self, f"{self.block_name}_{i}")(x)
        return self.Dense_0(x.float().mean(dim=(2, 3)))


def _build(cls, device, **kw):
    return cls(**kw).to(resolve_device(device))


@register_model("resnet5_56")
def resnet5_56(num_classes: int = 10, norm: str = "gn", device=None,
               gn_fn=None, generator=None, **_):
    return _build(ResNetClientStump, device, n_blocks=1, block="basic",
                  num_classes=num_classes, norm=norm, gn_fn=gn_fn,
                  generator=generator)


@register_model("resnet8_56")
def resnet8_56(num_classes: int = 10, norm: str = "gn", device=None,
               gn_fn=None, generator=None, **_):
    return _build(ResNetClientStump, device, n_blocks=2, block="bottleneck",
                  num_classes=num_classes, norm=norm, gn_fn=gn_fn,
                  generator=generator)


@register_model("resnet56_server")
def resnet56_server(num_classes: int = 10, norm: str = "gn", device=None,
                    gn_fn=None, generator=None, **_):
    return _build(ResNetServerTail, device, layers=(6, 6, 6),
                  num_classes=num_classes, norm=norm, gn_fn=gn_fn,
                  generator=generator)


@register_model("resnet20_server")
def resnet20_server(num_classes: int = 10, norm: str = "gn", device=None,
                    gn_fn=None, generator=None, **_):
    """Small server tail (2-2-2): the CI-size counterpart of
    ``resnet56_server``."""
    return _build(ResNetServerTail, device, layers=(2, 2, 2),
                  num_classes=num_classes, norm=norm, gn_fn=gn_fn,
                  generator=generator)


@register_model("resnet110_server")
def resnet110_server(num_classes: int = 10, norm: str = "gn", device=None,
                     gn_fn=None, generator=None, **_):
    return _build(ResNetServerTail, device, layers=(12, 12, 12),
                  num_classes=num_classes, norm=norm, gn_fn=gn_fn,
                  generator=generator)


@register_model("resnet_split_bottom")
def resnet_split_bottom(n_blocks: int = 1, norm: str = "gn", device=None,
                        gn_fn=None, generator=None, **_):
    return _build(ResNetSplitBottom, device, n_blocks=n_blocks, norm=norm,
                  gn_fn=gn_fn, generator=generator)


def stacked_init(module, n: int, generator=None):
    """``n`` independent draws of ``module``'s parameters as flax draws
    them (every weight of two or more dims lecun-normal over its fan-in,
    GroupNorm scales 1, biases 0): ``{name: [n, ...]}`` on the module's
    device. The JAX package inits each client's net from its own key; the
    port draws from ``generator``."""
    out = {}
    for name, p in module.named_parameters():
        rows = torch.empty((n,) + tuple(p.shape))
        for row in rows:
            if name.endswith("bias"):
                row.zero_()
            elif p.dim() == 1:  # a norm's scale
                row.fill_(1.0)
            else:
                _lecun_normal_(row, p[0].numel(), generator)
        out[name] = rows.to(p.device)
    return out
