"""CIFAR ResNets with GroupNorm (port of ``fedml_tpu/models/resnet.py``'s
``CifarResNet`` family: ``resnet20``, ``resnet56``, ``resnet56_s2d``,
``resnet110``).

Module and parameter names follow the flax tree (``Conv_0``,
``BottleneckBlock_3.Norm_2.GroupNorm_0.weight``, ``…downsample``), so
``convert.from_jax_params`` maps the two one to one. Numerics follow flax:

- convs and norms compute in the compute dtype (``dtype="bf16"``), with
  f32 parameters cast per call; the strided 3×3 conv pads (1, 1)
  explicitly, "SAME" on the 3×3 stem is padding 1, the 1×1 convs
  (stride 2 on the downsample path included) pad nothing;
- GroupNorm: eps 1e-6, f32 statistics, groups by :func:`norm_groups`;
  ``"gn"`` and ``"gn_fused"`` both run ``ops.group_norm`` (the
  hand-written kernel on the card — the port never calls
  ``F.group_norm``), ``"none"`` is the identity;
- the global mean is taken in f32 and the head ``Dense`` runs in f32.

Inputs are NHWC, as in the JAX package. Inside, activations stay in
``torch.channels_last``: the input permutes to an NCHW view with no copy,
and every GroupNorm reads an ``[N, H·W, C]`` view of the conv output.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.core.device import resolve_device
from fedml_tpu_torch.models.registry import register_model, resolve_dtype
from fedml_tpu_torch.ops.group_norm import EPS, group_norm


def norm_groups(c: int, groups: int = 32) -> int:
    """The largest divisor of the channel count that is <= ``groups``."""
    g = min(groups, c)
    while c % g:
        g -= 1
    return g


def _lecun_normal_(w, fan_in, generator):
    """flax's default kernel init: variance_scaling(1, fan_in,
    truncated_normal) — a normal truncated at ±2σ, rescaled to unit
    variance."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                              generator=generator)


class Conv(nn.Module):
    """flax ``nn.Conv`` without bias: OIHW f32 weight, computed in the
    compute dtype."""

    def __init__(self, cin, cout, k, stride=1, padding=0, dtype=None,
                 generator=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        _lecun_normal_(self.weight, cin * k * k, generator)
        self.stride, self.padding, self.dtype = stride, padding, dtype

    def forward(self, x):
        dt = self.dtype or x.dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), None, self.stride,
                        self.padding)


class _GroupNormParams(nn.Module):
    """flax ``GroupNorm``'s parameters (``scale`` → ``weight``)."""

    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))


class Norm(nn.Module):
    """``"gn"``/``"gn_fused"`` (GroupNorm through ``ops.group_norm``),
    ``"none"`` (identity); ``"bn"`` is not ported yet. ``gn_fn`` swaps the
    GroupNorm function (same signature as ``ops.group_norm``) — how the
    card's check runs the model on the plain twin."""

    def __init__(self, kind, channels, groups=32, dtype=None, gn_fn=None):
        super().__init__()
        self.kind, self.dtype = kind, dtype
        self.gn_fn = gn_fn or group_norm
        if kind == "none":
            return
        if kind == "bn":
            raise NotImplementedError(
                "norm='bn' is not ported yet (ROADMAP.md A2); use 'gn'")
        if kind not in ("gn", "gn_fused"):
            raise ValueError(f"unknown norm {kind!r}: expected gn, "
                             "gn_fused, none or bn")
        self.num_groups = norm_groups(channels, groups)
        self.GroupNorm_0 = _GroupNormParams(channels)

    def forward(self, x):  # [N, C, H, W], channels-last memory
        if self.kind == "none":
            return x
        p = self.GroupNorm_0
        y = self.gn_fn(x.to(self.dtype or x.dtype).permute(0, 2, 3, 1),
                       p.weight, p.bias, self.num_groups, EPS)
        return y.permute(0, 3, 1, 2)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, cin, planes, strides=1, norm="gn", dtype=None,
                 gn_fn=None, generator=None):
        super().__init__()
        out = planes * self.expansion
        kw = dict(dtype=dtype, generator=generator)
        nk = dict(dtype=dtype, gn_fn=gn_fn)
        self.Conv_0 = Conv(cin, planes, 1, **kw)
        self.Norm_0 = Norm(norm, planes, **nk)
        # Explicit (1, 1) padding: torch's conv3x3 grid at stride 2 too.
        self.Conv_1 = Conv(planes, planes, 3, strides, 1, **kw)
        self.Norm_1 = Norm(norm, planes, **nk)
        self.Conv_2 = Conv(planes, out, 1, **kw)
        self.Norm_2 = Norm(norm, out, **nk)
        self.has_downsample = strides != 1 or cin != out
        if self.has_downsample:
            self.downsample = Conv(cin, out, 1, strides, 0, **kw)
            self.Norm_3 = Norm(norm, out, **nk)

    def forward(self, x):
        y = F.relu(self.Norm_0(self.Conv_0(x)))
        y = F.relu(self.Norm_1(self.Conv_1(y)))
        y = self.Norm_2(self.Conv_2(y))
        residual = self.Norm_3(self.downsample(x)) if self.has_downsample \
            else x
        return F.relu(residual + y)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin, planes, strides=1, norm="gn", dtype=None,
                 gn_fn=None, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        nk = dict(dtype=dtype, gn_fn=gn_fn)
        self.Conv_0 = Conv(cin, planes, 3, strides, 1, **kw)
        self.Norm_0 = Norm(norm, planes, **nk)
        self.Conv_1 = Conv(planes, planes, 3, 1, 1, **kw)
        self.Norm_1 = Norm(norm, planes, **nk)
        self.has_downsample = strides != 1 or cin != planes
        if self.has_downsample:
            self.downsample = Conv(cin, planes, 1, strides, 0, **kw)
            self.Norm_2 = Norm(norm, planes, **nk)

    def forward(self, x):
        y = F.relu(self.Norm_0(self.Conv_0(x)))
        y = self.Norm_1(self.Conv_1(y))
        residual = self.Norm_2(self.downsample(x)) if self.has_downsample \
            else x
        return F.relu(residual + y)


def space_to_depth(x, block: int = 2):
    """[B, H, W, C] → [B, H/b, W/b, C·b²]: 2×2 spatial patches into
    channels, in the JAX package's channel order."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // block, block, w // block, block, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(
        b, h // block, w // block, c * block * block)


class CifarResNet(nn.Module):
    """CIFAR-style 3-stage bottleneck ResNet over RGB images.
    ``stem="s2d"``: 2×2 space-to-depth input (3 → 12 channels) with stage
    widths doubled. ``widths`` overrides the stage widths. (The JAX
    model's ``stem_width`` and ``logical_*`` fields serve the lane-padded
    layouts of ``parallel/layout.py``, which is not ported.)"""

    def __init__(self, layers: Sequence[int] = (6, 6, 6),
                 num_classes: int = 10, norm: str = "gn", dtype=None,
                 stem: str = "conv", widths=None, gn_fn=None,
                 generator=None):
        super().__init__()
        self.stem, self.dtype = stem, dtype
        stem_ch, widths = self.stage_widths(stem, widths)
        cin = 3 * 4 if stem == "s2d" else 3
        kw = dict(dtype=dtype, generator=generator)
        self.Conv_0 = Conv(cin, stem_ch, 3, 1, 1, **kw)
        self.Norm_0 = Norm(norm, stem_ch, dtype=dtype, gn_fn=gn_fn)
        cin, i = stem_ch, 0
        for stage, (planes, n_blocks) in enumerate(zip(widths, layers)):
            for j in range(n_blocks):
                strides = 2 if (stage > 0 and j == 0) else 1
                blk = BottleneckBlock(cin, planes, strides, norm,
                                      gn_fn=gn_fn, **kw)
                self.add_module(f"BottleneckBlock_{i}", blk)
                cin, i = planes * BottleneckBlock.expansion, i + 1
        self.n_blocks = i
        self.Dense_0 = nn.Linear(cin, num_classes)
        _lecun_normal_(self.Dense_0.weight, cin, generator)
        nn.init.zeros_(self.Dense_0.bias)

    @staticmethod
    def stage_widths(stem="conv", widths=None):
        """(stem channels, per-stage widths) of the stem kind."""
        if stem == "s2d":
            default, stem_ch = (32, 64, 128), 32
        elif stem == "conv":
            default, stem_ch = (16, 32, 64), 16
        else:
            raise ValueError(f"unknown stem {stem!r}: expected conv|s2d")
        return stem_ch, tuple(widths) if widths else default

    def forward(self, x):  # x [B, H, W, C]
        if self.stem == "s2d":
            x = space_to_depth(x, 2)
        x = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory
        x = F.relu(self.Norm_0(self.Conv_0(x)))
        for i in range(self.n_blocks):
            x = getattr(self, f"BottleneckBlock_{i}")(x)
        x = x.float().mean(dim=(2, 3))
        return self.Dense_0(x)


def _build(device, **kw):
    dev = resolve_device(device)
    kw["dtype"] = resolve_dtype(kw.get("dtype"))
    return CifarResNet(**kw).to(dev)


@register_model("resnet56")
def resnet56(num_classes: int = 10, norm: str = "gn", dtype=None,
             stem: str = "conv", widths=None, device=None, gn_fn=None,
             generator=None, **_):
    return _build(device, layers=(6, 6, 6), num_classes=num_classes,
                  norm=norm, dtype=dtype, stem=stem, widths=widths,
                  gn_fn=gn_fn, generator=generator)


@register_model("resnet56_s2d")
def resnet56_s2d(num_classes: int = 10, norm: str = "gn", dtype=None,
                 device=None, gn_fn=None, generator=None, **_):
    return _build(device, layers=(6, 6, 6), num_classes=num_classes,
                  norm=norm, dtype=dtype, stem="s2d", gn_fn=gn_fn,
                  generator=generator)


@register_model("resnet110")
def resnet110(num_classes: int = 10, norm: str = "gn", dtype=None,
              stem: str = "conv", device=None, gn_fn=None, generator=None,
              **_):
    return _build(device, layers=(12, 12, 12), num_classes=num_classes,
                  norm=norm, dtype=dtype, stem=stem, gn_fn=gn_fn,
                  generator=generator)


@register_model("resnet20")
def resnet20(num_classes: int = 10, norm: str = "gn", dtype=None,
             stem: str = "conv", widths=None, device=None, gn_fn=None,
             generator=None, **_):
    """Small CIFAR ResNet (2-2-2 bottleneck): the tests' workhorse."""
    return _build(device, layers=(2, 2, 2), num_classes=num_classes,
                  norm=norm, dtype=dtype, stem=stem, widths=widths,
                  gn_fn=gn_fn, generator=generator)
