"""ResNets (port of ``fedml_tpu/models/resnet.py``): the CIFAR family
``CifarResNet`` (``resnet20``, ``resnet56``, ``resnet56_s2d``,
``resnet110``) and the ImageNet-style ``ResNetGN`` (``resnet10_gn`` …
``resnet152_gn``, the fed_cifar100 row's ``resnet18_gn``).

Module and parameter names follow the flax tree (``Conv_0``,
``BottleneckBlock_3.Norm_2.GroupNorm_0.weight``, ``…downsample``,
``BasicBlock_1.Norm_0.BatchNorm_0.mean``), so ``convert.from_jax_params``
maps the two one to one. Numerics follow flax:

- convs and norms compute in the compute dtype (``dtype="bf16"``), with
  f32 parameters cast per call; the strided 3×3 conv pads (1, 1)
  explicitly, "SAME" on the 3×3 stem is padding 1, the 1×1 convs
  (stride 2 on the downsample path included) pad nothing; ``ResNetGN``'s
  ImageNet stem (``small_input=False``) is a 7×7 stride-2 conv padded 3
  and a 3×3 max-pool at stride 2 padded 1;
- GroupNorm: eps 1e-6, f32 statistics, groups by :func:`norm_groups`;
  ``"gn"`` and ``"gn_fused"`` both run ``ops.group_norm`` (the
  hand-written kernel on the card — the port never calls
  ``F.group_norm``), ``"none"`` is the identity;
- BatchNorm (``"bn"``) as flax's ``nn.BatchNorm(momentum=0.9)``: batch
  statistics in f32 over (N, H, W) with ``var = max(E[x²] − E[x]², 0)``,
  eps 1e-5, running stats ``0.9·ra + 0.1·batch`` with the biased
  variance, kept as the buffers ``BatchNorm_0.mean``/``.var`` (flax's
  ``batch_stats``). The module's ``training`` flag is flax's ``train``
  (``trainer.local.model_fns`` sets it per call); in train mode the new
  running stats are handed out as values (``new_buffers``), never
  written in place, so the update composes with ``grad`` and ``vmap``;
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

#: flax ``nn.BatchNorm``'s defaults as the JAX package builds it.
BN_MOMENTUM, BN_EPS = 0.9, 1e-5


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
    """flax ``nn.Conv``: OIHW f32 weight (and a zero-init bias with
    ``bias=True``), computed in the compute dtype."""

    def __init__(self, cin, cout, k, stride=1, padding=0, dtype=None,
                 generator=None, bias=False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        _lecun_normal_(self.weight, cin * k * k, generator)
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.stride, self.padding, self.dtype = stride, padding, dtype

    def forward(self, x):
        dt = self.dtype or x.dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.conv2d(x.to(dt), self.weight.to(dt), b, self.stride,
                        self.padding)


class _GroupNormParams(nn.Module):
    """flax ``GroupNorm``'s parameters (``scale`` → ``weight``)."""

    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9)`` over the channel dim 1 of an
    ``[N, C, ...]`` input: ``weight``/``bias`` (flax ``scale``/``bias``)
    and the running ``mean``/``var`` buffers (flax ``batch_stats``). In
    train mode it normalizes with the batch statistics and leaves the
    updated running stats in ``new_buffers`` (read by
    ``trainer.local.model_fns``); the buffers themselves are never
    written. ``dtype`` is the output dtype (None: x's promoted with
    f32)."""

    def __init__(self, channels, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))
        self.dtype = dtype
        self.new_buffers = None

    def forward(self, x):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        if self.training:
            dims = (0,) + tuple(range(2, x.dim()))
            xf = x.float()
            mean = xf.mean(dim=dims)
            var = torch.clamp((xf * xf).mean(dim=dims) - mean * mean,
                              min=0.0)
            m = BN_MOMENTUM
            self.new_buffers = {"mean": m * self.mean + (1 - m) * mean,
                                "var": m * self.var + (1 - m) * var}
        else:
            mean, var = self.mean, self.var
        # flax's _normalize: (x - mean) * (rsqrt(var + eps) * scale) + bias
        # in f32, cast to the compute dtype at the end.
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        y = (x.float() - mean.view(shape)) * mul.view(shape) \
            + self.bias.view(shape)
        return y.to(self.dtype or torch.promote_types(x.dtype,
                                                      torch.float32))


class Norm(nn.Module):
    """``"gn"``/``"gn_fused"`` (GroupNorm through ``ops.group_norm``),
    ``"bn"`` (:class:`BatchNorm`), ``"none"`` (identity). ``gn_fn`` swaps
    the GroupNorm function (same signature as ``ops.group_norm``) — how
    the card's check runs the model on the plain twin."""

    def __init__(self, kind, channels, groups=32, dtype=None, gn_fn=None):
        super().__init__()
        self.kind, self.dtype = kind, dtype
        self.gn_fn = gn_fn or group_norm
        if kind == "none":
            return
        if kind == "bn":
            self.BatchNorm_0 = BatchNorm(channels, dtype)
            return
        if kind not in ("gn", "gn_fused"):
            raise ValueError(f"unknown norm {kind!r}: expected gn, "
                             "gn_fused, none or bn")
        self.num_groups = norm_groups(channels, groups)
        self.GroupNorm_0 = _GroupNormParams(channels)

    def forward(self, x):  # [N, C, H, W], channels-last memory
        if self.kind == "none":
            return x
        if self.kind == "bn":
            return self.BatchNorm_0(x)
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


class ResNetGN(nn.Module):
    """ImageNet-style ResNet (the reference's resnet_gn.py): a 64-channel
    stem (3×3 "SAME" when ``small_input``, else 7×7 stride 2 and a 3×3
    max-pool), four stages of ``64·2^i`` planes (stride 2 at the first
    block of stages 2–4), the global mean in f32 and an f32 ``Dense``."""

    def __init__(self, stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 block: str = "basic", num_classes: int = 100,
                 norm: str = "gn", small_input: bool = True, dtype=None,
                 gn_fn=None, generator=None):
        super().__init__()
        self.small_input, self.dtype = small_input, dtype
        kw = dict(dtype=dtype, generator=generator)
        self.Conv_0 = (Conv(3, 64, 3, 1, 1, **kw) if small_input
                       else Conv(3, 64, 7, 2, 3, **kw))
        self.Norm_0 = Norm(norm, 64, dtype=dtype, gn_fn=gn_fn)
        blk = BasicBlock if block == "basic" else BottleneckBlock
        self.blocks = []
        cin = 64
        for stage, n_blocks in enumerate(stage_sizes):
            planes = 64 * 2 ** stage
            for j in range(n_blocks):
                strides = 2 if (stage > 0 and j == 0) else 1
                name = f"{blk.__name__}_{len(self.blocks)}"
                self.add_module(name, blk(cin, planes, strides, norm,
                                          gn_fn=gn_fn, **kw))
                self.blocks.append(name)
                cin = planes * blk.expansion
        self.Dense_0 = nn.Linear(cin, num_classes)
        _lecun_normal_(self.Dense_0.weight, cin, generator)
        nn.init.zeros_(self.Dense_0.bias)

    def forward(self, x):  # x [B, H, W, 3]
        x = x.permute(0, 3, 1, 2)  # NCHW view of NHWC memory
        x = F.relu(self.Norm_0(self.Conv_0(x)))
        if not self.small_input:
            x = F.max_pool2d(x, 3, 2, 1)
        for name in self.blocks:
            x = getattr(self, name)(x)
        x = x.float().mean(dim=(2, 3))
        return self.Dense_0(x)


def _build(device, cls=CifarResNet, **kw):
    dev = resolve_device(device)
    kw["dtype"] = resolve_dtype(kw.get("dtype"))
    return cls(**kw).to(dev)


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


# The ResNetGN factories take neither ``dtype`` nor ``norm``, as the JAX
# package's do (f32, GroupNorm): both are swallowed by ``**_``.
def _resnet_gn(stage_sizes, block, num_classes, device, gn_fn, generator):
    return _build(device, ResNetGN, stage_sizes=stage_sizes, block=block,
                  num_classes=num_classes, gn_fn=gn_fn, generator=generator)


@register_model("resnet10_gn")
def resnet10_gn(num_classes: int = 100, device=None, gn_fn=None,
                generator=None, **_):
    """One basic block per stage: the reduced-depth proxy of
    ``resnet18_gn``."""
    return _resnet_gn((1, 1, 1, 1), "basic", num_classes, device, gn_fn,
                      generator)


@register_model("resnet18_gn")
def resnet18_gn(num_classes: int = 100, device=None, gn_fn=None,
                generator=None, **_):
    """The fed_cifar100 baseline's model (20 GroupNorms a forward)."""
    return _resnet_gn((2, 2, 2, 2), "basic", num_classes, device, gn_fn,
                      generator)


@register_model("resnet34_gn")
def resnet34_gn(num_classes: int = 100, device=None, gn_fn=None,
                generator=None, **_):
    return _resnet_gn((3, 4, 6, 3), "basic", num_classes, device, gn_fn,
                      generator)


@register_model("resnet50_gn")
def resnet50_gn(num_classes: int = 100, device=None, gn_fn=None,
                generator=None, **_):
    return _resnet_gn((3, 4, 6, 3), "bottleneck", num_classes, device, gn_fn,
                      generator)


@register_model("resnet101_gn")
def resnet101_gn(num_classes: int = 100, device=None, gn_fn=None,
                 generator=None, **_):
    return _resnet_gn((3, 4, 23, 3), "bottleneck", num_classes, device,
                      gn_fn, generator)


@register_model("resnet152_gn")
def resnet152_gn(num_classes: int = 100, device=None, gn_fn=None,
                 generator=None, **_):
    return _resnet_gn((3, 8, 36, 3), "bottleneck", num_classes, device,
                      gn_fn, generator)
