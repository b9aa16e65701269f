"""Compact encoder–decoder segmentation net with GroupNorm (port of
``fedml_tpu/models/unet.py``'s ``UNet``), the model of FedSeg.

Names follow flax (``ConvBlock_3.Conv_1``, ``ConvBlock_0.Norm_1
.GroupNorm_0``, the head ``Conv_0``), so ``convert.from_jax_params`` maps
the trees one to one. Numerics follow flax: every 3×3 conv is SAME at
stride 1 (padding 1 on each side) without bias, the 1×1 head has a bias;
max pool is 2×2 VALID (odd sizes floor); the ×2 nearest upsample (a
broadcast, as JAX's, so its gradient is a plain sum) is cropped to the
skip's size, or edge-padded where the skip is larger;
GroupNorm through ``ops.group_norm`` (eps 1e-6, groups by
``norm_groups``). Inputs are NHWC and the logits come out NHWC ``[B, H,
W, classes]``, as the segmentation losses take them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.core.device import resolve_device
from fedml_tpu_torch.models.darts import Conv as SameConv
from fedml_tpu_torch.models.registry import register_model
from fedml_tpu_torch.models.resnet import Conv, Norm


class ConvBlock(nn.Module):
    """(3×3 conv → GroupNorm → relu) twice."""

    def __init__(self, cin, c, gn_fn=None, generator=None):
        super().__init__()
        self.Conv_0 = Conv(cin, c, 3, 1, 1, generator=generator)
        self.Norm_0 = Norm("gn", c, gn_fn=gn_fn)
        self.Conv_1 = Conv(c, c, 3, 1, 1, generator=generator)
        self.Norm_1 = Norm("gn", c, gn_fn=gn_fn)

    def forward(self, x):
        x = F.relu(self.Norm_0(self.Conv_0(x)))
        return F.relu(self.Norm_1(self.Conv_1(x)))


class UNet(nn.Module):
    """``levels`` down and up levels with skip connections; logits at the
    input's resolution."""

    def __init__(self, num_classes: int, base: int = 16, levels: int = 3,
                 in_channels: int = 3, gn_fn=None, generator=None):
        super().__init__()
        self.levels = levels
        cin, c = in_channels, base
        for i in range(levels):
            self.add_module(f"ConvBlock_{i}", ConvBlock(cin, c, gn_fn,
                                                        generator))
            cin, c = c, 2 * c
        self.add_module(f"ConvBlock_{levels}", ConvBlock(cin, c, gn_fn,
                                                         generator))
        for i in range(levels):
            c //= 2
            self.add_module(f"ConvBlock_{levels + 1 + i}",
                            ConvBlock(3 * c, c, gn_fn, generator))
        self.Conv_0 = SameConv(base, num_classes, 1, bias=True,
                               generator=generator)

    def forward(self, x):  # x [B, H, W, C]
        x = x.permute(0, 3, 1, 2)
        skips = []
        for i in range(self.levels):
            x = getattr(self, f"ConvBlock_{i}")(x)
            skips.append(x)
            x = F.max_pool2d(x, 2, 2)
        x = getattr(self, f"ConvBlock_{self.levels}")(x)
        for i, skip in enumerate(reversed(skips)):
            h, w = skip.shape[2], skip.shape[3]
            b, c, xh, xw = x.shape
            x = x[:, :, :, None, :, None].expand(b, c, xh, 2, xw, 2).reshape(
                b, c, 2 * xh, 2 * xw)[:, :, :h, :w]
            dh, dw = h - x.shape[2], w - x.shape[3]
            if dh or dw:
                x = F.pad(x, (0, dw, 0, dh), mode="replicate")
            x = torch.cat([x, skip], dim=1)
            x = getattr(self, f"ConvBlock_{self.levels + 1 + i}")(x)
        return self.Conv_0(x).permute(0, 2, 3, 1)


@register_model("unet")
def unet(num_classes: int = 21, base: int = 16, levels: int = 3,
         device=None, gn_fn=None, generator=None, **_):
    dev = resolve_device(device)
    return UNet(num_classes=num_classes, base=base, levels=levels,
                gn_fn=gn_fn, generator=generator).to(dev)
