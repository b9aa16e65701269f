"""EfficientNet B0–B7 (port of ``fedml_tpu/models/efficientnet.py``):
MBConv blocks with squeeze-excite and drop-connect, compound width and
depth scaling per variant, swish.

Names follow flax's auto-names (``MBConv_15.Conv_2``, ``MBConv_0.Dense_1``,
``Norm_1.GroupNorm_0``, ``Dense_0``), so ``convert.from_jax_params`` maps
the trees one to one. Numerics follow flax: SAME convs without bias
(``models/layers.py``; the depthwise k×k a grouped conv of weight ``[c, 1,
k, k]``), ``models/resnet.Norm``, swish as ``F.silu``; the SE's width is
``in_ch · se_ratio``, from the block's input channels.

The random masks come from the step's key (``rng``, passed by
``trainer.local.model_fns`` in train mode) through ``core.keys``: block
``i``'s drop-connect keeps sample ``n`` where ``uniform(fold_in(fold_in(
rng, i), n)) < 1 − rate`` (one mask per sample, scaled by ``1 / keep``;
only in train mode and where the residual applies; rate ``0.2 · i /
blocks``), and the dropout before the head folds the key with the block
count. They are not JAX's threefry bits. Inputs are NHWC.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from fedml_tpu_torch.core import keys
from fedml_tpu_torch.core.device import resolve_device
from fedml_tpu_torch.models.cnn import dense, dropout
from fedml_tpu_torch.models.layers import Conv, Named
from fedml_tpu_torch.models.registry import register_model
from fedml_tpu_torch.models.resnet import Norm

#: (width_mult, depth_mult, resolution, dropout) per variant.
PARAMS = {
    "b0": (1.0, 1.0, 224, 0.2), "b1": (1.0, 1.1, 240, 0.2),
    "b2": (1.1, 1.2, 260, 0.3), "b3": (1.2, 1.4, 300, 0.3),
    "b4": (1.4, 1.8, 380, 0.4), "b5": (1.6, 2.2, 456, 0.4),
    "b6": (1.8, 2.6, 528, 0.5), "b7": (2.0, 3.1, 600, 0.5),
}

#: B0's stage plan: (expand, channels, repeats, kernel, stride).
BASE_PLAN: Sequence[Tuple[int, int, int, int, int]] = (
    (1, 16, 1, 3, 1), (6, 24, 2, 3, 2), (6, 40, 2, 5, 2), (6, 80, 3, 3, 2),
    (6, 112, 3, 5, 1), (6, 192, 4, 5, 2), (6, 320, 1, 3, 1),
)


def round_filters(filters: int, width_mult: float, divisor: int = 8) -> int:
    """Channels scaled by ``width_mult``, rounded to a multiple of 8."""
    filters *= width_mult
    new = max(divisor, int(filters + divisor / 2) // divisor * divisor)
    if new < 0.9 * filters:
        new += divisor
    return int(new)


def round_repeats(repeats: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * repeats))


def drop_connect(y, rate: float, key):
    """``y [N, ...]`` with each sample kept where ``uniform(fold_in(key,
    n)) < 1 − rate`` and scaled by ``1 / (1 − rate)``, else zeroed."""
    keep = 1.0 - rate
    n = torch.arange(y.shape[0], dtype=torch.int64, device=y.device)
    mask = (keys.uniform(keys.fold_in(key, n)) < keep).to(y.dtype)
    return y * mask.view((-1,) + (1,) * (y.dim() - 1)) / keep


class MBConv(Named):
    """Mobile inverted bottleneck: (expand 1×1 →) depthwise k×k → SE →
    project 1×1, each conv normed; the residual (with drop-connect) at
    stride 1 with equal channels."""

    def __init__(self, cin, expand, out_ch, kernel, strides, se_ratio=0.25,
                 drop_rate=0.0, norm="gn", gn_fn=None, generator=None):
        super().__init__()
        mid = cin * expand
        self.expand, self.drop_rate = expand, drop_rate
        self.residual = strides == 1 and cin == out_ch
        if expand != 1:
            self.expand_conv = self.named("Conv", Conv(cin, mid, 1,
                                                       generator=generator))
            self.expand_norm = self.named("Norm", Norm(norm, mid,
                                                       gn_fn=gn_fn))
        self.dw_conv = self.named("Conv", Conv(mid, mid, kernel, strides,
                                               groups=mid,
                                               generator=generator))
        self.dw_norm = self.named("Norm", Norm(norm, mid, gn_fn=gn_fn))
        se_ch = max(1, int(cin * se_ratio))
        self.named("Dense", dense(mid, se_ch, generator))
        self.named("Dense", dense(se_ch, mid, generator))
        self.project_conv = self.named("Conv", Conv(mid, out_ch, 1,
                                                    generator=generator))
        self.project_norm = self.named("Norm", Norm(norm, out_ch,
                                                    gn_fn=gn_fn))

    def forward(self, x, key=None):
        """``key``: this block's drop-connect key, None for no mask."""
        y = x
        if self.expand != 1:
            y = getattr(self, self.expand_conv)(y)
            y = F.silu(getattr(self, self.expand_norm)(y))
        y = getattr(self, self.dw_conv)(y)
        y = F.silu(getattr(self, self.dw_norm)(y))
        s = F.silu(self.Dense_0(y.mean(dim=(2, 3))))
        s = torch.sigmoid(self.Dense_1(s))
        y = y * s[:, :, None, None]
        y = getattr(self, self.project_norm)(getattr(self,
                                                     self.project_conv)(y))
        if not self.residual:
            return y
        if key is not None:  # train mode, a rate above 0
            y = drop_connect(y, self.drop_rate, key)
        return y + x


class EfficientNet(Named):
    """Stem (stride 1 with ``small_input``, else 2), the MBConv stages of
    ``BASE_PLAN`` scaled by the variant, a 1×1 head conv, a global mean,
    dropout and ``Dense(num_classes)``."""

    takes_rng = True  # model_fns passes the step's key in train mode

    def __init__(self, variant="b0", num_classes=10, norm="gn",
                 small_input=True, drop_connect_rate=0.2, gn_fn=None,
                 generator=None):
        super().__init__()
        w_mult, d_mult, _res, self.dropout_rate = PARAMS[variant]
        cin = round_filters(32, w_mult)
        self.named("Conv", Conv(3, cin, 3, 1 if small_input else 2,
                                generator=generator))
        self.named("Norm", Norm(norm, cin, gn_fn=gn_fn))
        total = sum(round_repeats(r, d_mult) for _, _, r, _, _ in BASE_PLAN)
        self.blocks = []
        for expand, ch, repeats, kernel, stride in BASE_PLAN:
            out_ch = round_filters(ch, w_mult)
            for i in range(round_repeats(repeats, d_mult)):
                self.blocks.append(self.named("MBConv", MBConv(
                    cin, expand, out_ch, kernel, stride if i == 0 else 1,
                    drop_rate=drop_connect_rate * len(self.blocks) / total,
                    norm=norm, gn_fn=gn_fn, generator=generator)))
                cin = out_ch
        head = round_filters(1280, w_mult)
        self.named("Conv", Conv(cin, head, 1, generator=generator))
        self.named("Norm", Norm(norm, head, gn_fn=gn_fn))
        self.named("Dense", dense(head, num_classes, generator))

    def forward(self, x, rng=None):  # x [B, H, W, 3]
        train = self.training
        if train and rng is None:
            raise ValueError("EfficientNet in train mode needs the step's "
                             "key (rng) for its drop-connect and dropout "
                             "masks")
        x = F.silu(self.Norm_0(self.Conv_0(x.permute(0, 3, 1, 2))))
        for i, name in enumerate(self.blocks):
            block = getattr(self, name)
            draws = train and block.residual and block.drop_rate > 0.0
            x = block(x, keys.fold_in(rng, i) if draws else None)
        x = F.silu(self.Norm_1(self.Conv_1(x)))
        x = x.mean(dim=(2, 3))
        if train and self.dropout_rate > 0.0:
            x = dropout(x, self.dropout_rate,
                        keys.fold_in(rng, len(self.blocks)))
        return self.Dense_0(x)


@register_model("efficientnet")
def efficientnet(num_classes: int = 10, variant: str = "b0",
                 norm: str = "gn", small_input: bool = True,
                 drop_connect_rate: float = 0.2, device=None, gn_fn=None,
                 generator=None, **_):
    return EfficientNet(variant=variant, num_classes=num_classes, norm=norm,
                        small_input=small_input,
                        drop_connect_rate=drop_connect_rate, gn_fn=gn_fn,
                        generator=generator).to(resolve_device(device))
