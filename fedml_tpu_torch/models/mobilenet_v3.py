"""MobileNetV3 LARGE and SMALL (port of ``fedml_tpu/models/mobilenet_v3.py``):
h-swish and h-sigmoid, squeeze-excite, the inverted-residual blocks of
the reference's per-stage plans.

Names follow flax's auto-names (``MobileBlock_3.SqueezeExcite_0.Dense_1``,
``MobileBlock_14.Norm_2.GroupNorm_0``, ``Conv_1``, ``Dense_1``), so
``convert.from_jax_params`` maps the trees one to one. Numerics follow
flax: SAME convs without bias (``models/layers.py``; the depthwise k×k a
grouped conv of weight ``[c, 1, k, k]``), ``models/resnet.Norm``, the
activations written as the JAX package writes them (``relu6(x + 3) /
6``, so the rounding is the reference's), the SE's ``Dense`` layers with
bias. ``small_input`` keeps the stem at stride 1 for 32×32 inputs.

The dropout before the last ``Dense`` draws its masks from the step's key
(``rng``, passed by ``trainer.local.model_fns`` in train mode) through
``models/cnn.dropout``, folded with 0; they are not JAX's threefry bits.
Inputs are NHWC.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch.nn.functional as F

from fedml_tpu_torch.core import keys
from fedml_tpu_torch.core.device import resolve_device
from fedml_tpu_torch.models.cnn import dense, dropout
from fedml_tpu_torch.models.layers import Conv, Named
from fedml_tpu_torch.models.registry import register_model
from fedml_tpu_torch.models.resnet import Norm


def h_sigmoid(x):
    """relu6(x + 3) / 6."""
    return F.relu6(x + 3.0) / 6.0


def h_swish(x):
    """x · h_sigmoid(x)."""
    return x * h_sigmoid(x)


class SqueezeExcite(Named):
    """Global mean → Dense(c / 4) → relu → Dense(c) → h-sigmoid, scaling
    the channels."""

    def __init__(self, c, divide=4, generator=None):
        super().__init__()
        self.named("Dense", dense(c, c // divide, generator))
        self.named("Dense", dense(c // divide, c, generator))

    def forward(self, x):  # [N, C, H, W]
        s = F.relu(self.Dense_0(x.mean(dim=(2, 3))))
        s = h_sigmoid(self.Dense_1(s))
        return x * s[:, :, None, None]


class MobileBlock(Named):
    """Inverted residual: expand 1×1 → depthwise k×k → (SE) → project 1×1,
    each conv normed; the residual only at stride 1 with equal
    channels."""

    def __init__(self, cin, kernel, expand, out_ch, strides, use_se, act,
                 norm="gn", gn_fn=None, generator=None):
        super().__init__()
        self.nonlin = F.relu if act == "RE" else h_swish
        self.residual = strides == 1 and cin == out_ch
        self.named("Conv", Conv(cin, expand, 1, generator=generator))
        self.named("Norm", Norm(norm, expand, gn_fn=gn_fn))
        self.named("Conv", Conv(expand, expand, kernel, strides,
                                groups=expand, generator=generator))
        self.named("Norm", Norm(norm, expand, gn_fn=gn_fn))
        self.use_se = use_se
        if use_se:
            self.named("SqueezeExcite", SqueezeExcite(expand,
                                                      generator=generator))
        self.named("Conv", Conv(expand, out_ch, 1, generator=generator))
        self.named("Norm", Norm(norm, out_ch, gn_fn=gn_fn))

    def forward(self, x):
        y = self.nonlin(self.Norm_0(self.Conv_0(x)))
        y = self.Norm_1(self.Conv_1(y))
        if self.use_se:
            y = self.SqueezeExcite_0(y)
        y = self.Norm_2(self.Conv_2(self.nonlin(y)))
        return y + x if self.residual else y


# (kernel, expand, out, act, SE, stride): the reference's
# mobilenet_v3.py:150-189.
LARGE: Sequence[Tuple] = (
    (3, 16, 16, "RE", False, 1), (3, 64, 24, "RE", False, 2),
    (3, 72, 24, "RE", False, 1), (5, 72, 40, "RE", True, 2),
    (5, 120, 40, "RE", True, 1), (5, 120, 40, "RE", True, 1),
    (3, 240, 80, "HS", False, 2), (3, 200, 80, "HS", False, 1),
    (3, 184, 80, "HS", False, 1), (3, 184, 80, "HS", False, 1),
    (3, 480, 112, "HS", True, 1), (3, 672, 112, "HS", True, 1),
    (5, 672, 160, "HS", True, 1), (5, 672, 160, "HS", True, 2),
    (5, 960, 160, "HS", True, 1),
)
SMALL: Sequence[Tuple] = (
    (3, 16, 16, "RE", True, 2), (3, 72, 24, "RE", False, 2),
    (3, 88, 24, "RE", False, 1), (5, 96, 40, "RE", True, 2),
    (5, 240, 40, "RE", True, 1), (5, 240, 40, "RE", True, 1),
    (5, 120, 48, "HS", True, 1), (5, 144, 48, "HS", True, 1),
    (5, 288, 96, "HS", True, 2), (5, 576, 96, "HS", True, 1),
    (5, 576, 96, "HS", True, 1),
)


class MobileNetV3(Named):
    """16-channel stem (stride 1 with ``small_input``, else 2), the
    blocks of the mode's plan, a 1×1 conv to 960 (LARGE) or 576 (SMALL),
    a global mean, ``Dense(1280)`` + h-swish, dropout, ``Dense(
    num_classes)``."""

    takes_rng = True  # model_fns passes the step's key in train mode

    def __init__(self, model_mode="LARGE", num_classes=10, norm="gn",
                 dropout_rate=0.2, small_input=True, gn_fn=None,
                 generator=None):
        super().__init__()
        mode = model_mode.upper()
        if mode not in ("LARGE", "SMALL"):
            raise ValueError(
                f"model_mode must be LARGE or SMALL, got {mode!r}")
        plan = LARGE if mode == "LARGE" else SMALL
        last_expand = 960 if mode == "LARGE" else 576
        self.dropout_rate = dropout_rate
        self.named("Conv", Conv(3, 16, 3, 1 if small_input else 2,
                                generator=generator))
        self.named("Norm", Norm(norm, 16, gn_fn=gn_fn))
        cin, self.blocks = 16, []
        for k, e, o, act, se, s in plan:
            self.blocks.append(self.named("MobileBlock", MobileBlock(
                cin, k, e, o, s, se, act, norm, gn_fn, generator)))
            cin = o
        self.named("Conv", Conv(cin, last_expand, 1, generator=generator))
        self.named("Norm", Norm(norm, last_expand, gn_fn=gn_fn))
        self.named("Dense", dense(last_expand, 1280, generator))
        self.named("Dense", dense(1280, num_classes, generator))

    def forward(self, x, rng=None):  # x [B, H, W, 3]
        if self.training and rng is None:
            raise ValueError("MobileNetV3 in train mode needs the step's key "
                             "(rng) for its dropout mask")
        x = h_swish(self.Norm_0(self.Conv_0(x.permute(0, 3, 1, 2))))
        for name in self.blocks:
            x = getattr(self, name)(x)
        x = h_swish(self.Norm_1(self.Conv_1(x)))
        x = h_swish(self.Dense_0(x.mean(dim=(2, 3))))
        if self.training and self.dropout_rate > 0.0:
            x = dropout(x, self.dropout_rate, keys.fold_in(rng, 0))
        return self.Dense_1(x)


@register_model("mobilenet_v3")
def mobilenet_v3(num_classes: int = 10, model_mode: str = "LARGE",
                 norm: str = "gn", small_input: bool = True,
                 dropout_rate: float = 0.2, device=None, gn_fn=None,
                 generator=None, **_):
    return MobileNetV3(model_mode=model_mode, num_classes=num_classes,
                       norm=norm, dropout_rate=dropout_rate,
                       small_input=small_input, gn_fn=gn_fn,
                       generator=generator).to(resolve_device(device))
