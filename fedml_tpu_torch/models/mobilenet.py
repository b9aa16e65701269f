"""MobileNet v1 with a width multiplier α (port of
``fedml_tpu/models/mobilenet.py``), a cross-silo CV model of the
reference (``BASELINE.md``'s MobileNet rows).

Names follow flax's auto-names (``Conv_0``, ``Norm_0``,
``DepthwiseSeparable_12.Conv_0``, ``Dense_0``), so
``convert.from_jax_params`` maps the trees one to one. Numerics follow
flax: every conv is SAME (``models/layers.py``) without bias, the
depthwise 3×3 a grouped conv of weight ``[c, 1, 3, 3]``; ``Norm`` is
``models/resnet.Norm`` (GroupNorm on the kernels by default, ``"bn"``
with its running stats, ``"none"``); the stem's stride is 2 for inputs
taller than 64 and 1 otherwise, picked when the model is called.

Inputs are NHWC, as in the JAX package; inside, activations are NCHW
views of channels-last memory.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch.nn.functional as F

from fedml_tpu_torch.core.device import resolve_device
from fedml_tpu_torch.models.cnn import dense
from fedml_tpu_torch.models.layers import Conv, Named
from fedml_tpu_torch.models.registry import register_model
from fedml_tpu_torch.models.resnet import Norm

#: The reference's layer plan (mobilenet.py:69-205): (channels, stride)
#: after the 32-channel stem.
PLAN: Sequence[Tuple[int, int]] = (
    (64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
    (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2), (1024, 1),
)


class DepthwiseSeparable(Named):
    """depthwise 3×3 (stride ``strides``) → Norm → relu → 1×1 → Norm →
    relu."""

    def __init__(self, cin, out_ch, strides=1, norm="gn", gn_fn=None,
                 generator=None):
        super().__init__()
        self.named("Conv", Conv(cin, cin, 3, strides, groups=cin,
                                generator=generator))
        self.named("Norm", Norm(norm, cin, gn_fn=gn_fn))
        self.named("Conv", Conv(cin, out_ch, 1, generator=generator))
        self.named("Norm", Norm(norm, out_ch, gn_fn=gn_fn))

    def forward(self, x):
        x = F.relu(self.Norm_0(self.Conv_0(x)))
        return F.relu(self.Norm_1(self.Conv_1(x)))


class MobileNetV1(Named):
    """32-channel stem, then the depthwise-separable blocks of ``plan``,
    a global mean and ``Dense(num_classes)``; every width ``max(int(ch ·
    alpha), 8)``."""

    def __init__(self, num_classes=10, alpha=1.0, norm="gn", plan=PLAN,
                 gn_fn=None, generator=None):
        super().__init__()

        def c(ch):
            return max(int(ch * alpha), 8)

        cin = c(32)
        self.named("Conv", Conv(3, cin, 3, generator=generator))
        self.named("Norm", Norm(norm, cin, gn_fn=gn_fn))
        self.blocks = []
        for ch, s in plan:
            block = DepthwiseSeparable(cin, c(ch), s, norm, gn_fn, generator)
            self.blocks.append(self.named("DepthwiseSeparable", block))
            cin = c(ch)
        self.named("Dense", dense(cin, num_classes, generator))

    def forward(self, x):  # x [B, H, W, 3]
        stride = 2 if x.shape[1] > 64 else 1
        x = self.Conv_0(x.permute(0, 3, 1, 2), stride=stride)
        x = F.relu(self.Norm_0(x))
        for name in self.blocks:
            x = getattr(self, name)(x)
        return self.Dense_0(x.mean(dim=(2, 3)))


@register_model("mobilenet")
def mobilenet(num_classes: int = 10, alpha: float = 1.0, norm: str = "gn",
              device=None, gn_fn=None, generator=None, **_):
    return MobileNetV1(num_classes=num_classes, alpha=alpha, norm=norm,
                       gn_fn=gn_fn, generator=generator).to(
                           resolve_device(device))
