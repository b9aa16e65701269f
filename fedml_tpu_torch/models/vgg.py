"""VGG 11/13/16/19, plain, with BatchNorm or with GroupNorm (port of
``fedml_tpu/models/vgg.py``): ``vgg11`` … ``vgg19``, ``vgg11_bn`` …,
``vgg11_gn`` …

As the JAX model, the classifier is a global mean then ``Dense(
classifier_width)`` twice (relu, dropout) and ``Dense(num_classes)``, not
the reference's 512·7·7 flatten. Names follow flax's auto-names
(``Conv_7``, ``Norm_7.BatchNorm_0``, ``Dense_2``), so
``convert.from_jax_params`` maps the trees (and BatchNorm's
``batch_stats``) one to one. Numerics follow flax: 3×3 SAME convs with a
bias (flax's ``use_bias=True``), ``Norm`` after each conv when ``norm``
is set (``models/resnet.Norm``), 2×2 VALID max pools.

Dropout draws its masks from the step's key (``rng``, which
``trainer.local.model_fns`` passes in train mode) through
``models/cnn.dropout``: the two dropouts fold the key with 0 and 1. The
masks are not JAX's threefry bits. Inputs are NHWC.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch.nn.functional as F

from fedml_tpu_torch.core import keys
from fedml_tpu_torch.core.device import resolve_device
from fedml_tpu_torch.models.cnn import dense, dropout
from fedml_tpu_torch.models.layers import Conv, Named
from fedml_tpu_torch.models.registry import register_model
from fedml_tpu_torch.models.resnet import Norm

#: Per-depth conv plans, "M" a 2×2 max pool (the reference's cfgs A/B/D/E).
CFGS = {
    11: (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    13: (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512,
         "M"),
    16: (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
         512, 512, 512, "M"),
    19: (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512,
         512, "M", 512, 512, 512, 512, "M"),
}


class VGG(Named):
    """``norm``: "" (plain), "gn", "bn" (or "none")."""

    takes_rng = True  # model_fns passes the step's key in train mode

    def __init__(self, cfg: Sequence[Union[int, str]], num_classes=10,
                 norm="", classifier_width=4096, dropout_rate=0.5,
                 gn_fn=None, generator=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.layers = []
        cin = 3
        for v in cfg:
            if v == "M":
                self.layers.append(None)  # a max pool
                continue
            conv = self.named("Conv", Conv(cin, int(v), 3, bias=True,
                                           generator=generator))
            nm = (self.named("Norm", Norm(norm, int(v), gn_fn=gn_fn))
                  if norm else None)
            self.layers.append((conv, nm))
            cin = int(v)
        for _ in range(2):
            self.named("Dense", dense(cin, classifier_width, generator))
            cin = classifier_width
        self.named("Dense", dense(cin, num_classes, generator))

    def forward(self, x, rng=None):  # x [B, H, W, 3]
        if self.training and rng is None:
            raise ValueError("VGG in train mode needs the step's key (rng) "
                             "for its dropout masks")
        x = x.permute(0, 3, 1, 2)
        for layer in self.layers:
            if layer is None:
                x = F.max_pool2d(x, 2, 2)
                continue
            conv, nm = layer
            x = getattr(self, conv)(x)
            if nm is not None:
                x = getattr(self, nm)(x)
            x = F.relu(x)
        x = x.mean(dim=(2, 3))
        for i in range(2):
            x = F.relu(getattr(self, f"Dense_{i}")(x))
            if self.training and self.dropout_rate > 0.0:
                x = dropout(x, self.dropout_rate, keys.fold_in(rng, i))
        return self.Dense_2(x)


def _make(depth: int, default_norm: str):
    def ctor(num_classes: int = 10, classifier_width: int = 4096,
             norm: str = None, dropout_rate: float = 0.5, device=None,
             gn_fn=None, generator=None, **_):
        return VGG(CFGS[depth], num_classes=num_classes,
                   norm=default_norm if norm is None else norm,
                   classifier_width=classifier_width,
                   dropout_rate=dropout_rate, gn_fn=gn_fn,
                   generator=generator).to(resolve_device(device))
    return ctor


for _d in (11, 13, 16, 19):
    register_model(f"vgg{_d}")(_make(_d, ""))
    register_model(f"vgg{_d}_bn")(_make(_d, "bn"))
    register_model(f"vgg{_d}_gn")(_make(_d, "gn"))
