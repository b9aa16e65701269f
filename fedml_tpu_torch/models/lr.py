"""Logistic regression (port of ``fedml_tpu/models/lr.py``; reference:
fedml_api/model/linear/lr.py:4-11).

As in the JAX package the model returns logits and the loss applies the
softmax (the reference's sigmoid-then-CrossEntropyLoss quirk is not
reproduced). The input is flattened per sample (``x.reshape(B, -1)``, so
an NHWC image flattens in NHWC order, as flax does) and goes through one
``nn.Linear`` named ``linear``, flax's name for its ``Dense``. flax infers
the input width at ``init``; the port takes it as ``in_features``.
"""

from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from fedml_tpu_torch.core.device import resolve_device
from fedml_tpu_torch.models.registry import register_model, resolve_dtype
from fedml_tpu_torch.models.resnet import _lecun_normal_


class LogisticRegression(nn.Module):
    """``dtype`` is the compute dtype; the parameters stay f32. Init as
    flax's ``Dense``: lecun-normal kernel, zero bias."""

    def __init__(self, in_features: int, num_classes: int = 10, dtype=None,
                 generator=None):
        super().__init__()
        self.config = dict(in_features=in_features,
                           num_classes=num_classes, dtype=dtype)
        self.dtype = resolve_dtype(dtype)
        self.linear = nn.Linear(in_features, num_classes)
        _lecun_normal_(self.linear.weight, in_features, generator)
        nn.init.zeros_(self.linear.bias)

    def clone(self, **changes):
        """The same model with ``changes`` to its fields (freshly
        initialized, on the same device)."""
        dev = self.linear.weight.device
        return type(self)(**{**self.config, **changes}).to(dev)

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        if self.dtype is None:
            return self.linear(x)
        return F.linear(x.to(self.dtype), self.linear.weight.to(self.dtype),
                        self.linear.bias.to(self.dtype))


@register_model("lr")
def lr(num_classes: int = 10, in_features: int = None, dtype=None,
       device=None, generator=None, **_):
    if in_features is None:
        raise ValueError("create_model('lr') needs in_features (the "
                         "flattened sample width; flax infers it at init)")
    return LogisticRegression(in_features, num_classes, dtype,
                              generator).to(resolve_device(device))
