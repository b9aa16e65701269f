"""Vertical-FL party models (port of ``fedml_tpu/models/vfl.py``).

- :class:`VFLLocalModel`: the feature extractor each party runs on its
  own feature slice, ``Dense → leaky_relu(·, 0.01)``;
- :class:`VFLDenseModel`: the party's logit contribution, one ``Dense``
  (the guest keeps the bias, the hosts have none, so the summed logit has
  one).

Initialised as flax initialises ``nn.Dense``: a lecun-normal kernel and a
zero bias. The module names follow flax (``Dense_0``), so
``convert.from_jax_params`` carries a party's weights (a flax kernel
``[in, out]`` becomes a ``Linear`` weight ``[out, in]``). flax infers the
input width at ``init``; the port takes it as ``in_features``. No kernel
of the port runs here.
"""

from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.core.device import resolve_device
from fedml_tpu_torch.models.registry import register_model
from fedml_tpu_torch.models.resnet import _lecun_normal_


def _dense(cin, cout, use_bias, generator):
    dense = nn.Linear(cin, cout, bias=use_bias)
    _lecun_normal_(dense.weight, cin, generator)
    if use_bias:
        nn.init.zeros_(dense.bias)
    return dense


class VFLLocalModel(nn.Module):
    """Per-party feature extractor: Dense → LeakyReLU(0.01)."""

    def __init__(self, in_features: int, output_dim: int = 32,
                 generator=None):
        super().__init__()
        self.Dense_0 = _dense(in_features, output_dim, True, generator)

    def forward(self, x):
        return F.leaky_relu(self.Dense_0(x), 0.01)


class VFLDenseModel(nn.Module):
    """Party logit head: one Linear (the guest keeps the bias)."""

    def __init__(self, in_features: int, output_dim: int = 1,
                 use_bias: bool = True, generator=None):
        super().__init__()
        self.Dense_0 = _dense(in_features, output_dim, use_bias, generator)

    def forward(self, x):
        return self.Dense_0(x)


@register_model("vfl_local")
def vfl_local(in_features: int, output_dim: int = 32, device=None,
              generator=None, **_):
    return VFLLocalModel(in_features, output_dim, generator).to(
        resolve_device(device))


@register_model("vfl_dense")
def vfl_dense(in_features: int, output_dim: int = 1, use_bias: bool = True,
              device=None, generator=None, **_):
    return VFLDenseModel(in_features, output_dim, use_bias, generator).to(
        resolve_device(device))
