"""The FedAvg-era CNNs (port of ``fedml_tpu/models/cnn.py``):

- :class:`CNNOriginalFedAvg`: McMahan'17's 2-conv (32, 64 channels, 5×5
  "SAME") + max-pools + FC-512 net for MNIST/FEMNIST;
- :class:`CNNDropOut`: Reddi'20's variant, 3×3 "VALID" convs, one
  max-pool, dropout 0.25 and 0.5, FC-128 — the ``"cnn"`` registry entry
  (``dropout=True`` by default).

Inputs are NHWC, as in the JAX package; a 3-dim ``[B, H, W]`` input gains
its channel dim. ``stem="s2d"`` is the 2×2 space-to-depth input (1 → 4
channels at half the side), ``widths`` overrides the conv widths and
``hidden`` the first ``Dense``'s width. ``dtype`` is the compute dtype, as
flax's: convs and denses cast their input and f32 params to it (the
``"cnn"`` factory, as JAX's, builds f32 nets; ``parallel.layout.
step_dtype_model`` clones one to bf16). ``im2col=True`` is the physical
twin of ``parallel.layout.im2col_layout``: the 5×5 stem conv as patch
extraction in ``conv_general_dilated_patches``' (c, kh, kw) channel order
(``F.unfold``) and a 1×1 conv over the ``25·Cin`` patch channels. The
flatten before the first ``Dense`` takes (H, W, C) order, as flax's reshape
of NHWC does, so ``convert.from_jax_params`` carries the kernels as they
are. :meth:`clone` builds the same net with some fields changed (the
layouts' twins).

Dropout draws its masks from the step's key (``rng``, which
``trainer.local.model_fns`` passes in train mode) through ``core.keys``:
element ``i`` of layer ``l`` keeps its value where ``uniform(fold_in(
fold_in(rng, l), i)) < 1 − rate``, scaled by ``1 / (1 − rate)``. No
torch generator is read, so a captured step replays new masks for every
key it is given. The masks are not JAX's threefry bits.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.core import keys
from fedml_tpu_torch.core.device import resolve_device
from fedml_tpu_torch.models.registry import register_model
from fedml_tpu_torch.models.resnet import Conv, _lecun_normal_, space_to_depth


def dense(cin, cout, generator=None, dtype=None):
    """flax ``nn.Dense``: ``weight [out, in]`` lecun-normal, zero
    ``bias``, computed in ``dtype`` (None: as ``nn.Linear``)."""
    layer = Dense(cin, cout, dtype)
    _lecun_normal_(layer.weight, cin, generator)
    nn.init.zeros_(layer.bias)
    return layer


class Dense(nn.Linear):
    """``nn.Linear`` whose input and params are cast to the compute
    ``dtype`` per call (flax's ``Dense(dtype=...)``)."""

    def __init__(self, cin, cout, dtype=None):
        super().__init__(cin, cout)
        self.dtype = dtype

    def forward(self, x):
        if self.dtype is None:
            return super().forward(x)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        self.bias.to(self.dtype))


def dropout(x, rate: float, key):
    """flax ``nn.Dropout(rate)`` in train mode with the masks of ``key``
    (a 0-d key tensor; under ``vmap`` one per client)."""
    keep = 1.0 - rate
    idx = torch.arange(x.numel(), dtype=torch.int64, device=x.device)
    u = keys.uniform(keys.fold_in(key, idx)).view(x.shape)
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


def _stem(x, stem: str):
    if x.dim() == 3:
        x = x[..., None]
    if stem == "s2d":
        return space_to_depth(x, 2)
    if stem != "conv":
        raise ValueError(f"unknown stem {stem!r}: expected conv|s2d")
    return x


def _flatten(x):
    """``[B, C, H, W]`` → ``[B, H·W·C]`` in flax's (H, W, C) order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


class _Cloneable:
    """``clone(**changes)``: the same net (its constructor's arguments,
    kept as ``self.config``) with some fields changed, on the same
    device, freshly initialized."""

    def clone(self, **changes):
        dev = next(self.parameters()).device
        return type(self)(**{**self.config, **changes}).to(dev)


class CNNOriginalFedAvg(_Cloneable, nn.Module):
    """conv5(c1) → relu → pool → conv5(c2) → relu → pool → Dense(hidden) →
    relu → Dense(classes), for ``side``×``side`` single-channel images."""

    def __init__(self, num_classes: int = 62, only_digits: bool = False,
                 stem: str = "conv", widths=None, im2col: bool = False,
                 side: int = 28, hidden: int = 512, dtype=None,
                 generator=None):
        super().__init__()
        self.config = dict(num_classes=num_classes, only_digits=only_digits,
                           stem=stem, widths=widths, im2col=im2col,
                           side=side, hidden=hidden, dtype=dtype)
        self.stem, self.im2col, self.hidden = stem, im2col, hidden
        self.dtype, self.widths = dtype, widths
        self.num_classes, self.only_digits = num_classes, only_digits
        c1, c2 = widths or (32, 64)
        cin, side = (4, side // 2) if stem == "s2d" else (1, side)
        kw = dict(generator=generator, bias=True, dtype=dtype)
        self.Conv_0 = (Conv(cin * 25, c1, 1, 1, 0, **kw) if im2col
                       else Conv(cin, c1, 5, 1, 2, **kw))
        self.Conv_1 = Conv(c1, c2, 5, 1, 2, **kw)
        self.Dense_0 = dense((side // 4) ** 2 * c2, hidden, generator, dtype)
        self.Dense_1 = dense(hidden, 10 if only_digits else num_classes,
                             generator, dtype)

    def forward(self, x):  # x [B, H, W(, 1)]
        x = _stem(x, self.stem).permute(0, 3, 1, 2)
        if self.im2col:
            b, c, h, w = x.shape
            x = F.unfold(x.to(self.dtype or x.dtype), 5,
                         padding=2).view(b, c * 25, h, w)
        x = F.max_pool2d(F.relu(self.Conv_0(x)), 2, 2)
        x = F.max_pool2d(F.relu(self.Conv_1(x)), 2, 2)
        x = F.relu(self.Dense_0(_flatten(x)))
        return self.Dense_1(x)


class CNNDropOut(_Cloneable, nn.Module):
    """conv3(c1) → relu → conv3(c2) → relu → pool → dropout 0.25 →
    Dense(128) → relu → dropout 0.5 → Dense(classes), "VALID" convs, for
    ``side``×``side`` single-channel images."""

    takes_rng = True  # model_fns passes the step's key in train mode

    def __init__(self, num_classes: int = 62, only_digits: bool = False,
                 stem: str = "conv", widths=None, side: int = 28,
                 dtype=None, generator=None):
        super().__init__()
        self.config = dict(num_classes=num_classes, only_digits=only_digits,
                           stem=stem, widths=widths, side=side, dtype=dtype)
        self.stem, self.dtype = stem, dtype
        c1, c2 = widths or (32, 64)
        cin, side = (4, side // 2) if stem == "s2d" else (1, side)
        kw = dict(generator=generator, bias=True, dtype=dtype)
        self.Conv_0 = Conv(cin, c1, 3, 1, 0, **kw)
        self.Conv_1 = Conv(c1, c2, 3, 1, 0, **kw)
        self.Dense_0 = dense(((side - 4) // 2) ** 2 * c2, 128, generator,
                             dtype)
        self.Dense_1 = dense(128, 10 if only_digits else num_classes,
                             generator, dtype)

    def forward(self, x, rng=None):  # x [B, H, W(, 1)]
        train = self.training
        if train and rng is None:
            raise ValueError("CNNDropOut in train mode needs the step's key "
                             "(rng) for its dropout masks")
        x = _stem(x, self.stem).permute(0, 3, 1, 2)
        x = F.relu(self.Conv_1(F.relu(self.Conv_0(x))))
        x = F.max_pool2d(x, 2, 2)
        if train:
            x = dropout(x, 0.25, keys.fold_in(rng, 0))
        x = F.relu(self.Dense_0(_flatten(x)))
        if train:
            x = dropout(x, 0.5, keys.fold_in(rng, 1))
        return self.Dense_1(x)


@register_model("cnn")
def cnn(num_classes: int = 62, only_digits: bool = False,
        dropout: bool = True, stem: str = "conv", device=None,
        generator=None, **_):
    """``CNNDropOut`` (``dropout=True``) or ``CNNOriginalFedAvg``, f32. As
    the JAX factory, ``widths`` and ``dtype`` are swallowed by ``**_``
    (the classes take ``widths``)."""
    cls = CNNDropOut if dropout else CNNOriginalFedAvg
    return cls(num_classes=num_classes, only_digits=only_digits, stem=stem,
               generator=generator).to(resolve_device(device))

