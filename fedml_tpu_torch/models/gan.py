"""The MNIST GAN of FedGAN (port of ``fedml_tpu/models/gan.py``): an MLP
generator 100 → 128 → 256 → 512 → 1024 → 784 with LeakyReLU(0.2) and
LayerNorm and a tanh output reshaped NHWC ``[B, 28, 28, 1]``, an MLP
discriminator 784 → 512 → 256 → 1 with LeakyReLU(0.2) that returns
logits, and ``MNISTGan`` holding both as ``netg``/``netd``, the unit that
FedGAN averages.

Names follow flax (``netg.Dense_3``, ``netg.LayerNorm_1``), so
``convert.from_jax_params`` maps the trees one to one. LayerNorm is
flax's: eps 1e-6 (torch's default is 1e-5), ``scale`` → ``weight``.
``norm="bn"`` (BatchNorm1d, the reference's strict parity) is
``models/resnet.BatchNorm``, flax's ``BatchNorm(momentum=0.9)``
(``netg.BatchNorm_<i>``): batch statistics in train mode, its running
stats handed out as values, read in eval mode.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.core.device import resolve_device
from fedml_tpu_torch.models.registry import register_model
from fedml_tpu_torch.models.resnet import BatchNorm, _lecun_normal_

LN_EPS = 1e-6


def _dense(cin, cout, generator):
    """flax ``nn.Dense``: lecun-normal kernel, zero bias."""
    layer = nn.Linear(cin, cout)
    _lecun_normal_(layer.weight, cin, generator)
    nn.init.zeros_(layer.bias)
    return layer


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm`` over the last dim (eps 1e-6)."""

    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return F.layer_norm(x, x.shape[-1:], self.weight, self.bias, LN_EPS)


class Generator(nn.Module):
    def __init__(self, input_size=100, out_pixels=784, norm="ln",
                 generator=None):
        super().__init__()
        if norm not in ("ln", "bn"):
            raise ValueError(f"unknown norm {norm!r}: expected ln or bn")
        self.side = int(out_pixels ** 0.5)
        widths = (128, 256, 512, 1024)
        self.Dense_0 = _dense(input_size, widths[0], generator)
        self.norms = []
        for i in range(3):
            setattr(self, f"Dense_{i + 1}",
                    _dense(widths[i], widths[i + 1], generator))
            name = f"{'BatchNorm' if norm == 'bn' else 'LayerNorm'}_{i}"
            setattr(self, name, (BatchNorm if norm == "bn" else LayerNorm)(
                widths[i + 1]))
            self.norms.append(name)
        self.Dense_4 = _dense(widths[-1], out_pixels, generator)

    def forward(self, z):
        x = F.leaky_relu(self.Dense_0(z), 0.2)
        for i, name in enumerate(self.norms):
            x = getattr(self, name)(getattr(self, f"Dense_{i + 1}")(x))
            x = F.leaky_relu(x, 0.2)
        x = self.Dense_4(x).tanh()
        return x.reshape(z.shape[0], self.side, self.side, 1)


class Discriminator(nn.Module):
    def __init__(self, input_size=784, generator=None):
        super().__init__()
        self.Dense_0 = _dense(input_size, 512, generator)
        self.Dense_1 = _dense(512, 256, generator)
        self.Dense_2 = _dense(256, 1, generator)

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        x = F.leaky_relu(self.Dense_0(x), 0.2)
        x = F.leaky_relu(self.Dense_1(x), 0.2)
        return self.Dense_2(x)  # logits


class MNISTGan(nn.Module):
    """The two nets (the reference's MNIST_gan); calling it runs G then D,
    as the JAX module's joint ``__call__``."""

    def __init__(self, latent_dim=100, norm="ln", generator=None):
        super().__init__()
        self.latent_dim = latent_dim
        self.netg = Generator(latent_dim, norm=norm, generator=generator)
        self.netd = Discriminator(generator=generator)

    def forward(self, z):
        return self.netd(self.netg(z))

    def generate(self, z):
        return self.netg(z)

    def discriminate(self, x):
        return self.netd(x)


@register_model("mnist_gan")
def mnist_gan(latent_dim: int = 100, norm: str = "ln", device=None,
              generator=None, **_):
    dev = resolve_device(device)
    return MNISTGan(latent_dim, norm, generator).to(dev)
