"""Vision Transformer classifier (port of ``fedml_tpu/models/vit.py``):
the transformer LM's encoder ``Block`` with non-causal attention over
image patches.

A strided conv cuts the NHWC image into ``patch``² patches (one token
each, in flax's row-major (h, w) order), a learned ``pos_embed`` (normal
0.02) is added, ``n_layers`` non-causal ``Block``s run with no adapters
and every parameter trained, then a final LayerNorm, the mean over the
tokens and the ``head`` dense. No BatchNorm anywhere, so the model has no
running stats to average. Names follow flax (``patch_embed``,
``pos_embed``, ``Block_i``, ``LayerNorm_0``, ``head``), so
``convert.from_jax_params`` maps the trees one to one.

``attn_fn(q, k, v, causal=...) -> o`` is the attention, dense by default
as in the JAX model; ``models.transformer.flash_attention_out`` runs the
hand-written flash kernels (f32 here: the split-TF32 tensor-core
forward of ``ops/csrc/flash_fwd.cu`` and backward of ``flash_bwd.cu``).
The token count is fixed at construction from ``image_size`` (the JAX
model reads it from its init's input). Dropout after the position
embedding draws its masks from the step's key, as ``models/cnn.py``'s
does.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from fedml_tpu_torch.core import keys
from fedml_tpu_torch.core.device import resolve_device
from fedml_tpu_torch.models.cnn import dropout as key_dropout
from fedml_tpu_torch.models.registry import register_model
from fedml_tpu_torch.models.resnet import Conv
from fedml_tpu_torch.models.transformer import (LN_EPS, Block, _init_base,
                                                _layer_norm, dense_attention)


class ViT(nn.Module):
    """``forward(x [B, H, W, C])`` → logits ``[B, num_classes]``, f32."""

    def __init__(self, num_classes: int, patch: int = 4, d_model: int = 128,
                 n_heads: int = 4, n_layers: int = 4, dropout: float = 0.0,
                 attn_fn: Optional[Callable] = None, image_size: int = 32,
                 in_channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if image_size % patch:
            raise ValueError(f"image {image_size}x{image_size} not divisible "
                             f"by patch size {patch}")
        if d_model % n_heads:
            raise ValueError(f"d_model {d_model} not divisible by n_heads "
                             f"{n_heads}")
        self.patch, self.d_model, self.n_layers = patch, d_model, n_layers
        self.dropout = float(dropout)
        self.takes_rng = self.dropout > 0  # model_fns passes the step's key
        n_tokens = (image_size // patch) ** 2
        self.patch_embed = Conv(in_channels, d_model, patch, patch, 0,
                                generator=generator, bias=True)
        attn_fn = attn_fn if attn_fn is not None else dense_attention
        for i in range(n_layers):
            self.add_module(f"Block_{i}", Block(
                n_heads, d_model, attn_fn, False, None, 0, "attn", 16.0))
        self.LayerNorm_0 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.head = nn.Linear(d_model, num_classes)
        _init_base(self, generator)  # the Dense and LayerNorm inits
        self.pos_embed = nn.Parameter(torch.empty(1, n_tokens, d_model))
        with torch.no_grad():
            self.pos_embed.normal_(0.0, 0.02, generator=generator)

    def forward(self, x, rng=None):
        b, h, w, _ = x.shape
        if h % self.patch or w % self.patch:
            raise ValueError(f"image {h}x{w} not divisible by patch size "
                             f"{self.patch}")
        # One strided conv: a patch per token, (h, w) row-major as flax's
        # reshape of its NHWC output.
        x = self.patch_embed(x.permute(0, 3, 1, 2))
        x = x.permute(0, 2, 3, 1).reshape(b, -1, self.d_model)
        if x.shape[1] != self.pos_embed.shape[1]:
            raise ValueError(f"{x.shape[1]} patches, but the model was built "
                             f"for {self.pos_embed.shape[1]} (image_size)")
        x = x + self.pos_embed
        if self.dropout and self.training:
            if rng is None:
                raise ValueError("ViT dropout in train mode needs the step's "
                                 "key (rng)")
            x = key_dropout(x, self.dropout, keys.fold_in(rng, 0))
        for i in range(self.n_layers):
            x = getattr(self, f"Block_{i}")(x)
        x = _layer_norm(self.LayerNorm_0, x, None)
        return self.head(x.mean(dim=1))


@register_model("vit")
def vit(num_classes: int = 10, patch: int = 4, d_model: int = 128,
        n_heads: int = 4, n_layers: int = 4, dropout: float = 0.0,
        attn_fn: Optional[Callable] = None, image_size: int = 32,
        in_channels: int = 3, device=None,
        generator: Optional[torch.Generator] = None, **_):
    """ViT-Tiny-ish default sized for CIFAR (32x32 / patch 4 → 64 tokens),
    f32, every parameter trainable. Initialised on the CPU from
    ``generator`` and moved to ``device`` (``None`` → cuda)."""
    return ViT(num_classes=num_classes, patch=patch, d_model=d_model,
               n_heads=n_heads, n_layers=n_layers, dropout=dropout,
               attn_fn=attn_fn, image_size=image_size,
               in_channels=in_channels, generator=generator).to(
                   resolve_device(device))
