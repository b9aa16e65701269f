"""Decoder-only transformer LM with per-call LoRA adapters (port of
``fedml_tpu/models/transformer.py``).

The frozen base is an ``nn.Module`` whose submodules keep the flax names
(``Embed_0``, ``Block_i.MHA_0.Dense_0``, …; ``convert.py`` maps the flax
tree onto it). Adapters are not module parameters: they are a plain nested
dict with the flax tree's ``lora_*`` names, passed to ``forward`` on each
call — with ``[d, r]`` leaves (one adapter for the whole batch) or
``[B, d, r]`` leaves (one adapter per row, the serving plane's batch).

Numerics follow flax: LayerNorm eps 1e-6 with statistics in f32 (fast
variance), tanh-approximate GELU, the qkv projection split into three
contiguous ``d_model`` chunks, and with ``dtype=bf16`` every Dense, Embed
and LayerNorm computes in bf16 while the params stay f32; the logits head
computes in f32.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu_torch.core.device import resolve_device
from fedml_tpu_torch.models.registry import register_model, resolve_dtype
from fedml_tpu_torch.ops.flash_attention import flash_attention

#: Which dense projections get a LoRA pair next to them.
ADAPTER_SCOPES = ("attn", "mlp", "all")
LN_EPS = 1e-6


def lora_delta(a, b, x, *, alpha: float, rank: int):
    """``(alpha/rank) * (x @ A) @ B`` for ONE adapter pair, scale last."""
    return (alpha / rank) * ((x @ a) @ b)


def lora_delta_batched(a, b, x, *, alpha: float, rank: int):
    """Per-row twin of :func:`lora_delta`: ``a [B, d, r]``, ``b [B, r, o]``
    applied to ``x [B, ..., d]``; same contraction order, scale last."""
    xa = torch.einsum("b...d,bdr->b...r", x, a)
    return (alpha / rank) * torch.einsum("b...r,bro->b...o", xa, b)


def dense_attention(q, k, v, causal: bool = False):
    """Full-matrix attention over ``[B, T, H, D]`` in the inputs' dtype
    (port of ``fedml_tpu/parallel/ring_attention.py::reference_attention``,
    the dense path as XLA ran it)."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / torch.tensor(
        float(d), dtype=q.dtype).sqrt()
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        keep = torch.ones(tq, tk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def flash_attention_out(q, k, v, causal: bool = False):
    """The flash kernel as an ``attn_fn``: its output without the lse."""
    return flash_attention(q, k, v, causal)[0]


def _dense(layer: nn.Linear, x, dtype):
    """flax ``Dense``: with a compute dtype, input, kernel and bias are
    cast to it; otherwise the math runs in the promoted (f32) type."""
    w, b = layer.weight, layer.bias
    if dtype is not None:
        x, w = x.to(dtype), w.to(dtype)
        b = None if b is None else b.to(dtype)
    return F.linear(x, w, b)


def _layer_norm(ln: nn.LayerNorm, x, dtype):
    """flax ``LayerNorm``: statistics in f32 with var = E[x²] − E[x]²
    (clamped at 0), eps 1e-6, result cast to the compute dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf * xf).mean(dim=-1, keepdim=True) - mu * mu).clamp_min(0.0)
    y = (xf - mu) * (torch.rsqrt(var + LN_EPS) * ln.weight) + ln.bias
    return y if dtype is None else y.to(dtype)


def _lora(ad, site, x, alpha, dtype):
    """The LoRA residual of ``site`` (A and B cast to the compute dtype);
    ``[d, r]`` leaves apply to every row, ``[B, d, r]`` leaves per row."""
    a, b = ad[f"lora_{site}_a"], ad[f"lora_{site}_b"]
    if dtype is not None:
        a, b = a.to(dtype), b.to(dtype)
    fn = lora_delta if a.dim() == 2 else lora_delta_batched
    return fn(a, b, x, alpha=alpha, rank=int(a.shape[-1]))


class MHA(nn.Module):
    def __init__(self, n_heads: int, d_model: int, attn_fn: Callable,
                 causal: bool, dtype, adapter_rank: int,
                 adapter_alpha: float):
        super().__init__()
        self.n_heads, self.d_model = n_heads, d_model
        self.attn_fn, self.causal, self.dtype = attn_fn, causal, dtype
        self.adapter_rank, self.adapter_alpha = adapter_rank, adapter_alpha
        self.Dense_0 = nn.Linear(d_model, 3 * d_model, bias=False)  # qkv
        self.Dense_1 = nn.Linear(d_model, d_model, bias=False)  # out

    def forward(self, x, ad: Optional[dict] = None):
        b, t, _ = x.shape
        use = bool(self.adapter_rank) and ad is not None
        qkv = _dense(self.Dense_0, x, self.dtype)
        if use:
            qkv = qkv + _lora(ad, "qkv", x, self.adapter_alpha, self.dtype)
        shp = (b, t, self.n_heads, self.d_model // self.n_heads)
        q, k, v = (z.reshape(shp) for z in qkv.split(self.d_model, dim=-1))
        o = self.attn_fn(q, k, v, causal=self.causal).reshape(
            b, t, self.d_model)
        out = _dense(self.Dense_1, o, self.dtype)
        if use:
            out = out + _lora(ad, "out", o, self.adapter_alpha, self.dtype)
        return out


class Block(nn.Module):
    def __init__(self, n_heads: int, d_model: int, attn_fn: Callable,
                 causal: bool, dtype, adapter_rank: int, adapter_scope: str,
                 adapter_alpha: float, mlp_ratio: int = 4):
        super().__init__()
        self.dtype, self.adapter_alpha = dtype, adapter_alpha
        self.attn_rank = adapter_rank if adapter_scope in ("attn", "all") else 0
        self.mlp_rank = adapter_rank if adapter_scope in ("mlp", "all") else 0
        self.LayerNorm_0 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.MHA_0 = MHA(n_heads, d_model, attn_fn, causal, dtype,
                         self.attn_rank, adapter_alpha)
        self.LayerNorm_1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.Dense_0 = nn.Linear(d_model, mlp_ratio * d_model)
        self.Dense_1 = nn.Linear(mlp_ratio * d_model, d_model)

    def forward(self, x, ad: Optional[dict] = None):
        h = _layer_norm(self.LayerNorm_0, x, self.dtype)
        x = x + self.MHA_0(h, None if ad is None else ad.get("MHA_0"))
        h = _layer_norm(self.LayerNorm_1, x, self.dtype)
        use = bool(self.mlp_rank) and ad is not None
        up = _dense(self.Dense_0, h, self.dtype)
        if use:
            up = up + _lora(ad, "mlp_in", h, self.adapter_alpha, self.dtype)
        up = F.gelu(up, approximate="tanh")
        down = _dense(self.Dense_1, up, self.dtype)
        if use:
            down = down + _lora(ad, "mlp_out", up, self.adapter_alpha,
                                self.dtype)
        return x + down


class TransformerLM(nn.Module):
    """Pre-LN causal LM; ``forward(tokens [B, T], adapters=None)`` →
    f32 logits ``[B, T, V]``."""

    def __init__(self, vocab_size: int, d_model: int, n_heads: int,
                 n_layers: int, max_len: int, attn_fn: Callable,
                 causal: bool, dtype, adapter_rank: int, adapter_scope: str,
                 adapter_alpha: float):
        super().__init__()
        self.vocab_size, self.d_model = vocab_size, d_model
        self.n_heads, self.n_layers, self.max_len = n_heads, n_layers, max_len
        self.dtype = dtype
        self.adapter_rank, self.adapter_scope = adapter_rank, adapter_scope
        self.adapter_alpha = adapter_alpha
        self.Embed_0 = nn.Embedding(vocab_size, d_model)  # tokens
        self.Embed_1 = nn.Embedding(max_len, d_model)  # positions
        for i in range(n_layers):
            self.add_module(f"Block_{i}", Block(
                n_heads, d_model, attn_fn, causal, dtype, adapter_rank,
                adapter_scope, adapter_alpha))
        self.LayerNorm_0 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.Dense_0 = nn.Linear(d_model, vocab_size, bias=False)  # head

    def blocks(self):
        return [getattr(self, f"Block_{i}") for i in range(self.n_layers)]

    def forward(self, tokens, adapters: Optional[dict] = None):
        if adapters is not None and not self.adapter_rank:
            raise ValueError("adapters passed to a model built with "
                             "adapter_rank=0")
        t = tokens.shape[1]
        emb, pos = self.Embed_0.weight, self.Embed_1.weight[:t]
        if self.dtype is not None:
            emb, pos = emb.to(self.dtype), pos.to(self.dtype)
        x = F.embedding(tokens, emb) + pos[None]
        for i, block in enumerate(self.blocks()):
            x = block(x, None if adapters is None
                      else adapters.get(f"Block_{i}"))
        x = _layer_norm(self.LayerNorm_0, x, self.dtype)
        return F.linear(x.float(), self.Dense_0.weight)

    # -- adapters ----------------------------------------------------------

    def adapter_shapes(self) -> dict:
        """The adapter tree's leaf shapes, nested as flax nests them."""
        r, d = self.adapter_rank, self.d_model
        out = {}
        for i, block in enumerate(self.blocks()):
            node = {}
            if block.attn_rank:
                node["MHA_0"] = {"lora_qkv_a": (d, r), "lora_qkv_b": (r, 3 * d),
                                 "lora_out_a": (d, r), "lora_out_b": (r, d)}
            if block.mlp_rank:
                node.update({"lora_mlp_in_a": (d, r),
                             "lora_mlp_in_b": (r, 4 * d),
                             "lora_mlp_out_a": (4 * d, r),
                             "lora_mlp_out_b": (r, d)})
            out[f"Block_{i}"] = node
        return out

    def init_adapters(self, generator: Optional[torch.Generator] = None):
        """flax's LoRA init: A ~ N(0, 0.02), B = 0, so the adapted model
        starts exactly at the base. f32 leaves on the model's device."""
        dev = self.Embed_0.weight.device

        def make(tree):
            out = {}
            for key, val in tree.items():
                if isinstance(val, dict):
                    out[key] = make(val)
                elif key.endswith("_a"):
                    out[key] = torch.empty(val).normal_(
                        0.0, 0.02, generator=generator).to(dev)
                else:
                    out[key] = torch.zeros(val, device=dev)
            return out

        return make(self.adapter_shapes())


def _init_base(model: TransformerLM, generator: Optional[torch.Generator]):
    """flax's default inits: Dense kernels lecun-normal (truncated at two
    standard deviations), biases 0, Embed N(0, 1/d), LayerNorm 1 and 0."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Linear):
                std = math.sqrt(1.0 / mod.weight.shape[1]) / .87962566103423978
                nn.init.trunc_normal_(mod.weight, 0.0, std, -2 * std, 2 * std,
                                      generator=generator)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                nn.init.normal_(mod.weight, 0.0,
                                math.sqrt(1.0 / mod.weight.shape[1]),
                                generator=generator)
            elif isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()


@register_model("transformer_lm")
def transformer_lm(vocab_size: int = 90, d_model: int = 128, n_heads: int = 4,
                   n_layers: int = 2, max_len: int = 2048,
                   attn_fn: Optional[Callable] = None, causal: bool = True,
                   attn: str = "dense", dtype=None, adapter_rank: int = 0,
                   adapter_scope: str = "attn", adapter_alpha: float = 16.0,
                   device=None, generator: Optional[torch.Generator] = None):
    """``attn="flash"`` runs the hand-written flash kernel
    (fedml_tpu_torch.ops.flash_attention) in every block; ``"dense"`` the
    full-matrix attention. ``attn_fn(q, k, v, causal=...) -> o`` overrides
    both. The base is initialised on the CPU from ``generator`` and moved
    to ``device`` (``None`` → cuda), frozen (no grad) and in eval mode."""
    if attn_fn is None:
        if attn == "flash":
            attn_fn = flash_attention_out
        elif attn == "dense":
            attn_fn = dense_attention
        else:
            raise ValueError(f"unknown attn {attn!r}: expected dense|flash")
    if adapter_rank and adapter_scope not in ADAPTER_SCOPES:
        raise ValueError(f"unknown adapter_scope {adapter_scope!r}: expected "
                         f"one of {ADAPTER_SCOPES}")
    if adapter_rank < 0:
        raise ValueError(f"adapter_rank must be >= 0, got {adapter_rank}")
    if d_model % n_heads:
        raise ValueError(f"d_model {d_model} not divisible by n_heads "
                         f"{n_heads}")
    dev = resolve_device(device)
    model = TransformerLM(vocab_size, d_model, n_heads, n_layers, max_len,
                          attn_fn, causal, resolve_dtype(dtype),
                          int(adapter_rank), adapter_scope,
                          float(adapter_alpha))
    _init_base(model, generator)
    return model.to(dev).requires_grad_(False).eval()
