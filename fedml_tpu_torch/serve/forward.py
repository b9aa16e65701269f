"""Batched multi-adapter inference over one frozen base (port of
``fedml_tpu/serve/forward.py``).

Every request belongs to a different personalized model (a LoRA row of a
:class:`~fedml_tpu_torch.models.adapter.PersonalAdapterStore`), but the
frozen base is shared: ``B`` requests ride one forward, the base matmuls
run against one weight and the per-row LoRA pairs contract per row
(``lora_delta_batched``). JAX's ``jit(vmap(row))`` is here a written-out
batch dimension.

:class:`AdapterDecoder` is the KV-cached greedy decode over the same base
and adapters: the prompt runs once and fills the cache, each step is a
single-position forward reading it. Like the JAX decoder it evaluates the
raw f32 params with an f32 cache whatever the model's compute dtype, and
its attention is dense. Full-sequence attention follows
:func:`pick_attention`: the flash kernel from ``T >= 2048``, dense below.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from fedml_tpu_torch.core.device import resolve_device
from fedml_tpu_torch.core.flat import (stacked_tree_of, tree_spec,
                                       vector_to_tree_np)
from fedml_tpu_torch.models.transformer import lora_delta_batched

#: The flash-vs-dense crossover the JAX package measured on its TPU sweep;
#: kept as the switch point so the port serves the same configurations.
FLASH_CROSSOVER_T = 2048


def pick_attention(seq_len: int, crossover: int = FLASH_CROSSOVER_T) -> str:
    """``attn=`` for a serving model at this sequence length: ``"flash"``
    from the crossover on, ``"dense"`` below it."""
    return "flash" if int(seq_len) >= int(crossover) else "dense"


def _tokens(tokens, device) -> torch.Tensor:
    if isinstance(tokens, torch.Tensor):
        return tokens.to(device=device, dtype=torch.long)
    return torch.as_tensor(np.asarray(tokens, np.int64), device=device)


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


def _check_device(model, device) -> torch.device:
    dev = resolve_device(device)
    have = _model_device(model)
    if have.type != dev.type:
        raise ValueError(f"the model lives on {have}, not on {dev}")
    return have


class ServeForward:
    """The batched multi-adapter forward over one frozen base.

    ``fns`` is the :class:`~fedml_tpu_torch.models.adapter.AdapterFns`
    holding the base; ``template_adapters`` fixes the adapter tree (and the
    flat dim store rows must match). ``batched(stacked, tokens)`` is the
    serving path; ``sequential(adapters, tokens_row)`` the per-request
    baseline. ``device=None`` means cuda; the model must live there."""

    def __init__(self, fns, template_adapters, *, device=None):
        self.fns = fns
        self.device = _check_device(fns.holder["base"], device)
        self.spec = tree_spec(template_adapters)
        self.dim = int(sum(self.spec.sizes))

    def batched(self, stacked, tokens):
        """``[B, ...]``-stacked adapters + ``[B, T]`` tokens → ``[B, T, V]``
        f32 logits on the device, in one forward."""
        return self.fns.apply(stacked, _tokens(tokens, self.device))

    def sequential(self, adapters, tokens_row):
        """One adapter tree + ``[T]`` tokens → ``[T, V]``."""
        return self.fns.apply(adapters,
                              _tokens(tokens_row, self.device)[None])[0]

    def stacked_tree(self, vecs):
        """``[B, D]`` store rows → the batched forward's adapter input."""
        return stacked_tree_of(vecs, self.spec, self.device)

    def prefill(self, vecs, tokens):
        """``B`` requests in one forward: ``[B, D]`` rows + ``[B, T]`` ints
        → ``[B, T, V]`` f32 logits."""
        return self.batched(self.stacked_tree(vecs), tokens)

    def prefill_sequential(self, vecs, tokens):
        """The one-adapter-at-a-time baseline: one forward PER ROW."""
        tokens = np.asarray(tokens, np.int64)
        out = []
        for i in range(tokens.shape[0]):
            tree = vector_to_tree_np(np.asarray(vecs[i], np.float32),
                                     self.spec)
            tree = _to_device_tree(tree, self.device)
            out.append(self.sequential(tree, tokens[i]))
        return torch.stack(out)


def _to_device_tree(tree, device):
    return {k: _to_device_tree(v, device) if isinstance(v, dict)
            else torch.as_tensor(v, device=device) for k, v in tree.items()}


class _DecodeCache(NamedTuple):
    """Per-layer KV cache: ``k``/``v`` ``[L, B, T_max, H, Dh]`` f32;
    ``pos`` the per-row ``[B]`` count of filled positions."""

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor


def _layer_norm(x, ln):
    """The JAX decoder's LayerNorm: eps 1e-6, var = E[(x − μ)²]."""
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * ln.weight + ln.bias


class AdapterDecoder:
    """KV-cached greedy decode over base + per-row adapters.

    Same math as the model (pre-LN blocks, causal attention at
    ``1/sqrt(d_head)``, tanh GELU, f32 logits head) evaluated on the f32
    params, with the per-row LoRA residuals through
    :func:`~fedml_tpu_torch.models.transformer.lora_delta_batched`. The
    cache is updated in place (JAX returned a new one)."""

    def __init__(self, model, fns, template_adapters, *,
                 max_len: Optional[int] = None, device=None):
        self.model = model
        self.fns = fns
        self.device = _check_device(model, device)
        self.spec = tree_spec(template_adapters)
        self.n_heads = int(model.n_heads)
        self.n_layers = int(model.n_layers)
        self.d_model = int(model.d_model)
        self.alpha = float(model.adapter_alpha)
        self.max_len = int(max_len or model.max_len)
        if self.max_len > model.max_len:
            raise ValueError(f"max_len {self.max_len} exceeds the model's "
                             f"position table ({model.max_len})")

    def _delta(self, ad, site, x):
        a = ad.get(f"lora_{site}_a")
        if a is None:
            return None
        return lora_delta_batched(a, ad[f"lora_{site}_b"], x,
                                  alpha=self.alpha, rank=int(a.shape[-1]))

    def _block(self, blk, ad, x, ck, cv, pos):
        """One pre-LN block over ``x [B, S, d]``; writes this step's keys
        and values into ``ck``/``cv`` ``[B, T, H, Dh]`` at the per-row
        offsets ``pos``."""
        ad = ad or {}
        h = _layer_norm(x, blk.LayerNorm_0)
        mha, mad = blk.MHA_0, ad.get("MHA_0", {})
        qkv = F.linear(h, mha.Dense_0.weight)
        d = self._delta(mad, "qkv", h)
        if d is not None:
            qkv = qkv + d
        bsz, s, _ = qkv.shape
        hd = self.d_model // self.n_heads
        shp = (bsz, s, self.n_heads, hd)
        q, k, v = (z.reshape(shp) for z in qkv.split(self.d_model, dim=-1))
        qpos = pos[:, None] + torch.arange(s, device=pos.device)[None, :]
        rows = torch.arange(bsz, device=pos.device)[:, None]
        ck[rows, qpos] = k
        cv[rows, qpos] = v
        scores = torch.einsum("bqhd,bkhd->bhqk", q, ck) / math.sqrt(hd)
        # Causal over absolute per-row positions: row b's query i sits at
        # pos[b]+i and sees key j iff j <= pos[b]+i (unfilled slots and a
        # short row's stale pad slots lie beyond it).
        keep = (torch.arange(ck.shape[1], device=pos.device)[None, None, :]
                <= qpos[:, :, None])
        scores = scores.masked_fill(~keep[:, None], float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", probs, cv).reshape(
            bsz, s, self.d_model)
        out = F.linear(o, mha.Dense_1.weight)
        d = self._delta(mad, "out", o)
        if d is not None:
            out = out + d
        x = x + out
        h = _layer_norm(x, blk.LayerNorm_1)
        up = F.linear(h, blk.Dense_0.weight, blk.Dense_0.bias)
        d = self._delta(ad, "mlp_in", h)
        if d is not None:
            up = up + d
        up = F.gelu(up, approximate="tanh")
        down = F.linear(up, blk.Dense_1.weight, blk.Dense_1.bias)
        d = self._delta(ad, "mlp_out", up)
        if d is not None:
            down = down + d
        return x + down

    def _run(self, stacked, tokens, cache):
        """``tokens [B, S]`` at the per-row ``cache.pos``: prompt prefill
        and single-token decode are the same code at different ``S``.
        Returns ``(logits [B, S, V], cache')``."""
        m = self.fns.holder["base"]
        steps = tokens.shape[1]
        pos = cache.pos
        x = (m.Embed_0.weight[tokens]
             + m.Embed_1.weight[pos[:, None]
                                + torch.arange(steps, device=pos.device)])
        for li, blk in enumerate(m.blocks()):
            x = self._block(blk, stacked.get(f"Block_{li}"), x,
                            cache.k[li], cache.v[li], pos)
        x = _layer_norm(x, m.LayerNorm_0)
        logits = F.linear(x, m.Dense_0.weight).float()
        return logits, cache._replace(pos=pos + steps)

    @torch.inference_mode()
    def empty_cache(self, batch: int, max_len: Optional[int] = None):
        t = int(max_len or self.max_len)
        hd = self.d_model // self.n_heads
        shape = (self.n_layers, batch, t, self.n_heads, hd)
        return _DecodeCache(
            torch.zeros(shape, dtype=torch.float32, device=self.device),
            torch.zeros(shape, dtype=torch.float32, device=self.device),
            torch.zeros(batch, dtype=torch.long, device=self.device))

    @torch.inference_mode()
    def prefill(self, stacked, tokens, lens=None,
                max_len: Optional[int] = None):
        """Prompt pass: ``[B, T0]`` tokens → the logits at each row's true
        last position ``[B, V]`` + the filled cache. ``lens [B]`` gives
        per-row prompt lengths of a right-padded batch: logits come from
        ``lens-1`` and the cache's write offsets rewind to ``lens``, so
        decode overwrites a short row's pad slots before its mask reaches
        them. ``lens=None`` means every row is full length."""
        tokens = _tokens(tokens, self.device)
        cache = self.empty_cache(tokens.shape[0], max_len)
        if tokens.shape[1] > cache.k.shape[2]:
            raise ValueError(f"prompt of {tokens.shape[1]} tokens exceeds "
                             f"the cache ({cache.k.shape[2]})")
        logits, cache = self._run(stacked, tokens, cache)
        if lens is None:
            return logits[:, -1], cache
        lens = _tokens(lens, self.device)
        rows = torch.arange(tokens.shape[0], device=self.device)
        return logits[rows, lens - 1], cache._replace(pos=lens)

    @torch.inference_mode()
    def step(self, stacked, token, cache):
        """One decode position: ``[B]`` tokens → ``[B, V]`` logits."""
        if int(cache.pos.max()) >= cache.k.shape[2]:
            raise ValueError("decode past the cache's max_len")
        logits, cache = self._run(stacked, token[:, None], cache)
        return logits[:, 0], cache

    @torch.inference_mode()
    def generate(self, stacked, tokens, n_new: int, lens=None):
        """Greedy decode ``n_new`` tokens per row (``lens`` as in
        :meth:`prefill`). Returns ``[B, n_new]`` int32 on the device."""
        logits, cache = self.prefill(stacked, tokens, lens=lens)
        out = []
        for _ in range(int(n_new)):
            nxt = torch.argmax(logits, dim=-1)
            out.append(nxt)
            logits, cache = self.step(stacked, nxt, cache)
        if not out:
            return torch.zeros((logits.shape[0], 0), dtype=torch.int32,
                               device=self.device)
        return torch.stack(out, dim=1).to(torch.int32)
