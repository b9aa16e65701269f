"""Flash-attention forward: a hand-written Hopper kernel and its plain twin.

Source: ``fedml_tpu/ops/flash_attention.py::_fwd_kernel`` (the Pallas TPU
kernel, reached through ``_fwd``). The port computes the same function:
``o = softmax(q·kᵀ/√D [causal-masked]) · v`` with an online softmax in
f32, and returns ``(o, lse)`` with the row log-sum-exp ``lse [B, H, T]``
in f32 (the TPU kernel's 8-row sublane copy of lse is dropped).

The CUDA kernel is ``csrc/flash_fwd.cu``. At the serving shape it is
bound by operations (~2·B·H·T²·D against ~8·B·T·H·D bytes); this first
version runs both products on the FP32 FMA pipes, so its ceiling is the
card's FP32 rate, not the bf16 tensor-core rate — see the note at the top
of the source.

:func:`flash_attention` launches the kernel for CUDA tensors and runs
:func:`flash_attention_plain` for CPU tensors; there is no other route and
no fallback. ``flash_attention.launches`` counts kernel launches.
"""

from __future__ import annotations

import math

import torch

from fedml_tpu_torch.ops.build import extension

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)


def _check(q, k, v):
    if q.dim() != 4:
        raise ValueError(f"q must be [B, T, H, D], got shape {tuple(q.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v shapes differ: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share a dtype in {DTYPES}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"head dim {q.shape[-1]} not supported; "
                         f"expected one of {HEAD_DIMS}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")


def flash_attention_plain(q, k, v, causal: bool = False):
    """Dense twin of the kernel: scores in f32, causal mask at
    ``NEG_INF``, softmax with the ``l > 0`` guard. q/k/v ``[B, T, H, D]``
    → ``(o [B, T, H, D] in q's dtype, lse [B, H, T] f32)``."""
    _check(q, k, v)
    t, d = q.shape[1], q.shape[3]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (
        1.0 / math.sqrt(d))
    if causal:
        keep = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l > 0, l, torch.ones_like(l))
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float()) / l_safe.permute(
        0, 2, 1, 3)
    lse = (m + torch.log(l_safe))[..., 0]
    return o.to(q.dtype), lse


def flash_attention(q, k, v, causal: bool = False):
    """Fused attention forward: q/k/v ``[B, T, H, D]`` (float32 or
    bfloat16, head dim 16/32/64/128, innermost dim contiguous) →
    ``(o [B, T, H, D], lse [B, H, T] f32)``.

    Any T is accepted: the kernel masks the ragged edge itself. The TPU
    version's ``block_q``/``block_k``/``bwd_block_*`` arguments were TPU
    tuning (VMEM block sizes) and are not carried over; the CUDA kernel
    fixes its own tiles. CUDA tensors launch the kernel (and count one
    launch); CPU tensors run :func:`flash_attention_plain`."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, got "
                         f"{q.device}")
    o, lse = extension().flash_fwd(q, k, v, bool(causal))
    flash_attention.launches += 1
    return o, lse


flash_attention.launches = 0
