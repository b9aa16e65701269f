"""Flash attention, forward and backward: hand-written Hopper kernels and
their plain twins, wired into autograd and ``torch.func.vmap``.

Source: ``fedml_tpu/ops/flash_attention.py`` — ``_fwd_kernel`` (reached
through ``_fwd``), ``_dq_kernel`` and ``_dkv_kernel`` (through ``_bwd``),
the Pallas TPU kernels under the ``jax.custom_vjp`` of the public
``flash_attention``. The port computes the same functions:
``o = softmax(q·kᵀ/√D [causal-masked]) · v`` with an online softmax in f32
and the row log-sum-exp ``lse [B, H, T]`` f32 (the TPU kernel's 8-row
sublane copy of lse is dropped); the backward recomputes
``P = exp(S − lse)`` and gives ``dq = scale·dS·K``, ``dk = scale·dSᵀ·Q``,
``dv = Pᵀ·dO`` with ``dS = P∘(dO·Vᵀ − δ)`` and ``δ = rowsum(dO∘O)``, which
is computed here with torch ops in f32, as ``_bwd`` computes it outside
its kernels.

The CUDA kernels for bf16 run on the tensor cores with ``wgmma`` and TMA:
``csrc/flash_fwd_sm90.cu`` (the forward) and ``csrc/flash_bwd_sm90.cu``
(dq and dk/dv). f32 runs on the FP32 pipes with FMA, since the tensor
cores have no full-f32 product: ``csrc/flash_fwd.cu`` and
``csrc/flash_bwd.cu``. Each route is chosen by dtype alone. The kernels
read q, k, v (and dO) as
``[R, B, T, H, D]`` at any stride with D at stride 1, so MHA's views of
one qkv buffer need no copy; the tensor-core kernels also need every base
and stride a multiple of 16 bytes, as TMA reads them. R is 1 for a plain
call; under ``vmap`` the client dim becomes R, so one launch serves every
client. All are bound by operations — see the notes at the top of the
sources.

Routes: the ops ``fedml_tpu_torch::flash_fwd``/``flash_bwd`` run the
kernels for CUDA tensors and the plain twins (:func:`flash_attention_plain`,
:func:`flash_attention_bwd_plain`) for CPU tensors; there is no other route
and no fallback. ``flash_attention.launches``,
``flash_attention_bwd.dq_launches`` and ``flash_attention_bwd.dkv_launches``
count kernel launches (the backward's counts take both routes);
``flash_attention.copies`` counts every copy made on the way to any of the
kernels: a dO whose head dim is not at stride 1, a client dim that no view
can fold into R, or a bf16 operand whose base or strides TMA cannot take.
The counters are registered with ``core/graph.py``, so a replayed CUDA
graph of a step counts the launches that it replays. The tensor-core
kernels' TMA descriptors are encoded on the host at each call and passed
by value, so a captured launch keeps the addresses it was captured with:
the graph's static buffers and private pool never move.
"""

from __future__ import annotations

import math

import torch
from torch.utils.flop_counter import register_flop_formula

from fedml_tpu_torch.core.graph import launch_counter
from fedml_tpu_torch.ops.build import extension

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
_OP = "fedml_tpu_torch::"


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


def _check_bwd(q, k, v, o, lse, do):
    _check(q, k, v)
    b, t, h, _ = q.shape
    for name, x in (("o", o), ("do", do)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} {x.dtype} {tuple(x.shape)} must match "
                             f"q {q.dtype} {tuple(q.shape)} on {q.device}")
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (b, h, t)
            or lse.device != q.device):
        raise ValueError(f"lse must be float32 [{b}, {h}, {t}], got "
                         f"{lse.dtype} {tuple(lse.shape)}")


def _causal_keep(t, device):
    return torch.ones(t, t, dtype=torch.bool, device=device).tril()


# --- plain twins ------------------------------------------------------------

def flash_attention_plain(q, k, v, causal: bool = False):
    """Dense twin of the forward kernel: scores in f32, causal mask at
    ``NEG_INF``, softmax with the ``l > 0`` guard. q/k/v ``[B, T, H, D]``
    → ``(o [B, T, H, D] in q's dtype, lse [B, H, T] f32)``."""
    _check(q, k, v)
    t, d = q.shape[1], q.shape[3]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (
        1.0 / math.sqrt(d))
    if causal:
        s = s.masked_fill(~_causal_keep(t, q.device), NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l > 0, l, torch.ones_like(l))
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.float()) / l_safe.permute(
        0, 2, 1, 3)
    lse = (m + torch.log(l_safe))[..., 0]
    return o.to(q.dtype), lse


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal: bool = False):
    """Dense f32 twin of the backward kernels (the same formulas without
    the kernels' roundings of dS and P to the input type): ``[B, T, H, D]``
    q, k, v, o, do and ``lse [B, H, T]`` → ``(dq, dk, dv)`` in the input
    dtype."""
    _check_bwd(q, k, v, o, lse, do)
    t, d = q.shape[1], q.shape[3]
    scale = 1.0 / math.sqrt(d)
    q32, k32, v32, do32 = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", q32, k32) * scale
    if causal:
        s = s.masked_fill(~_causal_keep(t, q.device), NEG_INF)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do32, v32)
    delta = (do32 * o.float()).sum(-1).transpose(1, 2)  # [B, H, T]
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k32) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q32) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do32)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# --- kernel launches ([R, B, T, H, D] operands on a CUDA device) -------------

def _head_dim_contiguous(t):
    """The kernels read D at stride 1; anything else is copied once and
    counted."""
    if t.stride(-1) == 1:
        return t
    flash_attention.copies += 1
    return t.contiguous()


def _tma_ready(t):
    """The tensor-core kernels read bf16 operands by TMA, which takes a base
    and (r, b, t, h) strides that are multiples of 16 bytes; any other
    operand is copied once (into a fresh, aligned buffer) and counted."""
    if t.data_ptr() % 16 == 0 and all(
            n == 1 or (s > 0 and s * t.element_size() % 16 == 0)
            for n, s in zip(t.shape[:4], t.stride()[:4])):
        return t
    flash_attention.copies += 1
    return t.clone(memory_format=torch.contiguous_format)


def _launch_fwd(q, k, v, causal: bool):
    """The forward kernel by dtype alone: bf16 operands reach the
    tensor-core kernel (``flash_fwd_sm90.cu``), f32 operands the FMA kernel
    (``flash_fwd.cu``)."""
    ext = extension()
    if q.dtype == torch.bfloat16:
        q, k, v = (_tma_ready(t) for t in (q, k, v))
        fwd_fn = ext.flash_fwd_sm90
    else:
        fwd_fn = ext.flash_fwd
    o, lse = fwd_fn(q, k, v, bool(causal))
    flash_attention.launches += 1
    return o, lse


def _launch_bwd(q, k, v, o, lse, do, causal: bool):
    """δ in f32 with torch ops, then the dq kernel and the dk/dv kernel:
    bf16 operands reach the tensor-core kernels (``flash_bwd_sm90.cu``),
    f32 operands the FMA kernels (``flash_bwd.cu``), by dtype alone."""
    ext = extension()
    do = _head_dim_contiguous(do)
    if not lse.is_contiguous():
        flash_attention.copies += 1
        lse = lse.contiguous()
    delta = (do.float() * o.float()).sum(-1).transpose(-1, -2).contiguous()
    if q.dtype == torch.bfloat16:
        q, k, v, do = (_tma_ready(t) for t in (q, k, v, do))
        dq_fn, dkv_fn = ext.flash_dq_sm90, ext.flash_dkv_sm90
    else:
        dq_fn, dkv_fn = ext.flash_dq, ext.flash_dkv
    dq = dq_fn(q, k, v, do, lse, delta, bool(causal))
    flash_attention_bwd.dq_launches += 1
    dk, dv = dkv_fn(q, k, v, do, lse, delta, bool(causal))
    flash_attention_bwd.dkv_launches += 1
    return dq, dk, dv


# --- the ops: device dispatch, autograd, vmap --------------------------------

def _flat(t):
    return t.reshape(-1, *t.shape[2:])


@torch.library.custom_op(_OP + "flash_fwd", mutates_args=())
def _fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on cuda or cpu, got "
                         f"{q.device}")
    o, lse = flash_attention_plain(_flat(q), _flat(k), _flat(v), causal)
    return o.view(q.shape), lse.view(*q.shape[:2], *lse.shape[1:])


@torch.library.custom_op(_OP + "flash_bwd", mutates_args=())
def _bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
            causal: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention runs on cuda or cpu, got "
                         f"{q.device}")
    grads = flash_attention_bwd_plain(_flat(q), _flat(k), _flat(v), _flat(o),
                                      _flat(lse), _flat(do), causal)
    return tuple(g.view(q.shape) for g in grads)


_fwd_op.register_kernel("cuda")(_launch_fwd)
_bwd_op.register_kernel("cuda")(_launch_bwd)


@_fwd_op.register_fake
def _(q, k, v, causal):
    r, b, t, h, _ = q.shape
    return torch.empty_like(q), q.new_empty((r, b, h, t), dtype=torch.float32)


@_bwd_op.register_fake
def _(q, k, v, o, lse, do, causal):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


@register_flop_formula(torch.ops.fedml_tpu_torch.flash_fwd)
def _fwd_flops(q, k, v, causal, out_shape=None, **_) -> int:
    """The forward's two products, ``S = q·kᵀ`` and ``o = P·v``, over the
    full ``T_q × T_k`` square (what ``FlopCounterMode`` counts for SDPA;
    a causal call does about half of it), so ``obs.flops.model_cost``
    counts the kernel."""
    r, b, t_q, h, d = q
    return 4 * r * b * h * t_q * k[2] * d


class _FlashAttention(torch.autograd.Function):
    """The gradient of the forward op is the backward op, as in
    ``ops/group_norm.py``: an ``autograd.Function`` with ``setup_context``
    (``torch.func.grad`` refuses the one that ``register_autograd``
    generates) whose ``generate_vmap_rule`` reaches the ops' vmap rules
    below, so a vmapped step launches each kernel once for every client.
    lse is an output (the backward needs it) that carries no gradient."""

    generate_vmap_rule = True

    @staticmethod
    def forward(q, k, v, causal):
        return _fwd_op(q, k, v, causal)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal = inputs
        o, lse = output
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mark_non_differentiable(lse)
        ctx.causal = causal

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        with torch.no_grad():  # once differentiable: no double backward
            dq, dk, dv = _bwd_op(q, k, v, o, lse, do, ctx.causal)
        return dq, dk, dv, None


def _fold(t, bdim, size):
    """A batched operand ``[..., R, rest]`` with its vmap dim moved to the
    front and folded into R: ``[C·R, rest]``. Unbatched operands are
    broadcast (a stride-0 view; the kernels read any stride). A fold that
    no view can express is copied once and counted."""
    if bdim is None:
        t = t.unsqueeze(0).expand(size, *t.shape)
    else:
        t = t.movedim(bdim, 0)
    shape = (-1, *t.shape[2:])
    try:
        return t.view(shape)
    except RuntimeError:
        flash_attention.copies += 1
        return t.reshape(shape)


def _unfold(t, size):
    return t.unflatten(0, (size, t.shape[0] // size))


@_fwd_op.register_vmap
def _(info, in_dims, q, k, v, causal):
    c = info.batch_size
    o, lse = _fwd_op(*(_fold(x, d, c) for x, d in zip((q, k, v), in_dims)),
                     causal)
    return (_unfold(o, c), _unfold(lse, c)), (0, 0)


@_bwd_op.register_vmap
def _(info, in_dims, q, k, v, o, lse, do, causal):
    c = info.batch_size
    grads = _bwd_op(*(_fold(x, d, c)
                      for x, d in zip((q, k, v, o, lse, do), in_dims)),
                    causal)
    return tuple(_unfold(g, c) for g in grads), (0, 0, 0)


# --- public functions --------------------------------------------------------

def flash_attention(q, k, v, causal: bool = False):
    """Fused attention: q/k/v ``[B, T, H, D]`` (float32 or bfloat16, head
    dim 16/32/64/128, innermost dim contiguous) → ``(o [B, T, H, D],
    lse [B, H, T] f32)``. Differentiable in q, k, v (lse carries no
    gradient), and batched by ``torch.func.vmap`` into one launch.

    Any T is accepted: the kernels mask the ragged edge themselves. The
    TPU version's ``block_q``/``block_k``/``bwd_block_*`` arguments were
    TPU tuning (VMEM block sizes) and are not carried over; the CUDA
    kernels fix their own tiles. CUDA tensors launch the kernel (and count
    one launch): in bf16 the tensor-core ``flash_fwd_sm90_kernel``, in f32
    the FMA ``flash_fwd_kernel``. CPU tensors run
    :func:`flash_attention_plain`."""
    _check(q, k, v)
    o, lse = _FlashAttention.apply(q[None], k[None], v[None], bool(causal))
    return o[0], lse[0]


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = False):
    """The backward of :func:`flash_attention` from its saved forward, as
    JAX's ``_bwd`` takes it (ring attention merges per-block results with
    log-sum-exp algebra): ``[B, T, H, D]`` q, k, v, o, do and
    ``lse [B, H, T]`` → ``(dq, dk, dv)``. CUDA tensors launch the dq and
    the dk/dv kernel (one count each): in bf16 the tensor-core kernels
    ``flash_dq_sm90_kernel`` and ``flash_dkv_sm90_kernel``, in f32 the FMA
    kernels ``flash_dq_kernel`` and ``flash_dkv_kernel``. CPU tensors run
    :func:`flash_attention_bwd_plain`."""
    _check_bwd(q, k, v, o, lse, do)
    grads = _bwd_op(q[None], k[None], v[None], o[None], lse[None], do[None],
                    bool(causal))
    return tuple(g[0] for g in grads)


launch_counter(flash_attention, "launches", "copies")
launch_counter(flash_attention_bwd, "dq_launches", "dkv_launches")
