"""GroupNorm forward and backward: hand-written Hopper kernels and their
plain twins, wired into autograd and ``torch.func.vmap``.

Source: ``fedml_tpu/ops/group_norm.py`` — ``_fwd_kernel`` (reached through
``_fwd``) and ``_bwd_kernel`` (through ``_bwd``), the Pallas TPU kernels
under the ``jax.custom_vjp`` of the public ``group_norm``. The port
computes the same functions: per sample and group, f32 mean and
``var = max(E[x²] − μ², 0)``; ``y = (x − μ)·rsqrt(var + eps)·γ + β`` in
x's type; the backward recomputes the statistics and gives
``dx = rstd·(dxhat − mean_g(dxhat) − xhat·mean_g(dxhat·xhat))`` with
``dxhat = dy·γ``, ``dγ = Σ dy·xhat`` and ``dβ = Σ dy``.

The kernels are ``csrc/group_norm.cu``. They work on ``x [R, M, S, C]``:
R rows of γ/β (``[R, C]`` f32), M samples per row, S positions and C
channels, C contiguous and the other three dims at any stride. R is 1 for
a plain call; under ``vmap`` the client dim becomes R, so one launch
normalizes every client with its own γ/β. Both kernels hold each sample in
the shared memory of a thread-block cluster of up to 8 blocks, which sum
the statistics together through distributed shared memory, so the forward
reads x once and the backward x and dy once. A sample whose x is more than
8 blocks hold (FedSeg's U-Net at 256²) takes the streamed route: a cluster
of 16 blocks, one to an SM, where the card schedules it (else 8), each
holding as many of its rows as fit and reading the rest from device memory
in each pass; the backward keeps x first, then what fits of dy (the same
formulas; ``csrc/group_norm.cu`` says how the rows are dealt and read). The
backward writes per-sample f32 partials of dγ/dβ and a second kernel sums
them per row in a fixed order (no atomics: a rerun gives the same bits).

Routes: the ops ``fedml_tpu_torch::group_norm_fwd``/``group_norm_bwd``
run the kernels for CUDA tensors and the plain twins
(:func:`group_norm_fwd_plain`, :func:`group_norm_bwd_plain`) for CPU
tensors; there is no other route and no fallback. ``group_norm_fwd
.launches``, ``group_norm_bwd.launches`` and ``group_norm_bwd
.reduce_launches`` count kernel launches, and ``group_norm_fwd.streamed``
and ``group_norm_bwd.streamed`` the launches that took the streamed route
(chosen by shape before the launch, never on an error; a plan that finds no
cluster raises, as a failed launch does); ``group_norm.copies``
counts every copy of an operand on the way to the kernels: an input whose
channel dim was not contiguous, or whose dims could not be merged or
folded as a view. The counters are registered with ``core/graph.py``, so a
replayed CUDA graph of a step counts the launches that it replays.
"""

from __future__ import annotations

import math

import torch
from torch.utils.flop_counter import register_flop_formula

from fedml_tpu_torch.core.graph import launch_counter
from fedml_tpu_torch.ops.build import extension

EPS = 1e-6
DTYPES = (torch.float32, torch.bfloat16)
MAX_CHANNELS = 4096
_OP = "fedml_tpu_torch::"


def _param_dtype(x):
    """The dtype of γ/β and of the statistics: f32, or f64 for an f64 x,
    which only the plain twins take (the tests' ``gradgradcheck``)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _check(x, gamma, groups, what):
    if x.dim() != 4:
        raise ValueError(f"{what}: x must be [R, M, S, C], got shape "
                         f"{tuple(x.shape)}")
    r, _, _, c = x.shape
    dtypes = DTYPES + ((torch.float64,) if x.device.type == "cpu" else ())
    if x.dtype not in dtypes:
        raise ValueError(f"{what}: dtype must be one of {dtypes}, got "
                         f"{x.dtype}")
    pdt = _param_dtype(x)
    if gamma.dtype != pdt or tuple(gamma.shape) != (r, c):
        raise ValueError(f"{what}: gamma/beta must be {pdt} [{r}, {c}], "
                         f"got {gamma.dtype} {tuple(gamma.shape)}")
    if groups <= 0 or c % groups:
        raise ValueError(f"{what}: groups {groups} must divide channels {c}")
    if c > MAX_CHANNELS:
        raise ValueError(f"{what}: at most {MAX_CHANNELS} channels, got {c}")
    if gamma.device != x.device:
        raise ValueError(f"{what}: x and gamma are on different devices")


def _channels_innermost(t):
    """The kernels read C at stride 1 and every other dim at any stride;
    anything else is copied once and counted."""
    if t.stride(-1) == 1 or t.shape[-1] == 1:
        return t
    group_norm.copies += 1
    return t.contiguous()


def _view(t, shape):
    """``t`` viewed as ``shape``; a layout that no view can express is
    copied once and counted, so ``group_norm.copies`` sees every copy made
    on the way to the kernels (under ``vmap`` the view is taken of the
    physical, batched tensor)."""
    try:
        return t.view(shape)
    except RuntimeError:
        group_norm.copies += 1
        return t.reshape(shape)


# --- plain twins ------------------------------------------------------------

def _stats(x32, groups, eps):
    """Per-(row, sample, group) mean and rstd in x32's dtype (f32 for the
    kernels' types), broadcast back to ``[R, M, 1, C]`` (each channel
    carries its group's stats)."""
    r, m, s, c = x32.shape
    xg = x32.reshape(r, m, s, groups, c // groups)
    denom = s * (c // groups)
    mu = xg.sum(dim=(2, 4), keepdim=True) / denom
    ex2 = (xg * xg).sum(dim=(2, 4), keepdim=True) / denom
    rstd = torch.rsqrt(torch.clamp(ex2 - mu * mu, min=0.0) + eps)
    cpg = c // groups
    return (mu.expand(r, m, 1, groups, cpg).reshape(r, m, 1, c),
            rstd.expand(r, m, 1, groups, cpg).reshape(r, m, 1, c))


def group_norm_fwd_plain(x, gamma, beta, groups: int, eps: float = EPS):
    """Plain twin of the forward kernel: ``x [R, M, S, C]``, ``gamma``/
    ``beta [R, C]`` f32 → y in x's dtype."""
    _check(x, gamma, groups, "group_norm_fwd")
    x32 = x.to(_param_dtype(x))
    mu, rstd = _stats(x32, groups, eps)
    y = (x32 - mu) * rstd
    y = y * gamma[:, None, None, :] + beta[:, None, None, :]
    return y.to(x.dtype)


def group_norm_bwd_plain(x, dy, gamma, groups: int, eps: float = EPS):
    """Plain twin of the backward kernels: ``(dx in x's dtype, dγ [R, C]
    f32, dβ [R, C] f32)``, dγ/dβ summed over each row's M samples."""
    _check(x, gamma, groups, "group_norm_bwd")
    r, m, s, c = x.shape
    x32, dy32 = x.to(gamma.dtype), dy.to(gamma.dtype)
    mu, rstd = _stats(x32, groups, eps)
    xhat = (x32 - mu) * rstd
    dgamma = (dy32 * xhat).sum(dim=(1, 2))
    dbeta = dy32.sum(dim=(1, 2))
    dxhat = dy32 * gamma[:, None, None, :]
    cpg = c // groups
    denom = s * cpg

    def group_mean(t):  # [R, M, S, C] → per-group mean over (S, C/G)
        g = t.sum(dim=2).reshape(r, m, groups, cpg).sum(dim=3) / denom
        return g[..., None].expand(r, m, groups, cpg).reshape(r, m, 1, c)

    dx = rstd * (dxhat - group_mean(dxhat) - xhat * group_mean(dxhat * xhat))
    return dx.to(x.dtype), dgamma, dbeta


# --- kernel wrappers --------------------------------------------------------

def group_norm_fwd(x, gamma, beta, groups: int, eps: float = EPS):
    """Forward kernel on CUDA tensors: ``x [R, M, S, C]`` (bf16 or f32, C
    at stride 1 — or copied and counted), ``gamma``/``beta [R, C]`` f32 →
    y in x's dtype and x's strides. Counts one launch, and one streamed
    launch when the sample was too large for a cluster."""
    _check(x, gamma, groups, "group_norm_fwd")
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_fwd launches on cuda, got {x.device}")
    x = _channels_innermost(x)
    y, streamed = extension().group_norm_fwd(
        x, gamma.contiguous(), beta.contiguous(), int(groups), float(eps))
    group_norm_fwd.launches += 1
    group_norm_fwd.streamed += int(streamed)
    return y


def group_norm_bwd(x, dy, gamma, groups: int, eps: float = EPS):
    """Backward kernels on CUDA tensors: the per-sample pass (dx and f32
    partials of dγ/dβ) and the per-row reduce → ``(dx, dγ [R, C],
    dβ [R, C])``. Counts one launch of each, and one streamed launch when
    the sample was too large for a cluster."""
    _check(x, gamma, groups, "group_norm_bwd")
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_bwd launches on cuda, got {x.device}")
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"group_norm_bwd: dy {dy.dtype} {tuple(dy.shape)} "
                         f"must match x {x.dtype} {tuple(x.shape)}")
    ext = extension()
    x, dy = _channels_innermost(x), _channels_innermost(dy)
    dx, part_g, part_b, streamed = ext.group_norm_bwd(
        x, dy, gamma.contiguous(), int(groups), float(eps))
    group_norm_bwd.launches += 1
    group_norm_bwd.streamed += int(streamed)
    dgamma, dbeta = ext.group_norm_reduce(part_g, part_b, x.shape[0])
    group_norm_bwd.reduce_launches += 1
    return dx, dgamma, dbeta


launch_counter(group_norm_fwd, "launches", "streamed")
launch_counter(group_norm_bwd, "launches", "reduce_launches", "streamed")


# --- the ops: device dispatch, autograd, vmap --------------------------------

@torch.library.custom_op(_OP + "group_norm_fwd", mutates_args=())
def _fwd_op(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
            groups: int, eps: float) -> torch.Tensor:
    if x.device.type != "cpu":
        raise ValueError(f"group_norm runs on cuda or cpu, got {x.device}")
    return group_norm_fwd_plain(x, gamma, beta, groups, eps)


@torch.library.custom_op(_OP + "group_norm_bwd", mutates_args=())
def _bwd_op(x: torch.Tensor, dy: torch.Tensor, gamma: torch.Tensor,
            groups: int, eps: float
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if x.device.type != "cpu":
        raise ValueError(f"group_norm runs on cuda or cpu, got {x.device}")
    return group_norm_bwd_plain(x, dy, gamma, groups, eps)


_fwd_op.register_kernel("cuda")(group_norm_fwd)
_bwd_op.register_kernel("cuda")(group_norm_bwd)


@_fwd_op.register_fake
def _(x, gamma, beta, groups, eps):
    return torch.empty_like(x)


@_bwd_op.register_fake
def _(x, dy, gamma, groups, eps):
    return (torch.empty_like(x), torch.empty_like(gamma),
            torch.empty_like(gamma))


@register_flop_formula(torch.ops.fedml_tpu_torch.group_norm_fwd)
def _fwd_flops(x, gamma, beta, groups, eps, out_shape=None, **_) -> int:
    """The forward's elementwise work, 7 per element of x: the group sums
    of x and x² (3), the normalisation ``(x − μ)·rstd`` (2) and the
    affine ``γ·x̂ + β`` (2); the per-group terms are left out. So
    ``obs.flops.model_cost`` counts the kernel."""
    return 7 * math.prod(x)


class _GroupNorm(torch.autograd.Function):
    """The gradient of the forward op is the backward op. This is an
    ``autograd.Function`` with ``setup_context`` rather than the op's own
    ``register_autograd``: the Function that ``register_autograd``
    generates has no ``setup_context``, so ``torch.func.grad`` refuses it.
    ``generate_vmap_rule`` batches the Function by running its body under
    ``vmap``, which reaches the ops' own vmap rules below: one launch per
    call for every client.

    The backward is itself differentiable through
    :class:`_GroupNormBackward` when a gradient of it is asked for (a
    second derivative, as FedNAS's unrolled architecture step takes). A
    first derivative alone runs the backward op under ``no_grad``, so it
    records nothing and keeps nothing beyond x and γ."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, gamma, beta, groups, eps):
        return _fwd_op(x, gamma, beta, groups, eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, gamma, _, groups, eps = inputs
        ctx.save_for_backward(x, gamma)
        ctx.groups, ctx.eps = groups, eps

    @staticmethod
    def backward(ctx, dy):
        x, gamma = ctx.saved_tensors
        if _differentiated(x, dy, gamma):
            dx, dgamma, dbeta = _GroupNormBackward.apply(x, dy, gamma,
                                                         ctx.groups, ctx.eps)
        else:
            with torch.no_grad():
                dx, dgamma, dbeta = _bwd_op(x, dy, gamma, ctx.groups,
                                            ctx.eps)
        return dx, dgamma, dbeta, None, None


class _GroupNormBackward(torch.autograd.Function):
    """The backward op as a differentiable function of (x, dy, γ). Its
    gradient is what differentiating flax's GroupNorm twice gives in JAX
    (XLA lowers it; no Pallas kernel computes it), written with J, the
    Jacobian of x̂ in x, which is symmetric within a group, so that
    ``dx = J·(dy·γ)`` and every J-product is the backward op again (the
    kernel on the card). For cotangents u of dx and a, b of dγ, dβ:

    - ``d dy = γ·Ju + a·x̂ + b``;
    - ``d γ = Σ dy·Ju`` over samples and positions;
    - ``d x = J(dy·a) − (rstd/n)·(x̂·Σ_g u·dx + dx·Σ_g u·x̂)
      − rstd·mean_g(dy·γ·x̂)·Ju``, with Σ_g over a group's n elements.

    Its own gradient is again torch ops and this Function, so every order
    is exact."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x, dy, gamma, groups, eps):
        return _bwd_op(x, dy, gamma, groups, eps)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, dy, gamma, groups, eps = inputs
        ctx.save_for_backward(x, dy, gamma, output[0])
        ctx.groups, ctx.eps = groups, eps

    @staticmethod
    def backward(ctx, u, a, b):
        x, dy, gamma, dx = ctx.saved_tensors
        groups, eps = ctx.groups, ctx.eps
        r, m, s, c = x.shape
        cpg = c // groups
        n = s * cpg
        ju = _GroupNormBackward.apply(x, u.to(x.dtype), torch.ones_like(gamma),
                                      groups, eps)[0]
        jda = _GroupNormBackward.apply(x, dy, a, groups, eps)[0]
        pdt = gamma.dtype
        x32, dy32, dx32 = x.to(pdt), dy.to(pdt), dx.to(pdt)
        u32, ju32 = u.to(pdt), ju.to(pdt)
        mu, rstd = _stats(x32, groups, eps)
        xhat = (x32 - mu) * rstd

        def group_sum(t):  # [R, M, S, C] → per-group sum, per channel
            g = t.sum(dim=2).reshape(r, m, groups, cpg).sum(dim=3)
            return g[..., None].expand(r, m, groups, cpg).reshape(r, m, 1, c)

        gam, a4, b4 = (t[:, None, None, :] for t in (gamma, a, b))
        q = group_sum(u32 * dx32)
        p = group_sum(u32 * xhat)
        k = group_sum(dy32 * gam * xhat) / n
        d_x = (jda.to(pdt) - (rstd / n) * (xhat * q + dx32 * p)
               - rstd * k * ju32)
        d_dy = gam * ju32 + a4 * xhat + b4
        d_gamma = (dy32 * ju32).sum(dim=(1, 2))
        return d_x.to(x.dtype), d_dy.to(dy.dtype), d_gamma, None, None


def _differentiated(*tensors) -> bool:
    """Whether the backward being run is itself differentiated: plain
    autograd with ``create_graph`` and an operand that requires grad, or,
    under ``torch.func``, an operand that requires grad at a ``grad``
    level below the one running this backward (``grad`` of ``grad``). A
    single ``torch.func.grad`` records every backward at its own level,
    which nothing reads; that case is False."""
    ft = torch._C._functorch
    levels, bottom = [], False
    for t in tensors:
        while True:
            if ft.is_gradtrackingtensor(t):
                levels.append((ft.maybe_get_level(t), t.requires_grad))
            elif not ft.is_batchedtensor(t):
                bottom = bottom or t.requires_grad
                break
            t = ft.get_unwrapped(t)
    if not levels:
        return torch.is_grad_enabled() and bottom
    top = max(level for level, _ in levels)
    return bottom or any(rg for level, rg in levels if level < top)


def _fold(t, bdim, size):
    """A batched operand ``[..., R, rest]`` with its vmap dim moved to the
    front and folded into R: ``[B·R, rest]``. Unbatched operands are
    broadcast (a stride-0 view; the kernels read any stride)."""
    if bdim is None:
        t = t.unsqueeze(0).expand(size, *t.shape)
    else:
        t = t.movedim(bdim, 0)
    return _view(t, (-1, *t.shape[2:]))


def _unfold(t, size):
    return t.unflatten(0, (size, t.shape[0] // size))


@_fwd_op.register_vmap
def _(info, in_dims, x, gamma, beta, groups, eps):
    b = info.batch_size
    y = _fwd_op(_fold(x, in_dims[0], b), _fold(gamma, in_dims[1], b),
                _fold(beta, in_dims[2], b), groups, eps)
    return _unfold(y, b), 0


@_bwd_op.register_vmap
def _(info, in_dims, x, dy, gamma, groups, eps):
    b = info.batch_size
    dx, dgamma, dbeta = _bwd_op(_fold(x, in_dims[0], b),
                                _fold(dy, in_dims[1], b),
                                _fold(gamma, in_dims[2], b), groups, eps)
    return (_unfold(dx, b), _unfold(dgamma, b), _unfold(dbeta, b)), (0, 0, 0)


# --- public functions --------------------------------------------------------

def _as_nsc(x):
    """``[C]`` → ``[1, 1, C]``, ``[N, C]`` → ``[N, 1, C]``, ``[N, …, C]``
    → ``[N, prod(…), C]`` (the JAX wrapper's reshapes)."""
    c = x.shape[-1]
    if x.dim() == 1:
        return x.view(1, 1, c)
    if x.dim() == 2:
        return x[:, None, :]
    return _view(x, (x.shape[0], -1, c))


def _check_public(x, gamma, groups):
    c = x.shape[-1]
    if groups <= 0 or c % groups:
        raise ValueError(f"groups {groups} must divide channels {c}")
    if tuple(gamma.shape) != (c,):
        raise ValueError(f"gamma/beta must be [{c}], got {tuple(gamma.shape)}")


def group_norm(x, gamma, beta, groups: int, eps: float = EPS):
    """GroupNorm over ``x [..., C]`` with ``gamma``/``beta [C]`` f32 (the
    JAX ``group_norm``): leading dim = samples, the middle dims pooled,
    ``groups`` must divide C; f32 statistics, output in x's dtype.
    Differentiable, and batched by ``torch.func.vmap`` into one launch.
    CUDA tensors run the kernels, CPU tensors the plain twins."""
    _check_public(x, gamma, groups)
    pdt = _param_dtype(x)
    y = _GroupNorm.apply(_as_nsc(x)[None], gamma.to(pdt)[None],
                         beta.to(pdt)[None], int(groups), float(eps))
    return y.view(x.shape)


def group_norm_plain(x, gamma, beta, groups: int, eps: float = EPS):
    """Plain twin of :func:`group_norm` (same signature, ordinary autograd
    through torch ops): what ``chip_smoke.py`` and the tests hold the
    kernels against."""
    _check_public(x, gamma, groups)
    pdt = _param_dtype(x)
    y = group_norm_fwd_plain(_as_nsc(x)[None], gamma.to(pdt)[None],
                             beta.to(pdt)[None], int(groups), float(eps))
    return y.reshape(x.shape)


launch_counter(group_norm, "copies")
