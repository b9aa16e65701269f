"""Rematerialization of a loss (the port's ``jax.checkpoint``).

``checkpoint(loss_fn)`` keeps only the loss's inputs from the forward;
its backward runs the forward again and takes the vjp of the loss there,
so the activations of the forward are freed as soon as it returns
instead of living until the backward. ``torch.utils.checkpoint`` does
not compose with ``torch.func``: its non-reentrant form rests on saved
tensor hooks, which ``torch.func.grad`` refuses, and its reentrant form
is an ``autograd.Function`` without ``setup_context``. So this is a
Function of its own, with ``setup_context`` and ``generate_vmap_rule``,
as the GroupNorm and flash ops are (``ops/group_norm.py``): it runs under
``grad_and_value`` and under the cohort's (and DP's per-example)
``vmap``.

The recomputed forward draws the same keys (they are inputs), so its
dropout masks and its values are the first forward's, and the gradient
is bit-equal to the one taken without remat (JAX's own pin,
``tests/test_fedavg.py:78``).
"""

from __future__ import annotations

import torch
from torch.func import vjp


def _flatten(tree, leaves):
    """``tree`` (nested dicts, tuples and lists of tensors) into ``leaves``;
    returns the spec that :func:`_unflatten` rebuilds it from."""
    if isinstance(tree, dict):
        return ("d", tuple((k, _flatten(v, leaves)) for k, v in tree.items()))
    if isinstance(tree, (tuple, list)):
        return ("t", tuple(_flatten(v, leaves) for v in tree))
    if tree is None:
        return ("n",)
    leaves.append(tree)
    return ("l",)


def _unflatten(spec, it):
    kind = spec[0]
    if kind == "d":
        return {k: _unflatten(s, it) for k, s in spec[1]}
    if kind == "t":
        return tuple(_unflatten(s, it) for s in spec[1])
    if kind == "n":
        return None
    return next(it)


class _Remat(torch.autograd.Function):
    """``flat_fn(*inputs) -> (loss, *aux)`` over flat tensors; the first
    ``n_diff`` inputs are the differentiated ones. Saves the inputs only;
    the backward recomputes ``flat_fn`` and returns the vjp of the loss
    in those inputs (the aux outputs take no gradient)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(flat_fn, n_diff, *inputs):
        return tuple(flat_fn(*inputs))

    @staticmethod
    def setup_context(ctx, inputs, output):
        flat_fn, n_diff, *tensors = inputs
        ctx.flat_fn, ctx.n_diff = flat_fn, n_diff
        ctx.save_for_backward(*tensors)
        ctx.mark_non_differentiable(*output[1:])

    @staticmethod
    def backward(ctx, g_loss, *_):
        tensors = ctx.saved_tensors
        n = ctx.n_diff
        rest = tensors[n:]

        def loss_of(*diff):
            return ctx.flat_fn(*diff, *rest)[0]

        with torch.enable_grad():
            _, pullback = vjp(loss_of, *tensors[:n])
            grads = pullback(g_loss)
        return (None, None, *grads, *([None] * len(rest)))


def checkpoint(loss_fn):
    """``loss_fn(diff, *rest) -> (loss, aux)`` rematerialized: the same
    signature and values, differentiable in ``diff`` (a tree of tensors)
    only. ``rest`` and ``aux`` are trees of tensors (dicts, tuples, None);
    they travel as flat lists, since ``Function.apply`` takes no dicts."""

    def wrapped(diff, *rest):
        leaves = []
        diff_spec = _flatten(diff, leaves)
        n_diff = len(leaves)
        rest_spec = _flatten(rest, leaves)
        aux_spec = []

        def flat_fn(*flat):
            it = iter(flat)
            d = _unflatten(diff_spec, it)
            r = _unflatten(rest_spec, it)
            loss, aux = loss_fn(d, *r)
            out = [loss]
            spec = _flatten(aux, out)
            aux_spec[:] = [spec]
            return out

        out = _Remat.apply(flat_fn, n_diff, *leaves)
        return out[0], _unflatten(aux_spec[0], iter(out[1:]))

    return wrapped
