"""Update corruption for the robustness drills (port of
``fedml_tpu/core/faults.py``'s ``UpdateCorruptor``; its heartbeat and
dropout helpers belong to the federation plane, ROADMAP.md A10).

:meth:`UpdateCorruptor.device_fn` is the form the rounds run: pure and
mask-driven over the client-stacked trained params, so the attack drill
rides every round tier, captured rounds included. The ``random`` mode
draws from ``core/keys.py``, not threefry.
"""

from __future__ import annotations

import math

import torch

from fedml_tpu_torch.core.robustness import gaussian_tree
from fedml_tpu_torch.core.tree import tree_map


def _first_nan(w):
    """``w [C, ...]`` with the first element of each client's entry set to
    NaN (a 0-d entry all NaN)."""
    shape = w.shape[1:]
    first = (torch.arange(math.prod(shape), device=w.device) == 0).view(shape)
    return torch.where(first, torch.full((), float("nan"), dtype=w.dtype,
                                         device=w.device), w)


class UpdateCorruptor:
    """Faults injected into trained client updates: ``sign_flip`` (model
    replacement ``g - scale·(w - g)``), ``scale`` (``w·scale``), ``nan``
    (the first element of every leaf) and ``random`` (``scale`` x standard
    normals). The JAX package's host-side ``corrupt`` (one update, a
    carried key) is not ported: the rounds run :meth:`device_fn`."""

    MODES = ("sign_flip", "scale", "nan", "random")

    def __init__(self, mode: str = "sign_flip", scale: float = 10.0):
        if mode not in self.MODES:
            raise ValueError(f"unknown corruption mode {mode!r}; known "
                             f"{self.MODES}")
        self.mode = mode
        self.scale = scale

    def _corrupted(self, params, global_params, keys_):
        """Every client of the stack corrupted (``[C, ...]`` leaves,
        ``global_params`` broadcast, ``keys_ [C]``)."""
        mode, scale = self.mode, self.scale
        if mode == "sign_flip":
            return tree_map(lambda w, g: g - scale * (w - g), params,
                            global_params)
        if mode == "scale":
            return tree_map(lambda w: w * scale, params)
        if mode == "nan":
            return tree_map(_first_nan, params)
        return gaussian_tree(params, keys_, scale, batch_dims=1)

    def device_fn(self):
        """``(global_net, client_nets, adv, rngs) -> client_nets`` over the
        client-stacked trained models (``[C, ...]`` params): the slots
        where ``adv [C] > 0`` are corrupted, the others kept, selected with
        ``torch.where``; ``rngs [C]`` are the per-client streams of the
        ``random`` mode. No host state is read or changed."""

        def apply(global_net, client_nets, adv, rngs):
            gp = getattr(global_net, "params", global_net)
            cp = getattr(client_nets, "params", client_nets)
            bad = self._corrupted(cp, tree_map(lambda g: g[None], gp), rngs)
            new = tree_map(
                lambda c, b: torch.where((adv > 0).view(
                    (-1,) + (1,) * (c.dim() - 1)), b, c), cp, bad)
            if hasattr(client_nets, "params"):
                return type(client_nets)(new, client_nets.model_state)
            return new

        return apply
