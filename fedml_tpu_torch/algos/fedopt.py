"""FedOpt family — FedAvgM, FedAdam, FedYogi, FedAdagrad (port of
``fedml_tpu/algos/fedopt.py``; reference:
fedml_api/distributed/fedopt/FedOptAggregator.py:70-109).

The server averages the client models, forms the pseudo-gradient
``w_old - w_avg`` and takes one step of a server optimizer. The optimizers
are functional chains over parameter trees (``trainer/local.py``'s
style), written to match optax 0.2.6, the JAX package's, exactly; not
``torch.optim``, which has no Yogi, puts Adagrad's eps outside the sqrt
and starts its accumulator at 0, and updates in place, where the
optimizer state has to be the carry of a captured step. The step count is
a 0-d int32 tensor in that state, so a replayed round keeps advancing the
bias correction.
"""

from __future__ import annotations

import torch

from fedml_tpu_torch.algos.fedavg import FedAvgAPI
from fedml_tpu_torch.core.aggregate import pseudo_gradient
from fedml_tpu_torch.core.tree import tree_leaves, tree_map
from fedml_tpu_torch.trainer.local import (NetState, Optimizer, _chain,
                                           _scale, _trace, apply_updates)


def _count(params):
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def _bias_corrected(moment, decay: float, count):
    """optax's ``bias_correction``: ``moment / (1 - decay^count)``."""
    c = 1 - torch.pow(decay, count.float())
    return tree_map(lambda t: t / c, moment)


def _scale_by_adam(b1: float, b2: float, eps: float) -> Optimizer:
    """optax's ``scale_by_adam`` (eps outside the sqrt, eps_root 0)."""

    def init(p):
        z = tree_map(torch.zeros_like, p)
        return {"count": _count(p), "mu": z, "nu": z}

    def update(g, st, p):
        mu = tree_map(lambda t, m: (1 - b1) * t + b1 * m, g, st["mu"])
        nu = tree_map(lambda t, v: (1 - b2) * (t * t) + b2 * v, g, st["nu"])
        count = st["count"] + 1
        upd = tree_map(lambda m, v: m / (torch.sqrt(v) + eps),
                       _bias_corrected(mu, b1, count),
                       _bias_corrected(nu, b2, count))
        return upd, {"count": count, "mu": mu, "nu": nu}

    return Optimizer(init, update)


def _scale_by_yogi(b1: float, b2: float, eps: float,
                   initial: float = 1e-6) -> Optimizer:
    """optax's ``scale_by_yogi``: both moments start at ``initial``, and
    ``nu ← nu - (1 - b2)·sign(nu - g²)·g²``."""

    def init(p):
        full = tree_map(lambda t: torch.full_like(t, initial), p)
        return {"count": _count(p), "mu": full,
                "nu": tree_map(torch.clone, full)}

    def update(g, st, p):
        mu = tree_map(lambda t, m: (1 - b1) * t + b1 * m, g, st["mu"])
        nu = tree_map(
            lambda t, v: v - (1 - b2) * torch.sign(v - t * t) * (t * t),
            g, st["nu"])
        count = st["count"] + 1
        upd = tree_map(lambda m, v: m / (torch.sqrt(v) + eps),
                       _bias_corrected(mu, b1, count),
                       _bias_corrected(nu, b2, count))
        return upd, {"count": count, "mu": mu, "nu": nu}

    return Optimizer(init, update)


def _scale_by_rss(initial: float, eps: float) -> Optimizer:
    """optax's ``scale_by_rss``: the sum of squares starts at
    ``initial``; ``g · rsqrt(acc + eps)`` where ``acc > 0``, else 0."""

    def init(p):
        return {"sum_of_squares": tree_map(
            lambda t: torch.full_like(t, initial), p)}

    def update(g, st, p):
        acc = tree_map(lambda t, a: t * t + a, g, st["sum_of_squares"])
        upd = tree_map(
            lambda a, t: torch.where(a > 0, torch.rsqrt(a + eps),
                                     torch.zeros((), device=a.device)) * t,
            acc, g)
        return upd, {"sum_of_squares": acc}

    return Optimizer(init, update)


def make_server_optimizer(name: str, lr: float,
                          momentum: float = 0.9) -> Optimizer:
    """The server optimizers of "Adaptive Federated Optimization" (Reddi
    et al. 2020) with the JAX package's settings: ``sgd`` (momentum
    trace left out at 0), ``adam`` and ``yogi`` (b1 0.9, b2 0.99, eps
    1e-3), ``adagrad`` (accumulator from 0.1, eps 1e-3)."""
    if name == "sgd":
        opts = (_trace(momentum),) if momentum > 0 else ()
    elif name == "adam":
        opts = (_scale_by_adam(0.9, 0.99, 1e-3),)
    elif name == "yogi":
        opts = (_scale_by_yogi(0.9, 0.99, 1e-3),)
    elif name == "adagrad":
        opts = (_scale_by_rss(0.1, 1e-3),)
    else:
        raise ValueError(f"unknown server optimizer {name!r}")
    return _chain(*opts, _scale(-lr))


class FedOptAPI(FedAvgAPI):
    """FedAvg with a server optimizer (``cfg.server_optimizer``,
    ``server_lr``, ``server_momentum``) stepping on the pseudo-gradient.
    ``server_opt_state`` is the carry of the captured steps."""

    window_carry = "server optimizer state"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        cfg = self.cfg
        self.server_opt = make_server_optimizer(
            cfg.server_optimizer, cfg.server_lr, cfg.server_momentum)
        self.server_opt_state = self.server_opt.init(self.net.params)

    def _server_step(self, params, avg_params, opt_state):
        # The reference sets param.grad = old - avg, then opt.step()
        # (FedOptAggregator.set_model_global_grads:109).
        updates, opt_state = self.server_opt.update(
            pseudo_gradient(params, avg_params), opt_state, params)
        return apply_updates(params, updates), opt_state

    def _server_update(self, old_net, avg_net):
        new_params, self.server_opt_state = self._server_step(
            old_net.params, avg_net.params, self.server_opt_state)
        # Non-trainable state keeps the plain client average.
        return NetState(new_params, avg_net.model_state)

    # --- the carry protocol: the server optimizer state --------------------
    def _window_server_update(self):
        step = self._server_step

        def update(net, avg, opt_state, key):
            del key  # the server step is deterministic
            new_params, opt_state = step(net.params, avg.params, opt_state)
            return NetState(new_params, avg.model_state), opt_state

        return update

    def _window_carry_init(self):
        return self.server_opt_state

    def _window_carry_commit(self, extra) -> None:
        self.server_opt_state = extra
