"""FedDyn — federated learning with dynamic regularization (Acar et al.,
ICLR 2021; port of ``fedml_tpu/algos/feddyn.py``).

Client k minimizes ``f_k(w) - <g_k, w> + (alpha/2) ||w - w_t||^2``::

    per-step gradient:  grad f_k(w) - g_k + alpha (w - w_t)
    after local run:    g_k <- g_k - alpha (w_k - w_t)
    server state:       h   <- h - alpha (1/N) sum_{k in S} (w_k - w_t)
    new global:         w   <- mean_{k in S} w_k - (1/alpha) h

The N client corrections g_k are one client stack on the device, carried
with h through the one captured step of the "custom" carry protocol (the
SCAFFOLD pattern, ``algos/scaffold.py``).
"""

from __future__ import annotations

import torch

from fedml_tpu_torch.algos.fedavg import FedAvgAPI
from fedml_tpu_torch.core.tree import (client_rows, client_stack,
                                       stack_of_rows, tree_map)
from fedml_tpu_torch.parallel.shard import (make_fused_stateful_round_step,
                                            make_stateful_client_round)
from fedml_tpu_torch.trainer.local import (NetState,
                                           make_corrected_local_train)


def make_feddyn_local_train(apply_fn, lr: float, alpha: float,
                            local_epochs: int, loss_fn):
    """``local_train(net, (g_k, global_params), x, y, mask, rng) -> (net',
    loss)``: SGD whose every step is ``p - lr (g - g_k + alpha (p -
    w_global))``, in that order."""

    def step_update(params, grads, aux):
        g_k, global_params = aux
        return tree_map(
            lambda p, g, gk, w0: p - lr * (g - gk + alpha * (p - w0)),
            params, grads, g_k, global_params)

    return make_corrected_local_train(apply_fn, local_epochs, loss_fn,
                                      step_update)


class FedDynAPI(FedAvgAPI):
    """FedAvg + dynamic regularization, plain-SGD clients only; ``alpha``
    the regularization strength (typically 0.01-0.1). The carry is
    ``(server_h, client stack of the g_k)``; ``client_grads`` is the
    ``[N, ...]`` view of the stack."""

    window_carry = "server h + client correction stack"

    window_protocol = "custom"

    def __init__(self, *args, alpha: float = 0.01, **kw):
        super().__init__(*args, **kw)
        if alpha <= 0:
            raise ValueError(f"feddyn alpha must be > 0, got {alpha}")
        self._require_plain_sgd_round("FedDynAPI's corrected SGD step")
        self.alpha = alpha
        self.server_h = tree_map(torch.zeros_like, self.net.params)
        self._grads = client_stack(self.server_h, self.train_fed.num_clients)

    @property
    def client_grads(self):
        return client_rows(self._grads)

    def _feddyn_update(self, net, h, gk_sub, trained, losses, weights):
        """The server update: each participant's g_k, the server's h, and
        the new global as the uniform participant mean minus h/alpha (the
        previous global when no client took part)."""
        alpha = self.alpha
        n_total = float(self.train_fed.num_clients)
        active = (weights > 0).float()
        total_active = active.sum()
        any_ok = total_active > 0
        wn = active / torch.clamp(total_active, min=1e-12)
        gk_new = tree_map(
            lambda gk, wk, w0: gk - alpha * (wk.float() - w0.float()[None]),
            gk_sub, trained.params, net.params)
        h_new = tree_map(
            lambda hh, wk, w0: hh - (alpha / n_total) * torch.einsum(
                "c,c...->...", active, wk.float() - w0.float()[None]),
            h, trained.params, net.params)
        params = tree_map(
            lambda wk, hh, w0: torch.where(
                any_ok,
                (torch.einsum("c,c...->...", wn, wk.float())
                 - hh / alpha).to(w0.dtype),
                w0),
            trained.params, h_new, net.params)
        # The trained state (BatchNorm's running stats): FedAvg's
        # sample-count-weighted mean, the old state when no client took
        # part.
        w = weights.float()
        wns = w / torch.clamp(w.sum(), min=1e-12)
        state = tree_map(
            lambda s, old: torch.where(
                any_ok,
                torch.einsum("c,c...->...", wns, s.float()).to(s.dtype),
                old),
            trained.model_state, net.model_state)
        return (NetState(params, state), h_new, gk_new,
                (losses * wns).sum())

    def _feddyn_round_fn(self):
        local_train = make_feddyn_local_train(
            self.fns.apply, self._client_lr, self.alpha, self.cfg.epochs,
            self._loss_fn)

        def body(net, h, gk_sub, x, y, mask, weights, rngs):
            trained, losses = local_train.run_clients(
                net, (gk_sub, net.params), x, y, mask, rngs,
                aux_dim=(0, None))
            return self._feddyn_update(net, h, gk_sub, trained, losses,
                                       weights)

        return make_stateful_client_round(body)

    def _build_fused_step(self):
        """One FedDyn round: the cohort's g_k gathered, the corrected
        round, the trained clients' g_k scattered back (the mask keeps a
        padded duplicate slot from clobbering real state)."""
        return make_fused_stateful_round_step(self._feddyn_round_fn())

    def _window_carry_init(self):
        return (self.server_h, self._grads)

    def _window_carry_commit(self, extra) -> None:
        self.server_h, self._grads = extra

    # -- checkpoint/resume: the corrections are run state -------------------
    def checkpoint_extra_state(self):
        return {"server_h": self.server_h, "client_grads": self.client_grads}

    def load_checkpoint_extra_state(self, extra) -> None:
        self.server_h = extra["server_h"]
        self._grads = stack_of_rows(extra["client_grads"])
