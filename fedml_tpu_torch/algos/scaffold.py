"""SCAFFOLD — stochastic controlled averaging (Karimireddy et al. 2020;
port of ``fedml_tpu/algos/scaffold.py``).

Every local step is corrected by the control variates::

    y   <- y - lr * (grad f_k(y) + c - c_k)          (local steps)
    c_k' = c_k - c + (x - y) / (K_k * lr)            (option II)
    x   <- x + server_lr * mean_w(y_k - x)
    c   <- c + (|S| / N) * mean_k(c_k' - c_k)

with x the global model, c the server control, c_k the client controls
and K_k the client's true optimizer-step count. The N client controls are
one client stack on the device (``core/tree.client_stack``); a round
gathers the cohort's, trains with the corrected-SGD trainer and scatters
the trained clients' controls back, all inside the one captured step of
the "custom" carry protocol.
"""

from __future__ import annotations

import torch

from fedml_tpu_torch.algos.fedavg import FedAvgAPI
from fedml_tpu_torch.core.tree import (client_rows, client_stack,
                                       stack_of_rows, tree_map, tree_select)
from fedml_tpu_torch.parallel.shard import (make_fused_stateful_round_step,
                                            make_stateful_client_round)
from fedml_tpu_torch.trainer.local import (NetState,
                                           make_corrected_local_train)


def make_scaffold_local_train(apply_fn, lr: float, local_epochs: int,
                              loss_fn, remat: bool = False):
    """``local_train(net, correction, x, y, mask, rng) -> (net', loss,
    K)``: plain SGD with the correction ``c - c_k`` added to every
    gradient; ``K`` the true number of non-empty steps."""

    def step_update(params, grads, correction):
        return tree_map(lambda p, g, corr: p - lr * (g + corr),
                        params, grads, correction)

    return make_corrected_local_train(apply_fn, local_epochs, loss_fn,
                                      step_update, remat=remat,
                                      with_step_count=True)


class ScaffoldAPI(FedAvgAPI):
    """FedAvg + control variates, plain-SGD clients only. The carry is
    ``(server_control, client stack of the controls)``; the controls are
    f32 zeros like the params at the start. ``client_controls`` is the
    ``[N, ...]`` view of the stack."""

    window_carry = "server control + client-control stack"

    window_protocol = "custom"

    def __init__(self, *args, server_lr: float = 1.0, **kw):
        super().__init__(*args, **kw)
        self._require_plain_sgd_round("ScaffoldAPI's corrected SGD step")
        self.server_lr = server_lr
        self.server_control = tree_map(torch.zeros_like, self.net.params)
        self._controls = client_stack(self.server_control,
                                      self.train_fed.num_clients)

    @property
    def client_controls(self):
        return client_rows(self._controls)

    def _scaffold_update(self, net, c_server, ck_sub, trained, losses,
                         k_steps, weights):
        """The server update: option II's client controls, the weighted
        model average under ``server_lr`` (an all-inactive round keeps the
        model) and the server control's active mean."""
        lr, server_lr = self._client_lr, self.server_lr
        n_total = float(self.train_fed.num_clients)
        active = (weights > 0).float()
        inv_klr = 1.0 / (k_steps * lr)
        ck_new = tree_map(
            lambda ck, c, xg, yk: (
                ck - c[None]
                + (xg.float()[None] - yk.float())
                * inv_klr.reshape((-1,) + (1,) * xg.dim())),
            ck_sub, c_server, net.params, trained.params)
        w = weights.float()
        total_w = w.sum()
        wn_w = w / torch.clamp(total_w, min=1e-12)
        # The whole net, params and trained state (BatchNorm's running
        # stats), as JAX steps the NetState.

        def server_step(xg, p):
            a = torch.einsum("c,c...->...", wn_w, p.float()).to(p.dtype)
            return (xg.float() * (1 - server_lr)
                    + server_lr * a.float()).to(xg.dtype)

        params = tree_select(total_w > 0,
                             tree_map(server_step, net.params,
                                      trained.params), net.params)
        state = tree_select(total_w > 0,
                            tree_map(server_step, net.model_state,
                                     trained.model_state), net.model_state)
        total_active = active.sum()
        wn = active / torch.clamp(total_active, min=1e-12)
        frac = total_active / n_total
        c_new = tree_map(
            lambda c, ckn, ck: c + frac * torch.einsum("c,c...->...", wn,
                                                       ckn - ck),
            c_server, ck_new, ck_sub)
        return (NetState(params, state), c_new, ck_new,
                (losses * wn_w).sum())

    def _scaffold_round_fn(self):
        local_train = make_scaffold_local_train(
            self.fns.apply, self._client_lr, self.cfg.epochs, self._loss_fn,
            remat=self.cfg.remat)

        def body(net, c_server, ck_sub, x, y, mask, weights, rngs):
            corrections = tree_map(lambda c, ck: c[None] - ck, c_server,
                                   ck_sub)
            trained, losses, k_steps = local_train.run_clients(
                net, corrections, x, y, mask, rngs)
            return self._scaffold_update(net, c_server, ck_sub, trained,
                                         losses, k_steps, weights)

        return make_stateful_client_round(body)

    def _build_fused_step(self):
        """One SCAFFOLD round: the cohort's controls gathered, the
        corrected round, the trained clients' controls scattered back (a
        sampled EMPTY client ran no step, and writing its ``ck - c`` would
        drift its control by ``-c`` each time it is sampled)."""
        return make_fused_stateful_round_step(self._scaffold_round_fn())

    def _window_carry_init(self):
        return (self.server_control, self._controls)

    def _window_carry_commit(self, extra) -> None:
        self.server_control, self._controls = extra

    # -- checkpoint/resume: the controls are run state ----------------------
    def checkpoint_extra_state(self):
        return {"server_control": self.server_control,
                "client_controls": self.client_controls}

    def load_checkpoint_extra_state(self, extra) -> None:
        self.server_control = extra["server_control"]
        self._controls = stack_of_rows(extra["client_controls"])
