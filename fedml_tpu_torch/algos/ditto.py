"""Ditto — personalized federated learning (Li et al. 2021; port of
``fedml_tpu/algos/ditto.py``).

A personal model v_k per client beside the FedAvg global w::

    w   <- FedAvg round (unchanged)
    v_k <- v_k - lr * (grad f_k(v_k) + lam * (v_k - w))

The N personal models are one client stack on the device. One round is
one captured step of the "custom" carry protocol: the global round, then
the cohort's personal models gathered, their proximal update against the
NEW global (the cfg's optimizer, ``extra_grad_fn`` anchored at the global
params) and the trained ones scattered back.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from fedml_tpu_torch.algos.fedavg import FedAvgAPI
from fedml_tpu_torch.core import keys
from fedml_tpu_torch.core.tree import (client_rows, client_stack,
                                       gather_stacked, scatter_stacked,
                                       stack_of_rows, tree_map)
from fedml_tpu_torch.parallel.shard import client_rngs
from fedml_tpu_torch.trainer.local import (NetState, make_client_optimizer,
                                           make_local_train_fn_from_cfg)

#: fold_in child of the ROUND key for the personal step's per-client
#: streams (never split off ``self.rng``), disjoint from the trainer's
#: client streams, the transform's 0x7F and the corruptor's 0xC0.
_PERSONAL_TAG = 0xD1770


def weighted_client_metrics(m) -> Dict[str, float]:
    """Per-client eval metrics (``[C]`` tensors) as sample-weighted
    means, under the personalized metrics' names."""
    num = m["num"]
    n = torch.clamp(num.sum(), min=1.0)
    return {"personal_accuracy": float((m["accuracy"] * num).sum() / n),
            "personal_loss_eval": float((m["loss"] * num).sum() / n)}


def streamed_client_metrics(api, nets_of, chunk: int = 256
                            ) -> Dict[str, float]:
    """:func:`weighted_client_metrics` over a ``FederatedStore``: the
    clients in host-gathered chunks, ``nets_of(idx)`` the chunk's
    per-client nets (``[k, ...]`` leaves), so the device holds one chunk
    of data and models at a time."""
    store = api.train_fed
    tot = {"acc": 0.0, "loss": 0.0, "n": 0.0}
    for lo in range(0, store.num_clients, chunk):
        idx = np.arange(lo, min(lo + chunk, store.num_clients))
        sub = store.gather_cohort(idx)
        m = api._per_client_eval(nets_of(idx), sub.x, sub.y, sub.mask,
                                 net_dim=0)
        num = m["num"]
        tot["acc"] += float((m["accuracy"] * num).sum())
        tot["loss"] += float((m["loss"] * num).sum())
        tot["n"] += float(num.sum())
    n = max(tot["n"], 1.0)
    return {"personal_accuracy": tot["acc"] / n,
            "personal_loss_eval": tot["loss"] / n}


def rows_of(tree, idx):
    """The ``idx`` rows of a ``[N, ...]`` tree (a dict of tensors)."""
    sel = torch.as_tensor(idx, dtype=torch.int64)
    return tree_map(lambda t: t.index_select(0, sel.to(t.device)), tree)


class DittoAPI(FedAvgAPI):
    """FedAvg for the global model + per-client personal models pulled
    toward the current global with strength ``lam``. The carry is the
    stack of the personal params (every personal model starts as the
    global init), with their model states (BatchNorm's running stats) in
    a second stack; ``personal_nets`` is their ``[N, ...]`` view. A round
    reports the global train loss; ``evaluate_personalized`` is the
    personalization metric."""

    window_protocol = "custom"
    window_carry = "personal-model stack"

    def __init__(self, *args, lam: float = 0.1, **kw):
        self.lam = lam
        super().__init__(*args, **kw)
        n = self.train_fed.num_clients
        self._personal = NetState(client_stack(self.net.params, n),
                                  client_stack(self.net.model_state, n))

    @property
    def personal_nets(self) -> NetState:
        return NetState(client_rows(self._personal.params),
                        client_rows(self._personal.model_state))

    def _personal_train(self):
        """The proximal personal trainer (the LIVE client lr)."""
        lam, cfg = self.lam, self.cfg
        optimizer = make_client_optimizer(cfg.client_optimizer,
                                          self._client_lr, cfg.wd,
                                          cfg.grad_clip)

        def prox(params, w_global):
            return tree_map(lambda v, w: lam * (v - w), params, w_global)

        return make_local_train_fn_from_cfg(self.fns.apply, optimizer, cfg,
                                            self._loss_fn, extra_grad_fn=prox)

    def _build_fused_step(self):
        """One Ditto round: the standard global round (``round_fn``), then
        the cohort's proximal personal updates against the new global,
        the personal stack gathered and scattered in the same step. An
        empty sampled client's personal training is a no-op, and the mask
        keeps its row as it was."""
        round_fn = self.round_fn
        personal_train = self._personal_train()

        def step(net, personal, x, y, mask, weights, key, idx, umask):
            avg, loss = round_fn(net, x, y, mask, weights, weights, key)
            sub = NetState(gather_stacked(personal.params, idx),
                           gather_stacked(personal.model_state, idx))
            rngs = client_rngs(keys.fold_in(key, _PERSONAL_TAG), x.shape[0])
            trained, _ = personal_train.run_stacked(sub, x, y, mask, rngs,
                                                    anchor=avg.params)
            personal = NetState(
                scatter_stacked(personal.params, idx, trained.params, umask),
                scatter_stacked(personal.model_state, idx,
                                trained.model_state, umask))
            return (avg, personal), loss

        return step

    def _window_carry_init(self):
        return self._personal

    def _window_carry_commit(self, extra) -> None:
        self._personal = extra

    # -- checkpoint/resume: the personal models are run state ---------------
    def checkpoint_extra_state(self):
        return {"personal_nets": self.personal_nets}

    def load_checkpoint_extra_state(self, extra) -> None:
        nets = extra["personal_nets"]
        self._personal = NetState(stack_of_rows(nets.params),
                                  stack_of_rows(nets.model_state))

    def evaluate_personalized(self) -> Dict[str, float]:
        """Sample-weighted mean of each personal model's accuracy and loss
        on its OWN local shard (one vmapped pass over the resident
        shards; over a store, chunk by chunk)."""
        if self._streaming:
            nets = self.personal_nets
            return streamed_client_metrics(self, lambda idx: NetState(
                rows_of(nets.params, idx), rows_of(nets.model_state, idx)))
        f = self.train_fed
        return weighted_client_metrics(self._per_client_eval(
            self.personal_nets, f.x, f.y, f.mask, net_dim=0))

    def evaluate_global_on_local(self) -> Dict[str, float]:
        """The baseline: the global model evaluated the same way."""
        m = self.evaluate_on_clients()
        return {"global_local_accuracy": m["clients_train_acc"]}
