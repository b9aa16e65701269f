"""q-FedAvg — fair federated learning (Li et al. 2020, "Fair Resource
Allocation in Federated Learning"; port of ``fedml_tpu/algos/qfedavg.py``).

The server reweights each round by the clients' losses, leaning the
update toward whoever is served worst::

    Delta_k = L * (w - w_k)                       (L = 1/lr)
    h_k     = q * F_k^(q-1) * ||Delta_k||^2 + L * F_k^q
    w      <- w - sum_k F_k^q Delta_k / sum_k h_k

with F_k the client's masked mean loss AT THE BROADCAST MODEL w, over its
whole shard (a forward-only pass of the cohort, vmapped like the local
steps, so one launch of each kernel per layer and batch). ``q = 0`` is the
equal-weight FedAvg parameter update. It replaces FedAvgAPI's round
(``_make_vmap_round``), so the fused, pipelined and on-device tiers
capture it as they capture FedAvg's round. ``L`` is baked into the round, which
``set_client_lr`` rebuilds. The mesh-sharded round waits for ROADMAP.md
A11 (``mesh=`` is refused).
"""

from __future__ import annotations

import torch
from torch.func import vmap

from fedml_tpu_torch.algos.fedavg import FedAvgAPI
from fedml_tpu_torch.core.tree import tree_leaves, tree_map
from fedml_tpu_torch.parallel.shard import client_rngs, run_clients_guarded
from fedml_tpu_torch.trainer.local import NetState


def make_loss_at_global(apply_fn, loss_fn):
    """``loss_at_global(net, x, y, mask) -> F [C]``: each client's masked
    mean loss of the one ``net`` on its packed shard ``x [C, S, B, ...]``,
    without gradients. Each batch step runs the whole cohort under
    ``vmap``; with one net for every client the client dim folds into the
    batch dim of each layer (one launch of each kernel per layer and
    step)."""

    @torch.no_grad()
    def loss_at_global(net, x, y, mask):
        def per_example(xb, yb):
            logits, _ = apply_fn(net, xb, train=False)
            return loss_fn(logits, yb)

        step = vmap(per_example)
        ls, ns = [], []
        for s in range(x.shape[1]):
            per = step(x[:, s], y[:, s])
            ls.append((per * mask[:, s]).sum(-1))
            ns.append(mask[:, s].sum(-1))
        return (torch.stack(ls).sum(0)
                / torch.clamp(torch.stack(ns).sum(0), min=1.0))

    return loss_at_global


def qffl_update(net, client_nets, F_global, losses, weights, loss_weights,
                active, q: float, L: float):
    """The fair server update: ``(net', mean_loss)`` from the global
    ``net``, the trained ``[C, ...]`` client nets, ``F_global [C]``, the
    losses and weights ``[C]`` and the ``active [C]`` mask (weight > 0 and
    finite). ``F`` is clamped at 1e-12; an all-inactive round leaves the
    params as they were (numerator and the h-sum both vanish)."""
    F = torch.clamp(F_global, min=1e-12)
    on = active > 0
    zero = torch.zeros((), dtype=F.dtype, device=F.device)
    Fq = torch.where(on, F ** q, zero)
    Fq_m1 = torch.where(on, F ** (q - 1.0), zero)
    # Delta_k = L (w - w_k) over the trainable params, client-stacked.
    deltas = tree_map(lambda w, wk: L * (w.float()[None] - wk.float()),
                      net.params, client_nets.params)
    delta_sq = sum(torch.square(d).reshape(d.shape[0], -1).sum(1)
                   for d in tree_leaves(deltas))
    h = q * Fq_m1 * delta_sq + L * Fq
    denom = torch.clamp((h * active).sum(), min=1e-12)
    coef = Fq * active
    new_params = tree_map(
        lambda w, d: (w.float() - torch.einsum("c,c...->...", coef, d)
                      / denom).to(w.dtype),
        net.params, deltas)
    # The trained state (BatchNorm's running stats): the sample-count-
    # weighted mean over the active clients, as FedAvg weights it; an
    # all-diverged round keeps the previous stats (a zero-weight mean would
    # zero them).
    w_state = weights.float() * active
    total_w = w_state.sum()
    wn = w_state / torch.clamp(total_w, min=1e-12)
    state = tree_map(
        lambda s, old: torch.where(
            total_w > 0,
            torch.einsum("c,c...->...", wn, s.float()).to(s.dtype), old),
        client_nets.model_state, net.model_state)
    lw = loss_weights * active
    lw = lw / torch.clamp(lw.sum(), min=1e-12)
    return NetState(new_params, state), (losses * lw).sum()


def make_qffl_round(local_train, q: float, lr: float, apply_fn, loss_fn,
                    client_transform=None, nan_guard: bool = False):
    """``round_fn(net, x, y, mask, weights, loss_weights, rng) -> (net',
    mean_loss)``, the signature of ``make_vmap_round``, so FedAvgAPI's
    tiers capture it unchanged."""
    loss_at_global = make_loss_at_global(apply_fn, loss_fn)
    L = 1.0 / lr

    def round_fn(net, x, y, mask, weights, loss_weights, rng):
        F_global = loss_at_global(net, x, y, mask)
        rngs = client_rngs(rng, x.shape[0], 0)
        client_nets, losses, finite = run_clients_guarded(
            local_train, client_transform, nan_guard, net, x, y, mask, rngs)
        active = (weights > 0).float() * finite
        return qffl_update(net, client_nets, F_global, losses, weights,
                           loss_weights, active, q, L)

    return round_fn


class QFedAvgAPI(FedAvgAPI):
    """FedAvg with the q-FFL fair aggregation. ``q = 0`` is equal-weight
    FedAvg for the params; typical fair settings use q in [0.1, 5]."""

    def __init__(self, *args, q: float = 1.0, **kw):
        # Before the base constructor, which builds the round.
        self.q = q
        super().__init__(*args, **kw)

    def _make_vmap_round(self, local_train, transform, guard):
        return make_qffl_round(local_train, self.q, self._client_lr,
                               self.fns.apply, self._loss_fn,
                               client_transform=transform, nan_guard=guard)
