"""FedNAS — federated architecture search over the DARTS space (port of
``fedml_tpu/algos/fednas.py``).

Clients run the DARTS bilevel search locally: an architecture step on a
held-out half of their batches, then a weight step on the other half; the
server averages weights and alphas together, weighted by sample counts
(the FedAvg round, since the alphas are params of the one model), and the
genotype is derived from the averaged alphas.

The port's local search is :class:`FedNASLocalSearch`, the
``local_train`` of the FedAvg round, so FedNAS rides every tier FedAvg
rides (the fused round, the pipelined loop, the on-device rounds). The
train/valid halves are cut at ``h = n_real // 2`` with ``n_real`` a
client's true step count, computed on the device: the loop runs over the
static ``S // 2`` and gates steps ``i >= h`` off, so a captured round
holds no client's split. The first-order arch step takes the gradient in
the alphas alone (JAX takes it in every param and masks the weights'
part off: the same numbers); the unrolled step differentiates through
the lookahead ``w − ξ·∇w L_train(w, α)``, which needs GroupNorm's second
derivative (``ops.group_norm``). A BatchNorm search net (``norm="bn"``)
threads its running stats as JAX does: every forward reads the client's
stats, and only the weight step's forward writes them (the architecture
step's forwards, and the lookahead's, leave them as they were).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import grad, grad_and_value, vmap

from fedml_tpu_torch.algos.fedavg import FedAvgAPI
from fedml_tpu_torch.core.tree import tree_select
from fedml_tpu_torch.trainer.local import NetState, _per_client, softmax_ce

ALPHA_KEYS = ("alphas_normal", "alphas_reduce")


class FedNASLocalSearch:
    """``local_search(net, x, y, mask, rng) -> (net', loss)`` for one client
    and :meth:`run_clients` for a cohort (each step under ``vmap``): the
    bilevel DARTS step with the local-train signature, so the FedAvg round
    builders take it unchanged. Steps ``[0, h)`` are the train half and
    ``[h, 2h)`` the valid half, ``h = n_real // 2`` (the reference's 50/50
    split, FedNASTrainer.py:22-30; with an odd count the last real step
    feeds neither half). The search draws no random numbers, so ``rng``
    is unused. The loss is the weight steps' sample-weighted mean per
    epoch, averaged over epochs."""

    def __init__(self, apply_fn, lr_w: float, lr_a: float, xi: float,
                 local_epochs: int, unrolled: bool):
        self.apply_fn, self.lr_w, self.lr_a = apply_fn, lr_w, lr_a
        self.xi, self.local_epochs, self.unrolled = xi, local_epochs, unrolled

    def _loss(self, params, model_state, xb, yb, mb):
        """The batch's masked mean CE, and the model state its forward
        left."""
        logits, state = self.apply_fn(NetState(params, model_state), xb,
                                      train=True)
        per = softmax_ce(logits, yb)
        return (per * mb).sum() / torch.clamp(mb.sum(), min=1.0), state

    def _split(self, params):
        return ({k: v for k, v in params.items() if k in ALPHA_KEYS},
                {k: v for k, v in params.items() if k not in ALPHA_KEYS})

    def _loss_in_weights(self, alphas, model_state, xb, yb, mb):
        return lambda w: self._loss({**alphas, **w}, model_state, xb, yb, mb)

    def arch_grad(self, params, model_state, xt, yt, mt, xv, yv, mv):
        """The gradient of the valid loss in the alphas: at the weights
        (first order), or through the lookahead ``w − ξ∇w L_train`` (the
        unrolled, exact second-order step)."""
        alphas, weights = self._split(params)

        def val_loss(a):
            w = weights
            if self.unrolled:
                gw, _ = grad(self._loss_in_weights(a, model_state, xt, yt,
                                                   mt), has_aux=True)(w)
                w = {k: w[k] - self.xi * gw[k] for k in w}
            return self._loss({**a, **w}, model_state, xv, yv, mv)[0]

        return grad(val_loss)(alphas)

    def step(self, params, model_state, xt, yt, mt, xv, yv, mv, active):
        """One bilevel step of one client; ``active`` gates it. Returns
        the params, the model state of the weight step's forward, the
        loss and the step's sample count."""
        ga = self.arch_grad(params, model_state, xt, yt, mt, xv, yv, mv)
        alphas, weights = self._split(params)
        alphas = {k: alphas[k] - self.lr_a * ga[k] for k in alphas}
        gw, (loss, new_state) = grad_and_value(self._loss_in_weights(
            alphas, model_state, xt, yt, mt), has_aux=True)(weights)
        weights = {k: weights[k] - self.lr_w * gw[k] for k in weights}
        new = {k: alphas[k] if k in alphas else weights[k] for k in params}
        ns = torch.where(active, mt.sum(), torch.zeros_like(loss))
        return (tree_select(active, new, params),
                tree_select(active, new_state, model_state), loss, ns)

    def _search(self, params, model_state, x, y, mask, batched: bool):
        n_steps = mask.shape[-2]
        # True (non-padded) step count: padding sits at the tail, and a
        # real step has at least one unmasked sample.
        h = (mask > 0).any(-1).sum(-1) // 2
        if batched:
            rows = torch.arange(mask.shape[0], device=mask.device)

            def at(a, i):  # [C, S, B, ...] → each client's step i: [C, B, ...]
                return a[:, i] if isinstance(i, int) else a[rows, i]
        else:
            def at(a, i):
                if isinstance(i, int):
                    return a[i]
                return a.index_select(0, i.reshape(1))[0]
        step = self.step
        if batched:
            step = vmap(self.step, in_dims=(0, 0, -2, 0, 0, -2, 0, 0, 0))

        def inputs(i):
            xb = at(x, i)
            if batched:
                # Client dim next to the channel dim: the vmapped convs
                # then see channels-last inputs and GroupNorm reads views.
                xb = xb.movedim(0, -2).contiguous()
            return xb, at(y, i), at(mask, i)

        epoch_losses = []
        for _ in range(self.local_epochs):
            losses, ns = [], []
            for i in range(n_steps // 2):
                xt, yt, mt = inputs(i)
                xv, yv, mv = inputs(torch.clamp(h + i, max=n_steps - 1))
                active = (i < h) & (mt.sum(-1) > 0)
                params, model_state, loss, n = step(
                    params, model_state, xt, yt, mt, xv, yv, mv, active)
                losses.append(loss)
                ns.append(n)
            losses, ns = torch.stack(losses), torch.stack(ns)
            epoch_losses.append((losses * ns).sum(0)
                                / torch.clamp(ns.sum(0), min=1.0))
        return params, model_state, torch.stack(epoch_losses).mean(0)

    def __call__(self, net: NetState, x, y, mask, rng):
        params, state, loss = self._search(net.params, net.model_state, x,
                                           y, mask, batched=False)
        return NetState(params, state), loss

    def run_clients(self, net: NetState, x, y, mask, rngs):
        """The cohort (``x [C, S, B, ...]``) from one global ``net`` →
        (client nets with ``[C, ...]`` params and model state, losses
        ``[C]``)."""
        c = x.shape[0]
        params, state = ({k: _per_client(t, c) for k, t in tree.items()}
                         for tree in (net.params, net.model_state))
        params, state, losses = self._search(params, state, x, y, mask,
                                             batched=True)
        return NetState(params, state), losses


def make_fednas_local_search(apply_fn, lr_w: float, lr_a: float, xi: float,
                             local_epochs: int, unrolled: bool
                             ) -> FedNASLocalSearch:
    """The bilevel DARTS local step (see :class:`FedNASLocalSearch`)."""
    return FedNASLocalSearch(apply_fn, lr_w, lr_a, xi, local_epochs,
                             unrolled)


class FedNASAPI(FedAvgAPI):
    """Federated DARTS search (the reference's FedNASAPI.py:16) as a
    FedAvg-family algorithm: only the local step differs.

    ``arch_lr`` is the alphas' SGD lr, the live client lr the weights';
    ``xi``/``unrolled``: the 2nd-order arch step through the lookahead
    w − ξ∇L_train (architect.py's unrolled mode); ``unrolled=False`` is
    the reference's default 1st-order search."""

    window_carry = "— (alphas average with the weights)"

    def __init__(self, model, train_fed, test_global, cfg,
                 arch_lr: float = 3e-4, xi: float = 0.0,
                 unrolled: bool = False, **kw):
        # Read by _build_local_train, which super().__init__ calls: set
        # first.
        self.arch_lr = arch_lr
        self.xi = xi if unrolled else 0.0
        self.unrolled = unrolled
        self._steps = int(getattr(model, "steps", 4))
        self._multiplier = int(getattr(model, "multiplier", 4))
        super().__init__(model, train_fed, test_global, cfg, **kw)
        self._require_plain_sgd_round("FedNASAPI's bilevel search step")
        # Every client must pack >= 2 real steps: a 1-step client has h = 0,
        # trains nothing and keeps its full aggregation weight.
        counts = self._host_counts()
        steps = np.ceil(np.maximum(counts, 1) / cfg.batch_size)
        if int(steps.min()) < 2:
            raise ValueError(
                "FedNAS needs >= 2 packed steps for EVERY client (the "
                "local data is split into train/valid halves, "
                "FedNASTrainer.py:22-30); "
                f"min(ceil(count/batch)) = {int(steps.min())} — use a "
                "smaller batch_size so each client packs >= 2 batches")

    def _build_local_train(self, optimizer, loss_fn):
        # The bilevel step is its own plain SGD (weights at the live client
        # lr, alphas at arch_lr); the generic optimizer and loss are unused.
        del optimizer, loss_fn
        return make_fednas_local_search(
            self.fns.apply, self._client_lr, self.arch_lr, self.xi,
            self.cfg.epochs, self.unrolled)

    def genotype(self):
        """The searched architecture from the averaged alphas (the
        reference's record_model_global_architecture,
        FedNASAggregator.py:173)."""
        from fedml_tpu_torch.models.darts import derive_genotype

        return derive_genotype(
            self.net.params["alphas_normal"],
            self.net.params["alphas_reduce"], steps=self._steps,
            multiplier=self._multiplier)
