"""FedGAN — federated averaging over a generator and discriminator pair
(port of ``fedml_tpu/algos/fedgan.py``).

- Local GAN training (the reference's fedgan/MyModelTrainer.py:32-71): per
  batch, one Adam discriminator step on BCE(real, 1) + BCE(fake, 0), then
  one Adam generator step on BCE(D(G(z)), 1); both optimizers fresh each
  round.
- Joint aggregation of both nets (FedGANAggregator.py:58-88): the two nets
  are one param tree (``netg.*``, ``netd.*``), so FedAvg's weighted mean
  averages them together.

Each Adam (optax's defaults: 0.9, 0.999, eps 1e-8) updates its own subtree
only, with the other frozen, as JAX's ``multi_transform`` with
``set_to_zero`` freezes it; its state covers its subtree. The noise is
drawn inside the step from the port's counter keys (``keys.normal`` on
``fold_in(fold_in(step base, step), 0 / 1)``, the step index a device
tensor), so a captured round draws anew each replay. The random streams
differ from JAX's by design (threefry), so :class:`GanLocalTrain` takes
the noise and the epoch permutation as seams that the parity tests feed
with JAX's draws. A BatchNorm generator (``norm="bn"``) carries its
running stats as JAX does: each of its train-mode forwards (the fake
batch of D's step, then G's own step) updates them, and the round
averages them with the params; ``generate`` reads them in eval mode.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.func import functional_call, grad_and_value, vmap

from fedml_tpu_torch.algos.fedavg import FedAvgAPI
from fedml_tpu_torch.algos.fedopt import _scale_by_adam
from fedml_tpu_torch.core import keys
from fedml_tpu_torch.core.tree import tree_select
from fedml_tpu_torch.trainer.local import (NetState, _chain, _scale, _take,
                                           apply_updates, epoch_perm,
                                           model_fns)


def _sub(params, prefix):
    return {k[len(prefix):]: v for k, v in params.items()
            if k.startswith(prefix)}


def _bce(logits, target: float):
    """optax's ``sigmoid_binary_cross_entropy`` of ``logits [B, 1]``
    against a constant target, per example."""
    z = logits[:, 0]
    return F.binary_cross_entropy_with_logits(
        z, torch.full_like(z, target), reduction="none")


class GanLocalTrain:
    """``local_train(net, x, y, mask, rng) -> (net', mean_loss)`` for one
    client (``y`` is unused; ``mask [S, B]`` gates padded samples out of
    both losses) and :meth:`run_clients` for a cohort under ``vmap``. The
    reported loss is d_loss + g_loss, the sample-weighted mean over steps
    per epoch, averaged over epochs.

    Seams: ``noise(key, shape)`` draws a latent batch (``keys.normal``)
    and ``perm(mask, key)`` an epoch's permutation of the packed slots
    (``epoch_perm``); a caller may pass others, called in the order the
    reference draws (per epoch the permutation, then per step D's noise
    and G's)."""

    def __init__(self, module, lr: float, local_epochs: int,
                 latent_dim: int = 100, noise=None, perm=None):
        self.module, self.local_epochs = module, local_epochs
        self.latent_dim = latent_dim
        self.adam = _chain(_scale_by_adam(0.9, 0.999, 1e-8), _scale(-lr))
        self.noise = noise or keys.normal
        self.perm = perm or epoch_perm
        self._gen_apply = model_fns(module.netg).apply

    def _gen(self, pg, sg, z):
        """G's train-mode forward: the fake batch and G's new state."""
        return self._gen_apply(NetState(pg, sg), z, train=True)

    def _disc(self, pd, x):
        return functional_call(self.module.netd, pd, (x,))

    def step(self, pg, pd, sg, d_state, g_state, xb, mb, per_step):
        nb = torch.clamp(mb.sum(), min=1.0)
        b = xb.shape[0]
        fake, sg_d = self._gen(pg, sg, self.noise(keys.fold_in(per_step, 0),
                                                  (b, self.latent_dim)))
        fake = fake.detach()

        def d_loss(pd_):
            per = _bce(self._disc(pd_, xb), 1.0) + _bce(
                self._disc(pd_, fake), 0.0)
            return (per * mb).sum() / nb

        gd, dl = grad_and_value(d_loss)(pd)
        upd, new_d = self.adam.update(gd, d_state, pd)
        pd_new = apply_updates(pd, upd)
        zg = self.noise(keys.fold_in(per_step, 1), (b, self.latent_dim))

        def g_loss(pg_):
            fake_g, sg_g = self._gen(pg_, sg_d, zg)
            per = _bce(self._disc(pd_new, fake_g), 1.0)
            return (per * mb).sum() / nb, sg_g

        gg, (gl, sg_new) = grad_and_value(g_loss, has_aux=True)(pg)
        upd, new_g = self.adam.update(gg, g_state, pg)
        pg_new = apply_updates(pg, upd)
        nonempty = mb.sum() > 0
        return (tree_select(nonempty, pg_new, pg),
                tree_select(nonempty, pd_new, pd),
                tree_select(nonempty, sg_new, sg),
                tree_select(nonempty, new_d, d_state),
                tree_select(nonempty, new_g, g_state), dl + gl, mb.sum())

    def _train(self, params, state, x, mask, rng):
        pg, pd = _sub(params, "netg."), _sub(params, "netd.")
        sg = _sub(state, "netg.")
        d_state, g_state = self.adam.init(pd), self.adam.init(pg)
        pair = keys.split(rng)
        epoch_keys = keys.split(pair[..., 1], self.local_epochs)
        steps = torch.arange(mask.shape[0], device=mask.device)
        epoch_losses = []
        for e in range(self.local_epochs):
            epoch_key = epoch_keys[..., e]
            perm = self.perm(mask, keys.fold_in(epoch_key, 0))
            ex, em = _take(x, perm, False), _take(mask, perm, False)
            step_base = keys.fold_in(epoch_key, 1)
            losses, ns = [], []
            for s in range(mask.shape[0]):
                pg, pd, sg, d_state, g_state, loss, n = self.step(
                    pg, pd, sg, d_state, g_state, ex[s], em[s],
                    keys.fold_in(step_base, steps[s]))
                losses.append(loss)
                ns.append(n)
            losses, ns = torch.stack(losses), torch.stack(ns)
            epoch_losses.append((losses * ns).sum() / torch.clamp(ns.sum(),
                                                                  min=1.0))
        new = {**{"netg." + k: v for k, v in pg.items()},
               **{"netd." + k: v for k, v in pd.items()}}
        new_state = {"netg." + k: v for k, v in sg.items()}
        return ({k: new[k] for k in params}, {k: new_state[k] for k in state},
                torch.stack(epoch_losses).mean())

    def __call__(self, net: NetState, x, y, mask, rng):
        params, state, loss = self._train(net.params, net.model_state, x,
                                          mask, rng)
        return NetState(params, state), loss

    def run_clients(self, net: NetState, x, y, mask, rngs):
        """The cohort (``x [C, S, B, ...]``, ``rngs [C]``) from one global
        ``net`` → (client nets with ``[C, ...]`` params and G's state,
        losses ``[C]``)."""
        params, state, losses = vmap(self._train,
                                     in_dims=(None, None, 0, 0, 0))(
            net.params, net.model_state, x, mask, rngs)
        return NetState(params, state), losses


def make_gan_local_train(module, lr: float, local_epochs: int,
                         latent_dim: int = 100, noise=None,
                         perm=None) -> GanLocalTrain:
    """The adversarial D/G local step (see :class:`GanLocalTrain`)."""
    return GanLocalTrain(module, lr, local_epochs, latent_dim, noise, perm)


class FedGanAPI(FedAvgAPI):
    """Federated GAN trainer (the reference's FedGanAPI.py and
    FedGANAggregator.py): the local step is the adversarial D/G loop;
    sampling, aggregation and every round tier are FedAvg's. ``train_fed
    .y`` is ignored; a GAN has no accuracy (the reference logs only
    losses), so ``evaluate`` returns {}."""

    def __init__(self, model, train_fed, cfg, mesh=None,
                 latent_dim: int = None, device=None):
        if latent_dim is None:
            latent_dim = getattr(model, "latent_dim", 100)
        self.latent_dim = latent_dim
        super().__init__(model, train_fed, None, cfg, mesh=mesh,
                         device=device)
        # The adversarial step builds its own Adam pair: a config knob the
        # generic trainer honors is refused, not dropped.
        self._require_plain_sgd_round("FedGanAPI's adversarial D/G step")

    def _build_local_train(self, optimizer, loss_fn):
        # The two Adams take the live client lr; the generic optimizer and
        # loss are unused.
        del optimizer, loss_fn
        return make_gan_local_train(self.model, self._client_lr,
                                    self.cfg.epochs, self.latent_dim)

    def evaluate(self):
        return {}

    @torch.no_grad()
    def generate(self, n: int, key=None):
        """``n`` images ``[n, 28, 28, 1]`` from the current global
        generator; ``key`` (a port key) or the next split of ``api.rng``."""
        if key is None:
            pair = keys.split(self.rng)
            self.rng, key = pair[0], pair[1]
        z = keys.normal(key, (n, self.latent_dim))
        net = NetState(_sub(self.net.params, "netg."),
                       _sub(self.net.model_state, "netg."))
        return model_fns(self.model.netg).apply(net, z, train=False)[0]
