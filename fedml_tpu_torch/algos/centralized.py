"""Centralized (non-federated) baseline trainer (port of
``fedml_tpu/algos/centralized.py``; reference:
fedml_api/centralized/centralized_trainer.py:9): the pooled dataset
trained conventionally with the same local trainer and evaluation as the
federated rounds, the reference of the "full participation equals
centralized" pin."""

from __future__ import annotations

from fedml_tpu_torch.core import keys
from fedml_tpu_torch.core.device import resolve_device
from fedml_tpu_torch.trainer.local import (make_client_optimizer,
                                           make_eval_fn, make_local_train_fn,
                                           model_fns, softmax_ce)


class CentralizedTrainer:
    """One model on one device (``None`` → cuda). A mesh (the JAX
    package's batch-axis data parallelism) is not ported yet."""

    def __init__(self, model, cfg, loss_fn=softmax_ce, mesh=None,
                 device=None):
        if mesh is not None:
            raise NotImplementedError(
                "batch-axis data parallelism over a mesh is not ported yet "
                "(ROADMAP.md A11); the port trains on one card")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.fns = model_fns(self.model)
        optimizer = make_client_optimizer(cfg.client_optimizer, cfg.lr,
                                          cfg.wd)
        self.train_fn = make_local_train_fn(self.fns.apply, optimizer,
                                            cfg.epochs, loss_fn)
        self.eval_fn = make_eval_fn(self.fns.apply, loss_fn)
        self.rng = keys.split(keys.key(cfg.seed, self.device))[0]
        self.net = None

    def init_params(self, sample_x=None):
        """The model's own parameters as the start (``sample_x`` is
        accepted for the JAX signature; the port's modules are built with
        their shapes)."""
        self.net = self.fns.init()
        return self.net

    def train(self, x, y, mask) -> float:
        """One pass of ``cfg.epochs`` epochs over batched ``[S, B, ...]``
        data; returns the mean loss."""
        if self.net is None:
            self.init_params()
        pair = keys.split(self.rng)
        self.rng, sub = pair[0], pair[1]
        self.net, loss = self.train_fn(self.net, x, y, mask, sub)
        return float(loss)

    def evaluate(self, x, y, mask):
        return {k: float(v)
                for k, v in self.eval_fn(self.net, x, y, mask).items()}
