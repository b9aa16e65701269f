"""FedProx — FedAvg with the proximal term μ/2·‖w − w_global‖² in the
local objective (Li et al., MLSys'20; port of ``fedml_tpu/algos/
fedprox.py``, which notes that the reference's snapshot leaves the term
out). The proximal gradient μ(w − w_global) is added to every local step
through the trainer's ``extra_grad_fn``, ``w_global`` the round's
broadcast params; at μ = 0 none is added, and the round is FedAvg's."""

from __future__ import annotations

from fedml_tpu_torch.algos.fedavg import FedAvgAPI
from fedml_tpu_torch.core.tree import tree_map
from fedml_tpu_torch.trainer.local import make_local_train_fn


class FedProxAPI(FedAvgAPI):
    """Only the local objective changes, so FedProx has no carry and rides
    every round tier FedAvg does."""

    window_carry = "— (μ term lives in the local step)"

    def _build_local_train(self, optimizer, loss_fn):
        mu = self.cfg.fedprox_mu

        def prox_grad(params, global_params):
            return tree_map(lambda p, g: mu * (p - g), params, global_params)

        return make_local_train_fn(self.fns.apply, optimizer,
                                   self.cfg.epochs, loss_fn,
                                   extra_grad_fn=prox_grad if mu > 0
                                   else None)
