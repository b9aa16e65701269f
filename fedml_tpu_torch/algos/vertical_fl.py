"""Classical vertical (feature-partitioned) federated learning (port of
``fedml_tpu/algos/vertical_fl.py``; reference
fedml_api/standalone/classical_vertical_fl/).

The guest holds the labels and a feature slice, each host only a feature
slice. Per batch every party runs its extractor and head on its own slice
and sends its logit contribution to the guest; the guest sums them, takes
the sigmoid-BCE loss and sends back the **common gradient** ``dL/dz =
(σ(z) − y)/B``; every party pulls it back through its own nets
(``torch.func.vjp``: the cotangent in is the wire protocol's message) and
steps ``add_decayed_weights(0.01) → sgd(lr, momentum 0.9)``. Each party's
update depends on the common gradient alone, so the simulation's
arithmetic is the distributed protocol's.

The models are small dense layers: no kernel of the port runs here, and
the steps run eagerly. ``fit`` keeps its per-batch losses on the device
and reads them once at its end.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call, vjp

from fedml_tpu_torch.algos.capability import ExcludedScanTiers
from fedml_tpu_torch.core.device import resolve_device
from fedml_tpu_torch.models.vfl import VFLDenseModel, VFLLocalModel
from fedml_tpu_torch.trainer.local import (_add_decayed_weights, _chain,
                                           _scale, _trace, apply_updates)


class VflParty:
    """One party's (local extractor → dense head) pair; ``params`` is
    ``{"local": {name: tensor}, "dense": {name: tensor}}`` (JAX's
    ``{"local": {"Dense_0"}, "dense": {"Dense_0"}}``)."""

    def __init__(self, feature_dim: int, rep_dim: int, use_bias: bool,
                 generator=None, device=None):
        dev = resolve_device(device)
        self.local = VFLLocalModel(feature_dim, rep_dim, generator).to(dev)
        self.dense = VFLDenseModel(rep_dim, 1, use_bias, generator).to(dev)
        self.params = {
            part: {k: v.detach().clone()
                   for k, v in getattr(self, part).named_parameters()}
            for part in ("local", "dense")}

    def forward(self, params, x):
        rep = functional_call(self.local, params["local"], (x,))
        return functional_call(self.dense, params["dense"], (rep,))


def _sigmoid_bce(logits, labels):
    """optax's ``sigmoid_binary_cross_entropy``, per example."""
    return -(labels * F.logsigmoid(logits)
             + (1.0 - labels) * F.logsigmoid(-logits))


class VflAPI(ExcludedScanTiers):
    """Two-or-more-party VFL with a logistic top (reference
    VerticalMultiplePartyLogisticRegressionFederatedLearning, vfl.py:1).

    ``x_parties``: per-party feature matrices ``[N, d_p]``, the guest
    first; ``y``: binary labels ``[N]``, the guest's. ``device=None`` runs
    on the card."""

    window_protocol = None
    window_exclusion = (
        "vertical FL partitions FEATURES, not clients: every party "
        "joins every batch and the guest's common gradient crosses "
        "trust domains per batch — no client-cohort round exists to "
        "publish as a carry record")

    def __init__(self, feature_dims: Sequence[int], rep_dim: int = 32,
                 lr: float = 0.01, seed: int = 0, device=None):
        self.device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        # The guest keeps the bias, the hosts have none (party_models.py),
        # so the summed logit has one.
        self.parties: List[VflParty] = [
            VflParty(d, rep_dim, use_bias=(i == 0), generator=gen,
                     device=self.device)
            for i, d in enumerate(feature_dims)]
        # The reference's SGD(momentum 0.9, weight_decay 0.01)
        # (vfl_models_standalone.py:13).
        self.opt = _chain(_add_decayed_weights(0.01), _trace(0.9),
                          _scale(-lr))
        self.opt_states = [self.opt.init(p.params) for p in self.parties]

    def _step(self, params_list, opt_list, xs, y):
        """One batch of the protocol: returns (params', opt states', loss)."""
        logits, pullbacks = [], []
        for party, p, x in zip(self.parties, params_list, xs):
            out, pull = vjp(lambda pp, px=x, pt=party: pt.forward(pp, px), p)
            logits.append(out)
            pullbacks.append(pull)
        total = sum(logits)[:, 0]
        # The guest: the loss and the common gradient dL/dz.
        loss = _sigmoid_bce(total, y).mean()
        common = ((torch.sigmoid(total) - y) / y.shape[0])[:, None]
        new_params, new_opts = [], []
        for p, pull, st in zip(params_list, pullbacks, opt_list):
            (grads,) = pull(common)
            updates, st2 = self.opt.update(grads, st, p)
            new_params.append(apply_updates(p, updates))
            new_opts.append(st2)
        return new_params, new_opts, loss

    def _put(self, a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def fit(self, x_parties: Sequence[np.ndarray], y: np.ndarray,
            epochs: int = 5, batch_size: int = 64) -> List[float]:
        """The reference's fit(): epochs × batches over the aligned samples,
        the residual partial batch included (vfl_fixture.py:41-45). Returns
        the per-batch losses."""
        n = len(y)
        xs_all = [self._put(x) for x in x_parties]
        y_all = self._put(y)
        params = [p.params for p in self.parties]
        opts = self.opt_states
        losses = []
        steps = max(1, (n + batch_size - 1) // batch_size)
        for _ in range(epochs):
            for s in range(steps):
                sl = slice(s * batch_size, min(n, (s + 1) * batch_size))
                params, opts, loss = self._step(
                    params, opts, [x[sl] for x in xs_all], y_all[sl])
                losses.append(loss)
        for p, new in zip(self.parties, params):
            p.params = new
        self.opt_states = opts
        return torch.stack(losses).cpu().tolist()

    @torch.no_grad()
    def predict(self, x_parties: Sequence[np.ndarray]) -> np.ndarray:
        total = sum(party.forward(party.params, self._put(x))
                    for party, x in zip(self.parties, x_parties))[:, 0]
        return torch.sigmoid(total).cpu().numpy()

    def evaluate(self, x_parties, y) -> Dict[str, float]:
        prob = self.predict(x_parties)
        acc = float(np.mean((prob > 0.5).astype(np.int32) == y))
        return {"accuracy": acc}
