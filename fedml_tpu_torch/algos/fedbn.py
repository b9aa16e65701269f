"""FedBN — normalization layers stay client-local (Li et al., ICLR 2021;
port of ``fedml_tpu/algos/fedbn.py``).

Every normalization layer is left out of the aggregation: each client
keeps its own norm scale and bias (and BatchNorm's running stats), the
rest of the model federates as usual. Norm leaves are found by parameter
NAME, whose dotted segments follow flax's module paths
(``…Norm_2.GroupNorm_0.weight``), as the JAX package finds them by path.
The per-client norm leaves are one client stack on the device (norm
leaves only), the per-client model state (the whole ``model_state``)
another, and a round — one captured step of the "custom" carry protocol —

1. grafts each sampled client's norm leaves into the broadcast global,
   with the client's own model state,
2. trains the cohort from those per-client starting nets,
3. averages only the non-norm leaves into the new global (its norm leaves
   stay at their init: they only seed clients; its model state stays as
   it was),
4. scatters the trained norm leaves and model states back into the
   stacks.

Evaluation is per client by construction: a FedBN model is complete only
with a client's own norms (``evaluate`` is ``evaluate_personalized``).
"""

from __future__ import annotations

from typing import Dict

import torch

from fedml_tpu_torch.algos.ditto import weighted_client_metrics
from fedml_tpu_torch.algos.fedavg import RunStateCheckpoints, FedAvgAPI
from fedml_tpu_torch.core.tree import (client_rows, client_stack,
                                       gather_stacked, scatter_stacked)
from fedml_tpu_torch.parallel.shard import client_rngs
from fedml_tpu_torch.trainer.local import NetState

_NORM_PREFIXES = ("GroupNorm", "BatchNorm", "LayerNorm", "Norm_")


def norm_mask(params) -> Dict[str, bool]:
    """``{name: True}`` for the leaves of a norm layer: a dotted segment
    of the name starts with GroupNorm, BatchNorm, LayerNorm or Norm_."""
    return {k: any(seg.startswith(_NORM_PREFIXES) for seg in k.split("."))
            for k in params}


class FedBNAPI(RunStateCheckpoints, FedAvgAPI):
    """FedAvg with client-local normalization layers. A model without
    norm layers is refused (FedBN on it would be FedAvg, almost surely a
    misconfiguration), as is ``nan_guard``, which its round does not
    implement. The carry is ``(stack of the norm leaves, stack of the
    model states)``; ``local_norms`` and ``local_state`` are their
    ``[N, ...]`` views."""

    window_protocol = "custom"

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        if self._nan_guard:
            raise ValueError(
                "FedBNAPI's round does not implement nan_guard; rejecting "
                "rather than silently averaging diverged clients")
        self._norm_mask = norm_mask(self.net.params)
        if not any(self._norm_mask.values()):
            raise ValueError(
                "FedBN needs a model with normalization layers "
                "(GroupNorm/BatchNorm/LayerNorm); none found in the "
                "parameter tree")
        n = self.train_fed.num_clients
        self._norms = client_stack(self._norm_leaves(self.net.params), n)
        self._states = client_stack(self.net.model_state, n)

    def _norm_leaves(self, params):
        return {k: v for k, v in params.items() if self._norm_mask[k]}

    @property
    def local_norms(self):
        return client_rows(self._norms)

    @property
    def local_state(self):
        return client_rows(self._states)

    def _graft(self, global_params, norms):
        """Per-client starting params ``[k, ...]``: the clients' norm
        leaves over the broadcast global rest."""
        k = next(iter(norms.values())).shape[0]
        return {name: norms[name] if self._norm_mask[name]
                else g.unsqueeze(0).expand(k, *g.shape).clone()
                for name, g in global_params.items()}

    def _build_fused_step(self):
        """One FedBN round: the cohort's norm leaves gathered and grafted
        with its model states, the cohort trained (``local_train``, the
        cfg's optimizer), the non-norm leaves averaged, the trained norm
        leaves and states scattered back (an empty sampled client's
        training is a no-op, and the mask keeps its rows as they were)."""
        local_train, mask_of = self.local_train, self._norm_mask

        def step(net, extra, x, y, mask, weights, key, idx, umask):
            norms, states = extra
            sub = gather_stacked(norms, idx)
            start = NetState(self._graft(net.params, sub),
                             gather_stacked(states, idx))
            rngs = client_rngs(key, x.shape[0], 0)
            trained, losses = local_train.run_stacked(start, x, y, mask,
                                                      rngs)
            w = weights / torch.clamp(weights.sum(), min=1e-12)
            params = {
                name: g if mask_of[name] else torch.einsum(
                    "c,c...->...", w, trained.params[name].float()
                ).to(g.dtype)
                for name, g in net.params.items()}
            norms = scatter_stacked(norms, idx,
                                    self._norm_leaves(trained.params), umask)
            states = scatter_stacked(states, idx, trained.model_state, umask)
            return (NetState(params, net.model_state), (norms, states)), \
                (losses * w).sum()

        return step

    def _window_carry_init(self):
        return (self._norms, self._states)

    def _window_carry_commit(self, extra) -> None:
        self._norms, self._states = extra

    def evaluate(self) -> Dict[str, float]:
        """The personalized per-client eval: the global net's norm leaves
        are frozen at init, so the global model alone would be measured
        with random-init normalization."""
        return self.evaluate_personalized()

    def evaluate_personalized(self) -> Dict[str, float]:
        """Each client's model (its OWN norms grafted into the global, with
        its own model state) on its own local shard, sample-weighted (one
        vmapped pass over the resident shards; streaming stores are not
        ported, ROADMAP.md A9)."""
        f = self.train_fed
        nets = NetState(self._graft(self.net.params, self.local_norms),
                        self.local_state)
        return weighted_client_metrics(self._per_client_eval(
            nets, f.x, f.y, f.mask, net_dim=0))
