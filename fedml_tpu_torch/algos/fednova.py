"""FedNova — normalized averaging (Wang et al., NeurIPS'20; port of
``fedml_tpu/algos/fednova.py``, which derives the formulation below from
the reference's fedml_api/standalone/fednova/).

Vanilla SGD (the reference's default ``gmf=0``): client i runs τ_i local
steps and the server applies ``w⁺ = w_g − τ_eff · Σ p_i (w_g − w_i)/τ_i``
with ``p_i = n_i/N`` and ``τ_eff = Σ p_i τ_i``. That is the shared round's
weighted average with weights ``q_i ∝ n_i/τ_i``, then one interpolation
``w⁺ = w_g − γ (w_g − avg_q)`` with ``γ = τ_eff · Σ p_i/τ_i``. With equal
τ, γ is 1 and FedNova is FedAvg.

``(q, γ)`` are a function of the cohort's sample counts: computed on the
host in float64 each round (``_round_aux``) and handed to the captured
steps as f32 device tensors, copied in at every replay. The on-device
round draws its cohort inside the step and has no slot for them, so the
capability record refuses it.
"""

from __future__ import annotations

import numpy as np

from fedml_tpu_torch.algos.fedavg import FedAvgAPI
from fedml_tpu_torch.core.tree import tree_map
from fedml_tpu_torch.trainer.local import NetState


class FedNovaAPI(FedAvgAPI):
    window_carry = "— (per-round q-weights + γ ride the scanned aux slot)"

    def _local_steps(self, counts) -> np.ndarray:
        """τ_i = epochs × ceil(n_i / B): the trainer's shuffle keeps padding
        at the tail, so client i takes exactly that many optimizer steps.
        An empty slot clamps to one step (its weight is zero anyway)."""
        b = self.cfg.batch_size
        return np.maximum(np.ceil(np.asarray(counts) / b),
                          1.0) * self.cfg.epochs

    def _nova_operands(self, counts: np.ndarray):
        """``(q, γ)`` of one round from the cohort's sample counts, in
        float64 on the host."""
        counts = np.asarray(counts, np.float64)
        tau = self._local_steps(counts)
        n_total = counts.sum()
        p = counts / max(n_total, 1.0)
        tau_eff = float((p * tau).sum())
        s = float((p / tau).sum())
        return counts / tau, np.float32(tau_eff * s)

    def _round_aux(self, round_idx: int, idx):
        q, gamma = self._nova_operands(
            self._host_counts()[np.asarray(idx)].astype(np.float64))
        return (self._to_device(q.astype(np.float32)),
                self._to_device(np.asarray(gamma, np.float32)))

    def _make_vmap_round(self, local_train, transform, guard):
        base = super()._make_vmap_round(local_train, transform, guard)

        def round_fn(net, x, y, mask, weights, loss_weights, rng, q, gamma):
            # Aggregate with the τ-normalized q, report the loss with the
            # true sample counts, then interpolate by γ; a further output
            # (oort's client losses) passes through.
            avg, loss, *rest = base(net, x, y, mask, q, loss_weights, rng)
            new_params = tree_map(lambda w, a: w - gamma * (w - a),
                                  net.params, avg.params)
            return (NetState(new_params, avg.model_state), loss, *rest)

        return round_fn
