"""FedAvg with robust aggregation and the attack drill (port of
``fedml_tpu/algos/robust.py``; reference:
fedml_api/distributed/fedavg_robust/FedAvgRobustAggregator.py).

- Each client's update is norm-diff clipped before aggregation (:179-185,
  the client transform) and the aggregate gets weak-DP Gaussian noise
  (:202-205), keyed by ``fold_in(round_key, _NOISE_TAG)`` inside the pure
  server update, so every tier draws the same noise.
- ``cfg.aggregator`` (inherited) swaps the mean for a Byzantine-robust
  reduction (``core/robust_agg``).
- The attack side: with ``cfg.attack_freq = k`` the adversary clients are
  forced into every k-th round's cohort (main_fedavg_robust.py:120), and
  ``cfg.corrupt_mode`` arms the device-side corruption drill on their
  trained updates, its ``[C]`` adversary mask a per-round aux operand.
  :func:`attack_success_rate` measures the model on a targeted test set.

The noise is drawn from ``core/keys.py``, not threefry.
"""

from __future__ import annotations

import numpy as np

from fedml_tpu_torch.algos.fedavg import FedAvgAPI
from fedml_tpu_torch.core import keys
from fedml_tpu_torch.core.faults import UpdateCorruptor
from fedml_tpu_torch.core.robustness import (add_gaussian_noise,
                                             norm_diff_clipping)
from fedml_tpu_torch.data.batching import batch_global
from fedml_tpu_torch.trainer.local import NetState

#: fold_in child of a round's key for the weak-DP noise: at the top of
#: the int32 range, where no client slot's stream (``fold_in(round_key,
#: slot)``) can reach it.
_NOISE_TAG = 0x7FFFFF3D


def attack_success_rate(api, x_targeted, y_target,
                        batch_size: int = 128) -> float:
    """Accuracy of the current global model on a targeted test set
    (triggered inputs labelled with the attack target): the backdoor's
    success rate (FedAvgRobustAggregator.test_target_accuracy)."""
    xt, yt, mask = batch_global(np.asarray(x_targeted), np.asarray(y_target),
                                batch_size, device=api.device)
    return float(api.eval_fn(api.net, xt, yt, mask)["accuracy"])


class FedAvgRobustAPI(FedAvgAPI):

    window_carry = ("— (round-keyed weak-DP noise; [W, C] adversary "
                    "mask rides the scanned aux slot)")
    def __init__(self, *args, adversary_clients=None, **kwargs):
        super().__init__(*args, **kwargs)
        cfg = self.cfg
        armed = cfg.attack_freq or cfg.corrupt_mode != "none"
        if armed and adversary_clients is None:
            k = max(1, int(cfg.attack_num_adversaries))
            if k > cfg.client_num_in_total:
                raise ValueError(
                    f"attack_num_adversaries={k} exceeds "
                    f"client_num_in_total={cfg.client_num_in_total}")
            adversary_clients = range(cfg.client_num_in_total - k,
                                      cfg.client_num_in_total)
        self.adversary_clients = np.asarray(
            list(adversary_clients) if adversary_clients is not None else [],
            np.int64)
        if cfg.compress and cfg.compress != "none":
            # The client transform here is the norm clip: cfg.compress
            # would be silently dropped.
            raise ValueError(
                "FedAvgRobustAPI's client transform is the robust norm "
                "clip; combining it with simulated compression is not "
                "supported — drop cfg.compress or use plain FedAvg")

    def sample_round(self, round_idx: int):
        """Every ``attack_freq``-th round the adversary clients join the
        cohort in place of honest ones, evicted uniformly at random with
        ``np.random.RandomState(round_idx)``, as the JAX package does;
        other rounds sample as FedAvg does."""
        idx = super().sample_round(round_idx)
        freq = self.cfg.attack_freq
        if (not freq or self.adversary_clients.size == 0
                or round_idx % freq != 0):
            return idx
        active = np.asarray(idx)
        adv = self.adversary_clients
        n_adv = min(len(adv), len(active))
        honest = active[np.isin(active, adv, invert=True)]
        rs = np.random.RandomState(round_idx)
        keep = rs.choice(honest, size=min(len(honest),
                                          len(active) - n_adv),
                         replace=False) if len(honest) else honest
        return np.sort(np.concatenate([keep, adv[:n_adv]])).astype(
            active.dtype)

    def _client_transform(self):
        bound = self.cfg.robust_norm_bound

        def clip(global_net, client_net):
            return NetState(norm_diff_clipping(client_net.params,
                                               global_net.params, bound),
                            client_net.model_state)

        return clip

    # --- the device-side corruption drill (cfg.corrupt_mode) ---------------
    def _corruptor(self):
        """The mask-driven corruptor of ``cfg.corrupt_mode`` (built from
        cfg alone: the round is built inside ``FedAvgAPI.__init__``, before
        the adversaries are resolved)."""
        if self.cfg.corrupt_mode == "none":
            return None
        return UpdateCorruptor(self.cfg.corrupt_mode,
                               scale=self.cfg.corrupt_scale).device_fn()

    def _adv_mask(self, idx) -> np.ndarray:
        """1.0 at the cohort slots an adversary client holds."""
        return np.isin(np.asarray(idx),
                       self.adversary_clients).astype(np.float32)

    def _round_aux(self, round_idx: int, idx):
        if self.cfg.corrupt_mode == "none":
            return ()
        return (self._to_device(self._adv_mask(idx)),)

    # --- the server update: weak-DP noise, keyed by the round --------------
    def _noised(self, avg_net, key):
        params = add_gaussian_noise(avg_net.params,
                                    keys.fold_in(key, _NOISE_TAG),
                                    self.cfg.robust_stddev)
        return NetState(params, avg_net.model_state)

    def _server_update(self, old_net, avg_net):
        if self.cfg.robust_stddev > 0:
            return self._noised(avg_net, self._last_round_key)
        return avg_net

    def _window_server_update(self):
        """The pure form: the noise folds in from the step's round key, no
        carry; none at all when ``robust_stddev`` is 0."""
        if self.cfg.robust_stddev <= 0:
            return None

        def update(net, avg, extra, key):
            return self._noised(avg, key), extra

        return update
