"""Turbo-Aggregate — secure aggregation with dropout-tolerant clients
(port of ``fedml_tpu/algos/turboaggregate.py``).

Parity target: reference fedml_api/standalone/turboaggregate/ — the MPC
library (mpc_function.py → ``core/mpc.py``), ``TA_Client.set_dropout``
(TA_client.py:25) and ``TurboAggregateTrainer`` (TA_trainer.py:11):
clients organized into groups, model updates masked so that no single
party, the server included, sees a raw update.

The protocol (additive-masking secure aggregation): every surviving
client quantizes its weighted model into the prime field and splits it
into additive shares, one per group; each group sums the shares it holds;
the server adds the group sums and dequantizes. The sum of all shares is
the sum of the secrets mod p, so the aggregate is the weighted mean up to
the 1/scale quantization, and it does not depend on the shares drawn. A
dropped client contributes nothing and its weight leaves the
normalization. The secret is the whole client net, its params and its
trained state (BatchNorm's running stats), as JAX ravels the
``NetState``.

On the card the cohort's local training is one captured step that returns
the client stack (no average); the stack comes to the host in one copy,
and the MPC runs there in numpy, as in the JAX package: the protocol is
between trust domains, not a device kernel. With a tracer installed the
round records ``turbo.train``, ``turbo.d2h`` and ``turbo.mpc`` spans.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from fedml_tpu_torch.algos.fedavg import FedAvgAPI
from fedml_tpu_torch.core import keys, mpc
from fedml_tpu_torch.data.batching import gather_clients
from fedml_tpu_torch.obs import trace as obs_trace
from fedml_tpu_torch.parallel.shard import client_rngs
from fedml_tpu_torch.trainer.local import NetState


class TurboAggregateAPI(FedAvgAPI):
    """FedAvg with MPC aggregation. ``n_groups`` = Turbo-Aggregate ring
    groups; ``scale`` = fixed-point quantization (2^16: ≤ 0.5/2^16 of
    error per client and value)."""

    #: Carry capability record: opted out, with the reason every tier
    #: guard quotes.
    window_protocol = None
    window_exclusion = (
        "aggregation is the host-side Turbo-Aggregate MPC protocol "
        "(prime-field additive shares across trust domains, "
        "core/mpc) — there is no pure (carry_init, server_update, "
        "carry_commit) device record to scan")

    def __init__(self, *args, n_groups: int = 2, scale: int = 2 ** 16,
                 prime: int = mpc.DEFAULT_PRIME, **kwargs):
        super().__init__(*args, **kwargs)
        if self.cfg.compress != "none":
            raise ValueError(
                "TurboAggregate's MPC path quantizes updates itself and "
                "bypasses the client-transform hook; cfg.compress would "
                "be silently dropped — unset it")
        self.n_groups = n_groups
        self.scale = scale
        self.prime = prime
        self.dropout_mask: Optional[np.ndarray] = None

    def set_dropout(self, dropped: Optional[Sequence[int]]):
        """Mark clients (by position in the sampled round) as dropped
        (reference TA_client.py:25)."""
        self.dropout_mask = (np.asarray(dropped, np.int64)
                             if dropped is not None else None)

    def _cohort_training(self):
        """The cohort's local training, uncaptured: ``step(net, idx, key)
        -> (net, (client nets [C, ...], losses [C]))``, each client's
        key ``fold_in(key, slot)``, the trained models not averaged, their
        params and trained state (BatchNorm's running stats) in one dict
        by name. From a store: ``step(net, x, y, mask, key)`` over the
        streamed cohort."""
        local_train = self.local_train

        def fed_step(net, x, y, mask, key):
            rngs = client_rngs(key, x.shape[0])
            nets, losses = local_train.run_clients(net, x, y, mask, rngs)
            return net, ({**nets.params, **nets.model_state}, losses)

        if self._streaming:
            return fed_step

        def step(net, idx, key):
            sub = gather_clients(self.train_fed, idx)
            return fed_step(net, sub.x, sub.y, sub.mask, key)

        return step

    def _local_batch(self):
        """The captured cohort training; a new client lr drops it with the
        other captured steps."""
        tier = "local_batch" + ("_store" if self._streaming else "")
        return self._captured(tier, self._cohort_training)

    def _train_clients(self, idx, key):
        """The cohort's trained nets (``{name: [C, ...]}``, params and
        state) and losses ``[C]`` on the device (the captured step's
        buffers); from a store
        the cohort is gathered on the host when the round needs it (the
        round's host MPC dwarfs the gather)."""
        if self._streaming:
            sub = self.train_fed.gather_cohort(np.asarray(idx))
            operands = (sub.x, sub.y, sub.mask)
        else:
            operands = (self._cohort_on_device(idx),)
        _, out = self._local_batch()(self.net, *operands, key)
        return out

    def _secure_aggregate(self, flat: np.ndarray, wn: np.ndarray,
                          share_rng) -> np.ndarray:
        """The MPC over the ``[C, D]`` float64 client vectors: quantized
        ``flat[c]·wn[c]`` split into ``n_groups`` additive shares, the
        group sums, their total, dequantized. Clients with ``wn`` 0
        contribute nothing."""
        group_sums = np.zeros((self.n_groups, flat.shape[1]), np.int64)
        for c in range(len(wn)):
            if wn[c] == 0.0:
                continue  # dropped or padded client
            q = mpc.quantize(flat[c] * wn[c], self.scale, self.prime)
            shares = mpc.additive_shares(q, self.n_groups, self.prime,
                                         share_rng)
            group_sums = np.mod(group_sums + shares, self.prime)
        total = np.zeros(flat.shape[1], np.int64)
        for g in range(self.n_groups):
            total = np.mod(total + group_sums[g], self.prime)
        return mpc.dequantize(total, self.scale, self.prime)

    def train_one_round(self, round_idx: int) -> Dict[str, float]:
        self._check_layout()
        tr = obs_trace.active()
        traced = tr is not obs_trace.NULL
        ck = obs_trace.corr(round=round_idx)
        idx = np.asarray(self.sample_round(round_idx))
        counts = self._host_counts()
        weights = counts[idx].astype(np.float64)
        if self.dropout_mask is not None:
            weights[self.dropout_mask] = 0.0
        pair = keys.split(self.rng)
        self.rng, rnd = pair[0], pair[1]
        with tr.span("turbo.train", cat="round", corr=ck,
                     clients=len(idx)):
            nets, losses = self._train_clients(idx, rnd)
            if traced:
                self._fence()
        wsum = weights.sum()
        if wsum == 0.0:
            # Every sampled client dropped: the round is a no-op (plain
            # FedAvg semantics keep the previous global model).
            return {"round": round_idx, "train_loss": float("nan")}
        wn = weights / wsum
        leaves = [(tree, k) for tree in ("params", "model_state")
                  for k in getattr(self.net, tree)]
        with tr.span("turbo.d2h", cat="round", corr=ck):
            # One copy of the whole stack to the host, in f64 there.
            stack = torch.cat([nets[k].reshape(len(idx), -1).float()
                               for _, k in leaves], 1).cpu()
            flat = stack.numpy().astype(np.float64)
            host_losses = losses.cpu().numpy().astype(np.float64)
        # The share stream comes from secret randomness, the api's key
        # chain, never from public round state. SIMULATION ONLY: MT19937
        # is not a CSPRNG; a deployment draws masks from an OS CSPRNG with
        # pairwise key agreement (mpc.key_agreement).
        pair = keys.split(self.rng)
        self.rng, mask_key = pair[0], pair[1]
        share_rng = np.random.RandomState(
            np.asarray([int(mask_key)], np.uint32))
        with tr.span("turbo.mpc", cat="round", corr=ck,
                     values=int(flat.size), groups=self.n_groups):
            avg_flat = self._secure_aggregate(flat, wn, share_rng)
        avg = torch.from_numpy(avg_flat.astype(np.float32)).to(self.device)
        new, off = {"params": {}, "model_state": {}}, 0
        for tree, k in leaves:
            ref = getattr(self.net, tree)[k]
            n = ref.numel()
            new[tree][k] = avg[off:off + n].view(ref.shape).to(ref.dtype)
            off += n
        self.net = NetState(new["params"], new["model_state"])
        return {"round": round_idx,
                "train_loss": float(np.sum(host_losses * wn))}
