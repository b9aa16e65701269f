"""Shared federated training loop (port of ``fedml_tpu/algos/loop.py``'s
``FederatedLoop``): seeded sampling, one round through ``round_fn``,
evaluation every ``frequency_of_the_test`` rounds and on the last."""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
from torch.func import vmap

from fedml_tpu_torch.algos.capability import record_for, refusal
from fedml_tpu_torch.core import keys
from fedml_tpu_torch.core.sampling import sample_clients
from fedml_tpu_torch.data.batching import gather_clients
from fedml_tpu_torch.trainer.local import NetState


def eval_segments(comm_round: int, frequency_of_the_test: int,
                  start: int = 0):
    """Splits ``[start, comm_round)`` into inclusive ``(lo, hi)`` spans,
    each ending at a round that :meth:`FederatedLoop.train` evaluates
    after (``round_idx % freq == 0`` or the last round): the windowed tier
    plans its windows within them, so a window never runs past a point
    where the host evaluates."""
    freq = max(int(frequency_of_the_test), 1)
    r = start
    while r < comm_round:
        e = r
        while not (e % freq == 0 or e == comm_round - 1):
            e += 1
        yield r, e
        r = e + 1


class FederatedLoop:
    """Mixin. Subclasses provide ``cfg``, ``train_fed``, ``test_global``,
    ``eval_fn``, ``train_one_round`` and ``_eval_net()`` (the model that
    ``evaluate`` and ``evaluate_on_clients`` read); those that also
    provide ``net``, ``rng`` and ``round_fn`` get the shared round
    scaffold (``sample_round``/``run_round``)."""

    def _eval_net(self):
        """The model the evaluations read: FedAvg's global net,
        DecentralizedAPI's consensus net."""
        raise NotImplementedError

    def capability(self):
        """This class's capability record (``algos/capability``), on which
        every tier's guard keys."""
        return record_for(type(self))

    def _require(self, tier: str, allowed: bool) -> None:
        if not allowed:
            raise NotImplementedError(refusal(type(self), tier))

    def train_one_round(self, round_idx: int) -> Dict[str, float]:
        raise NotImplementedError

    def sample_round(self, round_idx: int):
        """Reference-seeded sampling (``np.random.RandomState(round_idx)``,
        FedAVGAggregator.py:90-99). A sharded store's ``ClientDirectory``
        draws it from its count metadata, the same stream. Loss-biased
        selection is ``FedAvgAPI``'s; a class that lands here refuses it
        rather than silently sampling uniformly."""
        sel = getattr(self.cfg, "client_selection", "random")
        if sel != "random":
            raise NotImplementedError(
                f"client_selection={sel!r} is not supported by "
                f"{type(self).__name__}; only the FedAvg family implements "
                "loss-biased selection")
        directory = getattr(self.train_fed, "directory", None)
        if directory is not None \
                and directory.num_clients == self.cfg.client_num_in_total:
            return directory.sample_cohort(round_idx,
                                           self.cfg.client_num_per_round)
        return sample_clients(round_idx, self.cfg.client_num_in_total,
                              self.cfg.client_num_per_round)

    def _round_aux(self, round_idx: int, idx):
        """Trailing operands of ``round_fn`` beyond the standard seven,
        computed on the host per round from the cohort ``idx`` and handed
        over as device tensors (FedNova's τ-normalized weights, the attack
        drill's adversary mask). Default: none."""
        return ()

    def _cohort(self, round_idx: int, idx):
        """The round's sampled clients, gathered on the device."""
        return gather_clients(self.train_fed, idx)

    def run_round(self, round_idx: int):
        """One sampled round, eagerly: the cohort from ``_cohort`` (the
        device gather, or a store's host gather), weighted by true sample
        counts, fresh round key (kept as
        ``_last_round_key``: a randomized server update folds in from
        it). Returns ``(avg_net, mean_loss)`` without touching
        ``self.net``; a round built with ``with_client_losses`` keeps its
        third output, the clients' losses, as ``_round_client_losses``.
        With ``_server_update`` it is the reference procedure that the
        captured rounds are held to."""
        pair = keys.split(self.rng)
        self.rng, rnd_rng = pair[0], pair[1]
        self._last_round_key = rnd_rng
        idx = self.sample_round(round_idx)
        aux = self._round_aux(round_idx, idx)
        sub = self._cohort(round_idx, idx)
        weights = sub.counts.float()
        return self._unpack_round(self.round_fn(
            self.net, sub.x, sub.y, sub.mask, weights, weights, rnd_rng,
            *aux))

    def _unpack_round(self, out):
        """A round's ``(avg, loss)``; a third output (the in-round client
        losses of ``with_client_losses``) is kept as
        ``_round_client_losses``."""
        if len(out) == 3:
            avg, loss, self._round_client_losses = out
            return avg, loss
        return out

    def _per_client_eval(self, net, x, y, mask, net_dim=None):
        """``eval_fn`` over a client-stacked layout (``x [C, S, B, ...]``),
        without gradients, vmapped so each step is one launch of each
        kernel for every client: ``net`` is one model (``net_dim=None``)
        or per-client ``[C, ...]`` params and model state (``net_dim=0``).
        Evaluation runs in eval mode, on the running stats. Returns the
        metrics as ``[C]`` tensors."""

        def one(params, state, xc, yc, mc):
            return self.eval_fn(NetState(params, state), xc, yc, mc)

        return vmap(one, in_dims=(net_dim, net_dim, 0, 0, 0))(
            net.params, net.model_state, x, y, mask)

    def evaluate_on_clients(self, arrays=None,
                            prefix: str = "clients_train"
                            ) -> Dict[str, float]:
        """The global model on every client's LOCAL shard (the reference's
        ``_local_test_on_all_clients``) as one vmapped pass over resident
        ``FederatedArrays`` (``arrays``, default the training shards; the
        per-client test layout with ``prefix="clients_test"``): the
        sample-weighted means and the worst client's accuracy and loss,
        clients without samples left out of the worst. Over a store, the
        clients go through in host-gathered chunks
        (:meth:`_evaluate_on_clients_streaming`)."""
        f = self.train_fed if arrays is None else arrays
        if arrays is None and getattr(self, "_streaming", False):
            return self._evaluate_on_clients_streaming(prefix)
        m = self._per_client_eval(self._eval_net(), f.x, f.y, f.mask)
        num = m["num"]
        n = torch.clamp(num.sum(), min=1.0)
        present = num > 0
        inf = torch.tensor(float("inf"), device=num.device)
        worst_acc = torch.where(present, m["accuracy"], inf).min()
        worst_loss = torch.where(present, m["loss"], -inf).max()
        kind = prefix.split("_")[-1]
        return {
            f"{prefix}_acc": float((m["accuracy"] * num).sum() / n),
            f"{prefix}_loss": float((m["loss"] * num).sum() / n),
            f"worst_client_{kind}_acc": float(worst_acc),
            f"worst_client_{kind}_loss": float(worst_loss),
        }

    def _evaluate_on_clients_streaming(self, prefix: str,
                                       chunk: int = 256) -> Dict[str, float]:
        """:meth:`evaluate_on_clients` over a store: the clients in chunks
        of ``chunk`` (the device holds one chunk at a time), the same
        weighted means and worst-client figures."""
        store = self.train_fed
        net = self._eval_net()
        tot_acc = tot_loss = tot_n = 0.0
        worst_acc, worst_loss = float("inf"), float("-inf")
        for lo in range(0, store.num_clients, chunk):
            sub = store.gather_cohort(
                np.arange(lo, min(lo + chunk, store.num_clients)))
            m = self._per_client_eval(net, sub.x, sub.y, sub.mask)
            num, acc, loss = (m[k].cpu().numpy()
                              for k in ("num", "accuracy", "loss"))
            present = num > 0
            tot_acc += float((acc * num).sum())
            tot_loss += float((loss * num).sum())
            tot_n += float(num.sum())
            if present.any():
                worst_acc = min(worst_acc, float(acc[present].min()))
                worst_loss = max(worst_loss, float(loss[present].max()))
        n = max(tot_n, 1.0)
        kind = prefix.split("_")[-1]
        return {f"{prefix}_acc": tot_acc / n, f"{prefix}_loss": tot_loss / n,
                f"worst_client_{kind}_acc": worst_acc,
                f"worst_client_{kind}_loss": worst_loss}

    def evaluate(self) -> Dict[str, float]:
        if self.test_global is None:
            return {}
        x, y, mask = self.test_global
        m = self.eval_fn(self._eval_net(), x, y, mask)
        return {k: float(v) for k, v in m.items()}

    def train(self) -> List[Dict[str, float]]:
        history = []
        for round_idx in range(self.cfg.comm_round):
            metrics = self.train_one_round(round_idx)
            if (round_idx % self.cfg.frequency_of_the_test == 0
                    or round_idx == self.cfg.comm_round - 1):
                metrics.update(self.evaluate())
            history.append(metrics)
        return history
