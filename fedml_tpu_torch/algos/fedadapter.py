"""FedAdapter — federated finetuning of a frozen-base transformer's LoRA
adapters on one card (port of ``fedml_tpu/algos/fedadapter.py``'s
``FedAdapterAPI``).

The base transformer is frozen: its parameters never require a gradient,
are never averaged and stay bitwise unchanged across rounds (test-pinned).
The federated net IS the adapter tree, so every layer of ``FedAvgAPI`` —
the vmapped client step, the weighted average, evaluation — runs on a model
smaller by the rank ratio without knowing adapters exist — the fused,
pipelined and on-device tiers included, which capture the round as a CUDA
graph (the frozen base is read in place, never part of the carry). On the
card each local step of the cohort goes through the flash-attention
forward, dq and dk/dv kernels once per layer for every client.

Per-client personalized adapters live on the host in a
:class:`~fedml_tpu_torch.models.adapter.PersonalAdapterStore` (the store
the serving plane reads): :meth:`FedAdapterAPI.personalize_cohort` starts
each client from a ditto-style interpolation toward the global adapters and
runs the same local finetune; :meth:`FedAdapterAPI.evaluate_personalized`
reports the personalized-vs-global quality. The store is run state:
``obs/checkpoint.py``'s ``save_run`` keeps it once it was materialized.

Over a ``FederatedStore`` the rounds stream each cohort from the host,
and the windowed tier replays the round W times per superbatch, as for
FedAvg; personalization gathers its cohort from the store too.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from fedml_tpu_torch.algos.fedavg import FedAvgAPI
from fedml_tpu_torch.core import keys
from fedml_tpu_torch.core.flat import stacked_tree_of, stacked_vectors_np
from fedml_tpu_torch.data.batching import FederatedArrays, gather_clients
from fedml_tpu_torch.data.store import FederatedStore
from fedml_tpu_torch.models.adapter import (PersonalAdapterStore,
                                            adapter_model_fns, param_count)
from fedml_tpu_torch.trainer.local import NetState, softmax_ce

#: fold_in child reserved for the personalization pass's per-client rng
#: streams (disjoint from the trainer's slot streams), as in the JAX package.
_PERSONAL_TAG = 0xADA77


class FedAdapterAPI(FedAvgAPI):
    """FedAvg over the ADAPTER tree of a frozen-base ``transformer_lm``.

    ``model`` must be built with adapters (``create_model("transformer_lm",
    adapter_rank=r, adapter_scope=...)``); a dense model is refused rather
    than silently training nothing. ``self.net`` is the adapter tree;
    ``self.base`` the frozen base module. ``base_params`` (a state dict,
    e.g. ``convert.from_jax_params(...)[0]``) swaps a pretrained base in;
    its keys and shapes must be the model's. ``personal_interp`` in [0, 1]
    is the weight of the global adapters in a personalization start."""

    _consumes_adapter_cfg = True
    window_carry = "— (adapter tree is the net; base frozen off-scan)"

    def __init__(self, model, train_fed, test_global, cfg, mesh=None,
                 loss_fn=softmax_ce, pad_id: int = 0,
                 nan_guard: bool = False, personal_interp: float = 0.5,
                 personal_spill_dir: Optional[str] = None,
                 base_params=None, device=None):
        if cfg.compute_layout not in ("none", ""):
            raise NotImplementedError(
                "cfg.compute_layout pads the trainable tree, but the "
                "FedAdapter net is the adapter tree while the compute runs "
                "through the frozen base; run the logical layout")
        if cfg.client_step_dtype not in ("fp32", ""):
            raise NotImplementedError(
                "cfg.client_step_dtype casts the trained model, which for "
                "FedAdapter is the frozen base behind the adapters; build "
                "the model with dtype='bf16' instead (the adapter tree "
                "stays fp32)")
        if not 0.0 <= personal_interp <= 1.0:
            raise ValueError(
                f"personal_interp must be in [0, 1], got {personal_interp}")
        self._base_params = base_params
        super().__init__(model, train_fed, test_global, cfg, mesh=mesh,
                         loss_fn=loss_fn, pad_id=pad_id, nan_guard=nan_guard,
                         device=device)
        #: The frozen base module: never trained, never averaged.
        self.base = self.fns.holder["base"]
        self.personal_interp = float(personal_interp)
        self._personal_spill_dir = personal_spill_dir
        self._personal_store = None

    def _model_fns(self, model):
        return adapter_model_fns(model, base_params=self._base_params)

    # -- introspection ----------------------------------------------------
    def adapter_profile(self) -> Dict[str, float]:
        """Trainable adapter params against the frozen base: uploads carry
        the adapter tree only."""
        a = param_count(self.net.params)
        b = param_count(dict(self.base.named_parameters()))
        return {"adapter_params": a, "base_params": b,
                "total_params": a + b, "adapter_ratio": a / max(a + b, 1)}

    # -- personalization (ditto-style interpolation + local finetune) -----
    def personal_store(self) -> PersonalAdapterStore:
        if self._personal_store is None:
            self._personal_store = PersonalAdapterStore(
                self.cfg.client_num_in_total, self.net.params,
                spill_dir=self._personal_spill_dir)
        return self._personal_store

    def personalize_cohort(self, clients, seed: int = 0) -> np.ndarray:
        """One personalization pass for ``clients``: each starts from
        ``interp·global + (1 − interp)·personal`` (a client never
        personalized starts at the global), runs the federated round's local
        finetune on its own shard, and its trained adapters go to the
        personal store. Returns the per-client training losses."""
        store = self.personal_store()
        idx = np.asarray(clients, np.int64)
        lam = self.personal_interp
        gvec = store.vec_of(self.net.params)
        start = ((1.0 - lam) * store.gather(idx, self.net.params)
                 + lam * gvec[None])
        sub = _gather_shards(self.train_fed, idx)
        nets = _stack_netstates(start, store, self.net.model_state,
                                self.device)
        base = keys.fold_in(keys.key(self.cfg.seed, self.device),
                            _PERSONAL_TAG)
        rngs = keys.fold_in(keys.fold_in(base, seed),
                            torch.as_tensor(idx, device=self.device))
        trained, losses = self.local_train.run_stacked(
            nets, sub.x, sub.y, sub.mask, rngs)
        store.scatter(idx, stacked_vectors_np(trained.params))
        return losses.cpu().numpy()

    def evaluate_personalized(self, arrays=None, clients=None,
                              chunk: int = 256) -> Dict[str, float]:
        """Sample-weighted per-client quality of the PERSONALIZED adapters
        against the global adapters on each client's shard. ``arrays``
        defaults to the training shards; pass per-client held-out arrays
        for the honest personalization delta. Clients never personalized
        evaluate at the global."""
        f = arrays if arrays is not None else self.train_fed
        store = self.personal_store()
        ids = (np.asarray(clients, np.int64) if clients is not None
               else np.arange(f.num_clients, dtype=np.int64))
        tot = {"p_acc": 0.0, "p_loss": 0.0, "g_acc": 0.0, "g_loss": 0.0,
               "n": 0.0}
        for lo in range(0, len(ids), chunk):
            idx = ids[lo:lo + chunk]
            sub = _gather_shards(f, idx)
            nets = _stack_netstates(store.gather(idx, self.net.params), store,
                                    self.net.model_state, self.device)
            pm = self._per_client_eval(nets, sub.x, sub.y, sub.mask,
                                       net_dim=0)
            gm = self._per_client_eval(self.net, sub.x, sub.y, sub.mask)
            num = pm["num"]
            tot["p_acc"] += float((pm["accuracy"] * num).sum())
            tot["p_loss"] += float((pm["loss"] * num).sum())
            tot["g_acc"] += float((gm["accuracy"] * num).sum())
            tot["g_loss"] += float((gm["loss"] * num).sum())
            tot["n"] += float(num.sum())
        n = max(tot["n"], 1.0)
        return {
            "personal_accuracy": tot["p_acc"] / n,
            "personal_loss_eval": tot["p_loss"] / n,
            "global_local_accuracy": tot["g_acc"] / n,
            "global_local_loss": tot["g_loss"] / n,
            "personalized_delta": (tot["p_acc"] - tot["g_acc"]) / n,
        }

    # -- checkpoint/resume: the personal adapter store is run state --------
    def checkpoint_extra_state(self):
        extra = dict(super().checkpoint_extra_state())
        # Only a store that was ever materialized: personal_store()
        # allocates the whole [N, D] stack (or creates the memmap spill
        # file), which a run that never personalized must not pay at every
        # checkpoint. A restore tolerates the absent key; to restore one,
        # materialize the store first (it is the template).
        if self._personal_store is not None:
            extra.update(self._personal_store.state_dict())
        return extra

    def load_checkpoint_extra_state(self, extra) -> None:
        super().load_checkpoint_extra_state(extra)
        if extra and "personal_vecs" in extra:
            self.personal_store().load_state_dict(extra)


def _gather_shards(fed, idx) -> FederatedArrays:
    """The cohort's ``[k, S, B, ...]`` shards: the device gather of
    resident ``FederatedArrays``, the host gather of a store."""
    if isinstance(fed, FederatedStore):
        return fed.gather_cohort(np.asarray(idx))
    if not isinstance(fed, FederatedArrays):
        raise TypeError(
            f"{type(fed).__name__}: expected FederatedArrays or a "
            "FederatedStore")
    return gather_clients(fed, idx)


def _stack_netstates(vecs, store: PersonalAdapterStore, model_state,
                     device) -> NetState:
    """``[k, D]`` store rows → one NetState with ``[k, ...]`` adapter
    leaves on ``device`` (the vmapped cohort's layout), one copy."""
    return NetState(stacked_tree_of(vecs, store.spec, device), model_state)
