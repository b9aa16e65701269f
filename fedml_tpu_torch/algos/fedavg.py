"""FedAvg — synchronous federated averaging on one card (port of
``fedml_tpu/algos/fedavg.py``'s ``FedAvgAPI``, host-loop tier).

Sampled clients are a leading tensor dim; each local step of the whole
cohort runs under ``vmap`` (``parallel.shard.make_vmap_round``), and the
new global model is the sample-weighted client average. Ported: the
single-device, resident (``FederatedArrays``), ``client_selection=
"random"`` case with ``train_one_round``/``train``/``evaluate``. The
on-device scan, the windowed and pipelined tiers, meshes, streaming
stores, other selection modes, compression and layouts are not ported
yet: asking for any of them raises, by name.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from fedml_tpu_torch.algos.config import FedConfig
from fedml_tpu_torch.algos.loop import FederatedLoop
from fedml_tpu_torch.core import keys
from fedml_tpu_torch.core.device import resolve_device
from fedml_tpu_torch.data.batching import FederatedArrays
from fedml_tpu_torch.parallel.shard import make_vmap_round
from fedml_tpu_torch.trainer.local import (make_client_optimizer,
                                           make_eval_fn, make_local_train_fn,
                                           model_fns, softmax_ce)

#: FedConfig fields that the JAX FedAvgAPI reads and the port does not
#: implement yet; a non-default value is refused at construction.
UNPORTED_FIELDS = ("aggregator", "group_reduce", "corrupt_mode",
                   "client_selection", "compress", "wire_codec",
                   "ingest_workers", "compute_layout", "client_step_dtype",
                   "remat", "dp_clip", "dp_noise_multiplier")


def refuse_unported(cfg, fields=UNPORTED_FIELDS, who="FedAvgAPI"):
    defaults = {f.name: f.default for f in dataclasses.fields(FedConfig)}
    for name in fields:
        val = getattr(cfg, name, defaults[name])
        if val != defaults[name]:
            raise NotImplementedError(
                f"cfg.{name}={val!r} is not ported yet to the PyTorch "
                f"{who} (ROADMAP.md A5); leave it at {defaults[name]!r}")


class FedAvgAPI(FederatedLoop):
    """Federated trainer on one card. ``model`` is an ``nn.Module`` whose
    own parameters are the initial global model (``api.net`` is public and
    may be replaced); ``train_fed`` a ``FederatedArrays`` on ``device``
    (``None`` → cuda); ``test_global`` an ``(x, y, mask)`` triple from
    ``data.batching.batch_global`` or None. ``pad_id`` marks padding in
    sequence labels (excluded from eval accuracy); it must match the pad
    id of a sequence ``loss_fn`` (``partial(seq_softmax_ce, pad_id=...)``).
    """

    #: Set True by the one subclass that reads cfg.adapter_rank
    #: (FedAdapterAPI); every other trainer class refuses the flag, which
    #: would otherwise silently train the dense model.
    _consumes_adapter_cfg = False

    def __init__(self, model, train_fed: FederatedArrays, test_global,
                 cfg: FedConfig, mesh=None, loss_fn=softmax_ce,
                 pad_id: int = 0, nan_guard: bool = False, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "a client mesh is not ported yet (ROADMAP.md A11); the port "
                "trains every client on one card")
        if not isinstance(train_fed, FederatedArrays):
            raise NotImplementedError(
                f"train_fed of type {type(train_fed).__name__}: only the "
                "resident FederatedArrays layout is ported (streaming "
                "stores: ROADMAP.md A9)")
        refuse_unported(cfg)
        if cfg.adapter_rank and not self._consumes_adapter_cfg:
            raise NotImplementedError(
                f"cfg.adapter_rank={cfg.adapter_rank} configures frozen-base "
                "adapter finetuning; use FedAdapterAPI (algos/fedadapter.py)"
                f" — on {type(self).__name__} the flag would be silently "
                "inert")
        self.device = resolve_device(device)
        fd, dev = train_fed.device, self.device
        if fd.type != dev.type or (fd.index is not None and dev.index
                                   is not None and fd.index != dev.index):
            raise ValueError(f"train_fed lies on {train_fed.device}, the "
                             f"driver runs on {self.device}")
        if cfg.batch_size != train_fed.batch_size:
            raise ValueError(
                f"cfg.batch_size={cfg.batch_size} != packed client batch "
                f"size {train_fed.batch_size}; build_federated_arrays with "
                "the same batch_size as the config")
        self.cfg = cfg
        self.train_fed, self.test_global = train_fed, test_global
        self.model = model.to(self.device)
        self.fns = self._model_fns(self.model)
        optimizer = make_client_optimizer(cfg.client_optimizer, cfg.lr,
                                          cfg.wd, cfg.grad_clip)
        self.local_train = make_local_train_fn(self.fns.apply, optimizer,
                                               cfg.epochs, loss_fn)
        self.round_fn = make_vmap_round(self.local_train,
                                        nan_guard=nan_guard)
        self.eval_fn = make_eval_fn(self.fns.apply, loss_fn, pad_id)
        self.rng = keys.split(keys.key(cfg.seed, self.device))[0]
        self.net = self.fns.init(torch.Generator().manual_seed(cfg.seed))

    def _model_fns(self, model):
        """The functional model interface that the round and the
        evaluation are built on. FedAdapterAPI returns the adapter-level fns here (``init`` →
        the trainable adapter tree, ``apply`` → the frozen base with the
        adapters per call), so the rest of FedAvg runs on the adapter tree
        unchanged."""
        return model_fns(model)

    def _server_update(self, old_net, avg_net):
        """FedAvg: the new global model is the client average."""
        return avg_net

    def train_one_round(self, round_idx: int) -> Dict[str, float]:
        avg, loss = self.run_round(round_idx)
        self.net = self._server_update(self.net, avg)
        return {"round": round_idx, "train_loss": float(loss)}

    def _unported(self, what):
        raise NotImplementedError(
            f"{what} is not ported yet (ROADMAP.md A5); use "
            "train_one_round / train")

    def train_rounds_on_device(self, n_rounds: int):
        self._unported("train_rounds_on_device")

    def train_rounds_pipelined(self, n_rounds: int, start_round: int = 0):
        self._unported("train_rounds_pipelined")

    def train_rounds_windowed(self, n_rounds: int, start_round: int = 0,
                              window: int = 8):
        self._unported("train_rounds_windowed")

    def train_windowed(self, window: int = 8):
        self._unported("train_windowed")
