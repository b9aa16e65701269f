"""ModelTrainer ABC + task trainers (port of
``fedml_tpu/trainer/model_trainer.py``).

Parity with the reference's framework-agnostic operator interface
(fedml_core/trainer/model_trainer.py:4-38: get/set_model_params, train,
test, test_on_the_server) and its three standalone task implementations
(fedml_api/standalone/fedavg/my_model_trainer_classification.py, _nwp.py,
_tag_prediction.py).

The train loop is ``trainer/local.py``'s ``make_local_train_fn`` (the
masked, reshuffled epochs of the federated rounds) and the evaluation its
``make_eval_fn``; this module packages them in the reference's object
shape. A trainer runs on ``device`` (``None`` → cuda, through
``core.device.resolve_device``): the model is moved there and batches are
packed there. Its keys come from ``core.keys``: ``key(seed + id)``,
split once per ``train`` call. ``remat``, ``dp_clip`` and
``dp_noise_multiplier`` are not ported yet (ROADMAP.md A3) and are
refused by name when set.
"""

from __future__ import annotations

import abc
from functools import partial
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from fedml_tpu_torch.core import keys
from fedml_tpu_torch.core.device import resolve_device
from fedml_tpu_torch.trainer.local import (NetState, make_client_optimizer,
                                           make_eval_fn, make_local_train_fn,
                                           model_fns, seq_softmax_ce,
                                           softmax_ce)

#: Trainer arguments of the JAX package that the port refuses when set.
UNPORTED_ARGS = ("remat", "dp_clip", "dp_noise_multiplier")


def sigmoid_bce(logits, labels):
    """Per-example multi-label BCE (tag prediction: labels are multi-hot
    [B, C]); mean over labels per sample."""
    logits = logits.float()
    per_label = -(labels * F.logsigmoid(logits)
                  + (1.0 - labels) * F.logsigmoid(-logits))
    return per_label.mean(-1)


class ModelTrainer(abc.ABC):
    """The reference ABC: params are a ``NetState``, the id is the client
    index (model_trainer.py:10 set_id)."""

    def __init__(self, model, args=None, device=None):
        for name in UNPORTED_ARGS:
            if getattr(args, name, None):
                raise NotImplementedError(
                    f"args.{name}={getattr(args, name)!r} is not ported yet "
                    f"to the PyTorch ModelTrainer (ROADMAP.md A3); leave it "
                    f"unset")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.fns = model_fns(self.model)
        self.args = args
        self.id = 0
        self.net: Optional[NetState] = None

    def set_id(self, trainer_id: int):
        self.id = trainer_id

    def get_model_params(self):
        return self.net

    def set_model_params(self, net: NetState):
        self.net = net

    def init(self, rng=None, sample_x=None):
        """The model's own parameters and buffers as the trainer's net
        (``rng`` and ``sample_x``, JAX's init inputs, are not needed: the
        module was initialised when it was built)."""
        self.net = self.fns.init()
        return self.net

    @abc.abstractmethod
    def train(self, train_data, device=None, args=None) -> None:
        """Local training over [S, B, ...] packed batches (or a list of
        (x, y) numpy batch pairs from the data loaders)."""

    @abc.abstractmethod
    def test(self, test_data, device=None, args=None) -> Dict[str, float]:
        ...

    def test_on_the_server(self, train_local_dict, test_local_dict,
                           device=None, args=None) -> bool:
        """Reference default: returns False (aggregator falls back to
        per-client eval), model_trainer.py:34-38."""
        return False

    # -- shared plumbing ----------------------------------------------------
    def _pack(self, data):
        """Accept loader batch lists or pre-packed ``(x, y, mask)``."""
        if isinstance(data, tuple) and len(data) == 3:
            return data  # (x, y, mask) packed
        xs = np.concatenate([np.asarray(b[0]) for b in data])
        ys = np.concatenate([np.asarray(b[1]) for b in data])
        bs = len(np.asarray(data[0][0]))
        from fedml_tpu_torch.data.batching import batch_global

        x, y, mask = batch_global(xs, ys, bs, device=self.device)
        if not np.issubdtype(ys.dtype, np.integer):
            y = y.to(torch.float32)  # multi-hot tag labels stay f32
        return x, y, mask

    def _build(self, loss_fn, pad_id=0):
        args = self.args
        opt = make_client_optimizer(
            getattr(args, "client_optimizer", "sgd"),
            getattr(args, "lr", 0.03),
            getattr(args, "wd", 0.0),
        )
        epochs = getattr(args, "epochs", 1)
        self._local = make_local_train_fn(self.fns.apply, opt, epochs,
                                          loss_fn)
        self._eval = make_eval_fn(self.fns.apply, loss_fn, pad_id=pad_id)
        self._rng = keys.key(getattr(args, "seed", 0) + self.id,
                             device=self.device)

    def _train_packed(self, data):
        x, y, mask = self._pack(data)
        pair = keys.split(self._rng)
        self._rng, rng = pair[0], pair[1]
        self.net, loss = self._local(self.net, x, y, mask, rng)
        return float(loss)

    def _test_packed(self, data):
        x, y, mask = self._pack(data)
        m = self._eval(self.net, x, y, mask)
        return {k: float(v) for k, v in m.items()}


class ClassificationTrainer(ModelTrainer):
    """my_model_trainer_classification.py parity: CE loss, accuracy metric."""

    def __init__(self, model, args=None, device=None):
        super().__init__(model, args, device)
        self._build(softmax_ce)

    def train(self, train_data, device=None, args=None):
        return self._train_packed(train_data)

    def test(self, test_data, device=None, args=None):
        return self._test_packed(test_data)


class NwpTrainer(ModelTrainer):
    """my_model_trainer_nwp.py parity: per-position CE with pad masking."""

    def __init__(self, model, args=None, pad_id: int = 0, device=None):
        super().__init__(model, args, device)
        self._build(partial(seq_softmax_ce, pad_id=pad_id), pad_id=pad_id)

    def train(self, train_data, device=None, args=None):
        return self._train_packed(train_data)

    def test(self, test_data, device=None, args=None):
        return self._test_packed(test_data)


class TagPredictionTrainer(ModelTrainer):
    """my_model_trainer_tag_prediction.py parity: multi-label BCE; test
    reports precision/recall over the 0.5 threshold like the reference."""

    def __init__(self, model, args=None, device=None):
        super().__init__(model, args, device)
        self._build(sigmoid_bce)

    def train(self, train_data, device=None, args=None):
        return self._train_packed(train_data)

    @torch.no_grad()
    def _prf(self, x, y, mask):
        tp = fp = fn = 0.0
        for bx, by, bm in zip(x, y, mask):
            logits, _ = self.fns.apply(self.net, bx, train=False)
            pred = (logits > 0).float()
            w = bm[:, None]
            tp = tp + (pred * by * w).sum()
            fp = fp + (pred * (1 - by) * w).sum()
            fn = fn + ((1 - pred) * by * w).sum()
        precision = tp / torch.clamp(torch.as_tensor(tp + fp), min=1.0)
        recall = tp / torch.clamp(torch.as_tensor(tp + fn), min=1.0)
        return precision, recall

    def test(self, test_data, device=None, args=None):
        x, y, mask = self._pack(test_data)
        precision, recall = self._prf(x, y, mask)
        return {"precision": float(precision), "recall": float(recall)}
