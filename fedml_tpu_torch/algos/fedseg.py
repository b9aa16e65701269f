"""Federated semantic segmentation (port of ``fedml_tpu/algos/fedseg.py``).

FedAvg over a segmentation net with the fedseg losses and metrics:

- losses: pixel-wise CE and focal loss with an ``ignore_index``
  (SegmentationLosses, fedseg/utils.py:71-123), per example ``[B]``: each
  sample's mean over its valid pixels, the ``loss_fn`` contract of the
  local trainer, whose sample mask multiplies per-example losses;
- metrics: pixel accuracy, per-class accuracy, mIoU and FWIoU from a
  confusion matrix (Evaluator, fedseg/utils.py:246-280), built on the
  device by a fixed-length ``scatter_add_`` into C² + 1 bins (the last
  takes the ignored pixels) — ``torch.bincount`` would read its maximum
  back to the host to size its output, a sync per batch — and read once
  an evaluation;
- the per-client metric store (``EvaluationMetricsKeeper``,
  FedSegAggregator.py:105-160).
"""

from __future__ import annotations

from functools import partial
from typing import Dict

import numpy as np
import torch

from fedml_tpu_torch.algos.fedavg import FedAvgAPI


def _nll(logits, labels, ignore_index):
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    return nll, valid


def _per_example(per_pix, valid):
    per = torch.where(valid, per_pix, torch.zeros_like(per_pix))
    return per.flatten(1).sum(1) / torch.clamp(
        valid.flatten(1).sum(1).float(), min=1.0)


def seg_ce_loss(logits, labels, ignore_index: int = 255):
    """Pixel-wise softmax CE over ``[B, H, W, C]`` logits and ``[B, H, W]``
    integer labels; pixels equal to ``ignore_index`` count nothing.
    Returns the per-example loss ``[B]``."""
    nll, valid = _nll(logits, labels, ignore_index)
    return _per_example(nll, valid)


def seg_focal_loss(logits, labels, gamma: float = 2.0, alpha: float = 0.5,
                   ignore_index: int = 255):
    """Focal loss α(1 − p)^γ·CE (fedseg/utils.py:97-123), per example
    ``[B]`` as :func:`seg_ce_loss`."""
    nll, valid = _nll(logits, labels, ignore_index)
    return _per_example(alpha * (1.0 - torch.exp(-nll)) ** gamma * nll,
                        valid)


def build_seg_loss(mode: str = "ce", ignore_index: int = 255):
    """SegmentationLosses.build_loss ('ce' | 'focal')."""
    if mode == "ce":
        return partial(seg_ce_loss, ignore_index=ignore_index)
    if mode == "focal":
        return partial(seg_focal_loss, ignore_index=ignore_index)
    raise ValueError(f"unknown segmentation loss mode {mode!r}")


def confusion_matrix(pred, labels, num_classes: int, ignore_index: int = 255):
    """``[C, C]`` int64 confusion counts (rows = ground truth), on the
    device and without a host sync."""
    valid = ((labels != ignore_index) & (labels >= 0)
             & (labels < num_classes))
    bins = num_classes * num_classes
    idx = torch.where(valid, labels.long() * num_classes + pred.long(),
                      torch.full_like(labels, bins, dtype=torch.long))
    idx = idx.flatten()
    counts = torch.zeros(bins + 1, dtype=torch.int64, device=idx.device)
    counts.scatter_add_(0, idx, torch.ones_like(idx))
    return counts[:-1].reshape(num_classes, num_classes)


def evaluator_scores(cm) -> Dict[str, torch.Tensor]:
    """Pixel acc, class acc, mIoU and FWIoU of a confusion matrix
    (Evaluator.{Pixel_Accuracy,...}, fedseg/utils.py:251-280), in f64 for
    int64 counts, else f32."""
    cm = cm.double() if cm.dtype == torch.int64 else cm.float()
    total = torch.clamp(cm.sum(), min=1.0)
    diag = torch.diagonal(cm)
    gt, pr = cm.sum(1), cm.sum(0)
    union = gt + pr - diag
    present = gt > 0
    n_present = torch.clamp(present.sum(), min=1).to(cm.dtype)
    zero = torch.zeros_like(diag)
    acc = diag.sum() / total
    acc_class = torch.where(present, diag / torch.clamp(gt, min=1.0),
                            zero).sum() / n_present
    iou = torch.where(union > 0, diag / torch.clamp(union, min=1.0), zero)
    miou = torch.where(present, iou, zero).sum() / n_present
    fwiou = torch.where(present, gt / total * iou, zero).sum()
    return {"acc": acc, "acc_class": acc_class, "mIoU": miou,
            "FWIoU": fwiou}


class EvaluationMetricsKeeper:
    """Per-client running metric store (fedseg/utils.py:62-69 and the
    aggregator's dicts, FedSegAggregator.py:105-160)."""

    def __init__(self):
        self._store: Dict[int, Dict[str, float]] = {}

    def add(self, client_idx: int, metrics: Dict[str, float]):
        self._store[client_idx] = {k: float(v) for k, v in metrics.items()}

    def aggregate(self) -> Dict[str, float]:
        if not self._store:
            return {}
        keys = next(iter(self._store.values())).keys()
        return {
            k: float(np.mean([m[k] for m in self._store.values()]))
            for k in keys
        }


class FedSegAPI(FedAvgAPI):
    """FedAvg over a segmentation model with the segmentation losses and
    metrics. ``loss_mode``: 'ce' | 'focal'; labels carry ``ignore_index``
    on void pixels. ``evaluate`` reports acc/acc_class/mIoU/FWIoU over the
    global test set from one confusion matrix built on the device."""

    window_carry = "— (seg loss/metrics live in the local step/eval)"

    def __init__(self, model, train_fed, test_global, cfg, num_classes: int,
                 loss_mode: str = "ce", ignore_index: int = 255, **kw):
        self.num_classes = num_classes
        self.ignore_index = ignore_index
        super().__init__(model, train_fed, test_global, cfg,
                         loss_fn=build_seg_loss(loss_mode, ignore_index),
                         **kw)
        self.metrics_keeper = EvaluationMetricsKeeper()

    @torch.no_grad()
    def _eval_cm(self, net, x, y, mask):
        """The confusion matrix of ``net`` over batched ``(x, y, mask)``;
        padded rows go in as ignored pixels."""
        nc, ig = self.num_classes, self.ignore_index
        cm = torch.zeros(nc, nc, dtype=torch.int64, device=x.device)
        for bx, by, bm in zip(x, y, mask):
            logits, _ = self.fns.apply(net, bx, train=False)
            by = torch.where(bm[:, None, None] > 0, by,
                             torch.full_like(by, ig))
            cm += confusion_matrix(logits.argmax(-1), by, nc, ig)
        return cm

    def evaluate(self) -> Dict[str, float]:
        if self.test_global is None:
            return {}
        cm = self._eval_cm(self._eval_net(), *self.test_global)
        return {k: float(v) for k, v in evaluator_scores(cm).items()}

    def evaluate_clients(self, test_local: Dict[int, tuple]
                         ) -> Dict[str, float]:
        """Per-client evaluation (the aggregator's add_client_test_result /
        output_global_acc_and_loss, FedSegAggregator.py:105-160):
        ``test_local`` maps client id → batched ``(x, y, mask)``; each
        client's scores land in ``self.metrics_keeper`` and the unweighted
        client mean is returned."""
        net = self._eval_net()
        for cid, (x, y, mask) in test_local.items():
            cm = self._eval_cm(net, x, y, mask)
            self.metrics_keeper.add(
                cid, {k: float(v) for k, v in evaluator_scores(cm).items()})
        return self.metrics_keeper.aggregate()
