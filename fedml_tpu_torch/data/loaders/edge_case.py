"""Backdoor / poisoned datasets for the robust-FL harness (port of
``fedml_tpu/data/loaders/edge_case.py``).

The reference's ``load_poisoned_dataset``
(edge_case_examples/data_loader.py:283) loads pre-baked poisoned torch
datasets (southwest-airplane CIFAR backdoor, ARDIS digit-7 MNIST backdoor,
green-car edge cases) plus the clean set and a *targeted* test loader that
measures attack success rate. The artifacts aren't downloadable here, so
this module generates the same *structure* synthetically:

- ``make_backdoor_dataset`` stamps a trigger patch onto a fraction of
  samples and flips their label to the attack target — the classic pattern
  backdoor (Gu et al., BadNets);
- ``make_edge_case_dataset`` draws inputs from a rare tail distribution
  labelled with the target class (edge-case attack of the reference's
  southwest set);
- returns (poisoned_train, clean_test, targeted_test) with the targeted set
  containing ONLY triggered inputs whose ground truth is the target label,
  so accuracy on it == attack success rate, matching
  FedAvgRobustAggregator.test_target_accuracy (fedavg_robust/
  FedAvgRobustAggregator.py:270).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def stamp_trigger(x: np.ndarray, patch: int = 3, value: float | None = None) -> np.ndarray:
    """Set a bottom-right patch to the max intensity (NHWC or N,features)."""
    x = x.copy()
    if x.ndim == 2:  # flat features: poison the last `patch` dims
        x[:, -patch:] = value if value is not None else x.max()
    else:
        x[:, -patch:, -patch:, :] = value if value is not None else x.max()
    return x


def make_backdoor_dataset(
    x: np.ndarray,
    y: np.ndarray,
    target_label: int,
    fraction: float = 0.2,
    patch: int = 3,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Poison ``fraction`` of (x, y): stamp trigger, relabel to target.
    Returns (x_poisoned, y_poisoned, poison_mask)."""
    rng = np.random.RandomState(seed)
    n = len(x)
    k = int(round(fraction * n))
    idx = rng.choice(n, k, replace=False)
    xp, yp = x.copy(), y.copy()
    xp[idx] = stamp_trigger(x[idx], patch)
    yp[idx] = target_label
    mask = np.zeros(n, bool)
    mask[idx] = True
    return xp, yp, mask


def make_targeted_test_set(
    x_test: np.ndarray,
    y_test: np.ndarray,
    target_label: int,
    patch: int = 3,
    max_samples: int = 512,
) -> Tuple[np.ndarray, np.ndarray]:
    """Triggered inputs drawn from NON-target classes, labelled target:
    model accuracy on this set == attack success rate."""
    keep = np.where(y_test != target_label)[0][:max_samples]
    return stamp_trigger(x_test[keep], patch), np.full(len(keep), target_label, y_test.dtype)


def make_edge_case_dataset(
    n_samples: int,
    hwc=(32, 32, 3),
    target_label: int = 9,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Tail-distribution inputs (shifted far mode) all labelled target —
    the southwest-airplane style edge-case poison."""
    rng = np.random.RandomState(seed)
    x = 3.0 + 0.25 * rng.randn(n_samples, *hwc).astype(np.float32)
    y = np.full(n_samples, target_label, np.int32)
    return x, y


def load_poisoned_dataset(
    dataset: str = "cifar10",
    fraction: float = 0.2,
    target_label: int = 2,
    n_samples: int = 1024,
    batch_size: int = 32,
    seed: int = 0,
):
    """Structured equivalent of edge_case_examples/data_loader.py:283 —
    returns (poisoned_train_batches, clean_test_batches, targeted_test_batches,
    num_poisoned)."""
    from fedml_tpu_torch.data.loaders.common import batch_data
    from fedml_tpu_torch.data.synthetic import make_image_classification

    hwc = (784,) if dataset in ("mnist", "emnist") else (32, 32, 3)
    x, y = make_image_classification(n_samples, hwc=hwc, n_classes=10, seed=seed)
    xt, yt = make_image_classification(n_samples // 4, hwc=hwc, n_classes=10, seed=seed + 1)
    xp, yp, mask = make_backdoor_dataset(x, y, target_label, fraction, seed=seed)
    tx, ty = make_targeted_test_set(xt, yt, target_label)
    return (
        batch_data(xp, yp, batch_size),
        batch_data(xt, yt, batch_size),
        batch_data(tx, ty, batch_size),
        int(mask.sum()),
    )
