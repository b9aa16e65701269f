"""Synthetic data (host-side numpy; port of ``fedml_tpu/data/
synthetic.py``'s ``make_classification`` and
``make_image_classification``)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def make_classification(n_samples: int, n_features: int = 16,
                        n_classes: int = 10, seed: int = 0,
                        noise: float = 0.1) -> Tuple[np.ndarray, np.ndarray]:
    """Features from a standard normal, labels the argmax of a random
    linear map plus noise (f32 features, int32 labels)."""
    rng = np.random.RandomState(seed)
    w = rng.randn(n_features, n_classes)
    x = rng.randn(n_samples, n_features).astype(np.float32)
    logits = x @ w + noise * rng.randn(n_samples, n_classes)
    y = np.argmax(logits, axis=1).astype(np.int32)
    return x, y


def make_image_classification(n_samples: int,
                              hwc: Tuple[int, int, int] = (28, 28, 1),
                              n_classes: int = 10, seed: int = 0
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """Class-conditional Gaussian images (NHWC, f32) and int32 labels."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, n_classes, size=n_samples).astype(np.int32)
    protos = rng.randn(n_classes, *hwc).astype(np.float32)
    x = protos[y] + 0.5 * rng.randn(n_samples, *hwc).astype(np.float32)
    return x, y
