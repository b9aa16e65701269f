"""CIFAR-10 / CIFAR-100 / CINIC-10 loaders (port of
``fedml_tpu/data/loaders/cifar.py``) with in-loader federated
partitioning (homo / hetero-LDA), the reference's
``load_partition_data_cifar10`` family (cifar10/data_loader.py:235,
cifar100, cinic10 — identical structure, different normalisation constants).

Raw formats are read directly (no torchvision): CIFAR python pickle batches,
CINIC-10 class-folder PNGs via PIL. Augmentation (random crop + flip +
cutout, cifar10/data_loader.py:58-76) is NOT baked into host arrays: it is
a batched torch transform on the device (``data.augment``), which keeps
the host arrays static.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Tuple

import numpy as np

from fedml_tpu_torch.data.loaders.common import (
    FederatedDataset,
    build_federated_dataset,
    clients_from_partition,
)
from fedml_tpu_torch.data.partition import partition_dirichlet, partition_homo, record_data_stats
from fedml_tpu_torch.data.synthetic import make_image_classification

CIFAR10_MEAN = np.array([0.49139968, 0.48215827, 0.44653124], np.float32)
CIFAR10_STD = np.array([0.24703233, 0.24348505, 0.26158768], np.float32)
CIFAR100_MEAN = np.array([0.5071, 0.4865, 0.4409], np.float32)
CIFAR100_STD = np.array([0.2673, 0.2564, 0.2762], np.float32)
CINIC10_MEAN = np.array([0.47889522, 0.47227842, 0.43047404], np.float32)
CINIC10_STD = np.array([0.24205776, 0.23828046, 0.25874835], np.float32)


def _unpickle(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f, encoding="bytes")


def read_cifar10_dir(data_dir: str):
    """cifar-10-batches-py: 5 train batches + test_batch, CHW uint8 rows."""
    xs, ys = [], []
    for i in range(1, 6):
        d = _unpickle(os.path.join(data_dir, f"data_batch_{i}"))
        xs.append(d[b"data"])
        ys.extend(d[b"labels"])
    x_train = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    y_train = np.asarray(ys, np.int32)
    d = _unpickle(os.path.join(data_dir, "test_batch"))
    x_test = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    y_test = np.asarray(d[b"labels"], np.int32)
    return x_train, y_train, x_test, y_test


def read_cifar100_dir(data_dir: str):
    d = _unpickle(os.path.join(data_dir, "train"))
    x_train = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    y_train = np.asarray(d[b"fine_labels"], np.int32)
    d = _unpickle(os.path.join(data_dir, "test"))
    x_test = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    y_test = np.asarray(d[b"fine_labels"], np.int32)
    return x_train, y_train, x_test, y_test


def read_image_folder(root: str, max_per_class: int | None = None):
    """CINIC-10 style ``root/<class>/*.png`` tree via PIL."""
    from PIL import Image

    classes = sorted(
        d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
    )
    xs, ys = [], []
    for ci, cname in enumerate(classes):
        files = sorted(os.listdir(os.path.join(root, cname)))
        if max_per_class:
            files = files[:max_per_class]
        for fn in files:
            with Image.open(os.path.join(root, cname, fn)) as im:
                xs.append(np.asarray(im.convert("RGB"), np.uint8))
            ys.append(ci)
    return np.stack(xs), np.asarray(ys, np.int32), classes


def _normalize(x: np.ndarray, mean, std) -> np.ndarray:
    return ((x.astype(np.float32) / 255.0) - mean) / std


def partition_data(
    y_train: np.ndarray, partition: str, n_nets: int, alpha: float, seed: int = 0
) -> Dict[int, np.ndarray]:
    """The reference's partition switch (cifar10/data_loader.py:113-160):
    ``homo`` uniform permutation split; ``hetero`` Dirichlet-LDA with
    min-size retry."""
    if partition == "homo":
        return partition_homo(len(y_train), n_nets, seed=seed)
    if partition == "hetero":
        return partition_dirichlet(y_train, n_nets, alpha, min_size=10, seed=seed)
    raise ValueError(f"unknown partition {partition!r} (homo|hetero)")


def _load_cifar_family(
    reader,
    data_dir: str,
    partition: str,
    client_number: int,
    alpha: float,
    batch_size: int,
    mean,
    std,
    class_num: int,
    synthetic_samples: int,
    seed: int = 0,
) -> FederatedDataset:
    if data_dir and os.path.isdir(data_dir):
        x_train, y_train, x_test, y_test = reader(data_dir)
        x_train = _normalize(x_train, mean, std)
        x_test = _normalize(x_test, mean, std)
    else:
        x_train, y_train = make_image_classification(
            synthetic_samples, hwc=(32, 32, 3), n_classes=class_num, seed=seed
        )
        x_test, y_test = make_image_classification(
            max(synthetic_samples // 5, client_number * 4),
            hwc=(32, 32, 3),
            n_classes=class_num,
            seed=seed + 1,
        )
    index_map = partition_data(y_train, partition, client_number, alpha, seed=seed)
    train_clients = clients_from_partition(x_train, y_train, index_map)
    # The reference gives every client the same global test loader
    # (cifar10/data_loader.py get_dataloader test side); we shard the test
    # set homogeneously so per-client eval exists, and the global test set
    # is the concatenation.
    test_map = partition_homo(len(y_test), client_number, seed=seed + 2)
    test_clients = clients_from_partition(x_test, y_test, test_map)
    fed = build_federated_dataset(train_clients, test_clients, batch_size, class_num)
    fed.traindata_cls_counts = record_data_stats(y_train, index_map)  # type: ignore[attr-defined]
    return fed


def load_partition_data_cifar10(
    data_dir: str | None,
    partition: str,
    client_number: int,
    alpha: float,
    batch_size: int,
    synthetic_samples: int = 2000,
    seed: int = 0,
) -> FederatedDataset:
    return _load_cifar_family(
        read_cifar10_dir, data_dir or "", partition, client_number, alpha,
        batch_size, CIFAR10_MEAN, CIFAR10_STD, 10, synthetic_samples, seed,
    )


def load_partition_data_cifar100(
    data_dir: str | None,
    partition: str,
    client_number: int,
    alpha: float,
    batch_size: int,
    synthetic_samples: int = 2000,
    seed: int = 0,
) -> FederatedDataset:
    return _load_cifar_family(
        read_cifar100_dir, data_dir or "", partition, client_number, alpha,
        batch_size, CIFAR100_MEAN, CIFAR100_STD, 100, synthetic_samples, seed,
    )


def load_partition_data_cinic10(
    data_dir: str | None,
    partition: str,
    client_number: int,
    alpha: float,
    batch_size: int,
    synthetic_samples: int = 2000,
    seed: int = 0,
) -> FederatedDataset:
    def reader(d):
        x_train, y_train, _ = read_image_folder(os.path.join(d, "train"))
        x_test, y_test, _ = read_image_folder(os.path.join(d, "test"))
        return x_train, y_train, x_test, y_test

    return _load_cifar_family(
        reader, data_dir or "", partition, client_number, alpha,
        batch_size, CINIC10_MEAN, CINIC10_STD, 10, synthetic_samples, seed,
    )
