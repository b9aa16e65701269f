"""Dataset loader registry — the L3 layer (port of
``fedml_tpu/data/loaders/__init__.py``).

``load_data(dataset, ...)`` reproduces the dispatch in the reference's
experiment mains (fedml_experiments/distributed/fedavg/main_fedavg.py:133-351)
and returns a ``FederatedDataset`` (the 8-tuple contract as a dataclass).
All loaders read the real on-disk formats when present and degrade to
synthetic same-shape data in this zero-egress environment.
"""

from __future__ import annotations

from fedml_tpu_torch.data.loaders.common import (
    FederatedDataset,
    batch_data,
    build_federated_dataset,
    clients_from_partition,
    contiguous_shard,
    to_federated_arrays,
)
from fedml_tpu_torch.data.loaders.leaf import (
    load_partition_data_mnist,
    load_partition_data_mnist_by_device_id,
    load_partition_data_shakespeare,
    read_leaf_dir,
)
from fedml_tpu_torch.data.loaders.tff_h5 import (
    load_partition_data_federated_cifar100,
    load_partition_data_federated_emnist,
    load_partition_data_federated_shakespeare,
    load_partition_data_federated_stackoverflow_lr,
    load_partition_data_federated_stackoverflow_nwp,
    write_synthetic_h5,
)
from fedml_tpu_torch.data.loaders.cifar import (
    load_partition_data_cifar10,
    load_partition_data_cifar100,
    load_partition_data_cinic10,
    partition_data,
)
from fedml_tpu_torch.data.loaders.imagenet import (
    load_partition_data_imagenet,
    load_partition_data_landmarks,
)
from fedml_tpu_torch.data.loaders.edge_case import load_poisoned_dataset
from fedml_tpu_torch.data.loaders.vertical import (
    load_lending_club,
    load_three_party_nus_wide,
    load_two_party_nus_wide,
    vertical_split,
)
from fedml_tpu_torch.data.loaders.streaming import StreamingDataLoader


def load_synthetic_seg(
    batch_size: int,
    n_clients: int = 8,
    samples_per_client: int = 24,
    hw=(16, 16),
    n_classes: int = 4,
    seed: int = 0,
) -> FederatedDataset:
    """Synthetic segmentation dataset (blob masks + void pixels) for the
    FedSeg pipeline — the reference's fedseg has no in-repo dataset either
    (it points at external Pascal/ADE setups)."""
    from fedml_tpu_torch.data.synthetic import make_segmentation

    train, test = {}, {}
    for c in range(n_clients):
        x, y = make_segmentation(samples_per_client, hw=hw, n_classes=n_classes,
                                 seed=seed + c)
        train[c] = (x, y)
        xt, yt = make_segmentation(max(4, samples_per_client // 4), hw=hw,
                                   n_classes=n_classes, seed=seed + 100 + c)
        test[c] = (xt, yt)
    return build_federated_dataset(train, test, batch_size, class_num=n_classes)


def load_synthetic_1_1(batch_size: int, n_clients: int = 30, seed: int = 0) -> FederatedDataset:
    """LEAF synthetic(α=1, β=1) LR task (data_preprocessing/synthetic_1_1/)."""
    from fedml_tpu_torch.data.synthetic import synthetic_alpha_beta

    x, y, idx_map = synthetic_alpha_beta(1.0, 1.0, n_clients=n_clients, seed=seed)
    clients = clients_from_partition(x, y, idx_map)
    # 80/20 train/test split inside each client.
    train, test = {}, {}
    for c, (cx, cy) in clients.items():
        k = max(1, int(0.8 * len(cx)))
        train[c] = (cx[:k], cy[:k])
        test[c] = (cx[k:], cy[k:]) if len(cx) > k else (cx[:1], cy[:1])
    return build_federated_dataset(train, test, batch_size, class_num=10)


_CIFAR_FAMILY = {
    "cifar10": load_partition_data_cifar10,
    "cifar100": load_partition_data_cifar100,
    "cinic10": load_partition_data_cinic10,
}


def load_data(
    dataset: str,
    data_dir: str | None = None,
    partition_method: str = "hetero",
    partition_alpha: float = 0.5,
    client_num_in_total: int = 10,
    batch_size: int = 32,
    **kw,
) -> FederatedDataset:
    """The main_fedavg.py:133 dispatch, one entry per supported dataset."""
    if dataset == "mnist":
        return load_partition_data_mnist(batch_size, **_paths(data_dir, "train", "test"), **kw)
    if dataset == "shakespeare":
        return load_partition_data_shakespeare(batch_size, **_paths(data_dir, "train", "test"), **kw)
    if dataset == "femnist":
        return load_partition_data_federated_emnist(batch_size, data_dir or "./data/FederatedEMNIST/datasets", **kw)
    if dataset == "fed_cifar100":
        return load_partition_data_federated_cifar100(batch_size, data_dir or "./data/fed_cifar100/datasets", **kw)
    if dataset == "fed_shakespeare":
        return load_partition_data_federated_shakespeare(batch_size, data_dir or "./data/fed_shakespeare/datasets", **kw)
    if dataset == "stackoverflow_lr":
        return load_partition_data_federated_stackoverflow_lr(batch_size, data_dir or "./data/stackoverflow/datasets", **kw)
    if dataset == "stackoverflow_nwp":
        return load_partition_data_federated_stackoverflow_nwp(batch_size, data_dir or "./data/stackoverflow/datasets", **kw)
    if dataset in _CIFAR_FAMILY:
        return _CIFAR_FAMILY[dataset](
            data_dir, partition_method, client_num_in_total, partition_alpha, batch_size, **kw
        )
    if dataset in ("ILSVRC2012", "imagenet"):
        return load_partition_data_imagenet(data_dir, client_num_in_total, batch_size, **kw)
    if dataset in ("gld23k", "gld160k"):
        return load_partition_data_landmarks(data_dir, kw.pop("fed_train_map_file", None), kw.pop("fed_test_map_file", None), batch_size, **kw)
    if dataset == "synthetic_1_1":
        return load_synthetic_1_1(batch_size, n_clients=client_num_in_total, **kw)
    if dataset == "synthetic_seg":
        return load_synthetic_seg(batch_size, n_clients=client_num_in_total, **kw)
    raise ValueError(f"unknown dataset {dataset!r}")


def _paths(data_dir, train_sub, test_sub):
    import os

    if data_dir:
        return {
            "train_path": os.path.join(data_dir, train_sub),
            "test_path": os.path.join(data_dir, test_sub),
        }
    return {}


__all__ = [
    "FederatedDataset",
    "batch_data",
    "build_federated_dataset",
    "clients_from_partition",
    "contiguous_shard",
    "to_federated_arrays",
    "load_data",
    "load_partition_data_mnist",
    "load_partition_data_mnist_by_device_id",
    "load_partition_data_shakespeare",
    "load_partition_data_federated_emnist",
    "load_partition_data_federated_cifar100",
    "load_partition_data_federated_shakespeare",
    "load_partition_data_federated_stackoverflow_lr",
    "load_partition_data_federated_stackoverflow_nwp",
    "load_partition_data_cifar10",
    "load_partition_data_cifar100",
    "load_partition_data_cinic10",
    "load_partition_data_imagenet",
    "load_partition_data_landmarks",
    "load_poisoned_dataset",
    "load_synthetic_1_1",
    "load_synthetic_seg",
    "load_two_party_nus_wide",
    "load_three_party_nus_wide",
    "load_lending_club",
    "vertical_split",
    "StreamingDataLoader",
    "write_synthetic_h5",
    "partition_data",
    "read_leaf_dir",
]
