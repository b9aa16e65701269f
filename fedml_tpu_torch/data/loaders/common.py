"""The universal dataset contract (port of
``fedml_tpu/data/loaders/common.py``).

The reference's L3→L1/L4 interface is the 8-tuple returned by every
``load_partition_data_<dataset>`` (SURVEY.md §1; e.g.
fedml_api/data_preprocessing/cifar10/data_loader.py:235,
MNIST/data_loader.py:87). Here it is a dataclass with ``.as_tuple()`` for
positional compatibility, and "dataloaders" are lists of ``(x, y)`` numpy
batch pairs — host-side, no torch DataLoader machinery.

``to_federated_arrays`` converts a FederatedDataset into the rectangular
layout on a device (``data.batching.FederatedArrays``) that the vmapped
round functions consume.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

Batch = Tuple[np.ndarray, np.ndarray]


def batch_data(
    x: np.ndarray,
    y: np.ndarray,
    batch_size: int,
    seed: int | None = 100,
    drop_last: bool = False,
) -> List[Batch]:
    """Shuffle-once-then-chunk batching, reproducing LEAF ``batch_data``
    (MNIST/data_loader.py:52-76 — note its fixed ``np.random.seed(100)``)."""
    x = np.asarray(x)
    y = np.asarray(y)
    n = len(x)
    if seed is not None:
        perm = np.random.RandomState(seed).permutation(n)
        x, y = x[perm], y[perm]
    out = []
    end = n - (n % batch_size) if drop_last else n
    for i in range(0, end, batch_size):
        out.append((x[i : i + batch_size], y[i : i + batch_size]))
    return out


@dataclasses.dataclass
class FederatedDataset:
    """The 8-tuple contract (+ explicit client_num) as a structure."""

    client_num: int
    train_data_num: int
    test_data_num: int
    train_data_global: List[Batch]
    test_data_global: List[Batch]
    train_data_local_num_dict: Dict[int, int]
    train_data_local_dict: Dict[int, List[Batch]]
    test_data_local_dict: Dict[int, List[Batch]]
    class_num: int
    # Extra (not in the reference tuple): raw per-client arrays, kept so the
    # device path can build rectangular stacked layouts without re-concatenating
    # batches. Optional.
    train_arrays: Dict[int, Batch] | None = None
    test_arrays: Dict[int, Batch] | None = None

    def as_tuple(self):
        """Positional form matching main_fedavg.py:341-351 dataset list."""
        return (
            self.client_num,
            self.train_data_num,
            self.test_data_num,
            self.train_data_global,
            self.test_data_global,
            self.train_data_local_num_dict,
            self.train_data_local_dict,
            self.test_data_local_dict,
            self.class_num,
        )


def build_federated_dataset(
    train_clients: Dict[int, Batch],
    test_clients: Dict[int, Batch],
    batch_size: int,
    class_num: int,
    shuffle_seed: int | None = 100,
) -> FederatedDataset:
    """Assemble the contract from per-client ``(x, y)`` arrays.

    ``test_clients`` may be a subset of train clients (some datasets have no
    per-client test split); the global test set is the concatenation of all
    provided test arrays.
    """
    train_local, test_local, num_dict = {}, {}, {}
    train_global: List[Batch] = []
    test_global: List[Batch] = []
    train_num = test_num = 0
    for cid in sorted(train_clients):
        x, y = train_clients[cid]
        num_dict[cid] = len(x)
        train_num += len(x)
        b = batch_data(x, y, batch_size, seed=shuffle_seed)
        train_local[cid] = b
        train_global += b
    for cid in sorted(test_clients):
        x, y = test_clients[cid]
        test_num += len(x)
        b = batch_data(x, y, batch_size, seed=shuffle_seed)
        test_local[cid] = b
        test_global += b
    return FederatedDataset(
        client_num=len(train_clients),
        train_data_num=train_num,
        test_data_num=test_num,
        train_data_global=train_global,
        test_data_global=test_global,
        train_data_local_num_dict=num_dict,
        train_data_local_dict=train_local,
        test_data_local_dict=test_local,
        class_num=class_num,
        train_arrays={c: (np.asarray(v[0]), np.asarray(v[1])) for c, v in train_clients.items()},
        test_arrays={c: (np.asarray(v[0]), np.asarray(v[1])) for c, v in test_clients.items()},
    )


def clients_from_partition(
    x: np.ndarray, y: np.ndarray, index_map: Dict[int, np.ndarray]
) -> Dict[int, Batch]:
    return {cid: (x[idx], y[idx]) for cid, idx in index_map.items()}


def to_federated_arrays(fed: FederatedDataset, batch_size: int,
                        split: str = "train", device=None):
    """Rectangular stacked layout for the on-device round functions, on
    ``device`` (``None`` → cuda).

    ``split="test"`` builds the layout from the per-client TEST shards
    (the reference's ``test_data_local_dict`` leg of the 8-tuple) for
    on-device per-client test evaluation; clients with no local test data
    get an empty (all-masked) row so indices stay aligned with the train
    layout. Returns None if the loader kept no test arrays at all."""
    from fedml_tpu_torch.data.batching import build_federated_arrays

    assert fed.train_arrays is not None, "loader did not keep raw arrays"
    if split == "train":
        arrays = fed.train_arrays
    elif split == "test":
        if not fed.test_arrays:
            return None
        extra = set(fed.test_arrays) - set(fed.train_arrays)
        if extra:
            raise ValueError(
                "test_arrays contain client ids with no train shard "
                f"({sorted(extra)[:5]}...): the test layout is indexed by "
                "train client id, so these shards would be silently "
                "dropped — use a separate FederatedDataset for held-out "
                "clients")
        # Keep the client-index space identical to the train layout.
        sample = next(iter(fed.test_arrays.values()))
        empty = (sample[0][:0], sample[1][:0])
        arrays = {c: fed.test_arrays.get(c, empty) for c in fed.train_arrays}
    else:
        raise ValueError(f"split must be 'train' or 'test', got {split!r}")
    cids = sorted(arrays)
    xs = np.concatenate([arrays[c][0] for c in cids])
    ys = np.concatenate([arrays[c][1] for c in cids])
    index_map, pos = {}, 0
    for c in cids:
        n = len(arrays[c][0])
        index_map[c] = np.arange(pos, pos + n)
        pos += n
    return build_federated_arrays(xs, ys, index_map, batch_size,
                                  device=device)


def contiguous_shard(n_samples: int, n_clients: int) -> Dict[int, np.ndarray]:
    """ImageNet/Landmarks-style contiguous per-client shard
    (ImageNet/data_loader.py:300 splits sample ranges by client_number)."""
    return {
        i: part
        for i, part in enumerate(np.array_split(np.arange(n_samples), n_clients))
    }
