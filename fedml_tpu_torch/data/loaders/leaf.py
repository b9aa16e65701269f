"""LEAF-format loaders (per-user JSON): MNIST and Shakespeare (port of
``fedml_tpu/data/loaders/leaf.py``).

File format (MNIST/data_loader.py:9-49): ``*.json`` files with keys
``users`` (list), optional ``hierarchies``, and ``user_data``:
``{user: {"x": [...], "y": [...]}}``. Train/test dirs hold the same users.

When the data directory is absent (zero-egress environment), loaders fall
back to synthetic generators with the same shapes/stats so every pipeline is
still exercisable end-to-end; pass ``synthetic_clients`` to control size.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np

from fedml_tpu_torch.data.loaders.common import FederatedDataset, build_federated_dataset
from fedml_tpu_torch.data.partition import partition_power_law
from fedml_tpu_torch.data.synthetic import make_image_classification
from fedml_tpu_torch.data import text


def read_leaf_dir(data_dir: str) -> Tuple[List[str], List, Dict, Dict]:
    """Parse one split directory of LEAF json files
    (MNIST/data_loader.py:9-49)."""
    users: List[str] = []
    groups: List = []
    data: Dict = {}
    for f in sorted(os.listdir(data_dir)):
        if not f.endswith(".json"):
            continue
        with open(os.path.join(data_dir, f)) as inf:
            cdata = json.load(inf)
        users.extend(cdata["users"])
        groups.extend(cdata.get("hierarchies", []))
        data.update(cdata["user_data"])
    return sorted(users), groups, data


def _leaf_to_clients(users, data, xdtype, ydtype) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    return {
        i: (
            np.asarray(data[u]["x"], dtype=xdtype),
            np.asarray(data[u]["y"], dtype=ydtype),
        )
        for i, u in enumerate(users)
    }


def load_partition_data_mnist(
    batch_size: int,
    train_path: str = "./data/MNIST/train",
    test_path: str = "./data/MNIST/test",
    synthetic_clients: int = 20,
    synthetic_samples_per_client: int = 30,
) -> FederatedDataset:
    """LEAF MNIST: 1000 power-law clients, flat 784 features, 10 classes
    (MNIST/data_loader.py:87-130). Synthetic fallback mirrors the power-law
    client-size skew."""
    if os.path.isdir(train_path) and os.path.isdir(test_path):
        users, _, train = read_leaf_dir(train_path)
        _, _, test = read_leaf_dir(test_path)
        train_clients = _leaf_to_clients(users, train, np.float32, np.int32)
        test_clients = _leaf_to_clients(users, test, np.float32, np.int32)
    else:
        n = synthetic_clients * synthetic_samples_per_client
        x, y = make_image_classification(n, hwc=(784,), n_classes=10)
        idx = partition_power_law(n, synthetic_clients, seed=1)
        train_clients = {c: (x[i], y[i]) for c, i in idx.items()}
        xt, yt = make_image_classification(n // 4 + synthetic_clients, hwc=(784,), n_classes=10, seed=7)
        idx_t = partition_power_law(len(xt), synthetic_clients, seed=2, min_size=1)
        test_clients = {c: (xt[i], yt[i]) for c, i in idx_t.items()}
    return build_federated_dataset(train_clients, test_clients, batch_size, class_num=10)


def load_partition_data_mnist_by_device_id(
    batch_size: int, device_id: str, train_path: str = "MNIST_mobile", test_path: str = "MNIST_mobile"
) -> FederatedDataset:
    """Mobile split variant (MNIST/data_loader.py:78-85)."""
    return load_partition_data_mnist(
        batch_size,
        os.path.join(train_path, device_id, "train"),
        os.path.join(test_path, device_id, "test"),
    )


def _shakespeare_clients(users, data) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    out = {}
    for i, u in enumerate(users):
        x, y = text.leaf_shakespeare_encode(data[u]["x"], data[u]["y"])
        out[i] = (x, y)
    return out


def _synthetic_play(rng, n_lines: int, line_len: int = 90) -> List[str]:
    chars = np.array(list(text.ALL_LETTERS))
    return ["".join(chars[rng.randint(0, len(chars), line_len)]) for _ in range(n_lines)]


def load_partition_data_shakespeare(
    batch_size: int,
    train_path: str = "./data/shakespeare/train",
    test_path: str = "./data/shakespeare/test",
    synthetic_clients: int = 8,
    synthetic_lines_per_client: int = 12,
) -> FederatedDataset:
    """LEAF Shakespeare char-LM: x = 80-char snippet indices, y = next char
    (shakespeare/data_loader.py + language_utils.py:27-53). class_num is the
    90-slot vocab."""
    if os.path.isdir(train_path) and os.path.isdir(test_path):
        users, _, train = read_leaf_dir(train_path)
        _, _, test = read_leaf_dir(test_path)
        train_clients = _shakespeare_clients(users, train)
        test_clients = _shakespeare_clients(users, test)
    else:
        rng = np.random.RandomState(3)
        train_clients, test_clients = {}, {}
        L = text.SHAKESPEARE_SEQ_LEN
        for c in range(synthetic_clients):
            lines = _synthetic_play(rng, synthetic_lines_per_client, L + 1)
            snip = [l[:L] for l in lines]
            nxt = [l[L] for l in lines]
            train_clients[c] = text.leaf_shakespeare_encode(snip, nxt)
            lines_t = _synthetic_play(rng, max(2, synthetic_lines_per_client // 4), L + 1)
            test_clients[c] = text.leaf_shakespeare_encode(
                [l[:L] for l in lines_t], [l[L] for l in lines_t]
            )
    return build_federated_dataset(
        train_clients, test_clients, batch_size, class_num=text.VOCAB_SIZE
    )
