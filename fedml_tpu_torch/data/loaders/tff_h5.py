"""TFF-packaged h5 loaders: FederatedEMNIST, fed_cifar100, fed_shakespeare,
StackOverflow (next-word prediction and tag logistic regression) (port of
``fedml_tpu/data/loaders/tff_h5.py``).

H5 layout (FederatedEMNIST/data_loader.py:22-24): group ``examples`` with one
subgroup per client id holding per-feature datasets (``pixels``/``label`` for
EMNIST, ``image``/``label`` for cifar100, ``snippets`` for shakespeare,
``tokens``/``title``/``tags`` for stackoverflow).

Every loader takes ``client_num`` (defaults to the dataset's full client
count — 3400 for FEMNIST, 500/100 for fed_cifar100, 342,477 for
stackoverflow) and falls back to a synthetic in-memory h5 when the data dir
is absent. ``write_synthetic_h5`` is exposed so tests can exercise the real
h5 read path.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from fedml_tpu_torch.data.loaders.common import FederatedDataset, build_federated_dataset
from fedml_tpu_torch.data import text

DEFAULT_TRAIN_CLIENTS_NUM_FEMNIST = 3400  # FederatedEMNIST/data_loader.py:15
DEFAULT_TRAIN_CLIENTS_NUM_CIFAR100 = 500  # fed_cifar100/data_loader.py:17
DEFAULT_TEST_CLIENTS_NUM_CIFAR100 = 100

_EXAMPLE = "examples"


def _h5_client_ids(h5file) -> List[str]:
    return sorted(h5file[_EXAMPLE].keys())


def _read_h5_clients(
    path: str, feature: str, label: str | None, limit: int | None
) -> Dict[int, Tuple[np.ndarray, np.ndarray]]:
    import h5py

    out = {}
    with h5py.File(path, "r") as f:
        ids = _h5_client_ids(f)
        if limit is not None:
            ids = ids[:limit]
        for i, cid in enumerate(ids):
            g = f[_EXAMPLE][cid]
            x = np.asarray(g[feature][()])
            y = (
                np.asarray(g[label][()]).squeeze()
                if label is not None
                else np.zeros(len(x), np.int32)
            )
            out[i] = (x, np.atleast_1d(y))
    return out


def write_synthetic_h5(
    path: str,
    n_clients: int,
    samples_per_client: int,
    feature: str,
    feature_shape: Tuple[int, ...],
    label: str | None = "label",
    n_classes: int = 10,
    seed: int = 0,
    text_feature: bool = False,
):
    """Produce a tiny TFF-layout h5 file (tests / zero-egress stand-in)."""
    import h5py

    rng = np.random.RandomState(seed)
    with h5py.File(path, "w") as f:
        ex = f.create_group(_EXAMPLE)
        for c in range(n_clients):
            g = ex.create_group(f"client_{c:05d}")
            if text_feature:
                chars = np.array(list(text.ALL_LETTERS))
                lines = [
                    "".join(chars[rng.randint(0, len(chars), feature_shape[0])])
                    for _ in range(samples_per_client)
                ]
                g.create_dataset(feature, data=np.array(lines, dtype="S"))
            else:
                g.create_dataset(
                    feature,
                    data=rng.randn(samples_per_client, *feature_shape).astype(np.float32),
                )
            if label is not None:
                g.create_dataset(
                    label, data=rng.randint(0, n_classes, (samples_per_client, 1))
                )


def _maybe_synthetic(
    data_dir: str,
    train_file: str,
    test_file: str,
    feature: str,
    feature_shape,
    n_classes: int,
    synthetic_clients: int,
    text_feature: bool = False,
    label: str | None = "label",
):
    """Return (train_path, test_path), generating tmp synthetic h5 if absent."""
    tp = os.path.join(data_dir, train_file)
    sp = os.path.join(data_dir, test_file)
    if os.path.isfile(tp) and os.path.isfile(sp):
        return tp, sp
    import tempfile

    tmp = tempfile.mkdtemp(prefix="fedml_tpu_h5_")
    tp = os.path.join(tmp, train_file)
    sp = os.path.join(tmp, test_file)
    write_synthetic_h5(tp, synthetic_clients, 24, feature, feature_shape, label, n_classes, 0, text_feature)
    write_synthetic_h5(sp, synthetic_clients, 8, feature, feature_shape, label, n_classes, 1, text_feature)
    return tp, sp


def load_partition_data_federated_emnist(
    batch_size: int,
    data_dir: str = "./data/FederatedEMNIST/datasets",
    client_num: int | None = None,
    synthetic_clients: int = 12,
) -> FederatedDataset:
    """3400-writer FEMNIST, 28x28 pixels, 62 classes
    (FederatedEMNIST/data_loader.py:103-160)."""
    tp, sp = _maybe_synthetic(
        data_dir, "fed_emnist_train.h5", "fed_emnist_test.h5", "pixels", (28, 28), 62, synthetic_clients
    )
    train = _read_h5_clients(tp, "pixels", "label", client_num)
    test = _read_h5_clients(sp, "pixels", "label", client_num)
    # Model input is NHWC with one channel.
    train = {c: (x[..., None].astype(np.float32), y.astype(np.int32)) for c, (x, y) in train.items()}
    test = {c: (x[..., None].astype(np.float32), y.astype(np.int32)) for c, (x, y) in test.items()}
    return build_federated_dataset(train, test, batch_size, class_num=62)


def load_partition_data_federated_cifar100(
    batch_size: int,
    data_dir: str = "./data/fed_cifar100/datasets",
    client_num: int | None = None,
    synthetic_clients: int = 10,
) -> FederatedDataset:
    """TFF Pachinko-partitioned CIFAR-100: 500 train / 100 test clients
    (fed_cifar100/data_loader.py:105-160)."""
    tp, sp = _maybe_synthetic(
        data_dir, "fed_cifar100_train.h5", "fed_cifar100_test.h5", "image", (32, 32, 3), 100, synthetic_clients
    )
    train = _read_h5_clients(tp, "image", "label", client_num)
    test = _read_h5_clients(sp, "image", "label", client_num)
    train = {c: (x.astype(np.float32) / 255.0 if x.max() > 2 else x, y.astype(np.int32)) for c, (x, y) in train.items()}
    test = {c: (x.astype(np.float32) / 255.0 if x.max() > 2 else x, y.astype(np.int32)) for c, (x, y) in test.items()}
    return build_federated_dataset(train, test, batch_size, class_num=100)


def load_partition_data_federated_shakespeare(
    batch_size: int,
    data_dir: str = "./data/fed_shakespeare/datasets",
    client_num: int | None = None,
    synthetic_clients: int = 8,
) -> FederatedDataset:
    """TFF Shakespeare: per-role snippet strings → bos/eos/pad id sequences;
    x = ids[:-1], y = ids[1:] (fed_shakespeare/data_loader.py +
    utils.py:52-77). class_num = 90-slot vocab."""
    tp, sp = _maybe_synthetic(
        data_dir,
        "shakespeare_train.h5",
        "shakespeare_test.h5",
        "snippets",
        (text.SHAKESPEARE_SEQ_LEN + 10,),
        0,
        synthetic_clients,
        text_feature=True,
        label=None,
    )

    def read_text(path):
        import h5py

        out = {}
        with h5py.File(path, "r") as f:
            ids = _h5_client_ids(f)
            if client_num is not None:
                ids = ids[:client_num]
            for i, cid in enumerate(ids):
                raw = f[_EXAMPLE][cid]["snippets"][()]
                sents = [s.decode("utf-8", "ignore") if isinstance(s, bytes) else str(s) for s in raw]
                seq = text.shakespeare_preprocess(sents)
                out[i] = (seq[:, :-1], seq[:, 1:])
        return out

    train, test = read_text(tp), read_text(sp)
    return build_federated_dataset(
        train, test, batch_size, class_num=len(text.shakespeare_word_dict()) + 1
    )


def _synthetic_word_list(n: int = 50) -> List[str]:
    return [f"word{i}" for i in range(n)]


def load_partition_data_federated_stackoverflow_nwp(
    batch_size: int,
    data_dir: str = "./data/stackoverflow/datasets",
    client_num: int | None = None,
    vocab_size: int = 10000,
    max_seq_len: int = 20,
    synthetic_clients: int = 8,
) -> FederatedDataset:
    """StackOverflow next-word prediction: 342,477 clients in the real data
    (stackoverflow_nwp/data_loader.py); tokens from the top-``vocab_size``
    word-count file; class_num = vocab_size + pad/bos/eos + oov = 10004."""
    wc = os.path.join(data_dir, "stackoverflow.word_count")
    if os.path.isfile(wc):
        with open(wc) as f:
            words = [next(f).split()[0] for _ in range(vocab_size)]
    else:
        words = _synthetic_word_list(min(vocab_size, 50))
    vocab = text.StackOverflowVocab(words)

    tp = os.path.join(data_dir, "stackoverflow_train.h5")
    sp = os.path.join(data_dir, "stackoverflow_test.h5")
    if os.path.isfile(tp) and os.path.isfile(sp):
        def read(path):
            import h5py

            out = {}
            with h5py.File(path, "r") as f:
                ids = _h5_client_ids(f)
                if client_num is not None:
                    ids = ids[:client_num]
                for i, cid in enumerate(ids):
                    raw = f[_EXAMPLE][cid]["tokens"][()]
                    sents = [s.decode("utf-8", "ignore") if isinstance(s, bytes) else str(s) for s in raw]
                    out[i] = vocab.encode_nwp(sents, max_seq_len)
            return out

        train, test = read(tp), read(sp)
    else:
        rng = np.random.RandomState(11)
        def synth(n_clients, n_sent, seed_off):
            out = {}
            for c in range(n_clients):
                sents = [
                    " ".join(rng.choice(words, rng.randint(3, max_seq_len + 4)))
                    for _ in range(n_sent)
                ]
                out[c] = vocab.encode_nwp(sents, max_seq_len)
            return out

        train = synth(synthetic_clients, 16, 0)
        test = synth(synthetic_clients, 5, 1)
    return build_federated_dataset(train, test, batch_size, class_num=vocab.vocab_size)


def load_partition_data_federated_stackoverflow_lr(
    batch_size: int,
    data_dir: str = "./data/stackoverflow/datasets",
    client_num: int | None = None,
    vocab_size: int = 10000,
    tag_size: int = 500,
    synthetic_clients: int = 8,
) -> FederatedDataset:
    """StackOverflow tag prediction: bag-of-words inputs (vocab+oov), multi-hot
    tag targets (stackoverflow_lr/data_loader.py + utils.py)."""
    import json

    wc = os.path.join(data_dir, "stackoverflow.word_count")
    tc = os.path.join(data_dir, "stackoverflow.tag_count")
    if os.path.isfile(wc) and os.path.isfile(tc):
        with open(wc) as f:
            words = [next(f).split()[0] for _ in range(vocab_size)]
        with open(tc) as f:
            tags = list(json.load(f).keys())[:tag_size]
    else:
        words = _synthetic_word_list(min(vocab_size, 50))
        tags = [f"tag{i}" for i in range(min(tag_size, 10))]
    word_dict = {w: i for i, w in enumerate(words)}
    tag_dict = {t: i for i, t in enumerate(tags)}

    tp = os.path.join(data_dir, "stackoverflow_train.h5")
    sp = os.path.join(data_dir, "stackoverflow_test.h5")
    if os.path.isfile(tp) and os.path.isfile(sp):
        def read(path):
            import h5py

            out = {}
            with h5py.File(path, "r") as f:
                ids = _h5_client_ids(f)
                if client_num is not None:
                    ids = ids[:client_num]
                for i, cid in enumerate(ids):
                    g = f[_EXAMPLE][cid]
                    sents = [
                        s.decode("utf-8", "ignore") if isinstance(s, bytes) else str(s)
                        for s in g["tokens"][()]
                    ]
                    raw_tags = [
                        s.decode("utf-8", "ignore") if isinstance(s, bytes) else str(s)
                        for s in g["tags"][()]
                    ]
                    x = text.bag_of_words(sents, word_dict)
                    y = text.bag_of_tags([t.split("|") for t in raw_tags], tag_dict)
                    out[i] = (x, y)
            return out

        train, test = read(tp), read(sp)
    else:
        rng = np.random.RandomState(13)

        def synth(n_clients, n_sent):
            out = {}
            for c in range(n_clients):
                sents = [" ".join(rng.choice(words, 6)) for _ in range(n_sent)]
                tag_lists = [rng.choice(tags, 2).tolist() for _ in range(n_sent)]
                out[c] = (
                    text.bag_of_words(sents, word_dict),
                    text.bag_of_tags(tag_lists, tag_dict),
                )
            return out

        train = synth(synthetic_clients, 14)
        test = synth(synthetic_clients, 4)
    return build_federated_dataset(train, test, batch_size, class_num=len(tag_dict))
