"""The port's dataset layer (``fedml_tpu_torch/data/loaders``, ``text.py``,
``partition.py``, ``augment.py``) against the JAX package's.

The loaders are host-side numpy in both packages; the port keeps its own
copy, so every loader must give JAX's arrays exactly: the same
``FederatedDataset`` field by field (sizes, the batch lists, the raw
per-client arrays, their dtypes), on small files in the real formats that
the test writes (CIFAR-10/100 python pickles, CINIC-10 and ImageNet class
folders of PNGs, LEAF JSON directories, TFF h5 files through
``write_synthetic_h5``, a Landmarks csv), and on the synthetic fallbacks
when the files are absent. Also ``partition_power_law`` and
``record_data_stats``, the text encoders, ``to_federated_arrays`` against
JAX's ``FederatedArrays`` field by field (labels as int64, the port's
dtype), and the port's augmentation on its own key streams (JAX's draws are
threefry bits: the shapes of the crops, flips and cutouts are held).
"""

import dataclasses
import json
import pickle

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.data import loaders as jax_loaders
from fedml_tpu.data import partition as jax_partition
from fedml_tpu.data import text as jax_text
from fedml_tpu_torch.core import keys
from fedml_tpu_torch.data import augment, loaders, partition, text


def _same(a, b, where="fed"):
    if isinstance(b, dict):
        assert isinstance(a, dict) and list(a) == list(b), where
        for k in b:
            _same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(b, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(b, (np.ndarray, np.generic)):
        assert np.asarray(a).dtype == np.asarray(b).dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


def _same_fed(port, jax_fed):
    assert type(port).__name__ == type(jax_fed).__name__
    for f in dataclasses.fields(jax_fed):
        _same(getattr(port, f.name), getattr(jax_fed, f.name), f.name)
    extra = set(vars(jax_fed)) - {f.name for f in dataclasses.fields(jax_fed)}
    for name in sorted(extra):  # e.g. the CIFAR loaders' class counts
        _same(getattr(port, name), getattr(jax_fed, name), name)


def _both(name, *args, **kw):
    return (getattr(loaders, name)(*args, **kw),
            getattr(jax_loaders, name)(*args, **kw))


# --- files in the real formats -----------------------------------------------

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("datasets")
    rng = np.random.RandomState(0)

    def pickled(path, obj):
        with open(path, "wb") as f:
            pickle.dump(obj, f)

    c10 = root / "cifar10"
    c10.mkdir()
    for i in range(1, 6):
        pickled(c10 / f"data_batch_{i}",
                {b"data": rng.randint(0, 256, (40, 3072)).astype(np.uint8),
                 b"labels": rng.randint(0, 10, 40).tolist()})
    pickled(c10 / "test_batch",
            {b"data": rng.randint(0, 256, (30, 3072)).astype(np.uint8),
             b"labels": rng.randint(0, 10, 30).tolist()})
    c100 = root / "cifar100"
    c100.mkdir()
    for split, n in (("train", 200), ("test", 50)):
        pickled(c100 / split,
                {b"data": rng.randint(0, 256, (n, 3072)).astype(np.uint8),
                 b"fine_labels": rng.randint(0, 100, n).tolist()})

    from PIL import Image

    def folder(base, split, n_classes, per, size):
        for c in range(n_classes):
            d = base / split / f"class{c:02d}"
            d.mkdir(parents=True)
            for j in range(per):
                Image.fromarray(rng.randint(0, 256, (size, size, 3)).astype(
                    np.uint8)).save(d / f"{j:03d}.png")

    cinic = root / "cinic10"
    for split in ("train", "test"):
        folder(cinic, split, 10, 12 if split == "train" else 4, 32)
    imnet = root / "imagenet"
    folder(imnet, "train", 3, 6, 20)
    folder(imnet, "val", 3, 2, 20)

    def leaf(base, make):
        for split, n in (("train", 7), ("test", 3)):
            d = base / split
            d.mkdir(parents=True)
            for part in range(2):
                users = [f"u{part}{k}" for k in range(3)]
                with open(d / f"part{part}.json", "w") as f:
                    json.dump({"users": users,
                               "user_data": {u: make(n) for u in users}}, f)

    leaf(root / "mnist", lambda n: {
        "x": rng.rand(n, 784).round(3).tolist(),
        "y": rng.randint(0, 10, n).tolist()})
    letters = np.array(list(jax_text.ALL_LETTERS))
    leaf(root / "shakespeare", lambda n: {
        "x": ["".join(letters[rng.randint(0, len(letters), 80)])
              for _ in range(n)],
        "y": ["".join(letters[rng.randint(0, len(letters), 1)])
              for _ in range(n)]})

    tff = {}
    for name, train, test, feature, shape, ncls, txt in (
            ("femnist", "fed_emnist_train.h5", "fed_emnist_test.h5",
             "pixels", (28, 28), 62, False),
            ("fed_cifar100", "fed_cifar100_train.h5", "fed_cifar100_test.h5",
             "image", (32, 32, 3), 100, False),
            ("fed_shakespeare", "shakespeare_train.h5", "shakespeare_test.h5",
             "snippets", (120,), 0, True)):
        d = root / name
        d.mkdir()
        label = None if txt else "label"
        loaders.write_synthetic_h5(str(d / train), 5, 9, feature, shape,
                                   label, max(ncls, 1), 3, txt)
        loaders.write_synthetic_h5(str(d / test), 5, 4, feature, shape,
                                   label, max(ncls, 1), 4, txt)
        tff[name] = str(d)
    return {"root": root, "tff": tff}


def test_write_synthetic_h5_is_byte_equal(tmp_path):
    import h5py

    for mod, name in ((loaders, "p.h5"), (jax_loaders, "j.h5")):
        mod.write_synthetic_h5(str(tmp_path / name), 3, 5, "pixels", (4, 4),
                               seed=2)
    with h5py.File(tmp_path / "p.h5") as p, h5py.File(tmp_path / "j.h5") as j:
        assert list(p["examples"]) == list(j["examples"])
        for cid in j["examples"]:
            for k in j["examples"][cid]:
                np.testing.assert_array_equal(p["examples"][cid][k][()],
                                              j["examples"][cid][k][()])


@pytest.mark.parametrize("case", [
    "cifar10-homo", "cifar10-hetero", "cifar100", "cinic10", "mnist",
    "shakespeare", "femnist", "fed_cifar100", "fed_shakespeare",
    "imagenet"])
def test_loaders_read_files_as_jax(files, case):
    root = files["root"]
    if case.startswith("cifar10-"):
        kw = dict(data_dir=str(root / "cifar10"),
                  partition_method=case.split("-")[1], partition_alpha=0.5,
                  client_num_in_total=4, batch_size=16)
        got, want = _both("load_data", "cifar10", **kw)
    elif case in ("cifar100", "cinic10"):
        got, want = _both("load_data", case, data_dir=str(root / case),
                          partition_method="homo", client_num_in_total=3,
                          batch_size=16)
    elif case in ("mnist", "shakespeare"):
        got, want = _both("load_data", case, data_dir=str(root / case),
                          batch_size=4)
    elif case in files["tff"]:
        got, want = _both("load_data", case, data_dir=files["tff"][case],
                          batch_size=4)
    else:
        got, want = _both("load_data", "imagenet",
                          data_dir=str(root / "imagenet"),
                          client_num_in_total=3, batch_size=4,
                          image_size=16)
    _same_fed(got, want)
    assert got.train_data_num > 0 and got.client_num > 1


@pytest.mark.parametrize("dataset", [
    "mnist", "shakespeare", "femnist", "fed_cifar100", "fed_shakespeare",
    "stackoverflow_lr", "stackoverflow_nwp", "cifar10", "cifar100",
    "cinic10", "imagenet", "gld23k", "synthetic_1_1", "synthetic_seg"])
def test_synthetic_fallbacks_equal_jax(tmp_path, dataset):
    """No files: every loader falls back to the same synthetic data as
    JAX's (a data choice, the same in both packages)."""
    kw = dict(data_dir=str(tmp_path / "absent"), batch_size=8,
              client_num_in_total=4)
    if dataset in ("cifar10", "cifar100", "cinic10"):
        kw["synthetic_samples"] = 120
    if dataset == "imagenet":
        kw.update(synthetic_samples=40, image_size=8)
    if dataset == "gld23k":
        kw.update(image_size=8, synthetic_clients=3)
    got, want = _both("load_data", dataset, **kw)
    _same_fed(got, want)


def test_landmarks_csv_as_jax(tmp_path):
    from PIL import Image

    rng = np.random.RandomState(1)
    (tmp_path / "images").mkdir()
    rows = ["user_id,image_id,class"]
    for u in range(3):
        for j in range(3):
            img = f"img{u}{j}"
            Image.fromarray(rng.randint(0, 256, (12, 12, 3)).astype(
                np.uint8)).save(tmp_path / "images" / f"{img}.jpg")
            rows.append(f"user{u},{img},{rng.randint(0, 5)}")
    csv = tmp_path / "train.csv"
    csv.write_text("\n".join(rows) + "\n")
    got, want = _both("load_partition_data_landmarks", str(tmp_path),
                      str(csv), None, 4, image_size=8)
    _same_fed(got, want)


def test_the_lesser_loaders_equal_jax():
    """The poisoned, vertical and streaming datasets (synthetic here)."""
    _same(loaders.load_poisoned_dataset("cifar10", n_samples=64,
                                        batch_size=16),
          jax_loaders.load_poisoned_dataset("cifar10", n_samples=64,
                                            batch_size=16))
    for name in ("load_two_party_nus_wide", "load_three_party_nus_wide",
                 "load_lending_club"):
        got, want = _both(name, None, n_samples=120)
        _same(got, want, name)
    x = np.random.RandomState(0).randn(60, 9)
    for splits in ((3, 3, 3), (2, 4), (5, 9)):
        _same(loaders.vertical_split(x, splits),
              jax_loaders.vertical_split(x, splits))
    for mode in ("stochastic", "adversarial"):
        kw = dict(client_list=list(range(4)), sample_num_in_total=80,
                  mode=mode, n_features=6)
        p = loaders.StreamingDataLoader(**kw)
        j = jax_loaders.StreamingDataLoader(**kw)
        _same(p.load_datastream(), j.load_datastream(), mode)
        _same(p.stream_arrays(), j.stream_arrays(), mode)


@pytest.mark.parametrize("split", ["train", "test"])
def test_to_federated_arrays_equals_jax(split):
    fed = loaders.load_data("synthetic_1_1", batch_size=8,
                            client_num_in_total=5)
    jfed = jax_loaders.load_data("synthetic_1_1", batch_size=8,
                                 client_num_in_total=5)
    got = loaders.to_federated_arrays(fed, 8, split=split, device="cpu")
    want = jax_loaders.to_federated_arrays(jfed, 8, split=split)
    assert got.x.device.type == "cpu"
    for f in ("x", "y", "mask", "counts"):
        w = np.asarray(getattr(want, f))
        g = getattr(got, f).numpy()
        if f == "y":
            w = w.astype(np.int64)
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


def test_to_federated_arrays_refuses_like_jax():
    fed = loaders.load_data("synthetic_1_1", batch_size=8,
                            client_num_in_total=3)
    with pytest.raises(ValueError, match="split must be"):
        loaders.to_federated_arrays(fed, 8, split="val", device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if not torch.cuda.is_available():
            loaders.to_federated_arrays(fed, 8)
        else:
            raise RuntimeError("no CUDA device (a card is present)")


@pytest.mark.parametrize("seed", [0, 3])
def test_partition_power_law_and_stats_equal_jax(seed):
    for n, c, kw in ((1000, 20, {}), (60, 7, {"sigma": 1.0}),
                     (40, 9, {"min_size": 1})):
        got = partition.partition_power_law(n, c, seed=seed, **kw)
        want = jax_partition.partition_power_law(n, c, seed=seed, **kw)
        _same(got, want)
        labels = np.random.RandomState(seed).randint(0, 5, n)
        _same(partition.record_data_stats(labels, got),
              jax_partition.record_data_stats(labels, want))


def test_text_encoders_equal_jax():
    rng = np.random.RandomState(0)
    letters = np.array(list(jax_text.ALL_LETTERS) + ["~", "é"])
    lines = ["".join(letters[rng.randint(0, len(letters), 81)])
             for _ in range(6)]
    assert text.VOCAB_SIZE == jax_text.VOCAB_SIZE
    assert text.shakespeare_word_dict() == jax_text.shakespeare_word_dict()
    _same(text.word_to_indices(lines[0]), jax_text.word_to_indices(lines[0]))
    _same(text.shakespeare_preprocess(lines),
          jax_text.shakespeare_preprocess(lines))
    _same(text.leaf_shakespeare_encode([s[:80] for s in lines],
                                       [s[80] for s in lines]),
          jax_text.leaf_shakespeare_encode([s[:80] for s in lines],
                                           [s[80] for s in lines]))
    words = ["the", "a", "fed", "learn", "card"]
    sents = [" ".join(rng.choice(words + ["oov"], 7)) for _ in range(5)]
    pv, jv = text.StackOverflowVocab(words), jax_text.StackOverflowVocab(words)
    assert pv.vocab_size == jv.vocab_size
    _same(pv.encode_nwp(sents, 6), jv.encode_nwp(sents, 6))
    wd = {w: i for i, w in enumerate(words)}
    _same(text.bag_of_words(sents, wd), jax_text.bag_of_words(sents, wd))
    tags = [["a", "b"], ["c"], ["z"]]
    td = {"a": 0, "b": 1, "c": 2}
    _same(text.bag_of_tags(tags, td), jax_text.bag_of_tags(tags, td))


# --- augmentation on the port's key streams ----------------------------------

def _batch(n=6, h=8, w=8, c=3):
    return torch.arange(n * h * w * c, dtype=torch.float32).reshape(n, h, w,
                                                                   c) + 1.0


def test_random_crop_takes_windows_of_the_padded_image():
    x = _batch()
    out = augment.random_crop(keys.key(1), x, padding=2)
    assert out.shape == x.shape
    pad = torch.nn.functional.pad(x, (0, 0, 2, 2, 2, 2))
    for i in range(x.shape[0]):
        hits = [(oy, ox) for oy in range(5) for ox in range(5)
                if torch.equal(out[i], pad[i, oy:oy + 8, ox:ox + 8])]
        assert hits, i
    assert torch.equal(out, augment.random_crop(keys.key(1), x, padding=2))
    assert not torch.equal(out, augment.random_crop(keys.key(2), x,
                                                    padding=2))


def test_random_flip_and_cutout():
    x = _batch(n=32)
    out = augment.random_flip(keys.key(5), x)
    flipped = [torch.equal(o, xi.flip(1)) for o, xi in zip(out, x)]
    kept = [torch.equal(o, xi) for o, xi in zip(out, x)]
    assert all(f or k for f, k in zip(flipped, kept))
    assert 0 < sum(flipped) < len(x)
    cut = augment.cutout(keys.key(6), x, length=4)
    zero = (cut == 0).all(-1)
    for i in range(len(x)):
        ys, xs = torch.nonzero(zero[i], as_tuple=True)
        assert 0 < len(ys) <= 9  # a clipped square of side length - 1
        assert torch.equal(cut[i][~zero[i]], x[i][~zero[i]])


def test_cifar_train_augment_under_vmap():
    """One key per client: the composed policy under ``vmap`` equals
    each client's own call (the streams are elementwise hashes)."""
    x = _batch(n=4, h=32, w=32).reshape(2, 2, 32, 32, 3)
    ks = keys.fold_in(keys.key(7), torch.arange(2))
    got = torch.func.vmap(augment.cifar_train_augment)(ks, x)
    for c in range(2):
        assert torch.equal(got[c], augment.cifar_train_augment(ks[c], x[c]))
    assert got.shape == x.shape


def test_loader_registry_surface_matches_jax():
    assert sorted(loaders.__all__) == sorted(jax_loaders.__all__)
    assert set(loaders._CIFAR_FAMILY) == set(jax_loaders._CIFAR_FAMILY)
    with pytest.raises(ValueError, match="unknown dataset"):
        loaders.load_data("nope")
    assert jax.tree.structure(loaders.contiguous_shard(10, 3)) \
        == jax.tree.structure(jax_loaders.contiguous_shard(10, 3))
