"""The port's sharded client directory (``fedml_tpu_torch/data/
directory.py``) against the JAX package's and against the port's flat
store:

- ``ShardedFederatedStore`` gathers (``gather_cohort``, ``gather_window``)
  byte-equal to the flat store's and to JAX's sharded store, in RAM and
  memmap-spilled, with shard counts that do not divide the clients, an
  explicit shard map with empty trailing shards, ``max_steps`` and the
  prefetchers;
- ``ClientDirectory``'s metadata and cohorts equal to JAX's, and the
  cohorts the same under re-sharding;
- ``from_shard_builder``;
- rounds over a sharded store bit-equal to the flat store's, on the host
  loop and on the windowed tier."""

import numpy as np
import pytest
import torch

from fedml_tpu.data import directory as jax_directory
from fedml_tpu_torch.algos import FedAvgAPI, FedConfig, ScaffoldAPI
from fedml_tpu_torch.core.tree import tree_leaves
from fedml_tpu_torch.data import directory, store
from fedml_tpu_torch.models import create_model

COUNTS = (130, 17, 0, 30, 12, 25, 8, 21, 3, 0, 64, 5, 40, 1)
FIELDS = ("x", "y", "mask", "counts")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _power_law(counts=COUNTS, shape=(4,), seed=0):
    rng = np.random.RandomState(seed)
    tot = int(sum(counts))
    x = rng.randn(tot, *shape).astype(np.float32)
    y = rng.randint(0, 5, tot).astype(np.int32)
    edges = np.concatenate([[0], np.cumsum(counts)])
    return x, y, {c: np.arange(edges[c], edges[c + 1])
                  for c in range(len(counts))}


def _equal(a, b, what=""):
    for f in FIELDS:
        ta, tb = getattr(a, f), getattr(b, f)
        assert ta.dtype == tb.dtype and torch.equal(ta, tb), (what, f)


def _same_as_jax(port, jax_arrays, what=""):
    for f in FIELDS:
        a = getattr(port, f).numpy()
        b = np.asarray(getattr(jax_arrays, f))
        b = b.astype(np.int64) if f == "y" else b
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), (what, f)


COHORTS = ([0, 1, 2], [2, 9], [4, 4, 7, 4], [13, 12, 11, 10], [5, 1, 11])


@pytest.mark.parametrize("num_shards,spill", [(1, False), (3, False),
                                              (5, True), (14, False),
                                              (4, True)])
def test_sharded_gathers_equal_the_flat_store_and_jax(num_shards, spill,
                                                      tmp_path):
    """Every cohort and a window (at its bucket and a forced larger one)
    byte-equal between the sharded store, the flat store and JAX's
    sharded store, whether the shards live in RAM or in read-only
    ``.npy`` memmaps."""
    x, y, parts = _power_law(shape=(3, 2))
    flat = store.FederatedStore(x, y, parts, 8, device="cpu")
    spill_dir = str(tmp_path / "port") if spill else None
    sh = directory.ShardedFederatedStore.from_flat(
        x, y, parts, 8, num_shards=num_shards, spill_dir=spill_dir,
        device="cpu")
    jsh = jax_directory.ShardedFederatedStore.from_flat(
        x, y, parts, 8, num_shards=num_shards,
        spill_dir=str(tmp_path / "jax") if spill else None)
    assert sh.memmapped is spill and sh.nbytes() == flat.nbytes()
    for idx in COHORTS:
        got = sh.gather_cohort(idx)
        _equal(got, flat.gather_cohort(idx), idx)
        _same_as_jax(got, jsh.gather_cohort(np.asarray(idx)), idx)
        _equal(sh.gather_cohort(idx, steps=32),
               flat.gather_cohort(idx, steps=32), idx)
    win = np.array([[0, 1, 2], [13, 12, 9], [4, 4, 5]])
    for steps in (32, 64):
        got = sh.gather_window(win, steps)
        _equal(got, flat.gather_window(win, steps), steps)
        _same_as_jax(got, jsh.gather_window(win, steps), steps)
    with pytest.raises(NotImplementedError, match="scalar copy-loop"):
        sh._gather_cohort_loop([0])


def test_explicit_shard_map_and_max_steps():
    """A shard map grouping clients by ``c % 3`` with two empty trailing
    shards, and ``max_steps`` truncating the giant: the same bytes as the
    flat store under the same truncation, and the directory's tallies
    equal JAX's."""
    x, y, parts = _power_law()
    shard_of = np.arange(len(COUNTS)) % 3
    sh = directory.ShardedFederatedStore.from_flat(
        x, y, parts, 4, num_shards=5, shard_of=shard_of, max_steps=4,
        device="cpu")
    jsh = jax_directory.ShardedFederatedStore.from_flat(
        x, y, parts, 4, num_shards=5, shard_of=shard_of, max_steps=4)
    flat = store.FederatedStore(x, y, parts, 4, max_steps=4, device="cpu")
    for idx in COHORTS:
        _equal(sh.gather_cohort(idx), flat.gather_cohort(idx), idx)
    d, jd = sh.directory, jsh.directory
    for name in ("counts", "shard_of", "shard_clients", "shard_rows",
                 "local_row_start"):
        np.testing.assert_array_equal(getattr(d, name), getattr(jd, name))
    assert d.num_shards == 5 and d.shard_clients[3:].sum() == 0
    assert d.nbytes() == jd.nbytes()
    np.testing.assert_array_equal(d.shard_histogram([0, 3, 6, 1]),
                                  jd.shard_histogram([0, 3, 6, 1]))
    np.testing.assert_array_equal(d.agg_shard_of([0, 4, 8], 2),
                                  jd.agg_shard_of([0, 4, 8], 2))
    assert d.agg_shard_of(7, 2) == jd.agg_shard_of(7, 2)
    for bad, match in ((dict(num_shards=0), "num_shards must be >= 1"),):
        with pytest.raises(ValueError, match=match):
            directory.ShardedFederatedStore.from_flat(x, y, parts, 4,
                                                      device="cpu", **bad)
    with pytest.raises(ValueError, match="one entry per client"):
        directory.ClientDirectory([1, 2], [0])
    with pytest.raises(ValueError, match="num_agg_shards"):
        d.agg_shard_of([0], 0)


def test_directory_cohorts_match_jax_and_resharding():
    """The directory's uniform and count-weighted cohorts equal JAX's for
    every round and shard count, and are the same for every sharding."""
    x, y, parts = _power_law()
    for r in range(6):
        want = None
        for g in (1, 2, 5, 14):
            d = directory.ShardedFederatedStore.from_flat(
                x, y, parts, 4, num_shards=g, device="cpu").directory
            jd = jax_directory.ShardedFederatedStore.from_flat(
                x, y, parts, 4, num_shards=g).directory
            got = (d.sample_cohort(r, 4), d.sample_cohort_weighted(r, 5))
            np.testing.assert_array_equal(got[0], jd.sample_cohort(r, 4))
            np.testing.assert_array_equal(got[1],
                                          jd.sample_cohort_weighted(r, 5))
            if want is None:
                want = got
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


def test_from_shard_builder_and_prefetchers(tmp_path):
    """A store built one spilled shard at a time equals ``from_flat``'s;
    a builder whose rows and counts disagree is refused; both prefetchers
    serve a sharded store's bytes."""
    x, y, parts = _power_law()
    counts = np.asarray(COUNTS)
    blocks = np.array_split(np.arange(len(COUNTS)), 3)
    edges = np.concatenate([[0], np.cumsum(counts)])
    seen = []

    def builder(s):
        cl = blocks[s]
        lo, hi = edges[cl[0]], edges[cl[-1] + 1]
        return x[lo:hi], y[lo:hi], counts[cl]

    sh = directory.ShardedFederatedStore.from_shard_builder(
        builder, 3, 4, str(tmp_path / "built"), progress=seen.append,
        device="cpu")
    assert seen == [0, 1, 2] and sh.memmapped
    ref = directory.ShardedFederatedStore.from_flat(
        x, y, parts, 4, num_shards=3, device="cpu")
    for idx in COHORTS:
        _equal(sh.gather_cohort(idx), ref.gather_cohort(idx), idx)
    with pytest.raises(ValueError, match="rows but counts sum"):
        directory.ShardedFederatedStore.from_shard_builder(
            lambda s: (x[:3], y[:3], [1, 1]), 1, 4, str(tmp_path / "bad"),
            device="cpu")
    pf = store.CohortPrefetcher(sh)
    pf.prefetch(0, [0, 5, 13])
    _equal(pf.get(0, [0, 5, 13]), ref.gather_cohort([0, 5, 13]))
    wpf = store.WindowPrefetcher(sh)
    win = np.array([[1, 2], [3, 4]])
    wpf.prefetch(0, win, 8)
    _equal(wpf.get(0, win, 8), ref.gather_window(win, 8))


def _api(cls, fed):
    cfg = FedConfig(client_num_in_total=len(COUNTS), client_num_per_round=4,
                    comm_round=8, epochs=1, batch_size=4, lr=0.1)
    model = create_model("lr", in_features=4, num_classes=5, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    return cls(model, fed, None, cfg, device="cpu")


@pytest.mark.parametrize("cls", [FedAvgAPI, ScaffoldAPI])
def test_sharded_store_rounds_equal_the_flat_store(cls, tmp_path):
    """Rounds over a 3-shard spilled store, sampled through its directory,
    bit-equal to the flat store's: 8 host-loop rounds, and 8 windowed
    rounds at window 4 against them."""
    x, y, parts = _power_law()

    def sharded():
        return directory.ShardedFederatedStore.from_flat(
            x, y, parts, 4, num_shards=3, spill_dir=str(tmp_path),
            device="cpu")

    flat = _api(cls, store.FederatedStore(x, y, parts, 4, device="cpu"))
    host, win = _api(cls, sharded()), _api(cls, sharded())
    want = [flat.train_one_round(r)["train_loss"] for r in range(8)]
    assert [host.train_one_round(r)["train_loss"]
            for r in range(8)] == want
    assert win.train_rounds_windowed(8, window=4) == want
    for api in (host, win):
        for a, b in zip(tree_leaves(flat.net.params),
                        tree_leaves(api.net.params)):
            assert torch.equal(a, b)
