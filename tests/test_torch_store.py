"""The port's host-resident client store (``fedml_tpu_torch/data/store.py``)
against the JAX package's, and the rounds that stream from it.

- ``gather_cohort``, its scalar reference, ``gather_window``,
  ``window_weights``, ``window_trained_mask`` and both bucket helpers
  byte for byte against ``fedml_tpu.data.store`` on power-law
  partitions, empty clients, duplicate indices and forced buckets;
- the prefetchers' contracts: stale rounds dropped, a mismatched index
  list gathered again, a worker's exception raised in ``get`` and the
  prefetcher still usable;
- rounds from a store against JAX's rounds from its store (FedAvg,
  FedOpt, FedNova, SCAFFOLD, FedDyn, Ditto, FedBN, FedAdapter), each at
  the tolerance its resident counterpart holds in
  ``tests/test_torch_{fedavg,algos,custom,fedadapter}.py``;
- the store and the resident layout giving the port bit-equal rounds,
  and the store-streamed evaluations against the resident ones.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algos.config import FedConfig as JaxFedConfig
from fedml_tpu.algos.ditto import DittoAPI as JaxDittoAPI
from fedml_tpu.algos.fedadapter import FedAdapterAPI as JaxFedAdapterAPI
from fedml_tpu.algos.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.algos.fedbn import FedBNAPI as JaxFedBNAPI
from fedml_tpu.algos.feddyn import FedDynAPI as JaxFedDynAPI
from fedml_tpu.algos.fednova import FedNovaAPI as JaxFedNovaAPI
from fedml_tpu.algos.fedopt import FedOptAPI as JaxFedOptAPI
from fedml_tpu.algos.scaffold import ScaffoldAPI as JaxScaffoldAPI
from fedml_tpu.comm.codec import tree_to_vector_np as jax_vec
from fedml_tpu.data import store as jax_store
from fedml_tpu.models.adapter import merge_params as jax_merge_params
from fedml_tpu.models.lr import LogisticRegression as JaxLogisticRegression
from fedml_tpu.models.registry import create_model as jax_create_model
from fedml_tpu.trainer.local import NetState as JaxNetState
from fedml_tpu.trainer.local import seq_softmax_ce as jax_seq_softmax_ce
from fedml_tpu_torch.algos import (DittoAPI, FedAdapterAPI, FedAvgAPI,
                                   FedBNAPI, FedConfig, FedDynAPI,
                                   FedNovaAPI, FedOptAPI, ScaffoldAPI)
from fedml_tpu_torch.convert import from_jax_params, to_jax_params
from fedml_tpu_torch.core.flat import tree_to_vector_np
from fedml_tpu_torch.core.tree import tree_leaves
from fedml_tpu_torch.data import build_federated_arrays, store
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.trainer.local import NetState, seq_softmax_ce
from test_torch_custom import _jax_stack_as_port

WIDTHS = (4, 8, 16)
FIELDS = ("x", "y", "mask", "counts")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _power_law(counts=(130, 17, 0, 30, 12, 25, 8, 21, 3, 0, 64, 5),
               shape=(4,), seed=0):
    """A federation with a giant client, two empty ones and ragged tails;
    labels int32 as the JAX package's data loaders give them."""
    rng = np.random.RandomState(seed)
    tot = int(sum(counts))
    x = rng.randn(tot, *shape).astype(np.float32)
    y = rng.randint(0, 5, tot).astype(np.int32)
    edges = np.concatenate([[0], np.cumsum(counts)])
    parts = {c: np.arange(edges[c], edges[c + 1])
             for c in range(len(counts))}
    return x, y, parts


def _same(port, jax_arrays, what=""):
    """Every field of a port ``FederatedArrays``/``WindowBatch`` equal in
    bytes to JAX's (labels compared as int64, the port's label dtype)."""
    for f in FIELDS:
        a = getattr(port, f).numpy()
        b = np.asarray(getattr(jax_arrays, f))
        if f == "y":
            b = b.astype(np.int64)
        assert a.shape == b.shape and a.dtype == b.dtype, (what, f)
        assert a.tobytes() == b.tobytes(), (what, f)


# --- the store against JAX's, byte for byte ---------------------------------

def test_bucket_helpers_match_jax():
    """Both bucket helpers equal JAX's for every count and batch, and the
    vectorized one equals the scalar one."""
    assert [store._bucket_steps(s) for s in range(0, 70)] == \
        [jax_store._bucket_steps(s) for s in range(0, 70)]
    counts = np.arange(0, 3000)
    for batch in (1, 5, 16, 32):
        got = store.bucket_steps_for_counts(counts, batch)
        np.testing.assert_array_equal(
            got, jax_store.bucket_steps_for_counts(counts, batch))
        np.testing.assert_array_equal(got, [
            store._bucket_steps(-(-int(c) // batch)) for c in counts])


@pytest.mark.parametrize("batch,max_steps", [(16, None), (8, None),
                                             (16, 3)])
@pytest.mark.parametrize("idx,steps", [
    ([0, 1, 2], None),           # the giant, a small and an empty client
    ([2, 9], None),              # only empty clients
    ([4, 4, 7, 4], None),        # duplicates
    ([5, 1, 11], 16),            # a forced bucket above the need
    (list(range(12)), None)])    # full participation
def test_gather_cohort_matches_jax(batch, max_steps, idx, steps):
    """``gather_cohort`` (and its scalar reference) byte-equal to JAX's,
    with ``max_steps`` truncating the giant; a forced bucket below the
    need is refused with JAX's words."""
    x, y, parts = _power_law()
    js = jax_store.FederatedStore(x, y, parts, batch, max_steps=max_steps)
    ps = store.FederatedStore(x, y, parts, batch, max_steps=max_steps,
                              device="cpu")
    np.testing.assert_array_equal(ps.counts, js.counts)
    assert ps.cohort_steps(idx) == js.cohort_steps(idx)
    want = js.gather_cohort(np.asarray(idx), steps=steps)
    _same(ps.gather_cohort(idx, steps=steps), want, "vectorized")
    _same(ps._gather_cohort_loop(idx, steps=steps), want, "loop")
    need = js.cohort_steps(idx)
    if need > 1:
        with pytest.raises(ValueError) as jexc:
            js.gather_cohort(np.asarray(idx), steps=need // 2)
        with pytest.raises(ValueError) as exc:
            ps.gather_cohort(idx, steps=need // 2)
        assert str(exc.value) == str(jexc.value)


def test_gather_window_and_its_companions_match_jax():
    """``gather_window`` byte-equal to JAX's at the window's max bucket and
    above it, each round's slice equal to ``gather_cohort`` at the forced
    bucket; ``window_weights`` and ``window_trained_mask`` equal JAX's
    with a padded slot; two windows of one shape reuse the staging
    buffers and the first window's tensors keep their bytes."""
    x, y, parts = _power_law(shape=(3, 2))
    js = jax_store.FederatedStore(x, y, parts, 8)
    ps = store.FederatedStore(x, y, parts, 8, device="cpu")
    w1 = np.array([[0, 1, 2], [3, 4, 5], [2, 9, 9]])
    w2 = np.array([[6, 7, 8], [10, 11, 1], [4, 4, 3]])
    steps = max(js.cohort_steps(r) for r in w1)
    first = ps.gather_window(w1, steps)
    before = first.x.clone()
    _same(first, js.gather_window(w1, steps), "window 1")
    _same(ps.gather_window(w2, steps), js.gather_window(w2, steps),
          "window 2")
    assert len(ps._staging) == 2
    assert torch.equal(first.x, before)  # the put copied, never aliased
    for t, row in enumerate(w1):
        _same(first.round_arrays(t), js.gather_cohort(row, steps=steps),
              f"round {t}")
    _same(ps.gather_window(w1, 2 * steps), js.gather_window(w1, 2 * steps),
          "a larger bucket")
    wmask = np.array([[1, 1, 0], [1, 1, 1], [1, 0, 1]], np.float32)
    for name in ("window_weights", "window_trained_mask"):
        got = getattr(ps, name)(w1, wmask)
        want = getattr(js, name)(w1, wmask)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match=r"window_indices must be \[W, k\]"):
        ps.gather_window(w1[0], steps)
    assert ps.example_input().shape == (8, 3, 2)
    assert ps.nbytes() == x.nbytes + 8 * len(y)


# --- the prefetchers' contracts ------------------------------------------------

def test_cohort_prefetcher_contracts():
    """A prefetched cohort equals a direct gather; a mismatched index list
    is gathered again; stale rounds are dropped; a failing worker leaves
    no pending round and ``get`` raises in the caller."""
    x, y, parts = _power_law()
    ps = store.FederatedStore(x, y, parts, 8, device="cpu")
    pf = store.CohortPrefetcher(ps)
    for r in range(3):
        pf.prefetch(r, [r, r + 1, r + 2])
    direct = ps.gather_cohort([2, 3, 4])
    got = pf.get(2, [2, 3, 4])
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(direct, f))
    assert not pf._ready and not pf._pending  # rounds 0 and 1 dropped
    pf.prefetch(5, [0, 1])
    other = pf.get(5, [1, 0])
    assert other.counts.tolist() == [17, 130]
    pf.prefetch(6, [99])  # out of range: the worker fails
    with pytest.raises(IndexError):
        pf.get(6, [99])
    assert not pf._pending
    assert pf.get(7, [3]).counts.tolist() == [30]


def test_window_prefetcher_raises_a_worker_failure_in_get():
    """A worker's exception is raised in ``get``, never lost and never a
    deadlock, and the prefetcher serves the next window; a window asked
    at another bucket than prefetched is gathered again."""
    x, y, parts = _power_law()
    ps = store.FederatedStore(x, y, parts, 8, device="cpu")
    pf = store.WindowPrefetcher(ps)
    bad = np.array([[0, 1], [2, 3]])
    pf.prefetch(0, bad, 1)  # below the giant's need
    with pytest.raises(ValueError, match="forced steps 1 < cohort need"):
        pf.get(0, bad, 1)
    good = np.array([[3, 4], [5, 6]])
    pf.prefetch(1, good, 8)
    want = ps.gather_window(good, 8)
    got = pf.get(1, good, 8)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f))
    pf.prefetch(2, good, 8)
    assert pf.get(2, good, 16).x.shape[2] == 16
    assert not pf._done and not pf._pending


# --- rounds from a store ------------------------------------------------------

def _replicated_task(counts=(5, 9, 13, 3, 17, 8), shape=(10,), seed=0):
    """Client i holds ``counts[i]`` copies of one sample with one label
    (the port's shuffle is not JAX's; with copies every permutation gives
    the same batches)."""
    rng = np.random.RandomState(seed)
    protos = rng.randn(len(counts), *shape).astype(np.float32)
    labels = rng.randint(0, 4, len(counts)).astype(np.int32)
    x = np.concatenate([np.repeat(protos[i:i + 1], c, 0)
                        for i, c in enumerate(counts)])
    y = np.concatenate([np.full(c, labels[i], np.int32)
                        for i, c in enumerate(counts)])
    edges = np.concatenate([[0], np.cumsum(counts)])
    return x, y, {i: np.arange(edges[i], edges[i + 1])
                  for i in range(len(counts))}


_ROUND_ALGOS = {
    "fedavg": (FedAvgAPI, JaxFedAvgAPI, {}, {}),
    "fedopt": (FedOptAPI, JaxFedOptAPI,
               dict(server_optimizer="adam", server_lr=0.05), {}),
    "fednova": (FedNovaAPI, JaxFedNovaAPI, {}, {}),
    "scaffold": (ScaffoldAPI, JaxScaffoldAPI, {}, dict(server_lr=1.0)),
    "feddyn": (FedDynAPI, JaxFedDynAPI, {}, dict(alpha=0.01)),
    "ditto": (DittoAPI, JaxDittoAPI, {}, dict(lam=0.1)),
    "fedbn": (FedBNAPI, JaxFedBNAPI, {}, {}),
}


def _jax_rows(stack):
    """A JAX ``[N, ...]`` stacked flax tree as the port's ``[N, ...]``
    rows (its client stack without the dustbin row)."""
    return {k: v[:-1] for k, v in _jax_stack_as_port(stack).items()}


V, T = 16, 8
TLM = dict(vocab_size=V, d_model=16, n_heads=2, n_layers=1, max_len=T)


def _replicated_tokens(counts=(5, 9, 13, 3, 17, 8), seed=0):
    """Client i holds ``counts[i]`` copies of one token sequence."""
    protos = np.random.RandomState(seed).randint(1, V, (len(counts), T + 1))
    seqs = np.concatenate([np.repeat(protos[i:i + 1], c, 0)
                           for i, c in enumerate(counts)])
    edges = np.concatenate([[0], np.cumsum(counts)])
    return (seqs[:, :T].astype(np.int32), seqs[:, 1:].astype(np.int32),
            {i: np.arange(edges[i], edges[i + 1])
             for i in range(len(counts))})


def _store_pair(algo):
    """The port's and JAX's class of ``algo``, each over its own package's
    store of one replicated task, from JAX's start weights: LR at lr 0.1
    and 2 local epochs; FedBN, which needs norm layers, over a tiny
    ``transformer_lm`` (its LayerNorms client-local) at lr 0.1 and 1
    epoch."""
    cls, jcls, cfg_kw, kw = _ROUND_ALGOS[algo]
    cfg = dict(client_num_in_total=6, client_num_per_round=4, comm_round=3,
               epochs=2, batch_size=4, lr=0.1, frequency_of_the_test=100,
               **cfg_kw)
    if algo == "fedbn":
        x, y, parts = _replicated_tokens()
        cfg["epochs"] = 1
        jm, jkw = jax_create_model("transformer_lm", **TLM), dict(
            loss_fn=partial(jax_seq_softmax_ce, pad_id=0))
        tm, tkw = create_model("transformer_lm", device="cpu", **TLM), dict(
            loss_fn=partial(seq_softmax_ce, pad_id=0))
    else:
        x, y, parts = _replicated_task()
        jm, jkw = JaxLogisticRegression(num_classes=4), {}
        tm, tkw = create_model("lr", in_features=10, num_classes=4,
                               device="cpu"), {}
    japi = jcls(jm, jax_store.FederatedStore(x, y, parts, 4), None,
                JaxFedConfig(**cfg), **jkw, **kw)
    api = cls(tm, store.FederatedStore(x, y, parts, 4, device="cpu"), None,
              FedConfig(**cfg), device="cpu", **tkw, **kw)
    api.net = NetState(from_jax_params(
        jax.tree.map(np.asarray, japi.net.params))[0], api.net.model_state)
    if algo == "ditto":
        api._window_carry_commit(NetState(
            _with_dustbin(_jax_rows(japi.personal_nets.params)),
            api._personal.model_state))
    if algo == "fedbn":
        api._window_carry_commit((_with_dustbin(
            _jax_rows(japi.local_norms)), api._states))
    return api, japi


def _with_dustbin(rows):
    """Rows as a client stack (the dustbin row appended)."""
    return {k: torch.cat([v, torch.zeros_like(v[:1])])
            for k, v in rows.items()}


def _carries(algo, api, japi):
    """``[(port dict, JAX tree, stacked)]`` of the carried state."""
    if algo == "scaffold":
        return [(api.server_control, japi.server_control, False),
                (api.client_controls, japi.client_controls, True)]
    if algo == "feddyn":
        return [(api.server_h, japi.server_h, False),
                (api.client_grads, japi.client_grads, True)]
    if algo == "ditto":
        return [(api.personal_nets.params, japi.personal_nets.params, True)]
    if algo == "fedbn":
        return [(api.local_norms, japi.local_norms, True)]
    if algo == "fedopt":
        st, jst = api.server_opt_state["0"], japi.server_opt_state[0]
        return [(st["mu"], jst.mu, False), (st["nu"], jst.nu, False)]
    return []


@pytest.mark.parametrize("algo", list(_ROUND_ALGOS))
def test_store_rounds_match_jax_store_rounds(algo):
    """3 rounds of ``train_one_round`` over each package's own store, from
    one start: params, the carried state and the losses within 1e-5, the
    tolerance of the resident LR tests, and the params moved."""
    api, japi = _store_pair(algo)
    start = jax_vec(jax.tree.map(np.asarray, japi.net.params))
    tol = 1e-5
    for r in range(3):
        la = api.train_one_round(r)["train_loss"]
        lb = japi.train_one_round(r)["train_loss"]
        assert la == pytest.approx(lb, rel=1e-5, abs=1e-5), r
    want = jax_vec(jax.tree.map(np.asarray, japi.net.params))
    assert np.abs(want - start).max() > 1e-2
    np.testing.assert_allclose(jax_vec(to_jax_params(api.net.params)), want,
                               rtol=0, atol=tol)
    for got, jtree, stacked in _carries(algo, api, japi):
        jrows = (_jax_rows(jtree) if stacked else from_jax_params(
            jax.tree.map(np.asarray, jtree))[0])
        assert set(got) == set(jrows)
        for k, v in got.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(jrows[k]),
                                       rtol=0, atol=tol, err_msg=k)


def test_fedadapter_store_rounds_match_jax():
    """FedAdapter over each package's store (flash attention on both
    sides, one layer, 2 rounds x 3 of 6 clients, batch 8 = the largest
    client, 1 local epoch): the
    adapters within 1e-6 and the losses within 1e-5, as the resident
    test holds them; then a personalization pass gathered from the store,
    bit-equal to one over the resident layout from the same adapters."""
    from fedml_tpu_torch.data import partition

    vocab, t = 32, 32
    kw = dict(vocab_size=vocab, d_model=32, n_heads=2, n_layers=1,
              max_len=t, adapter_rank=4, adapter_scope="attn", attn="flash")
    rng = np.random.RandomState(0)
    seqs = rng.randint(1, vocab, size=(48, t + 1))
    x, y = seqs[:, :t].astype(np.int32), seqs[:, 1:].astype(np.int32)
    parts = partition.partition_homo(len(x), 6)
    cfg = dict(client_num_in_total=6, client_num_per_round=3, comm_round=2,
               batch_size=8, lr=0.1, epochs=1, frequency_of_the_test=1000)
    japi = JaxFedAdapterAPI(jax_create_model("transformer_lm", **kw),
                            jax_store.FederatedStore(x, y, parts, 8), None,
                            JaxFedConfig(**cfg),
                            loss_fn=partial(jax_seq_softmax_ce, pad_id=0),
                            personal_interp=1.0)
    noise = np.random.default_rng(1)
    start = jax.tree.map(lambda a: np.asarray(a) + noise.normal(
        0, 0.05, a.shape).astype(np.float32), japi.net.params)
    japi.net = JaxNetState(jax.tree.map(jnp.asarray, start), {})
    state, adapters = from_jax_params(jax_merge_params(
        jax.tree.map(np.asarray, japi.base), start))
    api = FedAdapterAPI(create_model("transformer_lm", device="cpu", **kw),
                        store.FederatedStore(x, y, parts, 8, device="cpu"),
                        None, FedConfig(**cfg),
                        loss_fn=partial(seq_softmax_ce, pad_id=0),
                        base_params=state, personal_interp=1.0,
                        device="cpu")
    api.net = NetState(adapters, {})
    jl = [japi.train_one_round(r)["train_loss"] for r in range(2)]
    tl = api.train_rounds_pipelined(2)
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
    got, want = tree_to_vector_np(api.net.params), jax_vec(
        jax.tree.map(np.asarray, japi.net.params))
    assert np.abs(want - jax_vec(start)).max() > 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    res = FedAdapterAPI(create_model("transformer_lm", device="cpu", **kw),
                        build_federated_arrays(x, y, parts, 8, device="cpu"),
                        None, FedConfig(**cfg),
                        loss_fn=partial(seq_softmax_ce, pad_id=0),
                        base_params=state, personal_interp=1.0,
                        device="cpu")
    res.net = api.net
    np.testing.assert_array_equal(api.personalize_cohort([0, 3, 5]),
                                  res.personalize_cohort([0, 3, 5]))
    np.testing.assert_array_equal(
        api.personal_store().gather([0, 3, 5], api.net.params),
        res.personal_store().gather([0, 3, 5], res.net.params))


# --- the store against the resident layout, in the port ------------------------

def _lr_api(cls, fed, **kw):
    cfg = FedConfig(client_num_in_total=12, client_num_per_round=4,
                    comm_round=6, epochs=1, batch_size=4, lr=0.1,
                    **{k: kw.pop(k) for k in list(kw)
                       if k in FedConfig.__dataclass_fields__})
    model = create_model("lr", in_features=4, num_classes=5, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    return cls(model, fed, None, cfg, device="cpu", **kw)


def _carry_state(api):
    return [t for t in tree_leaves(api.net.params)] + [
        t for part in _flat(api._window_carry_init()) for t in part]


def _flat(extra):
    if extra is None:
        return []
    if isinstance(extra, NetState):
        return [tree_leaves(extra.params), tree_leaves(extra.model_state)]
    if isinstance(extra, (tuple, list)):
        return [leaf for e in extra for leaf in _flat(e)]
    return [tree_leaves(extra)]


_RESIDENT_CASES = {
    "fedavg": (FedAvgAPI, {}),
    "fedopt": (FedOptAPI, dict(server_optimizer="adam", server_lr=0.05)),
    "fednova": (FedNovaAPI, {}),
    "scaffold": (ScaffoldAPI, {}),
    "feddyn": (FedDynAPI, dict(alpha=0.05)),
    "ditto": (DittoAPI, dict(lam=0.1)),
}


@pytest.mark.parametrize("case", list(_RESIDENT_CASES))
def test_store_rounds_equal_resident_rounds_bit_for_bit(case):
    """On a power-law federation (a giant client, empty ones) the rounds
    from a store, each cohort at its own step bucket, are bit-equal to the
    rounds over the resident layout padded to the giant: the params, the
    carry and the losses, over 6 pipelined rounds."""
    cls, kw = _RESIDENT_CASES[case]
    x, y, parts = _power_law()
    res = _lr_api(cls, build_federated_arrays(x, y, parts, 4, device="cpu"),
                  **dict(kw))
    st = _lr_api(cls, store.FederatedStore(x, y, parts, 4, device="cpu"),
                 **dict(kw))
    assert res.train_rounds_pipelined(6) == st.train_rounds_pipelined(6)
    for a, b in zip(_carry_state(res), _carry_state(st)):
        assert torch.equal(a, b)


def test_streamed_evaluations_equal_the_resident_ones():
    """``evaluate_on_clients`` over a store goes through the clients in
    chunks and gives the resident figures (within 1e-6: the sums are
    taken in another order); so do Ditto's personalized evaluation and
    the store-backed FedAvg ``train``'s history."""
    x, y, parts = _power_law()

    def pair(cls, **kw):
        return (_lr_api(cls, build_federated_arrays(x, y, parts, 4,
                                                    device="cpu"), **kw),
                _lr_api(cls, store.FederatedStore(x, y, parts, 4,
                                                  device="cpu"), **kw))

    res, st = pair(DittoAPI, lam=0.1)
    res.train_rounds_pipelined(2)
    st.train_rounds_pipelined(2)
    for got, want in ((st.evaluate_on_clients(), res.evaluate_on_clients()),
                      (st._evaluate_on_clients_streaming("clients_train",
                                                         chunk=5),
                       res.evaluate_on_clients()),
                      (st.evaluate_personalized(),
                       res.evaluate_personalized())):
        assert sorted(got) == sorted(want)
        for k in got:
            assert got[k] == pytest.approx(want[k], abs=1e-6), k
    res, st = pair(FedAvgAPI)
    assert [h["train_loss"] for h in st.train()] == \
        [h["train_loss"] for h in res.train()]


@pytest.mark.parametrize("name", ["hierarchical", "turboaggregate"])
def test_host_loop_classes_stream_from_a_store(name):
    """Hierarchical FL (its groups' padded cohorts gathered from the host)
    and TurboAggregate (its cohort gathered for the round's training)
    take a store, as JAX's do, with 3 rounds bit-equal to their resident
    rounds; both stay off the windowed tier, as in JAX's records."""
    from fedml_tpu_torch.algos.hierarchical import HierarchicalFedAvgAPI
    from fedml_tpu_torch.algos.turboaggregate import TurboAggregateAPI

    x, y, parts = _power_law()
    if name == "hierarchical":
        cls, kw = HierarchicalFedAvgAPI, dict(group_ids=np.arange(12) % 3)
    else:
        cls, kw = TurboAggregateAPI, dict(n_groups=3)
    res = _lr_api(cls, build_federated_arrays(x, y, parts, 4, device="cpu"),
                  **dict(kw))
    st = _lr_api(cls, store.FederatedStore(x, y, parts, 4, device="cpu"),
                 **dict(kw))
    assert not st.capability().windowed
    for r in range(3):
        assert st.train_one_round(r) == res.train_one_round(r)
    for a, b in zip(tree_leaves(res.net.params), tree_leaves(st.net.params)):
        assert torch.equal(a, b)
