"""Client selection (``client_selection`` ``pow_d`` and ``oort``) and the
host round of ``FedAvgAPI.train_one_round`` against the JAX package: the
port's counterparts of ``tests/test_selection.py``, plus the cohorts and
utilities of both packages side by side.

The side-by-side runs use data where each client holds copies of one
sample with its own label (the port's shuffle bits cannot matter, and
the clients' losses differ widely), the port's start weights carried
from JAX's: the cohorts must be equal, the utilities within 1e-5
(absolute: f32 losses of LR rounds in other summation orders, times
sqrt(n) <= 6)."""

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.algos.config import FedConfig as JaxFedConfig
from fedml_tpu.algos.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.core.sampling import sample_clients as jax_sample_clients
from fedml_tpu.data import batching as jax_batching
from fedml_tpu.data.store import FederatedStore as JaxFederatedStore
from fedml_tpu.models.lr import LogisticRegression as JaxLogisticRegression
from fedml_tpu_torch.algos import (DecentralizedAPI, DittoAPI, FedAvgAPI,
                                   FedConfig, ScaffoldAPI)
from fedml_tpu_torch.convert import from_jax_params, to_jax_params
from fedml_tpu_torch.core import keys
from fedml_tpu_torch.core.sampling import sample_clients_weighted
from fedml_tpu_torch.core.topology import SymmetricTopologyManager
from fedml_tpu_torch.data import build_federated_arrays
from fedml_tpu_torch.data.batching import gather_clients
from fedml_tpu_torch.data.store import FederatedStore
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.obs.checkpoint import (CheckpointManager, restore_run,
                                            save_run)
from fedml_tpu_torch.trainer.local import NetState

# Utilities (losses x sqrt(n)) against JAX's: f32 LR rounds.
UTIL_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _noisy_clients(n_clients=8, per=48, d=6, seed=0):
    """Client c's labels flipped with probability c/10: later clients are
    harder (JAX's fixture)."""
    rng = np.random.RandomState(seed)
    w = rng.randn(d)
    xs, ys = [], []
    for c in range(n_clients):
        x = rng.randn(per, d).astype(np.float32)
        y = (x @ w > 0).astype(np.int32)
        flip = rng.rand(per) < (c / 10.0)
        ys.append(np.where(flip, 1 - y, y).astype(np.int32))
        xs.append(x)
    parts = {c: np.arange(c * per, (c + 1) * per) for c in range(n_clients)}
    return np.concatenate(xs), np.concatenate(ys), parts


def _replicated(n_clients=8, d=6, seed=0):
    """Client c holds 8 + 4c copies of one sample with its own label."""
    rng = np.random.RandomState(seed)
    protos = rng.randn(n_clients, d).astype(np.float32) * 2
    labels = rng.randint(0, 2, n_clients).astype(np.int32)
    counts = [8 + 4 * c for c in range(n_clients)]
    x = np.concatenate([np.repeat(protos[i:i + 1], c, 0)
                        for i, c in enumerate(counts)])
    y = np.concatenate([np.full(c, labels[i], np.int32)
                        for i, c in enumerate(counts)])
    edges = np.concatenate([[0], np.cumsum(counts)])
    return x, y, {i: np.arange(edges[i], edges[i + 1])
                  for i in range(n_clients)}


def _cfg(selection="random", cpr=3, rounds=10, candidates=0, **kw):
    return dict(client_num_in_total=8, client_num_per_round=cpr,
                comm_round=rounds, epochs=1, batch_size=16, lr=0.3,
                client_selection=selection, pow_d_candidates=candidates,
                frequency_of_the_test=1000, **kw)


def _model(d=6):
    return create_model("lr", in_features=d, num_classes=2, device="cpu",
                        generator=torch.Generator().manual_seed(0))


def _api(data=None, cls=FedAvgAPI, store=False, **kw):
    x, y, parts = data or _noisy_clients()
    fed = (FederatedStore(x, y, parts, 16, device="cpu") if store
           else build_federated_arrays(x, y, parts, 16, device="cpu"))
    return cls(_model(x.shape[1]), fed, None, FedConfig(**_cfg(**kw)),
               device="cpu")


def _pair(store=False, **kw):
    """The port's and JAX's FedAvg on the replicated task, one config, the
    port starting from JAX's weights."""
    x, y, parts = _replicated()
    jfed = (JaxFederatedStore(x, y, parts, batch_size=16) if store
            else jax_batching.build_federated_arrays(x, y, parts, 16))
    japi = JaxFedAvgAPI(JaxLogisticRegression(num_classes=2), jfed, None,
                        JaxFedConfig(**_cfg(**kw)))
    api = _api((x, y, parts), store=store, **kw)
    api.net = NetState(from_jax_params(jax.tree.map(
        np.asarray, japi.net.params))[0], {})
    return api, japi


def _assert_nets_close(api, japi, tol=1e-5):
    for a, b in zip(jax.tree.leaves(to_jax_params(api.net.params)),
                    jax.tree.leaves(jax.tree.map(np.asarray,
                                                 japi.net.params))):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)


def _active(idx, wmask=None):
    idx = np.asarray(idx)
    return set(idx[np.asarray(wmask) > 0].tolist() if wmask is not None
               else idx.tolist())


# --- pow_d --------------------------------------------------------------------

def test_pow_d_picks_highest_loss_candidates():
    """After 5 rounds, round 7's cohort is the 2 highest eval losses among
    the 6 count-weighted candidates (recomputed by a plain eval)."""
    x, y, parts = _noisy_clients()
    api = _api((x, y, parts), selection="pow_d", cpr=2, candidates=6)
    for r in range(5):
        api.train_one_round(r)
    idx = api.sample_round(7)
    counts = np.array([len(parts[c]) for c in range(8)])
    candidates = sample_clients_weighted(7, 8, 6, counts)
    fed = api.train_fed
    losses = {int(c): float(api.eval_fn(api.net, fed.x[c], fed.y[c],
                                        fed.mask[c])["loss"])
              for c in candidates}
    top2 = set(sorted(losses, key=losses.get, reverse=True)[:2])
    assert set(np.asarray(idx).tolist()) == top2, losses


@pytest.mark.parametrize("store", [False, True])
def test_pow_d_cohorts_match_jax(store):
    """4 pow_d rounds (d 6 of 8, 3 a round) in both packages: the same
    cohort every round, params within 1e-5; from a store the port's
    cohorts equal its resident ones (bit-equal params)."""
    api, japi = _pair(store=store, selection="pow_d", candidates=6,
                      rounds=4)
    resident = _pair(selection="pow_d", candidates=6, rounds=4)[0] \
        if store else None
    for r in range(4):
        idx = api.sample_round(r)
        jidx, jw = japi.sample_round(r)
        assert _active(idx) == _active(jidx, jw), r
        api.train_one_round(r)
        japi.train_one_round(r)
        if resident is not None:
            np.testing.assert_array_equal(resident.sample_round(r), idx)
            resident.train_one_round(r)
    _assert_nets_close(api, japi)
    if resident is not None:
        for k in api.net.params:
            assert torch.equal(api.net.params[k], resident.net.params[k])


def test_random_selection_matches_reference_sampling():
    api = _api(cpr=3)
    np.testing.assert_array_equal(np.sort(np.asarray(api.sample_round(4))),
                                  np.sort(jax_sample_clients(4, 8, 3)))


def test_pow_d_trains_and_guard_scan():
    """pow_d trains through the host loop; the on-device and pipelined
    tiers refuse it (the on-device tier with JAX's words); an unknown
    selection constructs and is refused when sampled."""
    api = _api(selection="pow_d", cpr=3, rounds=8)
    losses = [api.train_one_round(r)["train_loss"] for r in range(8)]
    assert np.isfinite(losses).all()
    with pytest.raises(NotImplementedError, match="pow_d/oort"):
        api.train_rounds_on_device(2)
    with pytest.raises(NotImplementedError, match="pow_d"):
        api.train_rounds_pipelined(2)
    bad = _api(selection="fedcs", cpr=3)
    with pytest.raises(ValueError, match="client_selection"):
        bad.sample_round(0)


def test_pow_d_windowed_refused_with_jax_words():
    api = _api(selection="pow_d", store=True)
    with pytest.raises(NotImplementedError,
                       match="only seeded-random selection permits"):
        api.train_rounds_windowed(2, window=2)


def test_non_fedavg_algorithms_reject_pow_d():
    x, y, parts = _noisy_clients()
    api = DecentralizedAPI(_model(), build_federated_arrays(
        x, y, parts, 16, device="cpu"), None,
        FedConfig(**_cfg("pow_d", cpr=8)),
        SymmetricTopologyManager(8, neighbor_num=2), device="cpu")
    with pytest.raises(NotImplementedError, match="client_selection"):
        api.sample_round(0)


def test_pow_d_requires_enough_candidates():
    api = _api(selection="pow_d", cpr=4, candidates=2)
    with pytest.raises(ValueError, match="candidates"):
        api.sample_round(0)


def test_pow_d_cohort_stable_within_round():
    """Ditto trains a personal step after the global one: the memo gives
    the cohort the round trained."""
    x, y, parts = _noisy_clients()
    api = DittoAPI(_model(), build_federated_arrays(x, y, parts, 16,
                                                    device="cpu"), None,
                   FedConfig(**_cfg("pow_d", cpr=2, rounds=4,
                                    candidates=6)), lam=0.1, device="cpu")
    for r in range(3):
        before = np.array(api.sample_round(r))
        api.train_one_round(r)
        np.testing.assert_array_equal(before, api.sample_round(r))


# --- oort -----------------------------------------------------------------------

def test_oort_explores_then_exploits_high_loss_clients():
    api = _api(selection="oort", cpr=3, rounds=12, oort_epsilon=0.34)
    participation = np.zeros(8)
    for r in range(12):
        participation[np.asarray(api.sample_round(r))] += 1
        api.train_one_round(r)
    assert (api._oort_last >= 0).all(), api._oort_last
    assert participation[6] + participation[7] > \
        participation[0] + participation[1], participation


def test_oort_utilities_update_only_for_participants():
    api = _api(selection="oort", cpr=2, rounds=4)
    api.train_one_round(0)
    active = set(np.asarray(api.sample_round(0)).tolist())
    for c in range(8):
        assert (api._oort_last[c] == 0) == (c in active)
    assert all(api._oort_utility[c] > 0 for c in active)
    assert all(api._oort_utility[c] == 0 for c in set(range(8)) - active)


def test_oort_cohorts_and_utilities_match_jax():
    """4 oort rounds in both packages: equal cohorts, equal last-seen
    rounds, utilities within 1e-5, params within 1e-5; round 3
    exploits (its cohort holds seen clients)."""
    api, japi = _pair(selection="oort", cpr=3, rounds=4, oort_epsilon=0.34)
    for r in range(4):
        idx = api.sample_round(r)
        jidx, jw = japi.sample_round(r)
        assert _active(idx) == _active(jidx, jw), r
        api.train_one_round(r)
        japi.train_one_round(r)
    np.testing.assert_array_equal(api._oort_last, japi._oort_last)
    np.testing.assert_allclose(api._oort_utility, japi._oort_utility,
                               rtol=0, atol=UTIL_TOL)
    _assert_nets_close(api, japi)
    assert (api._oort_last[np.asarray(api.sample_round(3))] < 3).any() or \
        (api._oort_last >= 0).sum() > 3


def test_oort_deterministic():
    a, b = (_api(selection="oort") for _ in range(2))
    for r in range(5):
        np.testing.assert_array_equal(a.sample_round(r), b.sample_round(r))
        a.train_one_round(r)
        b.train_one_round(r)


def test_oort_rejects_scan_and_pipelined_paths():
    api = _api(selection="oort")
    with pytest.raises(NotImplementedError, match="pow_d/oort"):
        api.train_rounds_on_device(2)
    with pytest.raises(NotImplementedError, match="oort"):
        api.train_rounds_pipelined(2)
    store = _api(selection="oort", store=True)
    with pytest.raises(NotImplementedError,
                       match="only seeded-random selection permits"):
        store.train_rounds_windowed(2, window=2)


def test_oort_over_streaming_store_matches_resident():
    """Oort from a store: 6 rounds bit-equal to the resident layout's
    (cohorts, utilities, params)."""
    a = _api(selection="oort", cpr=3, rounds=6)
    b = _api(selection="oort", cpr=3, rounds=6, store=True)
    for r in range(6):
        assert a.train_one_round(r) == b.train_one_round(r)
    np.testing.assert_array_equal(a._oort_utility, b._oort_utility)
    np.testing.assert_array_equal(a._oort_last, b._oort_last)
    assert (b._oort_last >= 0).sum() >= 3


def test_oort_state_checkpoints_and_resumes(tmp_path):
    """A run checkpoint holds the utilities and last-seen rounds: 2 rounds,
    a save, a fresh api restored, 2 more rounds — bit-equal to 4 rounds
    straight (params, cohorts, utilities)."""
    straight = _api(selection="oort", cpr=3, rounds=6)
    want = [straight.train_one_round(r) for r in range(4)]
    api = _api(selection="oort", cpr=3, rounds=6)
    got = [api.train_one_round(r) for r in range(2)]
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    save_run(mgr, api, 1)
    fresh = _api(selection="oort", cpr=3, rounds=6)
    assert (fresh._oort_last == -1).all()
    assert restore_run(mgr, fresh) == 2
    mgr.close()
    np.testing.assert_array_equal(fresh._oort_last, api._oort_last)
    np.testing.assert_array_equal(fresh._oort_utility, api._oort_utility)
    got += [fresh.train_one_round(r) for r in range(2, 4)]
    assert got == want
    np.testing.assert_array_equal(fresh._oort_utility,
                                  straight._oort_utility)
    for k in fresh.net.params:
        assert torch.equal(fresh.net.params[k], straight.net.params[k])


def test_oort_rejects_custom_round_subclasses():
    with pytest.raises(NotImplementedError, match="oort"):
        _api(cls=ScaffoldAPI, selection="oort", cpr=8)


def test_oort_utilities_come_from_in_round_training_losses():
    """The utility is the client's in-round TRAINING loss x sqrt(n): the
    round built under oort returns the [C] losses as a third output,
    which an independent call of the same round with round 0's key
    reproduces."""
    api = _api(selection="oort", cpr=3, rounds=2)
    rnd = keys.split(api.rng)[1]
    idx = np.asarray(api.sample_round(0))
    sub = gather_clients(api.train_fed, torch.from_numpy(idx).long())
    w = sub.counts.float()
    out = api.round_fn(api.net, sub.x, sub.y, sub.mask, w, w, rnd)
    assert len(out) == 3 and out[2].shape == (3,)
    api.train_one_round(0)
    counts = w.double().numpy()
    np.testing.assert_array_equal(
        api._oort_utility[idx],
        out[2].double().numpy() * np.sqrt(np.maximum(counts, 1)))


def test_oort_exploration_sustained_after_full_coverage():
    api = _api(selection="oort", cpr=4, rounds=30, oort_epsilon=0.5)
    for r in range(6):
        api.train_one_round(r)
    assert (api._oort_last >= 0).all()
    cohorts = []
    for r in range(6, 16):
        cohorts.append(frozenset(np.asarray(
            api._sample_round_uncached(r)).tolist()))
        api.train_one_round(r)
    assert len(set(cohorts)) > 3, cohorts


# --- the host round ----------------------------------------------------------------

class _Blend(FedAvgAPI):
    """A ``_server_update`` without its pure form (JAX: a host-loop
    subclass): the new model halfway between the old one and the
    average."""

    def _server_update(self, old_net, avg_net):
        return NetState({k: 0.5 * old_net.params[k] + 0.5 * avg_net.params[k]
                         for k in avg_net.params}, avg_net.model_state)


class _JaxBlend(JaxFedAvgAPI):
    def _server_update(self, old_net, avg_net):
        return jax.tree.map(lambda a, b: 0.5 * a + 0.5 * b, old_net, avg_net)


def test_server_update_only_subclass_trains_through_train_one_round():
    """The subclass trains through ``train_one_round`` (the host round: the
    round captured, the server update on the host side), 3 rounds within
    1e-5 of JAX's same subclass, bit-equal to ``run_round`` +
    ``_server_update``; the on-device and windowed tiers refuse it with
    the record's reason."""
    x, y, parts = _replicated()
    cfg = _cfg(cpr=4, rounds=3)
    japi = _JaxBlend(JaxLogisticRegression(num_classes=2),
                     jax_batching.build_federated_arrays(x, y, parts, 16),
                     None, JaxFedConfig(**cfg))
    api, host = (_api((x, y, parts), cls=_Blend, cpr=4, rounds=3)
                 for _ in range(2))
    start = from_jax_params(jax.tree.map(np.asarray, japi.net.params))[0]
    api.net = NetState(dict(start), {})
    host.net = NetState(dict(start), {})
    assert not api.capability().fused and api.capability().pipelined
    for r in range(3):
        got = api.train_one_round(r)["train_loss"]
        want = japi.train_one_round(r)["train_loss"]
        avg, loss = host.run_round(r)
        host.net = host._server_update(host.net, avg)
        assert got == float(loss)
        assert abs(got - want) < 1e-5
    _assert_nets_close(api, japi)
    for k in api.net.params:
        assert torch.equal(api.net.params[k], host.net.params[k])
    with pytest.raises(NotImplementedError, match="pure windowed form"):
        api.train_rounds_on_device(1)


@pytest.mark.parametrize("cls_name", ["FedNovaAPI", "QFedAvgAPI"])
def test_oort_on_classes_with_their_own_round_functions(cls_name):
    """Oort serves the FedAvg family's shared round, with the round
    function a class builds itself (JAX's guard refuses custom rounds and
    steps only): FedNova's
    round passes the client losses through; q-FedAvg's round returns none,
    so the utilities come from one eval of the new global model on the
    cohort (JAX's fallback). Either way only the cohort's utilities are
    written, positive."""
    import fedml_tpu_torch.algos as algos

    api = _api(cls=getattr(algos, cls_name), selection="oort", cpr=3,
               rounds=4)
    for r in range(3):
        assert np.isfinite(api.train_one_round(r)["train_loss"])
        idx = np.asarray(api.sample_round(r))
        assert (api._oort_last[idx] == r).all()
        assert (api._oort_utility[idx] > 0).all()
    assert (api._oort_utility[api._oort_last < 0] == 0).all()
