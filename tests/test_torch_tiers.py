"""The port's compiled round tiers on the CPU — ``train_one_round`` through
the fused step, ``train_rounds_pipelined`` and ``train_rounds_on_device``
of ``FedAvgAPI`` and ``FedAdapterAPI`` — against the eager reference
procedure (``run_round`` + ``_server_update``) and against the JAX
package's ``train_rounds_on_device``; ``keys.choice``, ``set_client_lr``,
the NaN guard inside the fused step and the carry protocol's refusals.
On the CPU the steps run eagerly (``device="cpu"``); their capture as CUDA
graphs is tested on the card (``tests/test_torch_cuda.py``)."""

from functools import partial

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.algos.config import FedConfig as JaxFedConfig
from fedml_tpu.algos.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.data import batching as jax_batching
from fedml_tpu.models.registry import create_model as jax_create_model
from fedml_tpu_torch.algos import FedAdapterAPI, FedAvgAPI, FedConfig
from fedml_tpu_torch.convert import from_jax_params, to_jax_params
from fedml_tpu_torch.core import keys
from fedml_tpu_torch.core.graph import CapturedStep
from fedml_tpu_torch.core.tree import tree_leaves
from fedml_tpu_torch.data import batching, partition, synthetic
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.trainer.local import NetState, seq_softmax_ce

WIDTHS = (4, 8, 16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _task(n=60, clients=6, seed=0):
    x, y = synthetic.make_image_classification(n, (8, 8, 3), 4, seed=seed)
    parts = partition.partition_dirichlet(y, clients, 0.5, min_size=4,
                                          seed=seed)
    return x, y, parts


def _api(cls=FedAvgAPI, per_round=3, lr=0.05, batch=4, nan_guard=False,
         fed=None):
    x, y, parts = _task()
    fed = fed or batching.build_federated_arrays(x, y, parts, batch,
                                                 device="cpu")
    cfg = FedConfig(client_num_in_total=6, client_num_per_round=per_round,
                    epochs=1, batch_size=batch, lr=lr)
    model = create_model("resnet20", widths=WIDTHS, num_classes=4,
                         device="cpu",
                         generator=torch.Generator().manual_seed(0))
    return cls(model, fed, None, cfg, nan_guard=nan_guard, device="cpu")


def _host_rounds(api, rounds):
    """The eager reference procedure: ``run_round`` + ``_server_update``."""
    losses = []
    for r in rounds:
        avg, loss = api.run_round(r)
        api.net = api._server_update(api.net, avg)
        losses.append(float(loss))
    return losses


def _assert_nets_equal(a, b):
    assert a.params.keys() == b.params.keys()
    for k in a.params:
        torch.testing.assert_close(a.params[k], b.params[k], rtol=0, atol=0)


# --- FedAvg --------------------------------------------------------------------

@pytest.mark.parametrize("per_round", [3, 6])
def test_fused_round_equals_run_round_and_server_update(per_round):
    """``train_one_round`` (the fused step: gather, train, average and
    server update as one step) is bit-equal to the separate procedure over
    3 rounds, params and losses."""
    fused, host = _api(per_round=per_round), _api(per_round=per_round)
    la = [fused.train_one_round(r)["train_loss"] for r in range(3)]
    lb = _host_rounds(host, range(3))
    assert la == lb
    _assert_nets_equal(fused.net, host.net)
    assert torch.equal(fused.rng, host.rng)
    assert CapturedStep.captures == 0  # the CPU runs the step eagerly


def test_pipelined_rounds_equal_the_host_loop():
    """``train_rounds_pipelined(5)`` (no sync between rounds, losses
    fetched once) equals 5 host-loop rounds bit for bit."""
    pipe, host = _api(), _api()
    la = pipe.train_rounds_pipelined(5)
    lb = _host_rounds(host, range(5))
    assert la == lb and len(la) == 5
    _assert_nets_equal(pipe.net, host.net)
    assert pipe.train_rounds_pipelined(0) == []


def test_on_device_rounds_equal_the_host_loop_at_full_participation():
    """At full participation the gather is the identity and is skipped;
    the per-round keys are the host loop's own chain, so 5 on-device
    rounds are bit-equal to 5 host-loop rounds."""
    dev, host = _api(per_round=6), _api(per_round=6)
    losses = dev.train_rounds_on_device(5)
    assert isinstance(losses, torch.Tensor) and losses.shape == (5,)
    assert losses.tolist() == _host_rounds(host, range(5))
    _assert_nets_equal(dev.net, host.net)
    assert torch.equal(dev.rng, host.rng)


def test_subsampled_on_device_rounds_draw_distinct_clients_and_match():
    """3 of 6 clients per round drawn on the device from the round key:
    distinct and in range, the same for the same seed, not one cohort for
    every round; the host loop fed the same cohorts gives bit-equal
    rounds."""
    dev, twin, host = _api(), _api(), _api()
    rng, cohorts = host.rng.clone(), []
    for _ in range(4):
        pair = keys.split(rng)
        rng = pair[0]
        cohorts.append(host._device_cohort(pair[1]))
    for c in cohorts:
        assert c.dtype == torch.int64 and c.shape == (3,)
        assert len(set(c.tolist())) == 3
        assert all(0 <= i < 6 for i in c.tolist())
    assert len({tuple(c.tolist()) for c in cohorts}) > 1
    losses = dev.train_rounds_on_device(4)
    assert torch.equal(losses, twin.train_rounds_on_device(4))
    _assert_nets_equal(dev.net, twin.net)
    host.sample_round = lambda r: cohorts[r]
    assert losses.tolist() == _host_rounds(host, range(4))
    _assert_nets_equal(dev.net, host.net)


def test_choice_is_uniform_without_replacement():
    """``keys.choice`` over 4000 keys (fixed seed), 3 of 10: every draw
    distinct; the count of each index, and of each index in the first slot,
    passes a chi-square test with 9 degrees of freedom at p = 0.001 (bound
    27.88)."""
    n, k, draws = 10, 3, 4000
    sel = keys.choice(keys.fold_in(keys.key(7), torch.arange(draws)), n, k)
    assert sel.shape == (draws, k)
    assert (sel.sort(dim=-1).values.diff(dim=-1) > 0).all()
    for obs, total in ((torch.bincount(sel.flatten(), minlength=n), draws * k),
                       (torch.bincount(sel[:, 0], minlength=n), draws)):
        exp = total / n
        chi2 = float(((obs.double() - exp) ** 2 / exp).sum())
        assert chi2 < 27.88, (obs, chi2)
    assert torch.equal(keys.choice(keys.key(3), n, k),
                       keys.choice(keys.key(3), n, k))
    with pytest.raises(ValueError, match="choice"):
        keys.choice(keys.key(3), 4, 5)


def test_set_client_lr_equals_a_fresh_api_at_that_lr():
    """A round at lr 0.05, then ``set_client_lr(0.02)``: the next rounds
    (fused, then on-device) equal those of an API built at lr 0.02 from the
    same model and key. The captured steps are dropped on a change and
    kept on a no-op."""
    a = _api(per_round=6, lr=0.05)
    a.train_one_round(0)
    b = _api(per_round=6, lr=0.02)
    b.net = NetState({k: v.clone() for k, v in a.net.params.items()}, {})
    b.rng = a.rng.clone()
    graphs = dict(a._graphs)
    a.set_client_lr(0.05)
    assert a._graphs == graphs and a._graphs
    a.set_client_lr(0.02)
    assert not a._graphs
    la = [a.train_one_round(r)["train_loss"] for r in (1, 2)]
    lb = [b.train_one_round(r)["train_loss"] for r in (1, 2)]
    assert la == lb
    assert torch.equal(a.train_rounds_on_device(2),
                       b.train_rounds_on_device(2))
    _assert_nets_equal(a.net, b.net)


def test_nan_guard_inside_the_fused_step():
    """A client whose data is NaN diverges; with ``nan_guard`` the fused
    round zero-weights it exactly as the separate procedure does (bit
    equal, finite), where without the guard the model turns NaN."""
    x, y, parts = _task()
    fed = batching.build_federated_arrays(x, y, parts, 4, device="cpu")
    fed.x[1] = float("nan")
    fused, host = (_api(per_round=6, nan_guard=True, fed=fed)
                   for _ in range(2))
    la = [fused.train_one_round(r)["train_loss"] for r in range(2)]
    assert la == _host_rounds(host, range(2))
    _assert_nets_equal(fused.net, host.net)
    assert all(torch.isfinite(v).all() for v in fused.net.params.values())
    bare = _api(per_round=6, fed=fed)
    bare.train_one_round(0)
    assert not all(torch.isfinite(v).all() for v in bare.net.params.values())


class _ImpureServer(FedAvgAPI):
    def _server_update(self, old_net, avg_net):
        return avg_net


class _NoProtocol(FedAvgAPI):
    window_protocol = None


@pytest.mark.parametrize("cls,match", [
    (_ImpureServer, "_ImpureServer overrides _server_update without "
     "providing its pure windowed form"),
    (_NoProtocol, "window_protocol=None"),
])
def test_tiers_refuse_a_server_update_without_its_pure_form(cls, match):
    """A class without the pure form of its server update (or without the
    protocol) has no fused step. As in JAX, ``train_one_round`` runs the
    host round (the round captured as its own step, then
    ``_server_update`` on the host side), bit-equal to ``run_round`` +
    ``_server_update``; the pipelined loop rides it where the record
    allows (a "round" class), and the tiers that fold the pure update
    between replays refuse, with the record's reason."""
    api, host = _api(cls=cls), _api(cls=cls)
    assert api.train_one_round(0)["train_loss"] == _host_rounds(host, [0])[0]
    _assert_nets_equal(api.net, host.net)
    tiers = [lambda: api.train_rounds_on_device(2)]
    if cls is _ImpureServer:
        assert api.train_rounds_pipelined(2, 1) == _host_rounds(host, [1, 2])
        _assert_nets_equal(api.net, host.net)
    else:
        tiers.append(lambda: api.train_rounds_pipelined(2))
    for tier in tiers:
        with pytest.raises(NotImplementedError, match=match):
            tier()


def test_tiers_refuse_a_streaming_store_by_name():
    """Where the JAX package takes a ``FederatedStore`` the port takes
    one: at construction, and on ``train_one_round`` and
    ``train_rounds_pipelined``, whose rounds equal the resident ones
    bit for bit. Where JAX refuses it the port refuses it with JAX's
    words: ``train_rounds_on_device`` over a store, and
    ``train_rounds_windowed`` over the resident layout. A ``train_fed``
    that is neither layout is refused at construction and, when
    ``api.train_fed`` is replaced later, by every tier."""
    from fedml_tpu.data.store import FederatedStore as JaxFederatedStore
    from fedml_tpu.models.lr import LogisticRegression
    from fedml_tpu_torch.data.store import FederatedStore

    x, y, parts = _task()
    resident = _api()
    streamed = _api(fed=FederatedStore(x, y, parts, 4, device="cpu"))
    assert streamed.train_rounds_pipelined(2) == \
        resident.train_rounds_pipelined(2)
    for k in resident.net.params:
        assert torch.equal(resident.net.params[k], streamed.net.params[k])
    assert streamed.train_one_round(2)["round"] == 2
    jcfg = JaxFedConfig(client_num_in_total=6, client_num_per_round=3,
                        epochs=1, batch_size=4)
    jstreamed = JaxFedAvgAPI(LogisticRegression(num_classes=4),
                             JaxFederatedStore(x, y, parts, 4), None, jcfg)
    jresident = JaxFedAvgAPI(LogisticRegression(num_classes=4),
                             jax_batching.build_federated_arrays(x, y,
                                                                 parts, 4),
                             None, jcfg)
    for port, jax_api, tier in ((streamed, jstreamed,
                                 "train_rounds_on_device"),
                                (resident, jresident,
                                 "train_rounds_windowed")):
        with pytest.raises(NotImplementedError) as jexc:
            getattr(jax_api, tier)(2)
        with pytest.raises(NotImplementedError) as exc:
            getattr(port, tier)(2)
        assert str(exc.value) == str(jexc.value)

    class _Store:
        pass

    with pytest.raises(AttributeError):  # JAX: no batch_size to check
        JaxFedAvgAPI(LogisticRegression(num_classes=4), _Store(), None,
                     jcfg)
    with pytest.raises(TypeError, match="_Store"):
        _api(fed=_Store())
    api = _api()
    api.train_fed = _Store()
    for tier in (lambda: api.train_one_round(0),
                 lambda: api.train_rounds_pipelined(2),
                 lambda: api.train_rounds_on_device(2),
                 lambda: api.train_rounds_windowed(2)):
        with pytest.raises(TypeError, match="_Store.*FederatedStore"):
            tier()


def test_gather_clients_takes_a_device_index_tensor_as_it_is():
    x, y, parts = _task()
    fed = batching.build_federated_arrays(x, y, parts, 4, device="cpu")
    idx = np.array([4, 0, 2])
    a = batching.gather_clients(fed, idx)
    b = batching.gather_clients(fed, torch.as_tensor(idx))
    for f in ("x", "y", "mask", "counts"):
        assert torch.equal(getattr(a, f), getattr(b, f))
    with pytest.raises(ValueError, match="int64"):
        batching.gather_clients(fed, torch.as_tensor(idx, dtype=torch.int32))


# --- against JAX's train_rounds_on_device --------------------------------------

def test_on_device_rounds_match_jax_at_full_participation():
    """``tests/test_torch_fedavg.py``'s end-to-end set-up at 6 of 6 clients
    (batch >= the largest client, so the shuffle only reorders a masked
    mean; lr 1e-3, where the small GroupNorm ResNet's amplification of f32
    rounding stays ~1e-5 against a ~3e-3 update): 2 on-device rounds of
    both packages from one start, params within 1e-4, losses within
    1e-5."""
    x, y, parts = _task()
    batch = max(len(v) for v in parts.values())
    cfg = dict(client_num_in_total=6, client_num_per_round=6, comm_round=2,
               epochs=2, lr=1e-3, batch_size=batch)
    japi = JaxFedAvgAPI(
        jax_create_model("resnet20", widths=WIDTHS, num_classes=4),
        jax_batching.build_federated_arrays(x, y, parts, batch), None,
        JaxFedConfig(**cfg))
    start = jax.tree.map(np.asarray, japi.net.params)
    jlosses = np.asarray(japi.train_rounds_on_device(2))
    fed = batching.build_federated_arrays(x, y, parts, batch, device="cpu")
    api = FedAvgAPI(create_model("resnet20", widths=WIDTHS, num_classes=4,
                                 device="cpu"), fed, None, FedConfig(**cfg),
                    device="cpu")
    api.net = NetState(from_jax_params(start)[0], {})
    losses = api.train_rounds_on_device(2)
    jparams = jax.tree.map(np.asarray, japi.net.params)
    moved = max(np.abs(a - b).max() for a, b in zip(
        jax.tree.leaves(jparams), jax.tree.leaves(start)))
    assert moved > 1e-3
    for a, b in zip(jax.tree.leaves(to_jax_params(api.net.params)),
                    jax.tree.leaves(jparams)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    np.testing.assert_allclose(losses.numpy(), jlosses, rtol=1e-5,
                               atol=1e-5)


# --- FedAdapter ------------------------------------------------------------------

V, T = 32, 32


def _adapter_api():
    rng = np.random.RandomState(0)
    seqs = rng.randint(1, V, size=(6 * 8, T + 1))
    fed = batching.build_federated_arrays(
        seqs[:, :T].astype(np.int32), seqs[:, 1:].astype(np.int32),
        partition.partition_homo(48, 6), 4, device="cpu")
    model = create_model("transformer_lm", vocab_size=V, d_model=32,
                         n_heads=2, n_layers=2, max_len=T, adapter_rank=4,
                         adapter_scope="attn", attn="flash", device="cpu",
                         generator=torch.Generator().manual_seed(0))
    cfg = FedConfig(client_num_in_total=6, client_num_per_round=6,
                    epochs=1, batch_size=4, lr=0.1, adapter_rank=4)
    return FedAdapterAPI(model, fed, None, cfg,
                         loss_fn=partial(seq_softmax_ce, pad_id=0),
                         device="cpu")


def test_fedadapter_tiers_equal_the_host_loop_with_the_base_frozen():
    """FedAdapter inherits the tiers: 3 fused, 3 pipelined and 3 on-device
    rounds each equal 3 host-loop rounds bit for bit at full
    participation, the adapters move, and the frozen base stays bitwise
    unchanged through all of them."""
    host = _adapter_api()
    want = _host_rounds(host, range(3))
    for run in (lambda a: [a.train_one_round(r)["train_loss"]
                           for r in range(3)],
                lambda a: a.train_rounds_pipelined(3),
                lambda a: a.train_rounds_on_device(3).tolist()):
        api = _adapter_api()
        base0 = {k: v.clone() for k, v in api.base.state_dict().items()}
        start = [v.clone() for v in tree_leaves(api.net.params)]
        assert run(api) == want
        _assert_nets_equal(api.net, host.net)
        assert any(not torch.equal(a, b) for a, b in zip(
            tree_leaves(api.net.params), start))
        after = api.base.state_dict()
        assert all(torch.equal(v, after[k]) for k, v in base0.items())
