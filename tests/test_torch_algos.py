"""The port's "round"-protocol algorithms — ``LogisticRegression``, the
FedOpt server optimizers, FedProx's ``extra_grad_fn``, ``FedOptAPI``,
``FedProxAPI``, ``FedAvgRobustAPI``, ``FedNovaAPI`` and
``CentralizedTrainer`` — against the JAX package on the same seeded
numpy inputs and weights; their reductions to FedAvg; their round tiers
against the eager reference procedure (``run_round`` +
``_server_update``) and the capability records' refusals.

The algorithm rounds use data where each client holds copies of one
sample: the port's shuffle draws from ``core/keys.py``, not threefry, and
with identical samples every permutation gives the same batches, so
several local steps per round (unequal between clients, as FedNova
needs) compare across the two packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fedml_tpu.algos.centralized import \
    CentralizedTrainer as JaxCentralizedTrainer
from fedml_tpu.algos.config import FedConfig as JaxFedConfig
from fedml_tpu.algos.fednova import FedNovaAPI as JaxFedNovaAPI
from fedml_tpu.algos.fedopt import FedOptAPI as JaxFedOptAPI
from fedml_tpu.algos.fedopt import \
    make_server_optimizer as jax_server_optimizer
from fedml_tpu.algos.fedprox import FedProxAPI as JaxFedProxAPI
from fedml_tpu.algos.robust import FedAvgRobustAPI as JaxFedAvgRobustAPI
from fedml_tpu.data import batching as jax_batching
from fedml_tpu.models.lr import LogisticRegression as JaxLogisticRegression
from fedml_tpu.models.registry import create_model as jax_create_model
from fedml_tpu.trainer.local import make_client_optimizer as jax_optimizer
from fedml_tpu.trainer.local import make_local_train_fn as jax_local_train
from fedml_tpu_torch.algos import (CentralizedTrainer, FedAvgAPI,
                                   FedAvgRobustAPI, FedConfig, FedNovaAPI,
                                   FedOptAPI, FedProxAPI)
from fedml_tpu_torch.algos.fedopt import make_server_optimizer
from fedml_tpu_torch.convert import from_jax_params, to_jax_params
from fedml_tpu_torch.core import keys
from fedml_tpu_torch.core.aggregate import pseudo_gradient, weighted_average
from fedml_tpu_torch.data import (batch_global, build_federated_arrays,
                                  make_classification, partition_homo)
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.trainer.local import (NetState, apply_updates,
                                           make_client_optimizer,
                                           make_local_train_fn, model_fns)

WIDTHS = (4, 8, 16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- the model and its weights -------------------------------------------------

def test_lr_forward_matches_flax_and_weights_round_trip():
    """``create_model("lr")`` over flattened NHWC input against flax's
    ``LogisticRegression`` with its weights carried across: logits within
    1e-6; ``to_jax_params`` gives flax's tree back bit for bit."""
    x = np.random.RandomState(0).randn(5, 4, 4, 3).astype(np.float32)
    jmodel = JaxLogisticRegression(num_classes=7)
    jparams = jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    jparams = jax.tree.map(np.asarray, jparams)
    state, adapters = from_jax_params(jparams)
    assert sorted(state) == ["linear.bias", "linear.weight"] and not adapters
    model = create_model("lr", in_features=48, num_classes=7, device="cpu")
    model.load_state_dict(state)
    got = model(torch.from_numpy(x)).detach().numpy()
    want = np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    back = to_jax_params(model.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(jparams)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(a, b)
    bf = create_model("lr", in_features=48, num_classes=7, dtype="bf16",
                      device="cpu")
    bf.load_state_dict(state)
    assert bf(torch.from_numpy(x)).dtype == torch.bfloat16
    with pytest.raises(ValueError, match="in_features"):
        create_model("lr", num_classes=7, device="cpu")


# --- the server optimizers -----------------------------------------------------

@pytest.mark.parametrize("name,momentum", [("sgd", 0.0), ("sgd", 0.9),
                                           ("adam", 0.9), ("yogi", 0.9),
                                           ("adagrad", 0.9)])
def test_server_optimizer_matches_optax(name, momentum):
    """5 steps of each server optimizer on the same params and
    pseudo-gradients: params within rtol 1e-6 of optax's, and the step
    count advanced by one per step."""
    rng = np.random.RandomState(2)
    p0 = {"a": rng.randn(6, 3).astype(np.float32),
          "b": rng.randn(4).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) * 0.3
              for k, v in p0.items()} for _ in range(5)]
    opt = make_server_optimizer(name, 0.05, momentum)
    jopt = jax_server_optimizer(name, 0.05, momentum)
    p = {k: torch.from_numpy(v) for k, v in p0.items()}
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    st, jst = opt.init(p), jopt.init(jp)
    for g in grads:
        upd, st = opt.update({k: torch.from_numpy(v) for k, v in g.items()},
                             st, p)
        p = apply_updates(p, upd)
        jupd, jst = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                                jst, jp)
        jp = optax.apply_updates(jp, jupd)
        for k in p0:
            np.testing.assert_allclose(p[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)
    if name in ("adam", "yogi"):
        assert st["0"]["count"].dtype == torch.int32
        assert int(st["0"]["count"]) == 5
    with pytest.raises(ValueError, match="unknown server optimizer"):
        make_server_optimizer("lamb", 0.1)


def test_aggregate_helpers():
    st = {"w": torch.tensor([[1.0, 2.0], [3.0, 6.0]])}
    assert torch.equal(weighted_average(st, [1, 3])["w"],
                       torch.tensor([2.5, 5.0]))
    assert torch.equal(pseudo_gradient({"w": torch.ones(2)},
                                       {"w": torch.tensor([0.5, 2.0])})["w"],
                       torch.tensor([0.5, -1.0]))


# --- the local trainer's extra gradient ----------------------------------------

def test_extra_grad_fn_matches_jax():
    """One client, 3 steps of momentum SGD with a proximal extra gradient
    anchored at the start params, against JAX's local trainer: params
    within 1e-6; the anchor is the start, not the moving params."""
    x, y, parts = _replicated_task(counts=(12,))
    fed = build_federated_arrays(x, y, parts, 4, device="cpu")
    jfed = jax_batching.build_federated_arrays(x, y, parts, 4)
    jmodel = JaxLogisticRegression(num_classes=4)
    jparams = jax.tree.map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(x[:1]))["params"])

    def prox(p, g):
        return jax.tree.map(lambda a, b: 0.7 * (a - b), p, g)

    from fedml_tpu.trainer.local import NetState as JaxNetState
    from fedml_tpu.trainer.local import model_fns as jax_model_fns

    jfns = jax_model_fns(jmodel)
    jlt = jax_local_train(jfns.apply, jax_optimizer("momentum", 0.1), 1,
                          extra_grad_fn=prox)
    jnet, _ = jlt(JaxNetState(jparams, {}), jfed.x[0], jfed.y[0],
                  jfed.mask[0], jax.random.PRNGKey(3))
    model = create_model("lr", in_features=10, num_classes=4, device="cpu")
    fns = model_fns(model)
    lt = make_local_train_fn(
        fns.apply, make_client_optimizer("momentum", 0.1), 1,
        extra_grad_fn=lambda p, g: {k: 0.7 * (p[k] - g[k]) for k in p})
    net, _ = lt(NetState(from_jax_params(jparams)[0], {}), fed.x[0],
                fed.y[0], fed.mask[0], keys.key(3))
    got = to_jax_params(net.params)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jnet.params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-6)
    plain = make_local_train_fn(fns.apply,
                                make_client_optimizer("momentum", 0.1), 1)
    free, _ = plain(NetState(from_jax_params(jparams)[0], {}), fed.x[0],
                    fed.y[0], fed.mask[0], keys.key(3))
    assert any(not torch.allclose(net.params[k], free.params[k])
               for k in net.params)


# --- the algorithms against JAX --------------------------------------------------

def _replicated_task(counts=(5, 9, 13, 3, 17, 8), shape=(10,), seed=0):
    """Client i holds ``counts[i]`` copies of one sample with one label."""
    rng = np.random.RandomState(seed)
    protos = rng.randn(len(counts), *shape).astype(np.float32)
    labels = rng.randint(0, 4, len(counts)).astype(np.int32)
    x = np.concatenate([np.repeat(protos[i:i + 1], c, 0)
                        for i, c in enumerate(counts)])
    y = np.concatenate([np.full(c, labels[i], np.int32)
                        for i, c in enumerate(counts)])
    edges = np.concatenate([[0], np.cumsum(counts)])
    parts = {i: np.arange(edges[i], edges[i + 1])
             for i in range(len(counts))}
    return x, y, parts


_ALGOS = {
    "fedopt": (FedOptAPI, JaxFedOptAPI,
               dict(server_optimizer="adam", server_lr=0.05)),
    "fedprox": (FedProxAPI, JaxFedProxAPI, dict(fedprox_mu=0.1)),
    "robust": (FedAvgRobustAPI, JaxFedAvgRobustAPI,
               dict(aggregator="coord_median", robust_norm_bound=0.5,
                    robust_stddev=0.0, corrupt_mode="scale",
                    corrupt_scale=3.0, attack_freq=1)),
    "fednova": (FedNovaAPI, JaxFedNovaAPI, {}),
}


def _pair(algo, model, rounds=3):
    """The port's and JAX's class of ``algo`` on the same data, config and
    start weights; ``model`` "lr" (lr 0.1) or "resnet20" (widths (4, 8,
    16), 16x16 images, lr 1e-3: the small GroupNorm ResNet amplifies f32
    rounding through its one-channel groups, the more the smaller their
    last feature maps, and at these sizes it stays small against the
    update)."""
    cls, jcls, kw = _ALGOS[algo]
    shape = (10,) if model == "lr" else (16, 16, 3)
    x, y, parts = _replicated_task(shape=shape)
    cfg = dict(client_num_in_total=6, client_num_per_round=4,
               comm_round=rounds, epochs=2, batch_size=4,
               lr=0.1 if model == "lr" else 1e-3,
               frequency_of_the_test=100, **kw)
    if model == "lr":
        jm = JaxLogisticRegression(num_classes=4)
        tm = create_model("lr", in_features=10, num_classes=4, device="cpu")
    else:
        jm = jax_create_model("resnet20", widths=WIDTHS, num_classes=4)
        tm = create_model("resnet20", widths=WIDTHS, num_classes=4,
                          device="cpu")
    japi = jcls(jm, jax_batching.build_federated_arrays(x, y, parts, 4),
                None, JaxFedConfig(**cfg))
    api = cls(tm, build_federated_arrays(x, y, parts, 4, device="cpu"),
              None, FedConfig(**cfg), device="cpu")
    start = jax.tree.map(np.asarray, japi.net.params)
    api.net = NetState(from_jax_params(start)[0], {})
    return api, japi, start


@pytest.mark.parametrize("model", ["lr", "resnet20"])
@pytest.mark.parametrize("algo", list(_ALGOS))
def test_algorithm_rounds_match_jax(algo, model):
    """3 rounds of each algorithm's ``train_one_round`` in both packages
    from one start: params within 1e-5 (LR) or 1e-4 (ResNet-20, lr 1e-3),
    losses within 1e-5, and the params moved. FedOpt's server state and
    FedNova's operands (unequal τ: 2 to 10 steps a round) come along."""
    api, japi, start = _pair(algo, model)
    la = [api.train_one_round(r)["train_loss"] for r in range(3)]
    lb = [japi.train_one_round(r)["train_loss"] for r in range(3)]
    jparams = jax.tree.map(np.asarray, japi.net.params)
    moved = max(np.abs(a - b).max() for a, b in zip(
        jax.tree.leaves(jparams), jax.tree.leaves(start)))
    assert moved > (1e-2 if model == "lr" else 1e-4)
    tol = 1e-5 if model == "lr" else 1e-4
    for a, b in zip(jax.tree.leaves(to_jax_params(api.net.params)),
                    jax.tree.leaves(jparams)):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol)
    np.testing.assert_allclose(la, lb, rtol=1e-5, atol=1e-5)
    if algo == "fedopt":
        assert int(api.server_opt_state["0"]["count"]) == 3
        for k in ("mu", "nu"):
            for a, b in zip(jax.tree.leaves(to_jax_params(
                    api.server_opt_state["0"][k])),
                    jax.tree.leaves(getattr(japi.server_opt_state[0], k))):
                np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                           atol=tol)
    if algo == "fednova":
        idx, wmask = japi.sample_round(0)
        q, gamma = api._round_aux(0, api.sample_round(0))
        jq, jgamma = japi._round_aux(0, idx, wmask)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(gamma) == float(jgamma) and float(gamma) != 1.0


# --- reductions to FedAvg ----------------------------------------------------------

def _lr_fed(counts=(5, 9, 13, 3, 17, 8), batch=4):
    x, y = make_classification(sum(counts), n_features=10, n_classes=4,
                               seed=1)
    edges = np.concatenate([[0], np.cumsum(counts)])
    parts = {i: np.arange(edges[i], edges[i + 1])
             for i in range(len(counts))}
    return build_federated_arrays(x, y, parts, batch, device="cpu")


def _lr_api(cls, fed, per_round=4, **kw):
    cfg = FedConfig(client_num_in_total=fed.num_clients,
                    client_num_per_round=per_round, epochs=2,
                    batch_size=fed.batch_size, lr=0.1, **kw)
    model = create_model("lr", in_features=10, num_classes=4, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    return cls(model, fed, None, cfg, device="cpu")


def _assert_nets_equal(a, b):
    assert a.params.keys() == b.params.keys()
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k


@pytest.mark.parametrize("cls,kw,counts,exact", [
    (FedProxAPI, dict(fedprox_mu=0.0), (5, 9, 13, 3, 17, 8), True),
    (FedOptAPI, dict(server_optimizer="sgd", server_lr=1.0,
                     server_momentum=0.0), (5, 9, 13, 3, 17, 8), False),
    (FedNovaAPI, {}, (8,) * 6, False),
])
def test_reductions_to_fedavg(cls, kw, counts, exact):
    """FedProx at μ 0 (no extra gradient at all) gives FedAvg's rounds bit
    for bit over 3 rounds. FedOpt with server SGD at lr 1 without
    momentum and FedNova with equal τ (γ = 1) compute the new model as
    ``w − (w − avg)``, which rounds ``w − avg`` and so differs from
    ``avg`` in the last bits: their params within 1e-6 of FedAvg's (the
    JAX package holds them to 1e-5), losses within rtol 1e-6."""
    fed = _lr_fed(counts)
    a, b = _lr_api(FedAvgAPI, fed), _lr_api(cls, fed, **kw)
    la = [a.train_one_round(r)["train_loss"] for r in range(3)]
    lb = [b.train_one_round(r)["train_loss"] for r in range(3)]
    if exact:
        assert la == lb
        _assert_nets_equal(a.net, b.net)
        return
    np.testing.assert_allclose(la, lb, rtol=1e-6)
    for k in a.net.params:
        torch.testing.assert_close(a.net.params[k], b.net.params[k], rtol=0,
                                   atol=1e-6)
    if cls is FedNovaAPI:
        q, gamma = b._round_aux(0, b.sample_round(0))
        assert float(gamma) == 1.0


def test_full_participation_full_batch_equals_centralized():
    """The reference's CI property (``tests/test_equivalence.py``): FedAvg
    with every client, one full local batch and SGD equals centralized
    full-batch gradient descent, params within 1e-4 over 5 rounds; and
    the port's CentralizedTrainer equals JAX's from the same start."""
    n, n_clients = 512, 8
    x, y = make_classification(n, n_features=10, n_classes=4, seed=3)
    parts = partition_homo(n, n_clients, seed=3)
    fed = build_federated_arrays(x, y, parts, n // n_clients, device="cpu")
    assert fed.steps_per_epoch == 1
    cfg = FedConfig(client_num_in_total=n_clients,
                    client_num_per_round=n_clients, comm_round=5, epochs=1,
                    batch_size=n // n_clients, lr=0.5,
                    frequency_of_the_test=100, seed=3)

    def lr():
        return create_model("lr", in_features=10, num_classes=4,
                            device="cpu",
                            generator=torch.Generator().manual_seed(3))

    fed_api = FedAvgAPI(lr(), fed, None, cfg, device="cpu")
    central = CentralizedTrainer(lr(), cfg, device="cpu")
    xc, yc, maskc = batch_global(x, y, n, device="cpu")
    fed_api.train()
    for _ in range(cfg.comm_round):
        central.train(xc, yc, maskc)
    for k in fed_api.net.params:
        torch.testing.assert_close(fed_api.net.params[k],
                                   central.net.params[k], rtol=0, atol=1e-4)
    jc = JaxCentralizedTrainer(JaxLogisticRegression(num_classes=4),
                               JaxFedConfig(**dataclasses.asdict(cfg)))
    jc.init_params(x[:1])
    tc = CentralizedTrainer(lr(), cfg, device="cpu")
    tc.init_params()
    tc.net = NetState(from_jax_params(jax.tree.map(np.asarray,
                                                   jc.net.params))[0], {})
    jxc, jyc, jmask = jax_batching.batch_global(x, y, n)
    for _ in range(3):
        loss, jloss = tc.train(xc, yc, maskc), jc.train(jxc, jyc, jmask)
        assert loss == pytest.approx(jloss, rel=1e-5, abs=1e-6)
    for a, b in zip(jax.tree.leaves(to_jax_params(tc.net.params)),
                    jax.tree.leaves(jc.net.params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)
    ev, jev = tc.evaluate(xc, yc, maskc), jc.evaluate(jxc, jyc, jmask)
    assert ev["accuracy"] == pytest.approx(jev["accuracy"])
    with pytest.raises(NotImplementedError, match="A11"):
        CentralizedTrainer(lr(), cfg, mesh=object(), device="cpu")


# --- the round tiers -------------------------------------------------------------

def _eager(api, rounds):
    losses = []
    for r in rounds:
        avg, loss = api.run_round(r)
        api.net = api._server_update(api.net, avg)
        losses.append(float(loss))
    return losses


_TIER_CASES = {
    "fedopt-adam": (FedOptAPI, dict(server_optimizer="adam", server_lr=0.05)),
    "fedopt-yogi": (FedOptAPI, dict(server_optimizer="yogi", server_lr=0.05)),
    "fedopt-sgdm": (FedOptAPI, dict(server_optimizer="sgd", server_lr=0.5)),
    "fedprox": (FedProxAPI, dict(fedprox_mu=0.1)),
    "fednova": (FedNovaAPI, {}),
    "robust": (FedAvgRobustAPI, dict(aggregator="coord_median",
                                     corrupt_mode="scale", attack_freq=1)),
}


@pytest.mark.parametrize("case", list(_TIER_CASES))
def test_tiers_equal_the_eager_rounds(case):
    """``train_one_round``, ``train_rounds_pipelined`` and, where the
    record allows it, ``train_rounds_on_device`` are bit-equal to the
    eager ``run_round`` + ``_server_update``, params, losses and carry
    (the on-device rounds at full participation, where the cohorts are
    the host loop's); where the record refuses the on-device tier, it
    raises the record's reason."""
    cls, kw = _TIER_CASES[case]
    fed = _lr_fed()
    host = _lr_api(cls, fed, **kw)
    want = _eager(host, range(3))
    fused = _lr_api(cls, fed, **kw)
    assert [fused.train_one_round(r)["train_loss"] for r in range(3)] == want
    pipe = _lr_api(cls, fed, **kw)
    assert pipe.train_rounds_pipelined(3) == want
    for api in (fused, pipe):
        _assert_nets_equal(api.net, host.net)
        if cls is FedOptAPI:
            for a, b in zip(jax.tree.leaves(api.server_opt_state),
                            jax.tree.leaves(host.server_opt_state)):
                assert torch.equal(a, b)
    dev = _lr_api(cls, fed, per_round=fed.num_clients, **kw)
    if dev.capability().on_device:
        host = _lr_api(cls, fed, per_round=fed.num_clients, **kw)
        want = _eager(host, range(3))
        assert dev.train_rounds_on_device(3).tolist() == want
        _assert_nets_equal(dev.net, host.net)
        if cls is FedOptAPI and "count" in dev.server_opt_state["0"]:
            assert int(dev.server_opt_state["0"]["count"]) == 3
    else:
        with pytest.raises(NotImplementedError,
                           match=f"{cls.__name__} feeds its round per-round "
                           "host-computed aux operands"):
            dev.train_rounds_on_device(3)
    assert (case in ("fednova", "robust")) != dev.capability().on_device


def test_fednova_operands_change_per_round_and_reach_the_step():
    """With unequal τ, ``(q, γ)`` differ between rounds, and the fused
    round with one round's operands swapped for another's differs from
    the eager round (so the step reads them, not a constant)."""
    api = _lr_api(FedNovaAPI, _lr_fed())
    ops = [api._round_aux(r, api.sample_round(r)) for r in range(3)]
    assert len({float(g) for _, g in ops}) > 1
    for q, g in ops:
        assert q.dtype == g.dtype == torch.float32 and g.dim() == 0
    a, b = _lr_api(FedNovaAPI, _lr_fed()), _lr_api(FedNovaAPI, _lr_fed())
    a.train_one_round(0)
    b._round_aux = lambda r, idx: ops[1]
    b.train_one_round(0)
    assert any(not torch.equal(a.net.params[k], b.net.params[k])
               for k in a.net.params)


# --- refusals ----------------------------------------------------------------------

@pytest.mark.parametrize("field,val,label", [
    ("remat", True, "A3"), ("dp_clip", 1.0, "A3"),
    ("dp_noise_multiplier", 1.0, "A3"),
    ("wire_codec", "int8", "A10"), ("ingest_workers", 2, "A10"),
    ("group_reduce", True, "A11"),
])
def test_unported_fields_cite_their_queue(field, val, label):
    with pytest.raises(NotImplementedError,
                       match=rf"cfg\.{field}=.*ROADMAP\.md {label}\)"):
        _lr_api(FedAvgAPI, _lr_fed(), **{field: val})


def test_aggregator_is_refused_where_the_round_is_custom():
    """FedNova builds its own round around the shared builder's, so a
    robust aggregator there would be silently bypassed: refused, as in
    JAX; on FedOpt and FedProx it rides the shared builder."""
    with pytest.raises(NotImplementedError, match="FedNovaAPI customizes"):
        _lr_api(FedNovaAPI, _lr_fed(), aggregator="krum1")
    for cls in (FedOptAPI, FedProxAPI):
        api = _lr_api(cls, _lr_fed(), aggregator="trimmed_mean0.2")
        api.train_one_round(0)
    with pytest.raises(ValueError, match="unknown aggregator"):
        _lr_api(FedAvgAPI, _lr_fed(), aggregator="median")
