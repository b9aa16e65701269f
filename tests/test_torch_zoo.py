"""The rest of the FedAvg-round family in the port — ``FedAcAPI``,
``ServerAvgAPI``, ``QFedAvgAPI``, ``HierarchicalFedAvgAPI``,
``TurboAggregateAPI`` and ``DecentralizedAPI`` — and the modules under
them (``core/topology.py``, ``core/mpc.py``, ``obs``'s ``corr`` and
``payload_nbytes``) against the JAX package on the same seeded numpy
inputs and weights; their reductions to FedAvg, their tiers against the
host loop, and their capability records and refusals against the JAX
package's support matrix (``docs/EXECUTION.md``).

Rounds compare across the packages on data where each client holds copies
of one sample (``tests/test_torch_algos.py``'s task): the port's shuffle
draws from ``core/keys.py``, not threefry, and with identical samples
every permutation gives the same batches."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algos import capability as jax_capability
from fedml_tpu.algos.config import FedConfig as JaxFedConfig
from fedml_tpu.algos.decentralized import DecentralizedAPI as JaxDecentralized
from fedml_tpu.algos.fedac import FedAcAPI as JaxFedAcAPI
from fedml_tpu.algos.fedac import ServerAvgAPI as JaxServerAvgAPI
from fedml_tpu.algos.hierarchical import \
    HierarchicalFedAvgAPI as JaxHierarchicalAPI
from fedml_tpu.algos.qfedavg import QFedAvgAPI as JaxQFedAvgAPI
from fedml_tpu.algos.qfedavg import _make_loss_at_global as jax_loss_at_global
from fedml_tpu.algos.qfedavg import _qffl_update as jax_qffl_update
from fedml_tpu.algos.turboaggregate import \
    TurboAggregateAPI as JaxTurboAggregateAPI
from fedml_tpu.core import mpc as jax_mpc
from fedml_tpu.core import topology as jax_topology
from fedml_tpu.data import batching as jax_batching
from fedml_tpu.models.lr import LogisticRegression as JaxLogisticRegression
from fedml_tpu.models.registry import create_model as jax_create_model
from fedml_tpu.obs import trace as jax_trace
from fedml_tpu.trainer.local import NetState as JaxNetState
from fedml_tpu.trainer.local import model_fns as jax_model_fns
from fedml_tpu.trainer.local import softmax_ce as jax_softmax_ce
from fedml_tpu_torch.algos import (DecentralizedAPI, FedAcAPI, FedAvgAPI,
                                   FedConfig, HierarchicalFedAvgAPI,
                                   QFedAvgAPI, ServerAvgAPI,
                                   TurboAggregateAPI)
from fedml_tpu_torch.algos.capability import record_for, refusal
from fedml_tpu_torch.algos.qfedavg import make_loss_at_global, qffl_update
from fedml_tpu_torch.convert import from_jax_params, to_jax_params
from fedml_tpu_torch.core import mpc, topology
from fedml_tpu_torch.data import (build_federated_arrays,
                                  make_classification, partition_homo)
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.obs import registry, trace
from fedml_tpu_torch.trainer.local import NetState, model_fns, softmax_ce

WIDTHS = (4, 8, 16)
P = mpc.DEFAULT_PRIME


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _lr_model():
    return create_model("lr", in_features=10, num_classes=4, device="cpu",
                        generator=torch.Generator().manual_seed(0))


def _jax_params(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tree):
    """A flax param tree as the port's ``{name: tensor}``."""
    return from_jax_params(_jax_params(tree))[0]


def _stack_to_port(jtree):
    """A JAX ``[n, ...]`` stacked flax tree as the port's ``{name: [n,
    ...]}``."""
    leaves = jax.tree.leaves(jtree)
    n = leaves[0].shape[0]
    rows = [_port(jax.tree.map(lambda a, i=i: np.asarray(a)[i], jtree))
            for i in range(n)]
    return {k: torch.stack([r[k] for r in rows]) for k in rows[0]}


def _close(params, jtree, atol, rtol=0.0):
    got = jax.tree.leaves(to_jax_params(params))
    want = jax.tree.leaves(_jax_params(jtree))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def _assert_nets_equal(a, b):
    assert a.params.keys() == b.params.keys()
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k


def _cfg(**kw):
    base = dict(client_num_in_total=6, client_num_per_round=4, comm_round=3,
                epochs=2, batch_size=4, lr=0.1, frequency_of_the_test=100)
    base.update(kw)
    return base


def _lr_pair(cls, jcls, cfg=None, counts=(5, 9, 13, 3, 17, 8), **kw):
    """The port's and JAX's class on the same replicated LR task, config
    and start weights (JAX's, carried across)."""
    x, y, parts = _replicated_task(counts=counts)
    cfg = cfg or _cfg(client_num_in_total=len(counts))
    japi = jcls(JaxLogisticRegression(num_classes=4),
                jax_batching.build_federated_arrays(x, y, parts, 4), None,
                JaxFedConfig(**cfg), **kw)
    api = cls(_lr_model(), build_federated_arrays(x, y, parts, 4,
                                                  device="cpu"),
              None, FedConfig(**cfg), device="cpu", **kw)
    api.net = NetState(_port(japi.net.params), {})
    return api, japi


# --- core/topology.py and core/mpc.py ---------------------------------------------

@pytest.mark.parametrize("kind,n,k,seed", [
    ("Symmetric", 8, 2, 0), ("Symmetric", 32, 4, 0), ("Symmetric", 2, 2, 0),
    ("Symmetric", 9, 5, 3), ("Asymmetric", 6, 2, 1),
    ("Asymmetric", 32, 2, 0)])
def test_topology_managers_match_jax_bit_for_bit(kind, n, k, seed):
    """The mixing matrix (the seeded ``RandomState`` draws are JAX's), its
    column-stochastic form and the neighbor lists and weights are
    bit-equal to the JAX package's."""
    tm = getattr(topology, f"{kind}TopologyManager")(n, neighbor_num=k,
                                                     seed=seed)
    jtm = getattr(jax_topology, f"{kind}TopologyManager")(
        n, neighbor_num=k, seed=seed)
    W, jW = tm.mixing_matrix(), jtm.mixing_matrix()
    np.testing.assert_array_equal(W, jW)
    np.testing.assert_array_equal(topology.column_stochastic(W),
                                  jax_topology.column_stochastic(jW))
    np.testing.assert_allclose(W.sum(1), np.ones(n), rtol=1e-12)
    for i in range(n):
        assert tm.get_in_neighbor_idx_list(i) == jtm.get_in_neighbor_idx_list(i)
        assert (tm.get_out_neighbor_idx_list(i)
                == jtm.get_out_neighbor_idx_list(i))
        assert tm.get_in_neighbor_weights(i) == jtm.get_in_neighbor_weights(i)
        assert (tm.get_out_neighbor_weights(i)
                == jtm.get_out_neighbor_weights(i))


def _mpc_case(name):
    """``(port result, JAX result)`` of one ``core/mpc.py`` function on the
    same integers."""
    rng = np.random.RandomState(7)
    X = rng.randint(0, P, size=(3, 5)).astype(np.int64)

    def both(fn, *args, **kw):
        return (getattr(mpc, fn)(*args, **kw),
                getattr(jax_mpc, fn)(*args, **kw))

    if name == "modular_inv":
        return both("modular_inv", np.array([3, 12345, P - 2]))
    if name == "field_div":
        return both("field_div", np.array([7, 99, 2 ** 30]),
                    np.array([3, 5, 11]))
    if name == "lagrange_coeffs":
        return both("lagrange_coeffs", np.array([1, 2, 3, 4]),
                    np.array([5, 6, 7]))
    if name == "bgw":
        a = mpc.bgw_encode(X, 5, 2, rng=np.random.RandomState(1))
        b = jax_mpc.bgw_encode(X, 5, 2, rng=np.random.RandomState(1))
        np.testing.assert_array_equal(a, b)
        return both("bgw_decode", a[[0, 2, 4]], [0, 2, 4])
    if name == "lcc":
        a = mpc.lcc_encode(X, 6, 3, 1, rng=np.random.RandomState(2))
        b = jax_mpc.lcc_encode(X, 6, 3, 1, rng=np.random.RandomState(2))
        np.testing.assert_array_equal(a, b)
        return both("lcc_decode", a[[1, 2, 4, 5]], [1, 2, 4, 5], 6, 3, 1)
    if name == "lcc_with_points":
        alpha, beta = np.array([1, 2, 3, 4]), np.array([10, 11, 12])
        a = mpc.lcc_encode_with_points(X, alpha, beta)
        b = jax_mpc.lcc_encode_with_points(X, alpha, beta)
        np.testing.assert_array_equal(a, b)
        got = both("lcc_decode_with_points", a[1:], alpha[1:], beta)
        np.testing.assert_array_equal(got[0], X)
        return got
    if name == "additive_shares":
        return (mpc.additive_shares(X, 4, P, np.random.RandomState(3)),
                jax_mpc.additive_shares(X, 4, P, np.random.RandomState(3)))
    if name == "key_agreement":
        pk_a, jpk_a = both("pk_gen", 123457)
        assert pk_a == jpk_a
        return both("key_agreement", 98765, pk_a)
    if name == "quantize":
        v = rng.randn(64) * 3.0
        q, jq = both("quantize", v)
        np.testing.assert_array_equal(q, jq)
        return both("dequantize", q)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["modular_inv", "field_div",
                                  "lagrange_coeffs", "bgw", "lcc",
                                  "lcc_with_points", "additive_shares",
                                  "key_agreement", "quantize"])
def test_mpc_functions_match_jax_bit_for_bit(name):
    """Every function of ``core/mpc.py`` against JAX's on the same
    integers (and the same seeded share streams): bit-equal results."""
    got, want = _mpc_case(name)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_additive_shares_sum_to_the_secret_and_stay_in_the_field():
    """Shares of values at the field's edge sum to the secret mod p, each
    share in [0, p): a sum of two reduced values fits int64."""
    x = np.array([0, 1, P - 1, P // 2, 123456789], np.int64)
    shares = mpc.additive_shares(x, 5, P, np.random.RandomState(0))
    assert shares.min() >= 0 and shares.max() < P
    np.testing.assert_array_equal(np.mod(shares.sum(0), P), x)
    v = np.array([-3.25, 0.0, 1e-5, 7.5])
    np.testing.assert_allclose(mpc.dequantize(mpc.quantize(v)), v,
                               atol=0.5 / 2 ** 16)


def test_obs_corr_and_payload_nbytes_match_jax():
    """``corr`` and ``payload_nbytes`` (the hierarchical spans' fields)
    against JAX's on the same payload."""
    for kw in ({}, {"round": 3}, {"epoch": 1, "round": 2, "sender": 5,
                                  "task_seq": 9}):
        assert trace.corr(**kw) == jax_trace.corr(**kw)
    rng = np.random.RandomState(0)
    tree = {"a": rng.randn(3, 4).astype(np.float32),
            "b": {"c": rng.randn(5).astype(np.float32)}}
    net = NetState({k: torch.from_numpy(v) for k, v in
                    (("a", tree["a"]), ("c", tree["b"]["c"]))}, {})
    # fedml_tpu.obs exports a registry() function under the module's name.
    jax_registry = importlib.import_module("fedml_tpu.obs.registry")
    want = jax_registry.payload_nbytes(
        JaxNetState(jax.tree.map(jnp.asarray, tree), {}))
    assert registry.payload_nbytes(net) == want == 4 * 17
    assert registry.payload_nbytes(
        {"h": torch.zeros(4, dtype=torch.bfloat16)}) == 8


# --- FedAc and ServerAvg -------------------------------------------------------------

def _carry_case(cls, kw, seed=0):
    """The port's and JAX's pure server updates of ``cls`` and the same
    ``(net, avg, extra)`` operands from numpy seeds."""
    api, japi = _lr_pair(cls, {FedAcAPI: JaxFedAcAPI,
                               ServerAvgAPI: JaxServerAvgAPI}[cls], **kw)
    rng = np.random.RandomState(seed)
    jp = _jax_params(japi.net.params)

    def draw():
        return jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32),
                            jp)

    net, avg = draw(), draw()
    if cls is FedAcAPI:
        jextra = (draw(), draw())
        extra = tuple(_port(e) for e in jextra)
    else:
        jextra = (draw(), np.float32(3.0), np.int32(kw.get("avg_start", 0)))
        extra = (_port(jextra[0]), torch.tensor(3.0),
                 torch.tensor(int(jextra[2]), dtype=torch.int32))
    got = api._window_server_update()(NetState(_port(net), {}),
                                      NetState(_port(avg), {}), extra, None)
    want = japi._window_server_update()(
        JaxNetState(jax.tree.map(jnp.asarray, net), {}),
        JaxNetState(jax.tree.map(jnp.asarray, avg), {}),
        jax.tree.map(jnp.asarray, jextra), None)
    return got, want


@pytest.mark.parametrize("cls,kw", [
    (FedAcAPI, dict(gamma=2.0)), (FedAcAPI, dict(gamma=3.0, alpha=2.5)),
    (ServerAvgAPI, dict(avg_coef=0.5)),
    (ServerAvgAPI, dict(avg_coef=0.3, avg_start=2))])
def test_pure_server_updates_match_jax(cls, kw):
    """FedAc's and ServerAvg's pure updates from the same ``(net, avg,
    extra)``: the new net and every carried value within 1e-6 of JAX's
    (ServerAvg's counters exactly, int32 and f32 as in JAX)."""
    (net, extra), (jnet, jextra) = _carry_case(cls, kw)
    _close(net.params, jnet.params, 1e-6, 1e-6)
    if cls is FedAcAPI:
        for e, je in zip(extra, jextra):
            _close(e, je, 1e-6, 1e-6)
    else:
        _close(extra[0], jextra[0], 1e-6, 1e-6)
        assert float(extra[1]) == float(jextra[1])
        assert extra[2].dtype == torch.int32
        assert int(extra[2]) == int(jextra[2])


@pytest.mark.parametrize("cls,jcls,kw", [
    (FedAcAPI, JaxFedAcAPI, dict(gamma=2.0)),
    (ServerAvgAPI, JaxServerAvgAPI, dict(avg_coef=0.5)),
    (QFedAvgAPI, JaxQFedAvgAPI, dict(q=1.0)),
    (QFedAvgAPI, JaxQFedAvgAPI, dict(q=0.0))])
def test_round_protocol_rounds_match_jax(cls, jcls, kw):
    """3 rounds of ``train_one_round`` (the fused step) in both packages
    from one start on LR: params and the carry within 1e-5, losses
    within 1e-5, the params moved."""
    api, japi = _lr_pair(cls, jcls, **kw)
    if cls is FedAcAPI:
        state = _port(japi.net.params)
        api._window_carry_commit((state, {k: v.clone() for k, v in
                                          state.items()}))
    start = _jax_params(japi.net.params)
    la = [api.train_one_round(r)["train_loss"] for r in range(3)]
    lb = [japi.train_one_round(r)["train_loss"] for r in range(3)]
    np.testing.assert_allclose(la, lb, rtol=1e-5, atol=1e-5)
    _close(api.net.params, japi.net.params, 1e-5)
    if cls is FedAcAPI:
        for e, je in zip(api._fedac_state, japi._fedac_state):
            _close(e, je, 1e-5)
    if cls is ServerAvgAPI:
        _close(api._savg_state[0], japi._savg_state[0], 1e-5)
        assert int(api._savg_state[2]) == int(japi._savg_state[2]) == 3
    moved = max(np.abs(a - b).max() for a, b in zip(
        jax.tree.leaves(_jax_params(japi.net.params)),
        jax.tree.leaves(start)))
    assert moved > 1e-2


def _lr_api(cls, per_round=4, counts=(5, 9, 13, 3, 17, 8), seed=1, **kw):
    x, y = make_classification(sum(counts), n_features=10, n_classes=4,
                               seed=seed)
    edges = np.concatenate([[0], np.cumsum(counts)])
    parts = {i: np.arange(edges[i], edges[i + 1])
             for i in range(len(counts))}
    fed = build_federated_arrays(x, y, parts, 4, device="cpu")
    cfg = FedConfig(**_cfg(client_num_in_total=len(counts),
                           client_num_per_round=per_round,
                           **{k: kw.pop(k) for k in list(kw)
                              if k in FedConfig.__dataclass_fields__}))
    return cls(_lr_model(), fed, None, cfg, device="cpu", **kw)


def test_fedac_at_gamma_1_is_fedavg():
    """At γ 1 (α = β = 1) FedAc's broadcast is ``md − (md − avg)``:
    within 1e-6 of FedAvg's round from the same start, key and cohort
    (not bit-equal: the subtraction rounds), over 3 rounds."""
    fa, ac = _lr_api(FedAvgAPI), _lr_api(FedAcAPI, gamma=1.0)
    assert ac.alpha == ac.beta == 1.0
    for r in range(3):
        assert fa.train_one_round(r) == pytest.approx(ac.train_one_round(r),
                                                      abs=1e-6)
        for k in fa.net.params:
            torch.testing.assert_close(ac.net.params[k], fa.net.params[k],
                                       rtol=1e-6, atol=1e-6)


def test_serveravg_at_beta_0_is_fedavg_bit_for_bit():
    """β 0 broadcasts ``1·avg + 0·mean``: FedAvg's rounds bit for bit,
    while the running mean accumulates beside them."""
    fa, sa = _lr_api(FedAvgAPI), _lr_api(ServerAvgAPI, avg_coef=0.0)
    for r in range(3):
        assert fa.train_one_round(r) == sa.train_one_round(r)
    _assert_nets_equal(fa.net, sa.net)
    assert float(sa._savg_state[1]) == 3.0
    assert any(v.abs().max() > 0 for v in sa._savg_state[0].values())


def _eager(api, rounds):
    losses = []
    for r in rounds:
        avg, loss = api.run_round(r)
        api.net = api._server_update(api.net, avg)
        losses.append(float(loss))
    return losses


def _carry_leaves(api):
    extra = api._window_carry_init()
    if extra is None:
        return []
    out = []
    for part in extra:
        out.extend(part.values() if isinstance(part, dict) else [part])
    return out


@pytest.mark.parametrize("cls,kw", [
    (FedAcAPI, dict(gamma=2.0)), (ServerAvgAPI, dict(avg_coef=0.5)),
    (QFedAvgAPI, dict(q=1.0))])
def test_tiers_equal_the_host_loop(cls, kw):
    """``train_one_round``, ``train_rounds_pipelined`` and, at full
    participation, ``train_rounds_on_device`` are bit-equal to the eager
    ``run_round`` + ``_server_update``: params, losses and the carry."""
    host = _lr_api(cls, **kw)
    want = _eager(host, range(3))
    fused = _lr_api(cls, **kw)
    assert [fused.train_one_round(r)["train_loss"] for r in range(3)] == want
    pipe = _lr_api(cls, **kw)
    assert pipe.train_rounds_pipelined(3) == want
    for api in (fused, pipe):
        _assert_nets_equal(api.net, host.net)
        for a, b in zip(_carry_leaves(api), _carry_leaves(host)):
            assert torch.equal(a, b)
    host = _lr_api(cls, per_round=6, **kw)
    want = _eager(host, range(3))
    dev = _lr_api(cls, per_round=6, **kw)
    assert dev.train_rounds_on_device(3).tolist() == want
    _assert_nets_equal(dev.net, host.net)
    for a, b in zip(_carry_leaves(dev), _carry_leaves(host)):
        assert torch.equal(a, b)


def test_fedac_carry_buffers_are_distinct():
    """FedAc's ``(x, x_ag)`` start as two clones of the init, distinct
    from ``net.params`` (a captured step copies its carry in place), and
    ServerAvg's counters are 0-d tensors (f32, int32), never Python
    numbers, which a captured step would bake in."""
    ac = _lr_api(FedAcAPI)
    x, x_ag = ac._fedac_state
    for k, p in ac.net.params.items():
        ptrs = {p.data_ptr(), x[k].data_ptr(), x_ag[k].data_ptr()}
        assert len(ptrs) == 3 and torch.equal(x[k], p)
    _, count, t = _lr_api(ServerAvgAPI)._savg_state
    assert (count.dim(), count.dtype, t.dim(), t.dtype) == (
        0, torch.float32, 0, torch.int32)


def _jax_error(fn):
    try:
        fn()
    except (ValueError, NotImplementedError) as exc:
        return type(exc), str(exc)
    raise AssertionError("the JAX class did not refuse")


@pytest.mark.parametrize("cls,jcls,kw", [
    (FedAcAPI, JaxFedAcAPI, dict(gamma=0.5)),
    (FedAcAPI, JaxFedAcAPI, dict(gamma=2.0, alpha=0.5)),
    (FedAcAPI, JaxFedAcAPI, dict(gamma=2.0, beta=0.9)),
    (ServerAvgAPI, JaxServerAvgAPI, dict(avg_coef=1.0)),
    (ServerAvgAPI, JaxServerAvgAPI, dict(avg_coef=-0.1))])
def test_invalid_settings_refused_with_jax_words(cls, jcls, kw):
    x, y, parts = _replicated_task()
    etype, msg = _jax_error(lambda: jcls(
        JaxLogisticRegression(num_classes=4),
        jax_batching.build_federated_arrays(x, y, parts, 4), None,
        JaxFedConfig(**_cfg()), **kw))
    with pytest.raises(etype) as exc:
        cls(_lr_model(), build_federated_arrays(x, y, parts, 4,
                                                device="cpu"),
            None, FedConfig(**_cfg()), device="cpu", **kw)
    assert str(exc.value) == msg


# --- q-FedAvg -----------------------------------------------------------------------

def _resnet_pair():
    jm = jax_create_model("resnet20", widths=WIDTHS, num_classes=4)
    tm = create_model("resnet20", widths=WIDTHS, num_classes=4,
                      device="cpu")
    jparams = jm.init(jax.random.PRNGKey(0),
                      jnp.zeros((1, 16, 16, 3)))["params"]
    return jm, tm, jparams


def test_loss_at_global_matches_jax_on_resnet20():
    """F_global, each client's masked mean loss of the broadcast net on
    its whole shard (forward only, the cohort vmapped), against JAX's
    ``vmap(loss_at_global)`` on ResNet-20 at 16×16 with JAX's weights:
    within 1e-5; a client with no samples gets 0."""
    jm, tm, jparams = _resnet_pair()
    rng = np.random.RandomState(4)
    x = rng.randn(3, 2, 4, 16, 16, 3).astype(np.float32)
    y = rng.randint(0, 4, (3, 2, 4)).astype(np.int64)
    mask = (rng.rand(3, 2, 4) > 0.3).astype(np.float32)
    mask[2] = 0.0
    jfn = jax_loss_at_global(jax_model_fns(jm).apply, jax_softmax_ce)
    want = jax.vmap(jfn, in_axes=(None, 0, 0, 0))(
        JaxNetState(jax.tree.map(jnp.asarray, jparams), {}),
        jnp.asarray(x), jnp.asarray(y.astype(np.int32)), jnp.asarray(mask))
    fn = make_loss_at_global(model_fns(tm).apply, softmax_ce)
    got = fn(NetState(_port(jparams), {}), torch.from_numpy(x),
             torch.from_numpy(y), torch.from_numpy(mask))
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert float(got[2]) == 0.0


@pytest.mark.parametrize("q,active", [(1.0, (1, 1, 1, 1)),
                                      (2.5, (1, 0, 1, 1)),
                                      (0.0, (1, 1, 1, 1)),
                                      (1.0, (0, 0, 0, 0))])
def test_qffl_update_matches_jax(q, active):
    """The fair update from the same global net, client nets, F_global
    (one below the 1e-12 clamp), losses and weights: params and the loss
    within 1e-5 of JAX's; an all-inactive round keeps the params."""
    rng = np.random.RandomState(5)
    jp = _jax_params(JaxLogisticRegression(num_classes=4).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 10)))["params"])
    clients = jax.tree.map(
        lambda a: (a[None] + 0.1 * rng.randn(4, *a.shape)).astype(
            np.float32), jp)
    F = np.array([0.7, 1e-14, 2.0, 1.3], np.float32)
    losses = rng.rand(4).astype(np.float32)
    weights = np.array([5.0, 9.0, 13.0, 3.0], np.float32)
    act = np.asarray(active, np.float32)
    L = 1.0 / 0.1
    jnet, jloss = jax_qffl_update(
        JaxNetState(jax.tree.map(jnp.asarray, jp), {}),
        JaxNetState(jax.tree.map(jnp.asarray, clients), {}),
        jnp.asarray(F), jnp.asarray(losses), jnp.asarray(weights),
        jnp.asarray(weights), jnp.asarray(act), q, L, lambda v: v)
    net, loss = qffl_update(
        NetState(_port(jp), {}), NetState(_stack_to_port(clients), {}),
        torch.from_numpy(F), torch.from_numpy(losses),
        torch.from_numpy(weights), torch.from_numpy(weights),
        torch.from_numpy(act), q, L)
    _close(net.params, jnet.params, 1e-5, 1e-5)
    assert float(loss) == pytest.approx(float(jloss), abs=1e-5)
    if not any(active):
        for k, v in _port(jp).items():
            assert torch.equal(net.params[k], v)


def test_q0_is_the_equal_weight_fedavg_mean():
    """q 0 (h_k = L) makes the update the unweighted client mean: with
    equal client counts, FedAvg's sample-weighted mean, within 1e-6 over 3
    rounds."""
    counts = (8, 8, 8, 8, 8, 8)
    qa = _lr_api(QFedAvgAPI, counts=counts, q=0.0)
    fa = _lr_api(FedAvgAPI, counts=counts)
    for r in range(3):
        qa.train_one_round(r)
        fa.train_one_round(r)
    for k in fa.net.params:
        torch.testing.assert_close(qa.net.params[k], fa.net.params[k],
                                   rtol=0, atol=1e-6)


def test_set_client_lr_rebuilds_the_fair_update():
    """``L = 1/lr`` is baked into the round: after ``set_client_lr(0.05)``
    a round equals one of an api built at lr 0.05 bit for bit, and
    differs from the old lr's."""
    a = _lr_api(QFedAvgAPI, q=1.0)
    b = _lr_api(QFedAvgAPI, q=1.0, lr=0.05)
    c = _lr_api(QFedAvgAPI, q=1.0)
    a.set_client_lr(0.05)
    assert a.train_one_round(0) == b.train_one_round(0)
    _assert_nets_equal(a.net, b.net)
    c.train_one_round(0)
    assert not torch.equal(a.net.params["linear.weight"],
                           c.net.params["linear.weight"])


# --- hierarchical FL ------------------------------------------------------------------

def test_hierarchical_one_group_equals_fedavg():
    """One group of every client with ``group_comm_round`` 1 is FedAvg's
    round (JAX's pin, ``tests/test_algos2.py``, within 1e-5; bit-equal
    here: the group's reduction over one partial is the identity)."""
    fa = _lr_api(FedAvgAPI)
    hi = _lr_api(HierarchicalFedAvgAPI, group_ids=np.zeros(6, int))
    for r in range(3):
        fa.train_one_round(r)
        hi.train_one_round(r)
    for k in fa.net.params:
        torch.testing.assert_close(hi.net.params[k], fa.net.params[k],
                                   rtol=0, atol=1e-5)
    _assert_nets_equal(hi.net, fa.net)


def test_hierarchical_group_invariance_fullbatch():
    """The reference CI's property at full participation, full batch and
    1 local epoch: 4 global × 1 group round with one group against 2
    global × 2 group rounds with two groups, within 5e-3 (JAX's pin:
    exact only to first order)."""
    n, n_clients = 512, 8
    x, y = make_classification(n, n_features=10, n_classes=4, seed=1)
    parts = partition_homo(n, n_clients, seed=1)
    fed = build_federated_arrays(x, y, parts, n // n_clients, device="cpu")
    base = dict(client_num_in_total=8, client_num_per_round=8, epochs=1,
                batch_size=n // n_clients, lr=0.5,
                frequency_of_the_test=100)
    a = HierarchicalFedAvgAPI(
        _lr_model(), fed, None,
        FedConfig(**base, comm_round=4, group_comm_round=1),
        group_ids=np.zeros(8, int), device="cpu")
    b = HierarchicalFedAvgAPI(
        _lr_model(), fed, None,
        FedConfig(**base, comm_round=2, group_comm_round=2),
        group_ids=np.array([0, 0, 0, 0, 1, 1, 1, 1]), device="cpu")
    a.train()
    b.train()
    for k in a.net.params:
        torch.testing.assert_close(a.net.params[k], b.net.params[k],
                                   rtol=0, atol=5e-3)
    assert set(b._graphs) == {"group4"} and set(a._graphs) == {"group8"}


@pytest.mark.parametrize("aggregator,gids", [
    ("mean", (0, 1, 0, 1, 2, 2)), ("coord_median", (0, 1, 0, 1, 2, 2)),
    ("trimmed_mean0.2", (0, 0, 1, 1, 1, 2))])
def test_hierarchical_rounds_match_jax(aggregator, gids):
    """3 rounds of hierarchical FL (``group_comm_round`` 2, groups of
    1–3 sampled clients padded to powers of two) in both packages from one
    start: params within 1e-5, losses within 1e-5; with a composable
    aggregator, within each group and across the group partials."""
    cfg = _cfg(group_comm_round=2, aggregator=aggregator)
    api, japi = _lr_pair(HierarchicalFedAvgAPI, JaxHierarchicalAPI, cfg=cfg,
                         group_ids=np.asarray(gids))
    la = [api.train_one_round(r)["train_loss"] for r in range(3)]
    lb = [japi.train_one_round(r)["train_loss"] for r in range(3)]
    np.testing.assert_allclose(la, lb, rtol=1e-5, atol=1e-5)
    _close(api.net.params, japi.net.params, 1e-5)
    assert all(k.startswith("group") for k in api._graphs)


def test_hierarchical_spans_and_empty_round():
    """With a tracer installed a round records one ``reduce.stage1`` span
    per sampled group and one ``reduce.stage2`` with the payload bytes;
    a round whose sampled clients are all empty keeps the model."""
    api = _lr_api(HierarchicalFedAvgAPI, counts=(5, 0, 13, 0, 17, 0),
                  group_ids=np.array([0, 1, 0, 1, 0, 1]))
    tr = trace.SpanTracer()
    with trace.using(tr):
        api.train_one_round(0)
    ev = tr.events()
    groups = len(np.unique(api.group_ids[api.sample_round(0)]))
    assert [e["name"] for e in ev].count("reduce.stage1") == groups
    (stage2,) = [e for e in ev if e["name"] == "reduce.stage2"]
    assert stage2["args"]["nbytes"] == groups * registry.payload_nbytes(
        api.net)
    assert stage2["args"]["round"] == 0
    empty = _lr_api(HierarchicalFedAvgAPI, counts=(0, 0, 0, 0, 0, 0),
                    group_ids=np.zeros(6, int))
    before = {k: v.clone() for k, v in empty.net.params.items()}
    assert empty.train_one_round(0) == {"round": 0, "train_loss": 0.0}
    for k, v in before.items():
        assert torch.equal(empty.net.params[k], v)


@pytest.mark.parametrize("field,val,match", [
    ("aggregator", "krum1", "krum1.*does not compose group-wise"),
    ("aggregator", "geometric_median8", "does not compose group-wise"),
    ("group_reduce", True, "group_reduce.*A11"),
    ("group_comm_round", 0, "group_comm_round must be >= 1")])
def test_hierarchical_refusals(field, val, match):
    """krum and the geometric median are refused with JAX's reason;
    ``group_reduce`` is refused (the port's A11); a bad
    ``group_comm_round`` or ``group_ids`` is refused; a store is taken,
    as JAX takes it (its group cohorts stream from the host, its round
    bit-equal to the resident one), and a ``train_fed`` that is neither
    layout is refused."""
    etype = ValueError if field == "group_comm_round" else \
        NotImplementedError
    with pytest.raises(etype, match=match):
        _lr_api(HierarchicalFedAvgAPI, group_ids=np.zeros(6, int),
                **{field: val})
    with pytest.raises(ValueError, match="one entry per client"):
        _lr_api(HierarchicalFedAvgAPI, group_ids=np.zeros(5, int))

    from fedml_tpu_torch.data.store import FederatedStore

    class _Store:
        pass

    x, y, parts = _replicated_task()
    groups = np.arange(6) % 2
    streamed, resident = (
        HierarchicalFedAvgAPI(_lr_model(), fed, None, FedConfig(**_cfg()),
                              group_ids=groups, device="cpu")
        for fed in (FederatedStore(x, y, parts, 4, device="cpu"),
                    build_federated_arrays(x, y, parts, 4, device="cpu")))
    assert streamed.train_one_round(0) == resident.train_one_round(0)
    for k, v in resident.net.params.items():
        assert torch.equal(streamed.net.params[k], v)
    with pytest.raises(TypeError, match="_Store"):
        HierarchicalFedAvgAPI(_lr_model(), _Store(), None,
                              FedConfig(**_cfg()),
                              group_ids=np.zeros(6, int), device="cpu")


def test_group_composable_exemption_is_not_inherited():
    """Only a class that declares ``composes_group_aggregation`` in its
    own ``__dict__`` takes the composable branch: a subclass of
    hierarchical FL that customizes the round again refuses every non-mean
    aggregator, as JAX's guard does."""
    class _Again(HierarchicalFedAvgAPI):
        def train_one_round(self, round_idx):
            return super().train_one_round(round_idx)

    with pytest.raises(NotImplementedError,
                       match="customizes the round or its aggregation"):
        _lr_api(_Again, group_ids=np.zeros(6, int),
                aggregator="coord_median")


# --- TurboAggregate ------------------------------------------------------------------

@pytest.mark.parametrize("dropped", [None, [0], [1, 3]])
def test_turboaggregate_aggregate_bit_equal_to_jax(dropped):
    """From JAX's trained client nets (carried into the port's round in
    place of its own training), the port's MPC aggregate is JAX's bit for
    bit, whatever the flatten order or the shares (field sums are exact
    and every operation is per element); the round's loss too. With
    dropouts the dropped clients leave the aggregate."""
    api, japi = _lr_pair(TurboAggregateAPI, JaxTurboAggregateAPI, n_groups=3)
    seen = {}
    local_batch = japi._local_batch

    def record(*args):
        seen["out"] = local_batch(*args)
        return seen["out"]

    japi._local_batch = record
    api.set_dropout(dropped)
    japi.set_dropout(dropped)
    want = japi.train_one_round(0)
    jnets, jlosses = seen["out"]
    api._train_clients = lambda idx, key: (
        _stack_to_port(jnets.params), torch.from_numpy(np.array(jlosses)))
    got = api.train_one_round(0)
    assert got == want
    for a, b in zip(jax.tree.leaves(to_jax_params(api.net.params)),
                    jax.tree.leaves(_jax_params(japi.net.params))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dropped", [None, [0]])
def test_turboaggregate_is_the_weighted_mean_within_quantization(dropped):
    """The MPC aggregate of the port's own client stack against the
    float64 sample-weighted mean of the same stack (without the dropped
    clients): within 0.5/2^16 per client and value plus the f32 cast."""
    api = _lr_api(TurboAggregateAPI, n_groups=3)
    api.set_dropout(dropped)
    seen = {}
    train = api._train_clients

    def record(idx, key):
        seen["idx"] = idx
        seen["out"] = train(idx, key)
        return seen["out"]

    api._train_clients = record
    api.train_one_round(0)
    params, _ = seen["out"]
    w = api.train_fed.counts.numpy()[seen["idx"]].astype(np.float64)
    if dropped:
        w[dropped] = 0.0
    w = w / w.sum()
    for k, p in params.items():
        mean = np.tensordot(w, p.numpy().astype(np.float64), axes=1)
        bound = len(w) * 0.5 / 2 ** 16 + np.abs(mean) * 2.0 ** -23
        assert (np.abs(api.net.params[k].numpy() - mean) <= bound).all(), k


def test_turboaggregate_all_dropped_is_a_no_op_and_tiers_refuse():
    """Every sampled client dropped: the round keeps the model and reports
    a NaN loss, as JAX's; the pipelined and on-device tiers refuse with
    the record's message, quoting the class's ``window_exclusion``; a
    client lr change drops the captured training step."""
    api = _lr_api(TurboAggregateAPI)
    api.set_dropout([0, 1, 2, 3])
    before = {k: v.clone() for k, v in api.net.params.items()}
    assert np.isnan(api.train_one_round(0)["train_loss"])
    for k, v in before.items():
        assert torch.equal(api.net.params[k], v)
    api.set_dropout(None)
    api.train_one_round(1)
    assert "local_batch" in api._graphs
    api.set_client_lr(0.05)
    assert "local_batch" not in api._graphs
    for tier in (lambda: api.train_rounds_pipelined(2),
                 lambda: api.train_rounds_on_device(2)):
        with pytest.raises(NotImplementedError) as exc:
            tier()
        assert TurboAggregateAPI.window_exclusion in str(exc.value)


# --- decentralized DSGD / PushSum ---------------------------------------------------------

def _decentralized_pair(mode, rounds_cfg=None):
    x, y, parts = _replicated_task(counts=(5, 9, 13, 3, 17, 8))
    cfg = _cfg(client_num_per_round=6, **(rounds_cfg or {}))
    tm = (topology.SymmetricTopologyManager(6, neighbor_num=4, seed=0)
          if mode == "dsgd" else
          topology.AsymmetricTopologyManager(6, neighbor_num=2, seed=0))
    jtm = (jax_topology.SymmetricTopologyManager(6, neighbor_num=4, seed=0)
           if mode == "dsgd" else
           jax_topology.AsymmetricTopologyManager(6, neighbor_num=2, seed=0))
    japi = JaxDecentralized(JaxLogisticRegression(num_classes=4),
                            jax_batching.build_federated_arrays(x, y, parts,
                                                                4),
                            None, JaxFedConfig(**cfg), jtm, mode=mode)
    api = DecentralizedAPI(_lr_model(), build_federated_arrays(
        x, y, parts, 4, device="cpu"), None, FedConfig(**cfg), tm,
        mode=mode, device="cpu")
    api.nets = NetState(_stack_to_port(japi.nets.params), {})
    return api, japi


@pytest.mark.parametrize("mode", ["dsgd", "pushsum"])
def test_decentralized_rounds_match_jax(mode):
    """DSGD and PushSum from JAX's stacks: the client stacks after one
    round and after three within 1e-5 of JAX's, the push weights within
    1e-6 (summing to n), the losses within 1e-5; the consensus net and
    ``evaluate`` (through ``_eval_net``) against JAX's."""
    api, japi = _decentralized_pair(mode)
    for r in range(3):
        la = api.train_one_round(r)["train_loss"]
        lb = japi.train_one_round(r)["train_loss"]
        assert la == pytest.approx(lb, abs=1e-5)
        if r == 0 or r == 2:
            got = api.nets.params
            want = _stack_to_port(japi.nets.params)
            for k in got:
                np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                           rtol=0, atol=1e-5)
    np.testing.assert_allclose(api.push_weights.numpy(),
                               np.asarray(japi.push_weights), atol=1e-6)
    assert float(api.push_weights.sum()) == pytest.approx(6.0, abs=1e-5)
    if mode == "pushsum":
        assert not np.allclose(api.push_weights.numpy(), 1.0)
    _close(api.consensus_net().params, japi.consensus_net().params, 1e-5)
    x, y, parts = _replicated_task(counts=(5, 9, 13, 3, 17, 8), seed=3)
    from fedml_tpu.data.batching import batch_global as jax_batch_global
    from fedml_tpu_torch.data import batch_global
    api.test_global = batch_global(x, y, 8, device="cpu")
    japi.test_global = jax_batch_global(x, y, 8)
    got, want = api.evaluate(), japi.evaluate()
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k] == pytest.approx(want[k], abs=1e-5), k
    m = api.evaluate_on_clients()
    jm = japi.evaluate_on_clients()
    for k in m:
        assert m[k] == pytest.approx(jm[k], abs=1e-5), k


def _decentralized(mode):
    x, y = make_classification(60, n_features=10, n_classes=4, seed=2)
    parts = partition_homo(60, 6, seed=2)
    fed = build_federated_arrays(x, y, parts, 4, device="cpu")
    tm = (topology.SymmetricTopologyManager(6, neighbor_num=4, seed=0)
          if mode == "dsgd" else
          topology.AsymmetricTopologyManager(6, neighbor_num=2, seed=0))
    return DecentralizedAPI(_lr_model(), fed, None,
                            FedConfig(**_cfg(client_num_per_round=6)), tm,
                            mode=mode, device="cpu")


@pytest.mark.parametrize("mode", ["dsgd", "pushsum"])
def test_decentralized_tiers_equal_the_host_loop(mode):
    """``train_rounds_pipelined(3)`` and ``train_rounds_on_device(3)`` are
    bit-equal to 3 ``train_one_round``: the stacks, the push weights, the
    losses and the key chain after."""
    host = _decentralized(mode)
    want = [host.train_one_round(r)["train_loss"] for r in range(3)]
    for tier in ("pipelined", "on_device"):
        api = _decentralized(mode)
        if tier == "pipelined":
            got = api.train_rounds_pipelined(3)
        else:
            got = api.train_rounds_on_device(3).tolist()
        assert got == want
        _assert_nets_equal(api.nets, host.nets)
        assert torch.equal(api.push_weights, host.push_weights)
        assert torch.equal(api.rng, host.rng)


def test_decentralized_stacks_are_real_copies():
    """Every client's row of the stacks is its own memory (the round
    writes the donated stacks in place), equal to the init."""
    api = _decentralized("dsgd")
    for k, p in api.nets.params.items():
        assert p.stride(0) > 0 and p.is_contiguous()
        assert torch.equal(p[0], p[-1])
    with pytest.raises(ValueError, match="unknown decentralized mode"):
        DecentralizedAPI(_lr_model(), api.train_fed, None, api.cfg,
                         topology.SymmetricTopologyManager(6), mode="admm",
                         device="cpu")
    with pytest.raises(ValueError, match=r"topology is \(5, 5\)"):
        DecentralizedAPI(_lr_model(), api.train_fed, None, api.cfg,
                         topology.SymmetricTopologyManager(5), device="cpu")


# --- capability records against the JAX package's matrix -------------------------------

_CLASSES = {
    "FedAc": (FedAcAPI, JaxFedAcAPI),
    "ServerAvg": (ServerAvgAPI, JaxServerAvgAPI),
    "q-FedAvg": (QFedAvgAPI, JaxQFedAvgAPI),
    "HierarchicalFL": (HierarchicalFedAvgAPI, JaxHierarchicalAPI),
    "TurboAggregate": (TurboAggregateAPI, JaxTurboAggregateAPI),
    "Decentralized": (DecentralizedAPI, JaxDecentralized),
}


@pytest.mark.parametrize("name", list(_CLASSES))
def test_capability_records_match_the_support_matrix(name):
    """Each class's record against the JAX package's (the matrix of
    ``docs/EXECUTION.md``): the protocol, the fused and pipelined tiers
    (one field in the port, whose host loop replays the fused step) and
    the on-device tier; a refused tier's message is the record's and
    quotes the class's ``window_exclusion``."""
    cls, jcls = _CLASSES[name]
    rec, jrec = record_for(cls), jax_capability.record_for(jcls)
    assert rec.protocol == jrec.protocol
    assert rec.fused == jrec.fused == jrec.pipelined
    assert rec.on_device == jrec.on_device
    assert rec.excluded == jrec.excluded
    for tier in ("train_one_round", "train_rounds_pipelined",
                 "train_rounds_on_device"):
        allowed = rec.on_device if tier.endswith("device") else rec.fused
        msg = refusal(cls, tier)
        if rec.protocol is None:
            assert f"(window_protocol=None): {jcls.window_exclusion}" in msg
        assert allowed or cls.__name__ in msg
    if name == "Decentralized":
        assert refusal(cls, "train_rounds_windowed") == \
            jax_capability.refusal(jcls, "train_rounds_windowed")
        with pytest.raises(NotImplementedError,
                           match="opts out of the windowed tier"):
            _decentralized("dsgd").train_rounds_windowed(2)


@pytest.mark.parametrize("cls,kw", [(HierarchicalFedAvgAPI,
                                     dict(group_ids=np.zeros(6, int))),
                                    (FedAcAPI, {}), (ServerAvgAPI, {})])
def test_refused_tiers_raise_and_checkpoints_cite_a8(cls, kw):
    """Hierarchical FL's pipelined and on-device tiers raise the record's
    message (never an eager fallback); FedAc's and ServerAvg's
    checkpoint hooks give their run state under JAX's keys, and take it
    back (tests/test_torch_checkpoint.py pins the resume)."""
    api = _lr_api(cls, **kw)
    if cls is HierarchicalFedAvgAPI:
        for tier, call in (("train_rounds_pipelined",
                            lambda: api.train_rounds_pipelined(2)),
                           ("train_rounds_on_device",
                            lambda: api.train_rounds_on_device(2))):
            with pytest.raises(NotImplementedError) as exc:
                call()
            assert str(exc.value) == refusal(cls, tier)
        assert not api._graphs
        return
    extra = api.checkpoint_extra_state()
    assert set(extra) == ({"fedac_x", "fedac_x_ag"} if cls is FedAcAPI
                          else {"savg_acc", "savg_count", "savg_t"})
    api.load_checkpoint_extra_state(extra)
    assert api.checkpoint_extra_state().keys() == extra.keys()


def test_turboaggregate_guards():
    """The JAX guards that the port keeps: ``compress`` is refused with
    TurboAggregate's own JAX message (its MPC bypasses the client
    transform), a mesh is refused (A11)."""
    with pytest.raises(ValueError) as exc:
        _lr_api(TurboAggregateAPI, compress="topk0.1")
    x, y, parts = _replicated_task()
    with pytest.raises(ValueError) as jexc:
        JaxTurboAggregateAPI(JaxLogisticRegression(num_classes=4),
                             jax_batching.build_federated_arrays(
                                 x, y, parts, 4), None,
                             JaxFedConfig(**_cfg(compress="topk0.1")))
    assert str(exc.value) == str(jexc.value)
    x, y, parts = _replicated_task()
    with pytest.raises(NotImplementedError, match="A11"):
        TurboAggregateAPI(_lr_model(), build_federated_arrays(
            x, y, parts, 4, device="cpu"), None, FedConfig(**_cfg()),
            mesh=object(), device="cpu")


def test_evaluations_read_the_eval_net():
    """``evaluate`` and ``evaluate_on_clients`` read ``_eval_net()``:
    FedAvg's global net, and a replaced eval net is what they see."""
    api = _lr_api(FedAvgAPI)
    assert api._eval_net() is api.net
    x, y, _ = _replicated_task(seed=5)
    from fedml_tpu_torch.data import batch_global
    api.test_global = batch_global(x, y, 8, device="cpu")
    base = api.evaluate()
    zero = NetState({k: torch.zeros_like(v) for k, v in
                     api.net.params.items()}, {})
    api._eval_net = lambda: zero
    assert api.evaluate()["loss"] == pytest.approx(np.log(4.0), abs=1e-6)
    assert api.evaluate() != base
    assert api.evaluate_on_clients()["clients_train_loss"] == pytest.approx(
        np.log(4.0), abs=1e-6)
    assert dataclasses.is_dataclass(api._eval_net())
