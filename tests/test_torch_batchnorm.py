"""BatchNorm in the port and its trained state carried through the rounds,
against the JAX package on the same seeded numpy inputs and weights:
``Norm(kind="bn")`` against flax's ``nn.BatchNorm`` in train and eval mode,
the running stats after masked local steps (an all-masked batch, a ragged
client, a vmapped cohort of clients with different data), and rounds of
FedAvg, FedDyn, FedBN, q-FedAvg, hierarchical FL and the robust round over
``resnet20(norm="bn")`` with params AND ``batch_stats`` compared.

Every client holds at most one batch of samples, so an epoch is one real
step (and all-masked ones after it): the port's shuffle draws from
``core/keys.py``, not threefry, and batch statistics and the masked mean
loss do not depend on the order of a batch's samples."""

import flax.linen as jnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algos.config import FedConfig as JaxFedConfig
from fedml_tpu.algos.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.algos.fedbn import FedBNAPI as JaxFedBNAPI
from fedml_tpu.algos.feddyn import FedDynAPI as JaxFedDynAPI
from fedml_tpu.algos.hierarchical import \
    HierarchicalFedAvgAPI as JaxHierarchicalAPI
from fedml_tpu.algos.qfedavg import QFedAvgAPI as JaxQFedAvgAPI
from fedml_tpu.algos.robust import FedAvgRobustAPI as JaxRobustAPI
from fedml_tpu.data import batching as jax_batching
from fedml_tpu.models.registry import create_model as jax_create_model
from fedml_tpu.trainer.local import NetState as JaxNetState
from fedml_tpu.trainer.local import make_client_optimizer as jax_optimizer
from fedml_tpu.trainer.local import make_local_train_fn as jax_local_train
from fedml_tpu.trainer.local import model_fns as jax_model_fns
from fedml_tpu_torch.algos import (FedAvgAPI, FedAvgRobustAPI, FedBNAPI,
                                   FedConfig, FedDynAPI,
                                   HierarchicalFedAvgAPI, QFedAvgAPI)
from fedml_tpu_torch.convert import (from_jax_params,
                                     stacked_from_jax_params, to_jax_params)
from fedml_tpu_torch.core import keys
from fedml_tpu_torch.data import build_federated_arrays
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models.resnet import Norm
from fedml_tpu_torch.trainer.local import (NetState, make_client_optimizer,
                                           make_local_train_fn, model_fns)

WIDTHS = (4, 8, 16)
# Rounds and steps of the small BN ResNet, port against JAX (f32, other
# summation orders in the convs and reductions): params within 2e-5 and
# the running stats within 2e-5 (absolute; the stats are O(1)).
ROUND_TOL = 2e-5
# One BatchNorm: f32 outputs within 1e-5, bf16 outputs within 2 bf16 ulps
# at |y| < 8 (2^-5), the running stats (f32 in both) within 1e-6.
BN_TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -5}
STATS_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_net(jnet):
    """A JAX ``NetState`` (params, ``{"batch_stats": ...}``) as the
    port's."""
    state = jnet.model_state.get("batch_stats", {})
    return NetState(from_jax_params(_np(jnet.params))[0],
                    from_jax_params(_np(state))[0] if state else {})


def _close_tree(got, jtree, tol):
    want = jax.tree_util.tree_leaves_with_path(_np(jtree))
    got = dict(jax.tree_util.tree_leaves_with_path(to_jax_params(got)))
    assert len(got) == len(want)
    for path, w in want:
        np.testing.assert_allclose(got[path], w, rtol=0, atol=tol,
                                   err_msg=jax.tree_util.keystr(path))


def _close_net(net, jnet, tol=ROUND_TOL):
    _close_tree(net.params, jnet.params, tol)
    _close_tree(net.model_state, jnet.model_state["batch_stats"], tol)


# --- one BatchNorm ----------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("train", [True, False])
def test_norm_bn_matches_flax(train, dtype):
    rng = np.random.RandomState(0)
    c = 6
    x = (rng.randn(5, 4, 3, c) * 2 + 1).astype(np.float32)
    scale = (1 + 0.2 * rng.randn(c)).astype(np.float32)
    bias = (0.2 * rng.randn(c)).astype(np.float32)
    mean = (0.3 * rng.randn(c)).astype(np.float32)
    var = (1 + 0.3 * rng.rand(c)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else None
    jx = jnp.asarray(x).astype(jdt or jnp.float32)
    bn = jnn.BatchNorm(use_running_average=not train, momentum=0.9,
                       dtype=jdt)
    want, upd = bn.apply({"params": {"scale": scale, "bias": bias},
                          "batch_stats": {"mean": mean, "var": var}}, jx,
                         mutable=["batch_stats"])
    norm = Norm("bn", c, dtype=dtype if dtype == torch.bfloat16 else None)
    fns = model_fns(norm)
    net = NetState({"BatchNorm_0.weight": torch.tensor(scale),
                    "BatchNorm_0.bias": torch.tensor(bias)},
                   {"BatchNorm_0.mean": torch.tensor(mean),
                    "BatchNorm_0.var": torch.tensor(var)})
    xt = torch.tensor(x).to(dtype).permute(0, 3, 1, 2)
    y, state = fns.apply(net, xt, train=train)
    assert y.dtype == dtype
    got = y.permute(0, 2, 3, 1).float().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=0,
                               atol=BN_TOL[dtype])
    stats = upd["batch_stats"]
    for k in ("mean", "var"):
        np.testing.assert_allclose(state[f"BatchNorm_0.{k}"].numpy(),
                                   np.asarray(stats[k]), rtol=0,
                                   atol=STATS_TOL)
    if not train:  # eval mode reads the running stats and updates none
        assert state is net.model_state


def test_bn_buffers_are_never_written_in_place():
    norm = Norm("bn", 3)
    fns = model_fns(norm)
    net = fns.init()
    before = {k: v.clone() for k, v in net.model_state.items()}
    _, state = fns.apply(net, torch.randn(
        4, 3, 2, 2, generator=torch.Generator().manual_seed(0)), train=True)
    for k, v in net.model_state.items():
        assert torch.equal(v, before[k])
        assert not torch.equal(state[k], v)
    assert norm.BatchNorm_0.new_buffers is None


# --- the running stats through masked local steps -----------------------------

def _bn_model(jax_too=True, seed=1):
    """``resnet20(norm="bn")`` at small widths in both packages, the
    port's weights carried to JAX (params and batch_stats)."""
    model = create_model("resnet20", widths=WIDTHS, norm="bn", num_classes=4,
                         device="cpu",
                         generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():  # running stats away from their init
        g = torch.Generator().manual_seed(seed)
        for name, buf in model.named_buffers():
            if name.endswith("mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=g))
            else:
                buf.copy_(1 + 0.1 * torch.rand(buf.shape, generator=g))
    jmodel = jax_create_model("resnet20", widths=WIDTHS, norm="bn",
                              num_classes=4)
    return model, jmodel


def _jax_net(model):
    state = {k: v for k, v in model.state_dict().items()
             if k.endswith((".mean", ".var"))}
    params = {k: v for k, v in model.state_dict().items() if k not in state}
    return JaxNetState(jax.tree.map(jnp.asarray, to_jax_params(params)),
                       {"batch_stats": jax.tree.map(jnp.asarray,
                                                    to_jax_params(state))})


def _task(counts, batch, seed=0, side=8):
    """Random images, a client per count, every client at most one batch
    (one real step an epoch)."""
    rng = np.random.RandomState(seed)
    n = sum(counts)
    x = rng.randn(n, side, side, 3).astype(np.float32)
    y = rng.randint(0, 4, n).astype(np.int32)
    edges = np.concatenate([[0], np.cumsum(counts)])
    parts = {i: np.arange(edges[i], edges[i + 1]) for i in range(len(counts))}
    return x, y, parts


def _with_masked_step(x, y, mask):
    """The packed ``[C, S, B, ...]`` arrays with an all-masked step
    appended, filled as padding is (copies of each client's first
    sample)."""
    def first(a):
        return np.broadcast_to(a[:, :1, :1], a[:, :1].shape)

    return (np.concatenate([x, first(x)], 1), np.concatenate([y, first(y)], 1),
            np.concatenate([mask, np.zeros_like(mask[:, :1])], 1))


def test_running_stats_after_masked_steps_match_jax():
    """Two epochs of a cohort whose clients hold 8 (a full batch), 5
    (ragged: three padded copies of its first sample enter the batch
    statistics, as in JAX) and 3 samples, batch 8, with an all-masked
    second step (a no-op on params and stats), vmapped and one client at
    a time: the clients of different data keep their own statistics."""
    model, jmodel = _bn_model()
    x, y, parts = _task((8, 5, 3), 8)
    jfed = jax_batching.build_federated_arrays(x, y, parts, 8)
    xs, ys, ms = _with_masked_step(np.asarray(jfed.x), np.asarray(jfed.y),
                                   np.asarray(jfed.mask))
    tx, ty, tm = (torch.tensor(np.ascontiguousarray(a)) for a in (xs, ys, ms))
    ty = ty.long()
    fns, jfns = model_fns(model), jax_model_fns(jmodel)
    lt = make_local_train_fn(fns.apply, make_client_optimizer("sgd", 0.05),
                             2)
    jlt = jax_local_train(jfns.apply, jax_optimizer("sgd", 0.05), 2)
    net, jnet = fns.init(), _jax_net(model)
    rngs = keys.fold_in(keys.key(0), torch.arange(3))
    cohort, _ = lt.run_clients(net, tx, ty, tm, rngs)
    jcohort, _ = jax.vmap(jlt, in_axes=(None, 0, 0, 0, 0))(
        jnet, jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(ms),
        jax.random.split(jax.random.PRNGKey(0), 3))
    for c in range(3):
        one, _ = lt(net, tx[c], ty[c], tm[c], rngs[c])
        want = jax.tree.map(lambda a, c=c: a[c], jcohort)
        _close_net(one, want)
        _close_net(NetState(*({k: v[c] for k, v in t.items()}
                              for t in (cohort.params, cohort.model_state))),
                   want)
    # The clients' statistics differ, and moved from the start.
    k = "Norm_0.BatchNorm_0.mean"
    s = cohort.model_state[k]
    assert not torch.allclose(s[0], s[1])
    assert not torch.equal(s[0], net.model_state[k])


def test_all_masked_cohort_keeps_stats_bit_equal():
    model, _ = _bn_model()
    x, y, parts = _task((4, 4), 4)
    fed = build_federated_arrays(x, y, parts, 4, device="cpu")
    fed.mask.zero_()
    fns = model_fns(model)
    lt = make_local_train_fn(fns.apply, make_client_optimizer("sgd", 0.1),
                             1)
    net = fns.init()
    out, _ = lt.run_clients(net, fed.x, fed.y, fed.mask,
                            keys.fold_in(keys.key(0), torch.arange(2)))
    for k, v in net.model_state.items():
        assert torch.equal(out.model_state[k][0], v)
        assert torch.equal(out.model_state[k][1], v)
    for k, v in net.params.items():
        assert torch.equal(out.params[k][1], v)


# --- rounds against JAX ------------------------------------------------------

COUNTS, BATCH = (5, 8, 3, 6, 8, 4), 8


def _cfg(**kw):
    base = dict(client_num_in_total=len(COUNTS), client_num_per_round=4,
                comm_round=2, epochs=1, batch_size=BATCH, lr=0.05,
                frequency_of_the_test=100)
    base.update(kw)
    return base


def _pair(cls, jcls, cfg=None, **kw):
    x, y, parts = _task(COUNTS, BATCH)
    cfg = cfg or _cfg()
    model, jmodel = _bn_model()
    jkw = dict(kw)
    japi = jcls(jmodel, jax_batching.build_federated_arrays(x, y, parts,
                                                            BATCH),
                None, JaxFedConfig(**cfg), **jkw)
    api = cls(model, build_federated_arrays(x, y, parts, BATCH, device="cpu"),
              None, FedConfig(**cfg), device="cpu", **kw)
    japi.net = _jax_net(model)
    assert set(api.net.model_state) == set(model_fns(model).init()
                                           .model_state)
    return api, japi


# Two groups that split each of the three rounds' cohorts ([5 2 1 3],
# [2 1 4 0], [4 1 3 2]) 2 + 2: one padded group size, one JAX compile.
GROUPS = [1, 0, 0, 1, 1, 1]
ALGOS = {
    "fedavg": (FedAvgAPI, JaxFedAvgAPI, {}, {}),
    "feddyn": (FedDynAPI, JaxFedDynAPI, {"alpha": 0.01}, {}),
    "qfedavg": (QFedAvgAPI, JaxQFedAvgAPI, {"q": 1.0}, {}),
    "hierarchical": (HierarchicalFedAvgAPI, JaxHierarchicalAPI,
                     {"group_ids": GROUPS}, {}),
    "robust": (FedAvgRobustAPI, JaxRobustAPI, {},
               {"aggregator": "coord_median", "robust_norm_bound": 0.5}),
}


def _restart_from_jax(api, japi):
    """JAX's global net (and FedDyn's server state and client stack, with
    the dustbin row) into the port's api."""
    api.net = _port_net(japi.net)
    if isinstance(api, FedDynAPI):
        grads = stacked_from_jax_params(_np(japi.client_grads))
        api._window_carry_commit((
            from_jax_params(_np(japi.server_h))[0],
            {k: torch.cat([v, v[:1]]) for k, v in grads.items()}))


@pytest.mark.parametrize("algo", sorted(ALGOS))
def test_bn_rounds_match_jax(algo):
    """Three rounds, each from JAX's start: the global params and
    ``batch_stats`` within ROUND_TOL of JAX's, and the stats moved from
    their start. (Free-running, these small BN rounds amplify sum-order
    rounding in JAX itself: its inner rounds of one client read 1.8e-3
    apart under other shuffle keys, which only reorder a batch.)
    Hierarchical FL runs two groups of one inner round; the robust round
    runs coord_median with the clip active (bound 0.5): the clip changes
    params only and passes each client's stats on, the median takes the
    stats too."""
    cls, jcls, kw, cfg = ALGOS[algo]
    api, japi = _pair(cls, jcls, _cfg(**cfg), **kw)
    start = {k: v.clone() for k, v in api.net.model_state.items()}
    for r in range(3):
        _restart_from_jax(api, japi)
        api.train_one_round(r)
        japi.train_one_round(r)
        _close_net(api.net, japi.net)
    moved = [not torch.equal(api.net.model_state[k], v)
             for k, v in start.items()]
    assert all(moved)


def test_fedbn_keeps_state_per_client_as_jax():
    """FedBN: each sampled client's whole model state is its own (the
    ``[N + 1, ...]`` stack), the global's stays as it was; the stacks and
    the global params within ROUND_TOL of JAX's after two rounds."""
    api, japi = _pair(FedBNAPI, JaxFedBNAPI)
    japi.local_state = jax.tree.map(
        lambda s: jnp.broadcast_to(s[None], (len(COUNTS),) + s.shape),
        japi.net.model_state)
    japi.local_norms = jax.tree.map(
        lambda p, m: (jnp.broadcast_to(p[None], (len(COUNTS),) + p.shape)
                      if m else jnp.zeros((0,), p.dtype)),
        japi.net.params, japi._norm_mask)
    global_state = {k: v.clone() for k, v in api.net.model_state.items()}
    sampled = set()
    for r in range(2):
        sampled |= {int(i) for i in api.sample_round(r)}
        api.train_one_round(r)
        japi.train_one_round(r)
    _close_tree(api.net.params, japi.net.params, ROUND_TOL)
    want = stacked_from_jax_params(_np(japi.local_state["batch_stats"]))
    for k, v in api.local_state.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=ROUND_TOL, err_msg=k)
        assert torch.equal(api.net.model_state[k], global_state[k])
        for c in range(len(COUNTS)):
            moved = not torch.equal(v[c], global_state[k])
            assert moved == (c in sampled), (k, c)


def test_evaluation_reads_the_running_stats():
    """``evaluate`` runs in eval mode: the logits of the running stats,
    as JAX's ``train=False``, not the batch's statistics."""
    api, japi = _pair(FedAvgAPI, JaxFedAvgAPI)
    x, y, _ = _task((16,), 16, seed=3)
    test = (torch.tensor(x)[None], torch.tensor(y, dtype=torch.long)[None],
            torch.ones(1, 16))
    m = api.eval_fn(api.net, *test)
    jm = japi.eval_fn(japi.net, jnp.asarray(x)[None],
                      jnp.asarray(y)[None], jnp.ones((1, 16)))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert float(m["accuracy"]) == pytest.approx(float(jm["accuracy"]))


def test_classes_without_a_state_carry_refuse_bn():
    """The classes that refused a BatchNorm model before they carried its
    state now train one: a ``DecentralizedAPI`` round over the BN ResNet
    keeps each client's running stats in a row of its own (``[n, ...]``),
    moves them from where they started, and its consensus net averages
    them (params and state, as JAX's ``consensus_net``)."""
    from fedml_tpu_torch.algos import DecentralizedAPI
    from fedml_tpu_torch.core.topology import SymmetricTopologyManager

    model, _ = _bn_model()
    x, y, parts = _task(COUNTS, BATCH)
    n = len(COUNTS)
    cfg = FedConfig(**{**_cfg(), "client_num_per_round": n})
    api = DecentralizedAPI(model, build_federated_arrays(
        x, y, parts, BATCH, device="cpu"), None, cfg,
        SymmetricTopologyManager(n, neighbor_num=2), device="cpu")
    before = {k: v.clone() for k, v in api.nets.model_state.items()}
    assert before and all(v.shape[0] == n for v in before.values())
    api.train_one_round(0)
    assert any(not torch.equal(api.nets.model_state[k], v)
               for k, v in before.items())
    cons = api.consensus_net().model_state
    for k, v in api.nets.model_state.items():
        torch.testing.assert_close(cons[k], v.mean(0))