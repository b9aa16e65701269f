"""The port's DARTS search space (``models/darts.py``) against the JAX
package's on the same seeded numpy inputs and JAX's weights carried across
with ``convert``: flax's SAME padding, every op at stride 1 and 2 on even
and odd sizes, the mixed edge, the search network's logits and its
gradients in the weights and the alphas, the retraining network,
``derive_genotype`` and ``genotype_to_dot``; the ``bn`` and no-GPU
refusals; and two rounds of ``FedNASAPI`` against JAX's (the local search
and the tiers are in ``test_torch_fednas.py``)."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call, grad

from fedml_tpu.algos.config import FedConfig as JaxFedConfig
from fedml_tpu.algos.fednas import FedNASAPI as JaxFedNASAPI
from fedml_tpu.data import batching as jax_batching
from fedml_tpu.models import darts as jd
from fedml_tpu_torch.algos import FedConfig, FedNASAPI
from fedml_tpu_torch.convert import from_jax_params, to_jax_params
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.data import build_federated_arrays
from fedml_tpu_torch.models import darts as td
from fedml_tpu_torch.models.layers import same_pad
from fedml_tpu_torch.trainer.local import NetState

TOL = 1e-5  # f32 forward: max |Δ| against max |want|, other conv orders


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


@pytest.mark.parametrize("size", [32, 9, 7, 8])
def test_same_pad_is_xlas(size):
    """``same_pad`` against ``lax.padtype_to_pads`` for every kernel,
    stride and dilation the search space uses."""
    for k, stride, dil in ((1, 1, 1), (1, 2, 1), (3, 1, 1), (3, 2, 1),
                           (5, 2, 1), (3, 2, 2), (5, 2, 2), (5, 1, 2)):
        span = (k - 1) * dil + 1
        want = jax.lax.padtype_to_pads((size,), (span,), (stride,), "SAME")
        assert same_pad(size, k, stride, dil) == tuple(want[0])
    assert same_pad(32, 3, 2) == (0, 1) and same_pad(32, 5, 2) == (1, 2)


def _op_pair(name, stride, c):
    """(flax module, the port's module) of one parametrized op."""
    if name == "relu_conv_norm":
        return jd.ReLUConvNorm(c, 1, stride), td.ReLUConvNorm(c, c, 1, stride)
    if name == "factorized_reduce":
        return jd.FactorizedReduce(c), td.FactorizedReduce(c, c)
    kind, k = name[:-1], int(name[-1])
    if kind == "sep_conv":
        return jd.SepConv(c, k, stride), td.SepConv(c, c, k, stride)
    return jd.DilConv(c, k, stride), td.DilConv(c, c, k, stride)


@pytest.mark.parametrize("name,stride,size", [
    (name, stride, size)
    for name in ("relu_conv_norm", "sep_conv3", "sep_conv5", "dil_conv3",
                 "dil_conv5", "factorized_reduce", "max_pool", "avg_pool")
    for stride in ((2,) if name == "factorized_reduce" else (1, 2))
    for size in (32, 9, 7)])
def test_darts_op_matches_flax(name, stride, size):
    """Each op against flax at stride 1 and 2 on even and odd sizes (the
    factorized reduce is stride 2 by construction): same output shape,
    within 1e-5 relative."""
    c = 4
    x = np.random.RandomState(size + stride).randn(2, size, size, c).astype(
        np.float32) * 2
    if name in ("max_pool", "avg_pool"):
        pool = fnn.max_pool if name == "max_pool" else fnn.avg_pool
        want = pool(jnp.asarray(x), (3, 3), strides=(stride, stride),
                    padding="SAME")
        fn = td.max_pool_same if name == "max_pool" else td.avg_pool_same
        got = fn(_nchw(x), stride).permute(0, 2, 3, 1)
    else:
        jmod, tmod = _op_pair(name, stride, c)
        params = jmod.init(jax.random.PRNGKey(size), jnp.asarray(x))
        want = jmod.apply(params, jnp.asarray(x))
        tmod.load_state_dict(from_jax_params(_np(params["params"]))[0])
        with torch.no_grad():
            got = tmod(_nchw(x)).permute(0, 2, 3, 1)
    assert tuple(got.shape) == want.shape
    assert _rel(got.numpy(), want) <= TOL


@pytest.mark.parametrize("stride", [1, 2])
def test_mixed_op_matches_flax(stride):
    """The softmax-weighted edge at an odd size, ``none`` included."""
    c, x = 4, np.random.RandomState(3).randn(2, 9, 9, 4).astype(np.float32)
    w = np.array(jax.nn.softmax(
        np.random.RandomState(4).randn(8).astype(np.float32)))
    jmod = jd.MixedOp(c, stride)
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x), w)
    want = jmod.apply(params, jnp.asarray(x), w)
    tmod = td.MixedOp(c, stride)
    tmod.load_state_dict(from_jax_params(_np(params["params"]))[0])
    with torch.no_grad():
        got = tmod(_nchw(x), torch.from_numpy(w)).permute(0, 2, 3, 1)
    assert _rel(got.numpy(), want) <= TOL


def _carried(jmod, model, x):
    """The port model's seeded weights as a flax tree, after checking that
    it has flax's structure and shapes (``eval_shape`` of flax's init):
    the names map with no table, either way."""
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))["params"]
    params = to_jax_params(model.state_dict())
    assert jax.tree.structure(params) == jax.tree.structure(shapes)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(shapes)):
        assert a.shape == b.shape
    sd = from_jax_params(params)[0]
    assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items())
    return params


def test_search_network_logits_and_gradients_match_flax():
    """The search net at c 4, 3 layers, 2 steps (cells normal, reduce,
    reduce) on 8×8 inputs: the logits within 1e-5 relative, and the
    gradient of a CE loss in every weight and in both alphas within 1e-5
    of the largest gradient (each alpha leaf within 1e-4 of its own
    largest)."""
    rng = np.random.RandomState(0)
    x = rng.randn(3, 8, 8, 3).astype(np.float32)
    y = rng.randint(0, 5, 3)
    jmod = jd.DartsNetwork(c=4, layers=3, steps=2, multiplier=2,
                           num_classes=5)
    model = create_model("darts", num_classes=5, c=4, layers=3, steps=2,
                         multiplier=2, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    params = _carried(jmod, model, x)

    def jloss(p):
        logits = jmod.apply({"params": p}, jnp.asarray(x))
        return (-jnp.mean(jax.nn.log_softmax(logits)[np.arange(3), y]),
                logits)

    (_, want_logits), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(params)
    want_grads = from_jax_params(_np(jgrads))[0]
    with torch.no_grad():
        assert _rel(model(torch.from_numpy(x)).numpy(), want_logits) <= TOL

    def loss(p):
        logits = functional_call(model, p, (torch.from_numpy(x),))
        return torch.nn.functional.cross_entropy(logits,
                                                 torch.from_numpy(y))

    got = grad(loss)({k: v.detach() for k, v in model.named_parameters()})
    assert set(got) == set(want_grads)
    scale = max(v.abs().max().item() for v in want_grads.values())
    for k in got:
        assert (got[k] - want_grads[k]).abs().max().item() <= 1e-5 * scale, k
    for k in ("alphas_normal", "alphas_reduce"):
        assert _rel(got[k].numpy(), want_grads[k].numpy()) <= 1e-4, k


def test_genotype_network_matches_flax():
    """The retraining net of a genotype with every op kind, pools and skips
    on both cell kinds (so factorized reduces at stride 2 and identity
    skips), at c 4, 3 layers on 9×9 inputs."""
    gen = jd.Genotype(
        normal=[("sep_conv_3x3", 0), ("skip_connect", 1),
                ("dil_conv_5x5", 2), ("max_pool_3x3", 0)],
        normal_concat=[2, 3],
        reduce=[("skip_connect", 0), ("avg_pool_3x3", 1),
                ("sep_conv_5x5", 2), ("dil_conv_3x3", 1)],
        reduce_concat=[2, 3])
    x = np.random.RandomState(1).randn(2, 9, 9, 3).astype(np.float32)
    jmod = jd.darts_genotype(gen, num_classes=4, c=4, layers=3)
    model = create_model("darts_genotype", genotype=gen, num_classes=4, c=4,
                         layers=3, device="cpu",
                         generator=torch.Generator().manual_seed(1))
    params = _carried(jmod, model, x)
    want = jax.jit(jmod.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        assert _rel(model(torch.from_numpy(x)).numpy(), want) <= TOL


def test_fednas_rounds_match_jax_api():
    """Two first-order rounds of ``FedNASAPI`` (3 of 4 clients a round,
    counts 12/7/10/9 at batch 2: 6, 4, 5 and 5 packed steps, so h 3, 2 and
    2 with an odd real step left over) from JAX's start against JAX's
    class: params and losses; then ``genotype()`` equal to JAX's of the
    same alphas. The searched weights and alphas within 1e-5 of the
    largest update of each (f32, other conv and sum orders)."""
    net = dict(c=4, layers=2, steps=1, multiplier=1, num_classes=5)
    counts = (12, 7, 10, 9)
    rng = np.random.RandomState(0)
    x = rng.randn(sum(counts), 8, 8, 3).astype(np.float32)
    y = rng.randint(0, 5, len(x)).astype(np.int32)
    edges = np.concatenate([[0], np.cumsum(counts)])
    parts = {i: np.arange(edges[i], edges[i + 1]) for i in range(4)}
    cfg = dict(client_num_in_total=4, client_num_per_round=3, comm_round=2,
               epochs=1, batch_size=2, lr=0.05, frequency_of_the_test=100)
    japi = JaxFedNASAPI(jd.DartsNetwork(**net),
                        jax_batching.build_federated_arrays(x, y, parts, 2),
                        None, JaxFedConfig(**cfg), arch_lr=0.01)
    api = FedNASAPI(create_model("darts", device="cpu", **net),
                    build_federated_arrays(x, y, parts, 2, device="cpu"),
                    None, FedConfig(**cfg), arch_lr=0.01, device="cpu")
    start = from_jax_params(_np(japi.net.params))[0]
    api.net = NetState(dict(start), {})
    for r in range(2):
        want_loss = japi.train_one_round(r)["train_loss"]
        got_loss = api.train_one_round(r)["train_loss"]
        assert abs(got_loss - want_loss) <= 1e-5 * abs(want_loss)
    want = from_jax_params(_np(japi.net.params))[0]
    alphas = ("alphas_normal", "alphas_reduce")
    for keys in ([k for k in want if k not in alphas], alphas):
        upd = max((want[k] - start[k]).abs().max().item() for k in keys)
        diff = max((api.net.params[k] - want[k]).abs().max().item()
                   for k in keys)
        assert upd > 0 and diff <= 1e-5 * upd
    assert tuple(api.genotype()) == tuple(jd.derive_genotype(
        np.asarray(japi.net.params["alphas_normal"]),
        np.asarray(japi.net.params["alphas_reduce"]), steps=1,
        multiplier=1))


@pytest.mark.parametrize("steps,multiplier", [(4, 4), (2, 2), (3, 2)])
def test_derive_genotype_and_dot_match_jax(steps, multiplier):
    """The genotype of random alphas (tensors in the port, arrays in JAX)
    and both cells' DOT text, equal."""
    rng = np.random.RandomState(steps)
    e = jd.n_edges(steps)
    an, ar = (rng.randn(e, 8).astype(np.float32) for _ in range(2))
    want = jd.derive_genotype(an, ar, steps, multiplier)
    got = td.derive_genotype(torch.from_numpy(an), torch.from_numpy(ar),
                             steps, multiplier)
    assert tuple(got) == tuple(want)
    assert td.n_edges(steps) == e and td.PRIMITIVES == jd.PRIMITIVES
    for which in ("normal", "reduce"):
        assert td.genotype_to_dot(got, which, "c") == jd.genotype_to_dot(
            want, which, "c")
    with pytest.raises(ValueError, match="normal' or 'reduce"):
        td.genotype_to_dot(got, "other")


def test_refusals(monkeypatch):
    """``norm='bn'`` builds the BatchNorm search net (its running stats
    the model's buffers, a mean and a var per norm); multiplier > steps is
    refused as JAX refuses it; without a CUDA device the registry entries
    raise unless ``device='cpu'``."""
    bn = create_model("darts", c=4, layers=2, steps=2, multiplier=2,
                      norm="bn", device="cpu")
    names = [k for k, _ in bn.named_buffers()]
    assert names and len(names) == 2 * sum(
        1 for k, _ in bn.named_parameters() if k.endswith("BatchNorm_0.weight"))
    with pytest.raises(ValueError, match="multiplier"):
        create_model("darts", steps=2, multiplier=3, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model("darts", c=4, layers=2, steps=2, multiplier=2)
    gen = td.derive_genotype(np.zeros((14, 8)), np.zeros((14, 8)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model("darts_genotype", genotype=gen, c=4, layers=2)
