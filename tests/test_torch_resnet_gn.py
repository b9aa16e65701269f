"""The port's ImageNet-style ``ResNetGN`` family (``resnet10_gn`` …
``resnet152_gn``) against the JAX package's: the forward and the gradient
of ``resnet10_gn`` and of a narrow two-stage ``ResNetGN`` with either
stem, the factories' structure (the flax names, 20 GroupNorms in
``resnet18_gn``, ``dtype`` and ``norm`` swallowed as JAX's factories
swallow them), two FedAvg rounds of ``resnet10_gn`` against JAX's
``FedAvgAPI``, and the GroupNorm at ResNet-18-GN's widths through the
port's op (its plain twin on the CPU) against JAX's Pallas kernel in
interpret mode. Weights are numpy from a seed in the flax tree, carried
to the port by ``convert.from_jax_params``; inputs are numpy from a
seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algos.config import FedConfig as JaxFedConfig
from fedml_tpu.algos.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.data import batching as jax_batching
from fedml_tpu.models.registry import create_model as jax_create_model
from fedml_tpu.models.resnet import ResNetGN as JaxResNetGN
from fedml_tpu.ops.group_norm import group_norm as jax_group_norm
from fedml_tpu_torch.algos import FedAvgAPI, FedConfig
from fedml_tpu_torch.convert import from_jax_params, to_jax_params
from fedml_tpu_torch.data import build_federated_arrays
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models.resnet import Norm, ResNetGN
from fedml_tpu_torch.ops.group_norm import group_norm
from fedml_tpu_torch.trainer.local import NetState, softmax_ce

# Logits within 5e-5 of |logit| scale and gradients within 2e-4 of each
# leaf's largest entry (f32; the convs and the GroupNorm statistics sum
# in other orders, through 9 to 11 GroupNorms).
LOGIT_TOL, GRAD_TOL = 5e-5, 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(model, shape, seed=1):
    """Random weights in the flax tree of ``model``: kernels ~ N(0,
    1/fan_in), GroupNorm scales 1 + N(0, 0.1²), biases N(0, 0.1²)."""
    rng = np.random.default_rng(seed)
    tree = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                          jnp.zeros(shape))["params"]

    def leaf(path, z):
        name = path[-1].key
        if name == "kernel":
            std = 1.0 / np.sqrt(np.prod(z.shape[:-1]))
            return rng.normal(0, std, z.shape).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + rng.normal(0, 0.1, z.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _port(model, params):
    state, adapters = from_jax_params(params)
    assert adapters == {} and set(state) == set(model.state_dict())
    model.load_state_dict(state)
    return model


def _loss_and_grads(jmodel, params, tmodel, x, y):
    def jloss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(x))
        return jnp.mean(-jax.nn.log_softmax(logits)[jnp.arange(len(y)), y])

    jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
    tmodel.zero_grad()
    logits = tmodel(torch.from_numpy(x))
    loss = softmax_ce(logits, torch.from_numpy(y)).mean()
    loss.backward()
    tg = to_jax_params({k: p.grad for k, p in tmodel.named_parameters()})
    return (logits.detach().numpy(), loss.item(),
            np.asarray(jax.jit(jmodel.apply)({"params": params},
                                             jnp.asarray(x))),
            float(jl), tg, jax.tree.map(np.asarray, jg))


CASES = {
    # name: (JAX model, port model, input shape)
    "resnet10_gn": (lambda: jax_create_model("resnet10_gn", num_classes=10),
                    lambda: create_model("resnet10_gn", num_classes=10,
                                         device="cpu"), (2, 8, 8, 3)),
    "narrow_small_input": (
        lambda: JaxResNetGN(stage_sizes=(1, 1), block="bottleneck",
                            num_classes=10),
        lambda: ResNetGN(stage_sizes=(1, 1), block="bottleneck",
                         num_classes=10), (2, 8, 8, 3)),
    "narrow_imagenet_stem": (
        lambda: JaxResNetGN(stage_sizes=(1, 1), block="basic",
                            num_classes=10, small_input=False),
        lambda: ResNetGN(stage_sizes=(1, 1), block="basic", num_classes=10,
                         small_input=False), (2, 16, 16, 3)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_gradient_match_flax(case):
    """Logits, the mean CE and every parameter's gradient against flax's
    (``narrow_imagenet_stem``: the 7×7 stride-2 stem padded 3 and the
    3×3 max-pool at stride 2 padded 1)."""
    jbuild, tbuild, shape = CASES[case]
    jmodel = jbuild()
    params = _jax_params(jmodel, shape)
    tmodel = _port(tbuild(), params)
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32)
    y = rng.randint(0, 10, shape[0]).astype(np.int64)
    got, loss, want, jloss, tg, jg = _loss_and_grads(jmodel, params, tmodel,
                                                     x, y)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL * scale)
    assert loss == pytest.approx(jloss, rel=1e-5)
    assert jax.tree.structure(tg) == jax.tree.structure(jg)
    for path, w in jax.tree_util.tree_leaves_with_path(jg):
        g = dict(jax.tree_util.tree_leaves_with_path(tg))[path]
        np.testing.assert_allclose(
            g, w, rtol=0, atol=GRAD_TOL * max(float(np.abs(w).max()), 1e-6),
            err_msg=jax.tree_util.keystr(path))


def test_factories_follow_the_jax_tree():
    """Every factory's state dict is the flax tree's, one to one; ResNet-18
    has 20 GroupNorms (the stem, 16 in the blocks, 3 downsamples) of 32
    groups; ``dtype`` and ``norm`` are swallowed as JAX's factories
    swallow them (f32, GroupNorm)."""
    for name in ("resnet10_gn", "resnet18_gn", "resnet50_gn"):
        jtree = jax.eval_shape(jax_create_model(name).init,
                               jax.random.PRNGKey(0),
                               jnp.zeros((1, 8, 8, 3)))["params"]
        model = create_model(name, device="cpu", dtype="bf16", norm="bn")
        want = {k: tuple(v.shape) for k, v in from_jax_params(
            jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                         jtree))[0].items()}
        assert {k: tuple(v.shape) for k, v in
                model.state_dict().items()} == want, name
        assert not list(model.buffers())
    norms = [m for m in create_model("resnet18_gn", device="cpu").modules()
             if isinstance(m, Norm)]
    assert len(norms) == 20
    assert {m.num_groups for m in norms} == {32}


def test_fedavg_rounds_of_resnet10_gn_match_jax():
    """2 rounds of 3 of 5 clients, each client one batch of 8×8 images (a
    shuffle only reorders a batch, which GroupNorm and the masked mean
    loss do not see), sgd lr 0.01: params within 2e-5 of JAX's (an update
    of ~1e-2), train losses within 1e-5, the held-out eval as JAX's."""
    counts, batch = (4, 3, 4, 2, 4), 4
    rng = np.random.RandomState(0)
    n = sum(counts)
    x = rng.randn(n, 8, 8, 3).astype(np.float32)
    y = rng.randint(0, 10, n).astype(np.int32)
    edges = np.concatenate([[0], np.cumsum(counts)])
    parts = {i: np.arange(edges[i], edges[i + 1]) for i in range(5)}
    cfg = dict(client_num_in_total=5, client_num_per_round=3, comm_round=2,
               epochs=1, batch_size=batch, lr=0.01, frequency_of_the_test=1)
    xt, yt = x[:8], y[:8]
    japi = JaxFedAvgAPI(jax_create_model("resnet10_gn", num_classes=10),
                        jax_batching.build_federated_arrays(x, y, parts,
                                                            batch),
                        jax_batching.batch_global(xt, yt, 8),
                        JaxFedConfig(**cfg))
    start = jax.tree.map(np.asarray, japi.net.params)
    jhist = japi.train()
    from fedml_tpu_torch.data.batching import batch_global
    api = FedAvgAPI(create_model("resnet10_gn", num_classes=10, device="cpu"),
                    build_federated_arrays(x, y, parts, batch, device="cpu"),
                    batch_global(xt, yt, 8, device="cpu"), FedConfig(**cfg),
                    device="cpu")
    api.net = NetState(from_jax_params(start)[0], {})
    hist = api.train()
    moved = max(np.abs(np.asarray(a) - b).max() for a, b in zip(
        jax.tree.leaves(japi.net.params), jax.tree.leaves(start)))
    assert moved > 1e-3
    got = to_jax_params(api.net.params)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(japi.net.params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=2e-5)
    for h, j in zip(hist, jhist):
        np.testing.assert_allclose(h["train_loss"], j["train_loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(h["loss"], j["loss"], rtol=1e-5)
        assert h["accuracy"] == pytest.approx(j["accuracy"])


# ResNet-18-GN's GroupNorms at 32 x 32 input: (positions, channels).
R18_GN = [(1024, 64), (256, 128), (64, 256), (16, 512)]


@pytest.mark.parametrize("s,c", R18_GN)
def test_group_norm_at_resnet18_widths_matches_jax(s, c):
    """y and the gradients in x, γ and β through the port's op (the plain
    twin on the CPU) against JAX's Pallas GroupNorm in interpret mode, f32,
    32 groups (2 to 16 channels a group), 3 samples: within 1e-5 of each
    output's scale."""
    rng = np.random.RandomState(c)
    x = (rng.randn(3, s, c) * 1.5 + 0.3).astype(np.float32)
    g = (1 + 0.1 * rng.randn(c)).astype(np.float32)
    b = (0.1 * rng.randn(c)).astype(np.float32)
    dy = rng.randn(3, s, c).astype(np.float32)

    def jf(x, g, b):
        return jnp.sum(jax_group_norm(x, g, b, 32, 1e-6) * dy)

    jy = np.asarray(jax_group_norm(jnp.asarray(x), g, b, 32, 1e-6))
    jgrads = jax.grad(jf, argnums=(0, 1, 2))(jnp.asarray(x), g, b)
    tx, tg, tb = (torch.tensor(a, requires_grad=True) for a in (x, g, b))
    ty = group_norm(tx, tg, tb, 32)
    (ty * torch.from_numpy(dy)).sum().backward()
    for got, want in ((ty.detach(), jy), (tx.grad, jgrads[0]),
                      (tg.grad, jgrads[1]), (tb.grad, jgrads[2])):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()))
