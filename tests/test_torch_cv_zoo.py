"""The cross-silo CV zoo of the port (``models/mobilenet.py``,
``vgg.py``, ``mobilenet_v3.py``, ``efficientnet.py``) against the JAX
package's flax modules on the same seeded numpy inputs and weights (the
flax tree carried across by ``convert.from_jax_params``):

- each block (``DepthwiseSeparable``, ``SqueezeExcite``, ``MobileBlock``
  at stride 1 and 2 with k 3 and 5, ``MBConv`` with and without its
  expansion and residual), its output and the gradient of a fixed
  projection of it, at odd and even sides, which pins flax's SAME padding
  at stride 2 ((0, 1) for k 3 and (1, 2) for k 5 on an even side);
- each whole model (``mobilenet`` α 0.25, ``vgg11`` and ``vgg11_gn`` with
  a 64-wide classifier, ``vgg11_bn`` with its ``batch_stats`` carried in,
  ``mobilenet_v3`` SMALL and LARGE, ``efficientnet`` b0): the logits in
  eval mode, and the loss and gradients of one train-mode step with the
  dropout rates at 0 (and, for ``vgg11_bn``, the new ``batch_stats``);
- one FedAvg round of a two-block MobileNet against JAX's ``FedAvgAPI``
  on ``tests/test_torch_algos.py``'s replicated task at lr 1e-3;
- the masks, which are the port's counter-hash draws (``core.keys``), not
  threefry's: a fixed key gives the same masks, two keys give others, the
  kept share is near 1 − rate, and drop-connect keeps or drops whole
  samples.

The JAX side runs jitted: at these sizes a compile takes a few seconds,
where op-by-op dispatch (one compile per op and shape) takes ~20 s for
``mobilenet_v3``'s forward and ~70 s for its gradient (a jit at full
width takes ~30 s). VGG's five pools need 32×32 inputs.
Tolerances, f32: outputs and logits within 2e-5 of max |want|, losses
within 1e-5, gradients within 1e-4 of each leaf's max |want| (the convs,
the GroupNorm statistics and the global means sum in other orders,
through up to 50 norms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call, grad_and_value, vmap

import fedml_tpu.models.efficientnet as jax_eff
from fedml_tpu.algos.config import FedConfig as JaxFedConfig
from fedml_tpu.algos.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.data import batching as jax_batching
from fedml_tpu.models.mobilenet import DepthwiseSeparable as JaxDepthwise
from fedml_tpu.models.mobilenet import MobileNetV1 as JaxMobileNetV1
from fedml_tpu.models.mobilenet_v3 import MobileBlock as JaxMobileBlock
from fedml_tpu.models.mobilenet_v3 import SqueezeExcite as JaxSqueezeExcite
from fedml_tpu.models.registry import create_model as jax_create_model
from fedml_tpu_torch.algos import FedAvgAPI, FedConfig
from fedml_tpu_torch.convert import from_jax_params, to_jax_params
from fedml_tpu_torch.core import keys
from fedml_tpu_torch.data import build_federated_arrays
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models import efficientnet as port_eff
from fedml_tpu_torch.models.efficientnet import MBConv, drop_connect
from fedml_tpu_torch.models.mobilenet import DepthwiseSeparable, MobileNetV1
from fedml_tpu_torch.models.mobilenet_v3 import MobileBlock, SqueezeExcite
from fedml_tpu_torch.trainer.local import NetState, model_fns
from test_torch_algos import _replicated_task

# Blocks: outputs within 2e-5 of max |want|, gradients within 1e-4 of
# each leaf's max |want|. Whole models: logits within 1e-4 and gradients
# within 1e-3 (losses within 1e-5): JAX itself moves its logits by up to
# 3.6e-5 and its gradients by up to 2.1e-4 of these scales when the input
# is perturbed by 1e-7 (relative), through up to 50 GroupNorms.
OUT_TOL, GRAD_TOL = 2e-5, 1e-4
LOGIT_TOL, LOSS_TOL, MODEL_GRAD_TOL = 1e-4, 1e-5, 1e-3
# A conv bias before BatchNorm has an exact gradient of 0 in train mode:
# both packages' rounding noise stays below this share of the largest
# gradient.
ZERO_GRAD = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_vars(module, x, seed=1):
    """Random variables in the flax tree of ``module`` at input ``x``:
    kernels ~ N(0, 1/fan_in) (a depthwise ``[k, k, 1, c]`` has fan-in k²),
    norm scales 1 + N(0, 0.1²), biases and running means N(0, 0.1²),
    running variances 1 + U(0, 0.5)."""
    rng = np.random.default_rng(seed)
    tree = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                          jnp.asarray(x))

    def leaf(path, z):
        name = path[-1].key
        if name == "kernel":
            std = 1.0 / np.sqrt(np.prod(z.shape[:-1]))
            return rng.normal(0, std, z.shape).astype(np.float32)
        if name == "var":
            return (1.0 + rng.uniform(0, 0.5, z.shape)).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + rng.normal(0, 0.1, z.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, dict(tree))


def _carry(model, variables):
    """``model`` with the flax variables loaded (strict: every name)."""
    state = from_jax_params(variables["params"])[0]
    if "batch_stats" in variables:
        state.update(from_jax_params(variables["batch_stats"])[0])
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    return model


def _close(got, want, tol):
    if torch.is_tensor(got):
        got = got.detach().numpy()
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


def _close_trees(got, want, tol, zero=()):
    """Leaf by leaf within ``tol`` of the leaf's max |want|; the leaves
    named in ``zero`` (exact gradient 0) below ``ZERO_GRAD`` of the
    tree's largest entry in both."""
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert set(flat_got) == set(flat_want)
    top = max(float(np.abs(w).max()) for w in flat_want.values())
    for k, w in flat_want.items():
        if jax.tree_util.keystr(k) in zero:
            for t in (flat_got[k], w):
                assert float(np.abs(t).max()) <= ZERO_GRAD * top
        else:
            _close(flat_got[k], w, tol)


# --- the blocks -------------------------------------------------------------

def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _block_holds(jblock, block, x, train=False):
    """The block's output in both packages, and the gradient of
    Σ out · proj with respect to the input and every param."""
    variables = _jax_vars(jblock, x)
    _carry(block, variables)
    want = jax.jit(jblock.apply, static_argnums=2)(variables, jnp.asarray(x),
                                                   train)
    proj = np.random.default_rng(7).normal(size=want.shape).astype(
        np.float32)

    def jloss(p, xi):
        out = jblock.apply({**variables, "params": p}, xi, train)
        return (out * proj).sum()

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(variables["params"],
                                                       jnp.asarray(x))
    block.train(train)
    params = dict(block.named_parameters())

    def loss(p, xi):
        out = functional_call(block, p, (xi.permute(0, 3, 1, 2),))
        return (out.permute(0, 2, 3, 1) * torch.from_numpy(proj)).sum(), out

    (g, gx), out = torch.func.grad(loss, argnums=(0, 1), has_aux=True)(
        params, torch.from_numpy(x))
    _close(out.permute(0, 2, 3, 1).detach(), want, OUT_TOL)
    _close(gx, jgx, GRAD_TOL)
    _close_trees(to_jax_params(g), jax.tree.map(np.asarray, jg), GRAD_TOL)


@pytest.mark.parametrize("side", [7, 8])
@pytest.mark.parametrize("strides", [1, 2])
def test_depthwise_separable_matches_flax(strides, side):
    x = np.random.RandomState(side).randn(2, side, side, 8).astype(
        np.float32)
    _block_holds(JaxDepthwise(out_ch=16, strides=strides),
                 DepthwiseSeparable(8, 16, strides), x)


def test_squeeze_excite_matches_flax():
    x = np.random.RandomState(3).randn(2, 5, 5, 16).astype(np.float32)
    variables = _jax_vars(JaxSqueezeExcite(), x)
    se = _carry(SqueezeExcite(16), variables)
    want = JaxSqueezeExcite().apply(variables, jnp.asarray(x))
    got = se(_nchw(x)).permute(0, 2, 3, 1).detach()
    _close(got, want, OUT_TOL)


# (kernel, expand, out, stride, SE, act, cin, side): k 3 and 5 at stride 1
# (the residual) and 2, on even and odd sides.
MOBILE_BLOCKS = [
    (3, 24, 8, 1, False, "RE", 8, 8),
    (5, 24, 16, 1, True, "HS", 8, 7),
    (3, 32, 16, 2, True, "HS", 8, 8),
    (5, 32, 16, 2, False, "RE", 8, 8),
    (5, 24, 16, 2, True, "HS", 8, 7),
    (3, 24, 16, 2, False, "HS", 8, 9),
]


@pytest.mark.parametrize("case", MOBILE_BLOCKS, ids=str)
def test_mobile_block_matches_flax(case):
    k, e, o, s, se, act, cin, side = case
    x = np.random.RandomState(side + k).randn(2, side, side, cin).astype(
        np.float32)
    _block_holds(JaxMobileBlock(k, e, o, s, se, act),
                 MobileBlock(cin, k, e, o, s, se, act), x)


# (cin, expand, out, kernel, stride, side): without expansion, with it,
# with and without the residual.
MBCONV_BLOCKS = [
    (8, 1, 8, 3, 1, 8),
    (8, 1, 16, 3, 1, 7),
    (8, 6, 8, 5, 1, 7),
    (8, 6, 16, 3, 2, 8),
    (8, 6, 16, 5, 2, 9),
]


@pytest.mark.parametrize("case", MBCONV_BLOCKS, ids=str)
def test_mbconv_matches_flax(case):
    """In train mode at drop rate 0 (the residual without its mask)."""
    cin, e, o, k, s, side = case
    x = np.random.RandomState(side + e).randn(2, side, side, cin).astype(
        np.float32)
    _block_holds(jax_eff.MBConv(e, o, k, s), MBConv(cin, e, o, k, s), x,
                 train=True)


# --- the whole models -----------------------------------------------------

def _jax_ce(logits, y):
    logp = jax.nn.log_softmax(logits)
    return -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=1))


def _model_holds(jmodel, model, x, y, bn=False, zero=()):
    """Eval logits, then one train-mode step: loss, gradients and (BN)
    the new running stats."""
    variables = _jax_vars(jmodel, x)
    _carry(model, variables)
    fns = model_fns(model)
    net = fns.init()
    xt, yt = torch.from_numpy(x), torch.from_numpy(y).long()
    want = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    got, _ = fns.apply(net, xt, train=False)
    _close(got.detach(), want, LOGIT_TOL)

    extra = {k: v for k, v in variables.items() if k != "params"}

    def jloss(p):
        out = jmodel.apply({"params": p, **extra}, jnp.asarray(x),
                           train=True, mutable=["batch_stats"] if bn
                           else False)
        logits, new = out if bn else (out, {})
        return _jax_ce(logits, jnp.asarray(y)), new

    (jl, jnew), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        variables["params"])
    key = keys.key(5)

    def loss(p):
        logits, state = fns.apply(NetState(p, net.model_state), xt,
                                  train=True, rng=key)
        return torch.nn.functional.cross_entropy(logits, yt), state

    g, (l, state) = grad_and_value(loss, has_aux=True)(net.params)
    np.testing.assert_allclose(float(l), float(jl), rtol=0, atol=LOSS_TOL)
    _close_trees(to_jax_params(g), jax.tree.map(np.asarray, jg),
                 MODEL_GRAD_TOL, zero)
    if bn:
        _close_trees(to_jax_params(state),
                     jax.tree.map(np.asarray, jnew["batch_stats"]), OUT_TOL)
    return state


def _inputs(side, classes, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(2, side, side, 3).astype(np.float32),
            rng.randint(0, classes, 2).astype(np.int32))


@pytest.mark.parametrize("side", [13, 16])
def test_mobilenet_matches_flax(side):
    x, y = _inputs(side, 10)
    _model_holds(jax_create_model("mobilenet", alpha=0.25),
                 create_model("mobilenet", alpha=0.25, device="cpu"), x, y)


def test_mobilenet_stem_stride_follows_input_height():
    """Stride 2 past 64 rows, picked when called (flax's ``x.shape[1] >
    64``), with the same weights at both sizes."""
    x, y = _inputs(66, 10)
    _model_holds(JaxMobileNetV1(alpha=0.25, plan=((16, 1),)),
                 MobileNetV1(alpha=0.25, plan=((16, 1),)), x, y)


@pytest.mark.parametrize("name", ["vgg11", "vgg11_gn"])
def test_vgg_matches_flax(name):
    x, y = _inputs(32, 10)
    kw = dict(classifier_width=64, dropout_rate=0.0)
    _model_holds(jax_create_model(name, **kw),
                 create_model(name, device="cpu", **kw), x, y)


def test_vgg11_bn_carries_batch_stats():
    """``vgg11_bn`` with random running stats carried in: eval logits on
    them, and the running stats after one train-mode step."""
    x, y = _inputs(32, 10)
    kw = dict(classifier_width=64, dropout_rate=0.0)
    model = create_model("vgg11_bn", device="cpu", **kw)
    conv_biases = {f"['Conv_{i}']['bias']" for i in range(8)}
    state = _model_holds(jax_create_model("vgg11_bn", **kw), model, x, y,
                         bn=True, zero=conv_biases)
    assert len(state) == 16 and all("BatchNorm_0" in k for k in state)


@pytest.mark.parametrize("mode", ["SMALL", "LARGE"])
def test_mobilenet_v3_matches_flax(mode):
    x, y = _inputs(16, 10)
    kw = dict(model_mode=mode, dropout_rate=0.0)
    _model_holds(jax_create_model("mobilenet_v3", **kw),
                 create_model("mobilenet_v3", device="cpu", **kw), x, y)


def test_mobilenet_v3_refuses_a_bad_mode():
    with pytest.raises(ValueError, match="LARGE or SMALL"):
        create_model("mobilenet_v3", model_mode="medium", device="cpu")


def test_efficientnet_b0_matches_flax(monkeypatch):
    """b0 with its head dropout (from the variant table) and drop-connect
    at 0 in both packages."""
    b0 = jax_eff._PARAMS["b0"][:3] + (0.0,)
    monkeypatch.setitem(jax_eff._PARAMS, "b0", b0)
    monkeypatch.setitem(port_eff.PARAMS, "b0", b0)
    x, y = _inputs(16, 10)
    model = create_model("efficientnet", drop_connect_rate=0.0, device="cpu")
    assert len(model.blocks) == 16
    _model_holds(jax_create_model("efficientnet", drop_connect_rate=0.0),
                 model, x, y)


def test_factories_keep_jax_defaults():
    """What ``create_model_for`` builds from ``num_classes`` alone: α 1
    with GroupNorm, LARGE, b0 with ``small_input`` and drop-connect 0.2;
    the VGG names' norms; a CUDA default that raises with no card."""
    m = create_model("mobilenet", device="cpu")
    assert m.Conv_0.weight.shape[0] == 32 and hasattr(m.Norm_0,
                                                      "GroupNorm_0")
    v3 = create_model("mobilenet_v3", device="cpu")
    assert v3.Conv_1.weight.shape[0] == 960 and v3.Conv_0.stride == 1
    eff = create_model("efficientnet", device="cpu")
    assert eff.Conv_0.stride == 1 and eff.MBConv_15.drop_rate == 0.2 * 15 / 16
    narrow = dict(classifier_width=64, device="cpu")
    assert not hasattr(create_model("vgg13", **narrow), "Norm_0")
    assert hasattr(create_model("vgg13_bn", **narrow).Norm_0, "BatchNorm_0")
    assert hasattr(create_model("vgg13_gn", **narrow).Norm_0, "GroupNorm_0")
    assert create_model("vgg13", device="cpu").Dense_1.weight.shape == (
        4096, 4096)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_model("mobilenet", alpha=0.25)


# --- FedAvg -----------------------------------------------------------------

def test_fedavg_round_matches_jax():
    """One round (2 epochs of batch 4, 4 of 6 clients) of a two-block
    MobileNet at α 0.25 on 16×16 replicated data, lr 1e-3, from JAX's
    start: params within 1e-4, loss within 1e-5, the params moved."""
    plan = ((64, 1), (128, 2))
    x, y, parts = _replicated_task(shape=(16, 16, 3))
    cfg = dict(client_num_in_total=6, client_num_per_round=4, comm_round=1,
               epochs=2, batch_size=4, lr=1e-3, frequency_of_the_test=100)
    japi = JaxFedAvgAPI(JaxMobileNetV1(num_classes=4, alpha=0.25, plan=plan),
                        jax_batching.build_federated_arrays(x, y, parts, 4),
                        None, JaxFedConfig(**cfg))
    api = FedAvgAPI(MobileNetV1(num_classes=4, alpha=0.25, plan=plan),
                    build_federated_arrays(x, y, parts, 4, device="cpu"),
                    None, FedConfig(**cfg), device="cpu")
    start = jax.tree.map(np.asarray, japi.net.params)
    api.net = NetState(from_jax_params(start)[0], {})
    la = api.train_one_round(0)["train_loss"]
    lb = japi.train_one_round(0)["train_loss"]
    jparams = jax.tree.map(np.asarray, japi.net.params)
    moved = max(np.abs(a - b).max() for a, b in zip(
        jax.tree.leaves(jparams), jax.tree.leaves(start)))
    assert moved > 1e-4
    for a, b in zip(jax.tree.leaves(to_jax_params(api.net.params)),
                    jax.tree.leaves(jparams)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    np.testing.assert_allclose(la, lb, rtol=0, atol=1e-5)


# --- the masks ------------------------------------------------------------

def _train_logits(model, x, key):
    fns = model_fns(model)
    return fns.apply(fns.init(), x, train=True, rng=key)[0]


@pytest.mark.parametrize("name,kw", [
    ("vgg11_gn", dict(classifier_width=64)),
    ("mobilenet_v3", dict(model_mode="SMALL")),
    ("efficientnet", {})])
def test_masks_follow_the_step_key(name, kw):
    """Train mode: one key gives the same logits twice, another key other
    logits; eval mode takes no key; train mode without one is refused."""
    model = create_model(name, device="cpu", **kw)
    x = torch.from_numpy(_inputs(32, 10)[0])
    a = _train_logits(model, x, keys.key(1))
    assert torch.equal(a, _train_logits(model, x, keys.key(1)))
    assert not torch.allclose(a, _train_logits(model, x, keys.key(2)))
    model.eval()
    assert torch.equal(model(x), model(x))
    model.train()
    with pytest.raises(ValueError, match="key"):
        model(x)


def test_drop_connect_drops_whole_samples_at_its_rate():
    y = torch.ones(4096, 3, 2, 2)
    rate = 0.25
    got = drop_connect(y, rate, keys.key(3))
    per = got.flatten(1)
    kept = (per == 1 / (1 - rate)).all(1)
    dropped = (per == 0).all(1)
    assert bool((kept | dropped).all())
    assert abs(kept.float().mean().item() - (1 - rate)) < 0.03
    assert torch.equal(got, drop_connect(y, rate, keys.key(3)))
    assert not torch.equal(got, drop_connect(y, rate, keys.key(4)))


def test_masks_differ_per_client_under_vmap():
    """Under the round's ``vmap`` each client's key draws its own
    drop-connect masks."""
    y = torch.ones(3, 64, 4, 1, 1)
    k = keys.fold_in(keys.key(0), torch.arange(3))
    got = vmap(lambda t, kk: drop_connect(t, 0.5, kk))(y, k)
    for c in range(3):
        assert torch.equal(got[c], drop_connect(y[c], 0.5, k[c]))
    assert not torch.equal(got[0], got[1])
