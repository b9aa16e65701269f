"""DP-SGD and its zCDP accounting in the port (``fedml_tpu_torch/core/
privacy.py``, ``trainer/local.py``) against the JAX package.

The accountant's functions are pure Python and must give JAX's values
exactly. The DP step is held to JAX's ``make_local_train_fn(...,
dp_clip=)`` within 1e-5 relative in f32, from JAX's weights (carried by
``convert.from_jax_params``), on data that is one batch a client (the two
packages' shuffles then only reorder a batch), with JAX's own noise: the
test computes JAX's per-leaf draws ``jax.random.normal(split(noise_rng,
n_leaves)[i], shape)`` for every client, epoch and step, and hands them to
the port through its ``dp_noise`` seam, keyed by the port's noise key of
the same step (:func:`noise_seam`). JAX orders the leaves as flax does,
the port by state-dict name; ``from_jax_params`` maps them. Also the
repaired fault (``CentralizedTrainer`` honoring ``dp_clip``), and the
port's mirror of ``tests/test_privacy.py``'s four DP cases.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fedml_tpu.algos.centralized import CentralizedTrainer as JaxCentral
from fedml_tpu.algos.config import FedConfig as JaxConfig
from fedml_tpu.core import privacy as jax_privacy
from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu.trainer.local import NetState as JaxNetState
from fedml_tpu.trainer.local import make_local_train_fn as jax_make_local
from fedml_tpu.trainer.local import model_fns as jax_model_fns
from fedml_tpu_torch.algos import CentralizedTrainer, FedAvgAPI, FedConfig
from fedml_tpu_torch.convert import from_jax_params
from fedml_tpu_torch.core import keys, privacy
from fedml_tpu_torch.data import (batch_global, build_federated_arrays,
                                  make_classification, partition_homo)
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models.resnet import CifarResNet
from fedml_tpu_torch.trainer.local import (make_client_optimizer,
                                           make_local_train_fn, model_fns)

WIDTHS = (4, 8, 16)
RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- the accountant ----------------------------------------------------------

@pytest.mark.parametrize("call", [
    ("zcdp_of_gaussian", (1.1,)), ("zcdp_of_gaussian", (0.0,)),
    ("zcdp_of_gaussian", (0.37,)), ("zcdp_to_eps", (0.5, 1e-5)),
    ("zcdp_to_eps", (math.inf, 1e-5)), ("zcdp_to_eps", (3.7, 0.3)),
    ("dp_sgd_epsilon", (1.1, 1, 8, 100, 1e-5)),
    ("dp_sgd_epsilon", (0.5, 5, 79, 2, 1e-6)),
])
def test_privacy_functions_equal_jax(call):
    name, args = call
    assert getattr(privacy, name)(*args) == getattr(jax_privacy, name)(*args)


def test_accountant_composes_as_jax():
    a, b = privacy.PrivacyAccountant(), jax_privacy.PrivacyAccountant()
    for z, steps in ((1.1, 8), (0.7, 3), (2.0, 1)):
        assert a.step(z, steps=steps) is a
        b.step(z, steps=steps)
        assert a.rho == b.rho
        for delta in (1e-5, 1e-3):
            assert a.epsilon(delta) == b.epsilon(delta)
    with pytest.raises(ValueError, match="delta"):
        privacy.zcdp_to_eps(0.5, 0.0)


# --- JAX's draws through the seam --------------------------------------------

def _port_noise_keys(client_rng, epochs: int, n_steps: int):
    """The port's DP noise key of each (epoch, step) of a client's local
    training from its key (``LocalTrain._epochs``): ``[..., E, S]``."""
    pair = keys.split(client_rng)
    epoch_keys = keys.split(pair[..., 1], epochs)
    s = torch.arange(n_steps)
    step_base = keys.fold_in(epoch_keys, 1)[..., None]
    return keys.fold_in(keys.fold_in(step_base, s), 1)


@functools.lru_cache(maxsize=None)
def _jax_draw_fn(epochs: int, n_steps: int, shapes):
    """JAX's noise of every (epoch, step) of a client's local training as
    one jitted function of the client's key (compiled once per layout)."""

    @jax.jit
    def draws(rng):
        _, shuffle_rng = jax.random.split(rng)
        out = []
        for epoch_rng in jax.random.split(shuffle_rng, epochs):
            step_base = jax.random.fold_in(epoch_rng, 1)
            for s in range(n_steps):
                noise_rng = jax.random.fold_in(
                    jax.random.fold_in(step_base, s), 1)
                ks = jax.random.split(noise_rng, len(shapes))
                out.append([jax.random.normal(k, shape, dtype)
                            for k, (shape, dtype) in zip(ks, shapes)])
        return out

    return draws


def _jax_draws(client_rng, epochs: int, n_steps: int, jparams):
    """JAX's per-leaf normals of each (epoch, step) of a client's local
    training (``make_local_train_fn``): ``[(e, s, {flax tree})]``."""
    leaves, treedef = jax.tree.flatten(jparams)
    shapes = tuple((tuple(l.shape), np.dtype(l.dtype)) for l in leaves)
    trees = _jax_draw_fn(epochs, n_steps, shapes)(client_rng)
    return [(i // n_steps, i % n_steps,
             jax.tree.unflatten(treedef, [np.asarray(d) for d in tree]))
            for i, tree in enumerate(trees)]


def noise_seam(port_keys, jax_trees):
    """A ``dp_noise`` seam that returns, for the port's noise key of a
    step, JAX's draws of the same step (``port_keys [K]`` beside
    ``jax_trees``, K flax trees). The lookup is a masked sum over the
    table, so it runs under the cohort's ``vmap``: exactly one row
    matches, and x + 0 is x."""
    table_keys = port_keys.reshape(-1)
    states = [from_jax_params(t)[0] for t in jax_trees]
    table = {name: torch.stack([st[name] for st in states])
             for name in states[0]}

    def seam(noise_key, grads):
        match = (table_keys == noise_key).float()
        return {name: torch.tensordot(match, table[name], dims=1).to(g.dtype)
                for name, g in grads.items()}

    return seam


def _lr_task(n_clients=3, n=6, d=5, k=3, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n_clients, 1, n, d).astype(np.float32)
    y = rng.randint(0, k, size=(n_clients, 1, n)).astype(np.int32)
    mask = np.ones((n_clients, 1, n), np.float32)
    if n_clients > 1:
        mask[1, 0, 4:] = 0.0  # a short client: masked examples are inert
    return x, y, mask


def _jax_lr(d, k, seed=0):
    module = jax_create_model("lr", num_classes=k)
    return module, module.init(jax.random.PRNGKey(seed),
                               jnp.zeros((1, d)))["params"]


def _jax_resnet(seed=1):
    from fedml_tpu.models.resnet import CifarResNet as JaxCifarResNet

    module = JaxCifarResNet(layers=(1, 1, 1), widths=WIDTHS, num_classes=3)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 8, 8, 3)))["params"]
    rng = np.random.default_rng(seed)

    def leaf(path, z):
        name = path[-1].key
        if name == "kernel":
            std = 1.0 / np.sqrt(np.prod(z.shape[:-1]))
            return rng.normal(0, std, z.shape).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + rng.normal(0, 0.1, z.shape)).astype(np.float32)

    return module, jax.tree_util.tree_map_with_path(leaf, shapes)


def _port_model(name, jparams, **kw):
    model = create_model(name, device="cpu", **kw)
    state, _ = from_jax_params(jax.tree.map(np.asarray, jparams))
    model.load_state_dict(state)
    return model


def _assert_tree_close(port_params, jparams, rtol=RTOL):
    want, _ = from_jax_params(jax.tree.map(np.asarray, jparams))
    for name, w in want.items():
        w = np.asarray(w)
        got = port_params[name].detach().numpy()
        np.testing.assert_allclose(got, w, rtol=rtol,
                                   atol=rtol * np.abs(w).max(), err_msg=name)


def _dp_case(model_name):
    if model_name == "lr":
        x, y, mask = _lr_task()
        module, jparams = _jax_lr(x.shape[-1], 3)
        port = _port_model("lr", jparams, in_features=x.shape[-1],
                           num_classes=3)
    else:
        rng = np.random.RandomState(2)
        x = rng.randn(2, 1, 4, 8, 8, 3).astype(np.float32)
        y = rng.randint(0, 3, size=(2, 1, 4)).astype(np.int32)
        mask = np.ones((2, 1, 4), np.float32)
        mask[1, 0, 3] = 0.0
        module, jparams = _jax_resnet()
        port = CifarResNet(layers=(1, 1, 1), widths=WIDTHS, num_classes=3)
        port.load_state_dict(from_jax_params(
            jax.tree.map(np.asarray, jparams))[0])
    return x, y, mask, module, jparams, port


@pytest.mark.parametrize("model_name,cohort", [
    ("lr", False), ("lr", True), ("resnet", False)])
def test_dp_steps_equal_jax_given_its_draws(model_name, cohort):
    """Clipped per-example gradients, their masked sum, JAX's noise and
    the mean: the port's DP-SGD steps (2 epochs) equal JAX's within 1e-5
    relative, one client or the whole cohort under ``vmap``."""
    x, y, mask, module, jparams, port = _dp_case(model_name)
    clip, z, lr, epochs = 0.5, 1.1, 0.3, 2
    jtrain = jax.jit(jax_make_local(
        jax_model_fns(module).apply, optax.sgd(lr), epochs, dp_clip=clip,
        dp_noise_multiplier=z))
    jnet0 = JaxNetState(params=jparams, model_state={})
    clients = range(x.shape[0]) if cohort else range(1)
    jkeys = [jax.random.PRNGKey(10 + c) for c in clients]
    pkeys = torch.stack([keys.key(10 + c) for c in clients])
    table_keys, trees = [], []
    for c, jk in zip(clients, jkeys):
        pk = _port_noise_keys(pkeys[c], epochs, 1)
        for e, s, tree in _jax_draws(jk, epochs, 1, jparams):
            table_keys.append(pk[e, s])
            trees.append(tree)
    fns = model_fns(port)
    lt = make_local_train_fn(fns.apply, make_client_optimizer("sgd", lr),
                             epochs, dp_clip=clip, dp_noise_multiplier=z,
                             dp_noise=noise_seam(torch.stack(table_keys),
                                                 trees))
    net = fns.init()
    tx, ty, tm = (torch.from_numpy(a) for a in (x, y, mask))
    ty = ty.long()
    if cohort:
        got, got_losses = lt.run_clients(net, tx, ty, tm, pkeys)
    for c, jk in zip(clients, jkeys):
        jnet, jloss = jtrain(jnet0, x[c], y[c], mask[c], jk)
        if cohort:
            params = {k: v[c] for k, v in got.params.items()}
            loss = got_losses[c]
        else:
            one, loss = lt(net, tx[c], ty[c], tm[c], pkeys[c])
            params = one.params
        _assert_tree_close(params, jnet.params)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)


def test_dp_fedavg_rounds_equal_jax_given_its_draws(monkeypatch):
    """Two FedAvg rounds under DP-SGD, full participation, each client one
    batch: the port's rounds (the cohort under ``vmap``) against JAX's
    FedAvgAPI, JAX's noise carried through the seam."""
    from fedml_tpu.algos import FedAvgAPI as JaxFedAvg
    from fedml_tpu.data.batching import \
        build_federated_arrays as jax_build_arrays

    import fedml_tpu_torch.algos.fedavg as port_fedavg
    from fedml_tpu_torch.trainer import local as port_local

    x, y = make_classification(24, n_features=5, n_classes=3, seed=4)
    parts = partition_homo(len(x), 3)
    cfg = dict(client_num_in_total=3, client_num_per_round=3, epochs=2,
               batch_size=8, lr=0.3, seed=5, dp_clip=0.5,
               dp_noise_multiplier=1.1)
    jfed = jax_build_arrays(x, y, parts, 8)
    module = jax_create_model("lr", num_classes=3)
    japi = JaxFedAvg(module, jfed, None, JaxConfig(**cfg))
    jparams0 = jax.tree.map(np.asarray, japi.net.params)
    # The round keys of both packages, and JAX's draws of every step.
    jrng, prng = japi.rng, keys.split(keys.key(5))[0]
    table_keys, trees = [], []
    for _ in range(2):
        jrng, jrnd = jax.random.split(jrng)
        pair = keys.split(prng)
        prng, prnd = pair[0], pair[1]
        for c in range(3):
            pk = _port_noise_keys(keys.fold_in(prnd, c), 2, 1)
            for e, s, tree in _jax_draws(jax.random.fold_in(jrnd, c), 2, 1,
                                         jparams0):
                table_keys.append(pk[e, s])
                trees.append(tree)
    seam = noise_seam(torch.stack(table_keys), trees)
    monkeypatch.setattr(
        port_fedavg, "make_local_train_fn_from_cfg",
        lambda *a, **kw: port_local.make_local_train_fn_from_cfg(
            *a, dp_noise=seam, **kw))
    fed = build_federated_arrays(x, y, parts, 8, device="cpu")
    api = FedAvgAPI(_port_model("lr", jparams0, in_features=5,
                                num_classes=3),
                    fed, None, FedConfig(**cfg), device="cpu")
    for r in range(2):
        jm = japi.train_one_round(r)
        pm = api.train_one_round(r)
        np.testing.assert_allclose(pm["train_loss"], jm["train_loss"],
                                   rtol=RTOL)
        _assert_tree_close(api.net.params, japi.net.params)


# --- the repaired fault ------------------------------------------------------

def test_centralized_trainer_honors_dp_clip():
    """The port's CentralizedTrainer built its trainer without the config's
    DP fields, so ``dp_clip`` silently trained plain SGD; it now builds
    through ``make_local_train_fn_from_cfg``, as JAX's does, and its DP
    steps equal JAX's (no noise; one batch, so the shuffles only reorder
    it)."""
    x, y, _ = _lr_task(n_clients=1, n=12)
    x, y = x[0, 0], y[0, 0]
    cfg = dict(epochs=3, lr=1.0, batch_size=12, dp_clip=0.05)
    module = jax_create_model("lr", num_classes=3)
    jt = JaxCentral(module, JaxConfig(**cfg))
    jt.init_params(jnp.asarray(x[:1]))
    from fedml_tpu.data.batching import batch_global as jax_batch_global

    pt = CentralizedTrainer(
        _port_model("lr", jt.net.params, in_features=5, num_classes=3),
        FedConfig(**cfg), device="cpu")
    jloss = jt.train(*jax_batch_global(x, y, 12))
    pt.init_params()
    start = {k: v.clone() for k, v in pt.net.params.items()}
    ploss = pt.train(*batch_global(x, y, 12, device="cpu"))
    np.testing.assert_allclose(ploss, jloss, rtol=RTOL)
    _assert_tree_close(pt.net.params, jt.net.params)
    # Each DP step moves the params by at most lr · clip.
    step = math.sqrt(sum(float(((pt.net.params[k] - start[k]) ** 2).sum())
                         for k in start))
    assert 0 < step <= cfg["epochs"] * cfg["lr"] * cfg["dp_clip"] + 1e-6


# --- the port's mirror of tests/test_privacy.py ------------------------------

def _setup(n=32, d=8, k=4, seed=0):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(1, n, d).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, k, size=(1, n)).astype(np.int64))
    mask = torch.ones(1, n)
    model = create_model("lr", in_features=d, num_classes=k, device="cpu",
                         generator=torch.Generator().manual_seed(seed))
    fns = model_fns(model)
    return fns, fns.init(), x, y, mask


def _norm(a, b):
    return math.sqrt(sum(float(((a[k] - b[k]) ** 2).sum()) for k in a))


def _case_huge_clip_is_plain_sgd():
    fns, net, x, y, mask = _setup()
    opt = make_client_optimizer("sgd", 0.5)
    plain = make_local_train_fn(fns.apply, opt, 2)
    dp = make_local_train_fn(fns.apply, opt, 2, dp_clip=1e9)
    key = keys.key(1)
    net_p, loss_p = plain(net, x, y, mask, key)
    net_d, loss_d = dp(net, x, y, mask, key)
    np.testing.assert_allclose(float(loss_p), float(loss_d), rtol=1e-5)
    for k in net_p.params:
        np.testing.assert_allclose(net_p.params[k], net_d.params[k],
                                   rtol=1e-4, atol=1e-6)


def _case_clip_bounds_update_norm():
    fns, net, x, y, mask = _setup()
    clip, lr = 0.05, 1.0
    dp = make_local_train_fn(fns.apply, make_client_optimizer("sgd", lr), 1,
                             dp_clip=clip)
    net2, _ = dp(net, x, y, mask, keys.key(0))
    assert 0.0 < _norm(net2.params, net.params) <= lr * clip + 1e-6


def _case_masked_examples_inert():
    fns, net, x, y, mask = _setup()
    mask[0, 0] = 0.0
    hostile = x.clone()
    hostile[0, 0] = 1e6
    dp = make_local_train_fn(fns.apply, make_client_optimizer("sgd", 0.5), 1,
                             dp_clip=1.0)
    net_a, _ = dp(net, x, y, mask, keys.key(2))
    net_b, _ = dp(net, hostile, y, mask, keys.key(2))
    for k in net_a.params:
        np.testing.assert_allclose(net_a.params[k], net_b.params[k],
                                   rtol=1e-5, atol=1e-7)


def _case_noise_changes_with_key_and_trains():
    fns, net, x, y, mask = _setup()
    dp = make_local_train_fn(fns.apply, make_client_optimizer("sgd", 0.5), 1,
                             dp_clip=1.0, dp_noise_multiplier=0.5)
    a, _ = dp(net, x, y, mask, keys.key(3))
    b, _ = dp(net, x, y, mask, keys.key(4))
    c, _ = dp(net, x, y, mask, keys.key(3))
    assert _norm(a.params, b.params) > 0
    assert _norm(a.params, c.params) == 0
    # Moderate noise still learns an easy task through FedAvgAPI.
    xs, ys = make_classification(480, n_features=8, n_classes=2, seed=3)
    fed = build_federated_arrays(xs, ys, partition_homo(len(xs), 4), 32,
                                 device="cpu")
    cfg = FedConfig(client_num_in_total=4, client_num_per_round=4,
                    comm_round=8, epochs=1, batch_size=32, lr=0.5,
                    dp_clip=1.0, dp_noise_multiplier=0.3)
    api = FedAvgAPI(create_model("lr", in_features=8, num_classes=2,
                                 device="cpu",
                                 generator=torch.Generator().manual_seed(0)),
                    fed, batch_global(xs, ys, 32, device="cpu"), cfg,
                    device="cpu")
    for r in range(cfg.comm_round):
        api.train_one_round(r)
    assert api.evaluate()["accuracy"] > 0.8


@pytest.mark.parametrize("case", [
    _case_huge_clip_is_plain_sgd, _case_clip_bounds_update_norm,
    _case_masked_examples_inert, _case_noise_changes_with_key_and_trains],
    ids=["huge_clip_plain_sgd", "clip_bounds_update", "masked_inert",
         "noise_by_key"])
def test_dp_cases_of_the_jax_suite(case):
    case()


def test_all_masked_step_is_a_noop_without_noise():
    """An all-masked DP step leaves the net as it was: no noise is added
    where no sample is (the masked-step gate)."""
    fns, net, x, y, mask = _setup()
    dp = make_local_train_fn(fns.apply, make_client_optimizer("sgd", 0.5), 1,
                             dp_clip=1.0, dp_noise_multiplier=5.0)
    out, _ = dp(net, x, y, torch.zeros_like(mask), keys.key(0))
    for k in net.params:
        assert torch.equal(out.params[k], net.params[k])


def test_dp_refusals_keep_jax_words():
    """DP noise with a compute layout, and DP on the corrected-SGD
    algorithms, are refused as JAX refuses them."""
    from fedml_tpu_torch.algos import FedDynAPI, ScaffoldAPI

    xs, ys = make_classification(48, n_features=8, n_classes=2, seed=3)
    fed = build_federated_arrays(xs, ys, partition_homo(len(xs), 4), 8,
                                 device="cpu")

    def model():
        return create_model("lr", in_features=8, num_classes=2,
                            device="cpu")

    base = dict(client_num_in_total=4, client_num_per_round=2, batch_size=8)
    with pytest.raises(NotImplementedError, match="DP noise"):
        FedAvgAPI(model(), fed, None,
                  FedConfig(**base, compute_layout="auto", dp_clip=1.0,
                            dp_noise_multiplier=0.5), device="cpu")
    for cls in (ScaffoldAPI, FedDynAPI):
        for field in ("dp_clip", "dp_noise_multiplier"):
            with pytest.raises(ValueError, match=f"does not support: {field}"):
                cls(model(), fed, None, FedConfig(**base, **{field: 1.0}),
                    device="cpu")
