"""The port's FedGAN slice — ``models/gan.py`` and ``algos/fedgan.py`` —
against the JAX package on the same seeded numpy inputs and weights: the
generator, the discriminator and the joint net; a local D/G train fed
JAX's noise and epoch permutations through the trainer's seams (the
random streams differ by design, ROADMAP.md §C); the round as the joint
sample-weighted mean of both nets; the tiers agreeing; ``generate``; the
refusals."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algos.fedgan import make_gan_local_train as jax_gan_train
from fedml_tpu.models.gan import MNISTGan as JaxMNISTGan
from fedml_tpu.trainer.local import NetState as JaxNetState
from fedml_tpu_torch.algos import FedConfig, FedGanAPI
from fedml_tpu_torch.algos.fedgan import make_gan_local_train
from fedml_tpu_torch.convert import from_jax_params, to_jax_params
from fedml_tpu_torch.core import keys
from fedml_tpu_torch.core.tree import tree_weighted_mean
from fedml_tpu_torch.data import build_federated_arrays
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.parallel.shard import client_rngs
from fedml_tpu_torch.trainer.local import NetState

LATENT = 100
LR = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _model(seed=0):
    return create_model("mnist_gan", device="cpu",
                        generator=torch.Generator().manual_seed(seed))


def _carried(model):
    """The port GAN's seeded weights as a flax tree (``netg``/``netd``),
    after checking flax's structure and shapes."""
    shapes = jax.eval_shape(JaxMNISTGan().init, jax.random.PRNGKey(0),
                            jnp.zeros((2, LATENT)))["params"]
    params = to_jax_params(model.state_dict())
    assert jax.tree.structure(params) == jax.tree.structure(shapes)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(shapes)):
        assert a.shape == b.shape
    return params


def test_gan_nets_match_flax():
    """``generate`` ([B, 28, 28, 1], tanh), ``discriminate`` (logits) and
    the joint forward within 1e-5 of the largest value (f32; LayerNorm at
    eps 1e-6)."""
    model = _model()
    params = _carried(model)
    jmod = JaxMNISTGan()
    rng = np.random.RandomState(0)
    z = rng.randn(4, LATENT).astype(np.float32)
    img = np.tanh(rng.randn(4, 28, 28, 1)).astype(np.float32)
    v = {"params": params}
    with torch.no_grad():
        for got, want in (
                (model.generate(torch.from_numpy(z)),
                 jmod.apply(v, z, method=jmod.generate)),
                (model.discriminate(torch.from_numpy(img)),
                 jmod.apply(v, img, method=jmod.discriminate)),
                (model(torch.from_numpy(z)), jmod.apply(v, z))):
            want = np.asarray(want)
            assert tuple(got.shape) == want.shape
            assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(
                want).max()
    assert model.netg.LayerNorm_0.weight.shape == (256,)


def _jax_draws(rng, mask, epochs):
    """JAX's permutations and noise for one local train, in the order the
    port's seams are called: per epoch the permutation, then per step D's
    noise and G's (``fedml_tpu/algos/fedgan.py``'s key chain)."""
    s, b = mask.shape
    _, shuffle_rng = jax.random.split(rng)
    perms, noise = [], []
    for epoch_rng in jax.random.split(shuffle_rng, epochs):
        ek = jax.random.fold_in(epoch_rng, 0)
        u = jax.vmap(lambda i: jax.random.uniform(jax.random.fold_in(ek, i)))(
            jnp.arange(s * b))
        perms.append(np.asarray(jnp.argsort(u + (1.0 - mask.reshape(-1))
                                            * 2.0)))
        base = jax.random.fold_in(epoch_rng, 1)
        for idx in range(s):
            per_step = jax.random.fold_in(base, idx)
            for which in (0, 1):
                noise.append(np.asarray(jax.random.normal(
                    jax.random.fold_in(per_step, which), (b, LATENT))))
    return perms, noise


def test_local_train_matches_jax_fed_its_draws():
    """One client, 2 epochs of 3 steps of 4 with a padded tail (10 real
    samples): the loss within 1e-5 relative; per net, the params within
    1e-4 of the net's largest update except at most 1 element in 10⁴,
    and every element within 2·lr. Adam divides by √ν: where a gradient
    is near zero its summation order flips the normalized step (27 of
    the 2.2 M elements here, up to 3e-5 against updates of 1.2e-3)."""
    rng = np.random.RandomState(1)
    s, b, epochs = 3, 4, 2
    x = np.tanh(rng.randn(s, b, 28, 28, 1)).astype(np.float32)
    mask = np.ones((s, b), np.float32)
    mask[2, 2:] = 0.0
    model = _model()
    params = _carried(model)
    key = jax.random.PRNGKey(3)
    jnet, jloss = jax.jit(jax_gan_train(JaxMNISTGan(), LR, epochs, LATENT))(
        JaxNetState(params, {}), jnp.asarray(x), jnp.zeros((s, b)),
        jnp.asarray(mask), key)
    perms, noise = _jax_draws(key, mask, epochs)
    perms, noise = iter(perms), iter(noise)
    train = make_gan_local_train(
        model, LR, epochs, LATENT,
        noise=lambda k, shape: torch.tensor(next(noise)),
        perm=lambda m, k: torch.tensor(next(perms), dtype=torch.long))
    start = from_jax_params(params)[0]
    net, loss = train(NetState(dict(start), {}), torch.from_numpy(x), None,
                      torch.from_numpy(mask), torch.tensor(0))
    want = from_jax_params(_np(jnet.params))[0]
    for net_name in ("netg.", "netd."):
        keys = [k for k in want if k.startswith(net_name)]
        upd = max((want[k] - start[k]).abs().max().item() for k in keys)
        diff = torch.cat([(net.params[k] - want[k]).abs().flatten()
                          for k in keys])
        assert upd > 0 and diff.max().item() <= 2 * LR
        assert (diff > 1e-4 * upd).sum().item() <= 1e-4 * diff.numel()
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert next(noise, None) is None and next(perms, None) is None


def _gan_task(counts=(9, 5, 12, 7), seed=0):
    rng = np.random.RandomState(seed)
    x = np.tanh(rng.randn(sum(counts), 28, 28, 1)).astype(np.float32)
    y = np.zeros(len(x), np.int32)
    edges = np.concatenate([[0], np.cumsum(counts)])
    parts = {i: np.arange(edges[i], edges[i + 1]) for i in range(len(counts))}
    return x, y, parts


def _api(per_round=3, **kw):
    x, y, parts = _gan_task()
    cfg = FedConfig(client_num_in_total=4, client_num_per_round=per_round,
                    comm_round=2, epochs=1, batch_size=4, lr=LR, **kw)
    return FedGanAPI(_model(), build_federated_arrays(x, y, parts, 4,
                                                      device="cpu"),
                     cfg, device="cpu")


def test_round_is_the_joint_mean_of_both_nets():
    """One ``train_one_round`` equals the sample-weighted mean of the
    sampled clients' own local trains (their keys as the round folds
    them), the generator and the discriminator averaged together: within
    1e-4 of the largest update but for at most 1 element in 10³ (210 of
    2.0 M here: three clients' flips), every element within 2·lr."""
    api = _api()
    start, rng0 = dict(api.net.params), api.rng.clone()
    api.train_one_round(0)
    got = dict(api.net.params)
    rnd = keys.split(rng0)[1]
    idx = api.sample_round(0)
    fed = api.train_fed
    rngs = client_rngs(rnd, len(idx))
    trained = [api.local_train(NetState(dict(start), {}), fed.x[c], fed.y[c],
                               fed.mask[c], rngs[i])[0].params
               for i, c in enumerate(idx)]
    stacked = {k: torch.stack([t[k] for t in trained]) for k in start}
    want = tree_weighted_mean(stacked, fed.counts[torch.as_tensor(idx)]
                              .float())
    # The cohort's vmapped step and one client's step sum in other orders,
    # which Adam's normalized step amplifies where a gradient is near zero
    # (as in the test above): the same bounds.
    upd = max((want[k] - start[k]).abs().max().item() for k in want)
    diff = torch.cat([(got[k] - want[k]).abs().flatten() for k in want])
    assert diff.max().item() <= 2 * LR
    assert (diff > 1e-4 * upd).sum().item() <= 1e-3 * diff.numel()
    assert any(not torch.equal(got[k], start[k]) for k in got
               if k.startswith("netg."))
    assert any(not torch.equal(got[k], start[k]) for k in got
               if k.startswith("netd."))


def test_tiers_agree_and_generate():
    """2 ``train_one_round`` rounds and ``train_rounds_pipelined(2)`` from
    one start bit-equal; at full participation ``train_rounds_on_device``
    bit-equal to eager rounds; ``generate(16)`` gives ``[16, 28, 28, 1]``
    in [−1, 1], the same for the same key; ``evaluate`` is {}."""
    api = _api()
    start, rng0 = dict(api.net.params), api.rng.clone()
    losses = [api.train_one_round(r)["train_loss"] for r in range(2)]
    one = dict(api.net.params)
    api.net, api.rng = NetState(dict(start), {}), rng0.clone()
    assert api.train_rounds_pipelined(2) == losses
    assert all(torch.equal(one[k], api.net.params[k]) for k in one)
    full = _api(per_round=4)
    full.net, full.rng = NetState(dict(start), {}), rng0.clone()
    dev = full.train_rounds_on_device(2).tolist()
    dev_net = dict(full.net.params)
    full.net, full.rng = NetState(dict(start), {}), rng0.clone()
    full.sample_round = lambda r: np.arange(4)
    eager = []
    for r in range(2):
        avg, loss = full.run_round(r)
        full.net = full._server_update(full.net, avg)
        eager.append(loss.item())
    assert dev == eager
    assert all(torch.equal(dev_net[k], full.net.params[k]) for k in dev_net)
    img = full.generate(16)
    assert img.shape == (16, 28, 28, 1) and float(img.abs().max()) <= 1.0
    key = full.rng.clone()
    assert torch.equal(full.generate(4, key), full.generate(4, key))
    assert full.evaluate() == {}


def test_refusals(monkeypatch):
    """``norm='bn'`` builds the BatchNorm1d generator (its running stats
    the model's buffers) and an unknown norm is refused; a non-sgd client
    optimizer, gradient clipping and the compute knobs are refused as JAX
    refuses them; without a CUDA device the model and the class raise
    unless asked for the CPU."""
    bn = create_model("mnist_gan", norm="bn", device="cpu")
    assert sorted(k for k, _ in bn.named_buffers()) == sorted(
        f"netg.BatchNorm_{i}.{s}" for i in range(3) for s in ("mean", "var"))
    with pytest.raises(ValueError, match="unknown norm"):
        create_model("mnist_gan", norm="gn", device="cpu")
    with pytest.raises(ValueError, match="compress"):
        _api(compress="topk0.1")
    with pytest.raises(NotImplementedError, match="own local trainer"):
        _api(compute_layout="auto")
    for kw, what in ((dict(client_optimizer="adam"), "plain SGD"),
                     (dict(grad_clip=1.0), "grad_clip")):
        with pytest.raises(ValueError, match=what):
            _api(**kw)
    x, y, parts = _gan_task()
    fed = build_federated_arrays(x, y, parts, 4, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model("mnist_gan")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FedGanAPI(_model(), fed, FedConfig(client_num_in_total=4,
                                            batch_size=4))
