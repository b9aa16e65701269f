"""BatchNorm where the port refused it before (``ROADMAP.md`` A2's tail):
the DARTS search net under FedNAS, the MNIST GAN's BatchNorm1d generator
under FedGAN, and the trained-state carry of FedGKT, SplitNN,
``DecentralizedAPI`` and TurboAggregate, each against the JAX package's
class from the same start (params and ``batch_stats`` carried across);
the four state carries over tiny conv-BatchNorm nets defined here in both
packages.

Every client packs one batch (one real step an epoch), so the epoch
shuffle only permutes a batch within itself: BatchNorm's batch
statistics and the batch's mean loss do not depend on it. The rounds run
at lr 1e-3: small BN ResNets amplify f32 rounding (``ROADMAP.md`` §C), and
at this lr it stays small against the update. Params and running stats
are compared within 1e-5 (absolute) unless a test states otherwise."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from fedml_tpu.algos.config import FedConfig as JaxFedConfig
from fedml_tpu.algos.decentralized import DecentralizedAPI as JaxDecentralized
from fedml_tpu.algos.fedgan import make_gan_local_train as jax_gan_train
from fedml_tpu.algos.fedgkt import FedGKTAPI as JaxFedGKTAPI
from fedml_tpu.algos.fednas import \
    make_fednas_local_search as jax_fednas_search
from fedml_tpu.algos.split_nn import SplitNNAPI as JaxSplitNNAPI
from fedml_tpu.algos.turboaggregate import \
    TurboAggregateAPI as JaxTurboAggregateAPI
from fedml_tpu.core import topology as jax_topology
from fedml_tpu.data import batching as jax_batching
from fedml_tpu.models import darts as jd
from fedml_tpu.models.gan import MNISTGan as JaxMNISTGan
from fedml_tpu.trainer.local import NetState as JaxNetState
from fedml_tpu.trainer.local import model_fns as jax_model_fns
from fedml_tpu_torch.algos import (DecentralizedAPI, FedConfig, FedGanAPI,
                                   FedGKTAPI, SplitNNAPI, TurboAggregateAPI)
from fedml_tpu_torch.algos.fedgan import make_gan_local_train
from fedml_tpu_torch.algos.fednas import make_fednas_local_search
from fedml_tpu_torch.convert import (from_jax_params, stacked_to_jax_params,
                                     to_jax_params)
from fedml_tpu_torch.core import topology
from fedml_tpu_torch.core.tree import client_rows
from fedml_tpu_torch.data import build_federated_arrays
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models.cnn import dense
from fedml_tpu_torch.models.resnet import BatchNorm, Conv
from fedml_tpu_torch.parallel.shard import client_rngs
from fedml_tpu_torch.trainer.local import NetState, model_fns

TOL = 1e-5
K = 4  # classes
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _task(counts, side=8, seed=0):
    """Random images, a client per count."""
    rng = np.random.RandomState(seed)
    n = sum(counts)
    x = rng.randn(n, side, side, 3).astype(np.float32)
    y = rng.randint(0, K, n).astype(np.int32)
    edges = np.concatenate([[0], np.cumsum(counts)])
    return x, y, {i: np.arange(edges[i], edges[i + 1])
                  for i in range(len(counts))}


def _feds(x, y, parts, batch):
    return (build_federated_arrays(x, y, parts, batch, device="cpu"),
            jax_batching.build_federated_arrays(x, y, parts, batch))


def _jnet(net: NetState, stacked=False):
    """A port NetState (params, BatchNorm buffers) as JAX's."""
    conv = stacked_to_jax_params if stacked else to_jax_params
    state = {"batch_stats": jax.tree.map(jnp.asarray,
                                         conv(net.model_state))} \
        if net.model_state else {}
    return JaxNetState(jax.tree.map(jnp.asarray, conv(net.params)), state)


def _close(got: dict, want, tol=TOL, stacked=False):
    """Port leaves ``{name: tensor}`` against a JAX tree, leaf by leaf."""
    conv = stacked_to_jax_params if stacked else to_jax_params
    got = dict(jax.tree_util.tree_leaves_with_path(conv(got)))
    want = jax.tree_util.tree_leaves_with_path(_np(want))
    assert len(got) == len(want) > 0
    for path, w in want:
        np.testing.assert_allclose(got[path], w, rtol=0, atol=tol,
                                   err_msg=jax.tree_util.keystr(path))


def _moved(before: dict, after: dict):
    return any(not torch.equal(before[k], after[k]) for k in before)


# --- tiny BatchNorm nets in both packages ------------------------------------------
# Conv(3x3, SAME, no bias) -> BatchNorm(momentum 0.9) -> relu, then the
# spatial mean and a Dense: the state carry is the point here, and at these
# sizes JAX's compiles stay short.


def _jbn(x, train):
    return fnn.BatchNorm(use_running_average=not train, momentum=0.9)(x)


class JaxStump(fnn.Module):
    """FedGKT's client net: ``(logits, features)``, NHWC."""

    num_classes: int = K

    @fnn.compact
    def __call__(self, x, train: bool = False):
        f = fnn.relu(_jbn(fnn.Conv(4, (3, 3), padding="SAME",
                                   use_bias=False)(x), train))
        return fnn.Dense(self.num_classes)(jnp.mean(f, axis=(1, 2))), f


class JaxHead(fnn.Module):
    """A conv-BN-Dense classifier: FedGKT's tail, SplitNN's top, and the
    model of DecentralizedAPI and TurboAggregate."""

    num_classes: int = K

    @fnn.compact
    def __call__(self, x, train: bool = False):
        h = fnn.relu(_jbn(fnn.Conv(4, (3, 3), padding="SAME",
                                   use_bias=False)(x), train))
        return fnn.Dense(self.num_classes)(jnp.mean(h, axis=(1, 2)))


class JaxBottom(fnn.Module):
    """SplitNN's bottom: the activations, NHWC."""

    @fnn.compact
    def __call__(self, x, train: bool = False):
        return fnn.relu(_jbn(fnn.Conv(4, (3, 3), padding="SAME",
                                      use_bias=False)(x), train))


class _ConvBN(nn.Module):
    def __init__(self, cin, gen):
        super().__init__()
        self.Conv_0 = Conv(cin, 4, 3, 1, 1, generator=gen)
        self.BatchNorm_0 = BatchNorm(4)

    def features(self, x):  # NCHW
        return F.relu(self.BatchNorm_0(self.Conv_0(x)))


class Stump(_ConvBN):
    num_classes = K

    def __init__(self, gen):
        super().__init__(3, gen)
        self.Dense_0 = dense(4, K, gen)

    def forward(self, x):  # NHWC in; NCHW features out
        f = self.features(x.permute(0, 3, 1, 2))
        return self.Dense_0(f.mean(dim=(2, 3))), f


class Head(_ConvBN):
    """``nhwc``: the input is an NHWC image (else NCHW features)."""

    def __init__(self, cin, gen, nhwc):
        super().__init__(cin, gen)
        self.Dense_0 = dense(4, K, gen)
        self.nhwc = nhwc

    def forward(self, x):
        h = self.features(x.permute(0, 3, 1, 2) if self.nhwc else x)
        return self.Dense_0(h.mean(dim=(2, 3)))


class Bottom(_ConvBN):
    def __init__(self, gen):
        super().__init__(3, gen)

    def forward(self, x):
        return self.features(x.permute(0, 3, 1, 2))


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


# --- FedGKT and SplitNN ----------------------------------------------------------

def test_fedgkt_bn_round_matches_jax():
    """One FedGKT round over a BN stump and a BN tail (3 clients of one
    batch) from the port's start: the stumps and their running stats
    within 1e-5, every client's stats moved; the tail's stats within
    1e-5 and its params within 2 server_lr (Adam's normalized step turns
    round where a gradient is near 0, as ``test_torch_split.py`` holds
    it); the eval-mode sweep's features (the server's inputs) agree."""
    x, y, parts = _task((4, 4, 4))
    fed, jfed = _feds(x, y, parts, 4)
    cfg = dict(client_num_in_total=3, client_num_per_round=3, comm_round=1,
               epochs=1, batch_size=4, lr=LR)
    api = FedGKTAPI(Stump(_gen(0)), Head(4, _gen(1), nhwc=False), fed, None,
                    FedConfig(**cfg), server_lr=LR, device="cpu")
    japi = JaxFedGKTAPI(JaxStump(), JaxHead(), jfed, None,
                        JaxFedConfig(**cfg), server_lr=LR)
    japi.client_nets = _jnet(api.client_nets, stacked=True)
    japi.server_net = _jnet(api.server_net)
    before = {k: v.clone() for k, v in api.client_nets.model_state.items()}
    top0 = {k: v.clone() for k, v in api.server_net.model_state.items()}
    assert before and all(v.shape[0] == 3 for v in before.values())
    m = api.train_one_round(0)
    jm = japi.train_one_round(0)
    for k in ("client_loss", "server_loss"):
        assert m[k] == pytest.approx(jm[k], rel=1e-5), k
    _close(api.client_nets.params, japi.client_nets.params, stacked=True)
    _close(api.client_nets.model_state,
           japi.client_nets.model_state["batch_stats"], stacked=True)
    for k, v in before.items():
        assert all(not torch.equal(v[c], api.client_nets.model_state[k][c])
                   for c in range(3)), k
    _close(api.server_net.model_state,
           japi.server_net.model_state["batch_stats"])
    assert _moved(top0, api.server_net.model_state)
    _close(api.server_net.params, japi.server_net.params, tol=2 * LR)
    np.testing.assert_allclose(api.server_logits.numpy(),
                               np.asarray(japi.server_logits), rtol=0,
                               atol=2 * LR)


def test_split_nn_bn_cycle_matches_jax():
    """One relay cycle of SplitNN over a BN bottom and a BN top (3 clients
    of one batch) from the port's start: each client's bottom and its
    running stats, the top and its stats within 1e-5; every client's
    stats moved and the dustbin row untouched."""
    x, y, parts = _task((4, 4, 4))
    fed, jfed = _feds(x, y, parts, 4)
    cfg = dict(client_num_in_total=3, client_num_per_round=3, comm_round=1,
               epochs=1, batch_size=4, lr=LR)
    api = SplitNNAPI(Bottom(_gen(2)), Head(4, _gen(3), nhwc=False), fed,
                     None, FedConfig(**cfg), device="cpu")
    japi = JaxSplitNNAPI(JaxBottom(), JaxHead(), jfed, None,
                         JaxFedConfig(**cfg))
    japi.client_nets = _jnet(NetState(client_rows(api.client_nets.params),
                                      client_rows(
                                          api.client_nets.model_state)),
                             stacked=True)
    japi.server_net = _jnet(api.server_net)
    state0 = {k: v.clone() for k, v in api.client_nets.model_state.items()}
    top0 = {k: v.clone() for k, v in api.server_net.model_state.items()}
    loss = api.train_one_epoch(0)["train_loss"]
    jloss = japi.train_one_epoch(0)["train_loss"]
    assert loss == pytest.approx(jloss, rel=1e-5)
    _close(client_rows(api.client_nets.params), japi.client_nets.params,
           stacked=True)
    _close(client_rows(api.client_nets.model_state),
           japi.client_nets.model_state["batch_stats"], stacked=True)
    _close(api.server_net.params, japi.server_net.params)
    _close(api.server_net.model_state,
           japi.server_net.model_state["batch_stats"])
    for k, v in state0.items():
        now = api.client_nets.model_state[k]
        assert torch.equal(now[3], v[3])  # the dustbin
        assert all(not torch.equal(now[c], v[c]) for c in range(3)), k
    assert _moved(top0, api.server_net.model_state)


# --- DecentralizedAPI and TurboAggregate -------------------------------------------

@pytest.mark.parametrize("mode", ["dsgd", "pushsum"])
def test_decentralized_bn_rounds_match_jax(mode):
    """2 gossip rounds over the BN classifier (6 clients of one batch):
    every client's params and running stats within 1e-5 of JAX's (the
    stats gossiped, and under PushSum de-biased, as JAX treats the whole
    ``NetState``), the stats moved; the consensus net's stats equal
    JAX's."""
    x, y, parts = _task((4,) * 6)
    fed, jfed = _feds(x, y, parts, 4)
    cfg = dict(client_num_in_total=6, client_num_per_round=6, comm_round=2,
               epochs=1, batch_size=4, lr=LR)
    api = DecentralizedAPI(Head(3, _gen(4), nhwc=True), fed, None,
                           FedConfig(**cfg),
                           topology.SymmetricTopologyManager(6, 2),
                           mode=mode, device="cpu")
    japi = JaxDecentralized(JaxHead(), jfed, None, JaxFedConfig(**cfg),
                            jax_topology.SymmetricTopologyManager(6, 2),
                            mode=mode)
    japi.nets = _jnet(api.nets, stacked=True)
    before = {k: v.clone() for k, v in api.nets.model_state.items()}
    for r in range(2):
        assert api.train_one_round(r)["train_loss"] == pytest.approx(
            japi.train_one_round(r)["train_loss"], rel=1e-5)
    _close(api.nets.params, japi.nets.params, stacked=True)
    _close(api.nets.model_state, japi.nets.model_state["batch_stats"],
           stacked=True)
    assert _moved(before, api.nets.model_state)
    _close(api.consensus_net().model_state,
           japi.consensus_net().model_state["batch_stats"])


def test_turboaggregate_bn_rounds_match_jax():
    """2 TurboAggregate rounds over the BN classifier (4 of 6 clients of
    one batch): the MPC aggregates the running stats with the params (JAX
    ravels the whole ``NetState``); both within 1e-5 plus the protocol's
    quantization (0.5/2^16 per client and value) of JAX's, the stats
    moved."""
    x, y, parts = _task((4,) * 6)
    fed, jfed = _feds(x, y, parts, 4)
    cfg = dict(client_num_in_total=6, client_num_per_round=4, comm_round=2,
               epochs=1, batch_size=4, lr=LR)
    api = TurboAggregateAPI(Head(3, _gen(5), nhwc=True), fed, None,
                            FedConfig(**cfg), n_groups=3, device="cpu")
    japi = JaxTurboAggregateAPI(JaxHead(), jfed, None, JaxFedConfig(**cfg),
                                n_groups=3)
    japi.net = _jnet(api.net)
    before = {k: v.clone() for k, v in api.net.model_state.items()}
    for r in range(2):
        assert api.train_one_round(r)["train_loss"] == pytest.approx(
            japi.train_one_round(r)["train_loss"], rel=1e-5)
    tol = TOL + 4 * 0.5 / 2 ** 16
    _close(api.net.params, japi.net.params, tol=tol)
    _close(api.net.model_state, japi.net.model_state["batch_stats"], tol=tol)
    assert _moved(before, api.net.model_state)


# --- FedNAS over the BatchNorm DARTS net --------------------------------------------

def test_fednas_bn_local_search_matches_jax():
    """FedNAS's bilevel local search over ``darts(norm="bn")`` (one normal
    cell of c 2: JAX's compile dominates; one client of 2 packed steps, an
    architecture step and a weight step; the search draws no random
    numbers) from the port's start against JAX's, first order: the loss
    within 1e-5 relative, weights, alphas and running
    stats within 1e-5; the stats are those of the weight step's forward
    alone (JAX threads them so), and moved."""
    net = dict(c=2, layers=1, steps=1, multiplier=1, num_classes=K)
    x, y, parts = _task((4,))
    fed, jfed = _feds(x, y, parts, 2)
    model = create_model("darts", norm="bn", device="cpu",
                         generator=torch.Generator().manual_seed(0), **net)
    fns = model_fns(model)
    start = fns.init()
    assert start.model_state
    jfns = jax_model_fns(jd.DartsNetwork(norm="bn", **net))
    out, loss = make_fednas_local_search(fns.apply, 0.05, 0.01, 0.0, 1,
                                         False)(
        start, fed.x[0], fed.y[0], fed.mask[0], torch.tensor(0))
    jout, jloss = jax.jit(jax_fednas_search(jfns.apply, 0.05, 0.01, 0.0, 1,
                                            False))(
        _jnet(start), jfed.x[0], jfed.y[0], jfed.mask[0],
        jax.random.PRNGKey(0))
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    _close(out.params, jout.params)
    _close(out.model_state, jout.model_state["batch_stats"])
    assert _moved(start.model_state, out.model_state)


# --- FedGAN over the BatchNorm1d generator ------------------------------------------

LATENT = 100


def _jax_draws(rng, mask, epochs):
    """JAX's permutations and noise for one local train, in the order the
    port's seams are called (``test_torch_gan.py``'s)."""
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


def test_fedgan_bn_local_train_matches_jax_fed_its_draws():
    """One client's GAN local step (4 samples) with the BatchNorm1d
    generator, JAX's noise and permutation through the seams: the loss
    within 1e-5 relative; the generator's running stats within 1e-5 and
    moved (both of its train-mode forwards, D's fake batch and then G's
    own, update them); the params as ``test_torch_gan.py`` holds them
    (Adam's first normalized step is ±lr, and turns round where a
    gradient is near 0: every element within 2 lr, all but 1 in 2000
    within 1e-4 of the net's largest update: batch statistics of 4
    samples leave many small gradients, and 295 of the 1.5 M generator
    elements turn here). The biases of the Denses in
    front of a BatchNorm are held to 2 lr only: the norm subtracts them,
    so their gradient is 0 in exact arithmetic and f32 rounding noise in
    both packages, which Adam normalizes into steps of any size up to
    lr."""
    rng = np.random.RandomState(1)
    model = create_model("mnist_gan", norm="bn", device="cpu",
                         generator=torch.Generator().manual_seed(0))
    net = NetState({k: v.detach().clone()
                    for k, v in model.named_parameters()},
                   {k: v.clone() for k, v in model.named_buffers()})
    x = np.tanh(rng.randn(1, 4, 28, 28, 1)).astype(np.float32)
    mask = np.ones((1, 4), np.float32)
    key = jax.random.PRNGKey(3)
    jnet, jloss = jax_gan_train(JaxMNISTGan(norm="bn"), LR, 1, LATENT)(
        _jnet(net), jnp.asarray(x), jnp.zeros((1, 4)), jnp.asarray(mask),
        key)
    perms, noise = (iter(d) for d in _jax_draws(key, mask, 1))
    train = make_gan_local_train(
        model, LR, 1, LATENT,
        noise=lambda k, shape: torch.tensor(next(noise)),
        perm=lambda m, k: torch.tensor(next(perms), dtype=torch.long))
    out, loss = train(net, torch.from_numpy(x), None,
                      torch.from_numpy(mask), torch.tensor(0))
    assert next(noise, None) is None and next(perms, None) is None
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    _close(out.model_state, jnet.model_state["batch_stats"])
    assert _moved(net.model_state, out.model_state)
    want = from_jax_params(_np(jnet.params))[0]
    noise_only = {f"netg.Dense_{i}.bias" for i in (1, 2, 3)}
    for prefix in ("netg.", "netd."):
        names = [k for k in want if k.startswith(prefix)]
        upd = max((want[k] - net.params[k]).abs().max().item()
                  for k in names)
        diff = torch.cat([(out.params[k] - want[k]).abs().flatten()
                          for k in names])
        assert upd > 0 and diff.max().item() <= 2 * LR
        held = torch.cat([(out.params[k] - want[k]).abs().flatten()
                          for k in names if k not in noise_only])
        assert (held > 1e-4 * upd).sum().item() <= held.numel() / 2000


def test_fedgan_bn_round_averages_the_generator_stats():
    """A FedGAN round with the BatchNorm1d generator: the global running
    stats move, and equal the sample-weighted mean of the cohort's
    trained stats (FedAvg's mean of the whole net); ``generate`` reads
    them in eval mode (deterministic for a key)."""
    rng = np.random.RandomState(0)
    counts = (4, 4, 4)
    x = np.tanh(rng.randn(sum(counts), 28, 28, 1)).astype(np.float32)
    y = np.zeros(sum(counts), np.int32)
    edges = np.concatenate([[0], np.cumsum(counts)])
    parts = {i: np.arange(edges[i], edges[i + 1]) for i in range(3)}
    fed = build_federated_arrays(x, y, parts, 4, device="cpu")
    cfg = FedConfig(client_num_in_total=3, client_num_per_round=3,
                    comm_round=1, epochs=1, batch_size=4, lr=LR)
    api = FedGanAPI(create_model("mnist_gan", norm="bn", device="cpu",
                                 generator=torch.Generator().manual_seed(0)),
                    fed, cfg, device="cpu")
    start = NetState(dict(api.net.params), dict(api.net.model_state))
    key = torch.tensor(5)
    nets, _ = api.local_train.run_clients(
        start, fed.x, fed.y, fed.mask, client_rngs(key, 3))
    w = fed.counts.float() / fed.counts.float().sum()
    avg, _ = api.round_fn(start, fed.x, fed.y, fed.mask, fed.counts.float(),
                          fed.counts.float(), key)
    for k, v in nets.model_state.items():
        torch.testing.assert_close(avg.model_state[k],
                                   torch.einsum("c,c...->...", w, v))
        assert not torch.equal(avg.model_state[k], start.model_state[k])
    api.net = avg
    k = torch.tensor(9)
    assert torch.equal(api.generate(4, k), api.generate(4, k))
