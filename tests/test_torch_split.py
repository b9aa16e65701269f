"""The port's model-split family — the split ResNets
(``models/resnet_split.py``), ``kl_loss`` and ``FedGKTAPI``,
``SplitNNAPI``, the VFL models and ``VflAPI`` — against the JAX package
on the same seeded numpy inputs and weights (JAX's, carried across with
``convert``), and their capability records and refusals against the JAX
package's support matrix (``docs/EXECUTION.md``).

Small GroupNorm ResNets amplify rounding in both packages (one-channel
groups at the 16-channel stem; ROADMAP.md §C), so the trainings run at
lr 1e-3 on 16×16 inputs and each FedGKT round starts from JAX's state.
FedGKT's rounds use data where each client holds copies of one sample:
the port's epoch shuffle draws from ``core/keys.py``, not threefry, and
with identical samples every permutation gives the same batches."""

import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from fedml_tpu.algos import capability as jax_capability
from fedml_tpu.algos.config import FedConfig as JaxFedConfig
from fedml_tpu.algos.fedgkt import FedGKTAPI as JaxFedGKTAPI
from fedml_tpu.algos.fedgkt import kl_loss as jax_kl_loss
from fedml_tpu.algos.split_nn import SplitNNAPI as JaxSplitNNAPI
from fedml_tpu.algos.vertical_fl import VflAPI as JaxVflAPI
from fedml_tpu.data import batching as jax_batching
from fedml_tpu.models.registry import create_model as jax_create_model
from fedml_tpu_torch.algos import FedConfig, FedGKTAPI, SplitNNAPI, VflAPI
from fedml_tpu_torch.algos.capability import record_for, refusal
from fedml_tpu_torch.algos.fedgkt import kl_loss
from fedml_tpu_torch.convert import (from_jax_params, stacked_from_jax_params,
                                     stacked_to_jax_params, to_jax_params,
                                     vfl_party_from_jax, vfl_party_to_jax)
from fedml_tpu_torch.core.tree import client_rows
from fedml_tpu_torch.data import build_federated_arrays
from fedml_tpu_torch.data.batching import batch_global
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models.resnet_split import stacked_init
from fedml_tpu_torch.trainer.local import NetState

K = 4  # classes
SIDE = 16  # input side: the features are [B, 16, 16, 16]
LR = 1e-3
SERVER_LR = 1e-3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree):
    """{flax path: numpy leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({(k,) + p: a for p, a in _flat(v).items()})
        else:
            out[(k,)] = np.asarray(v)
    return out


def _close(got, want, atol, rtol=0.0):
    """Two flax-shaped trees, leaf by leaf."""
    got, want = _flat(got), _flat(_np(want))
    assert sorted(got) == sorted(want)
    for p in got:
        np.testing.assert_allclose(got[p], want[p], rtol=rtol, atol=atol,
                                   err_msg="/".join(p))


def _max_diff(got, want):
    got, want = _flat(got), _flat(_np(want))
    return max(np.abs(got[p] - want[p]).max() for p in want)


# --- the split models against flax ------------------------------------------------

_STUMPS = ("resnet5_56", "resnet8_56", "resnet_split_bottom")
_TAILS = ("resnet20_server", "resnet56_server", "resnet110_server")


def _pair(name, sample):
    """(flax module, its params, the port's module with them loaded)."""
    kw = {} if name == "resnet_split_bottom" else dict(num_classes=K)
    jm = jax_create_model(name, **kw)
    jparams = _np(jm.init(jax.random.PRNGKey(0), jnp.asarray(sample))[
        "params"])
    tm = create_model(name, device="cpu", **kw)
    state, _ = from_jax_params(jparams)
    assert sorted(state) == sorted(dict(tm.named_parameters()))
    tm.load_state_dict(state)
    return jm, jparams, tm


@pytest.mark.parametrize("name", _STUMPS + _TAILS)
def test_split_model_forward_matches_flax(name):
    """Every split model's forward from converted flax params, at 8×8:
    the stump's logits and features (the port's features are JAX's NHWC
    through a permute, channels-last memory), the bottom's activations and
    the tails' logits from features, within 1e-4 of the output's scale
    (5e-4 for the 56- and 110-layer tails: 18 and 36 blocks of f32
    rounding compound through the one-channel groups of their first
    stage). ``norm="bn"`` raises, citing A2."""
    rng = np.random.RandomState(1)
    tail = name in _TAILS
    x = rng.randn(2, 8, 8, 16 if tail else 3).astype(np.float32)
    jm, jparams, tm = _pair(name, x)
    want = jm.apply({"params": jparams}, jnp.asarray(x))
    xt = torch.from_numpy(x)
    got = tm(xt.permute(0, 3, 1, 2) if tail else xt)
    if name in ("resnet5_56", "resnet8_56"):
        (got, feats), (want, jfeats) = got, want
        assert feats.shape == (2, 16, 8, 8)
        assert feats.permute(0, 2, 3, 1).is_contiguous()
        np.testing.assert_allclose(feats.permute(0, 2, 3, 1).detach().numpy(),
                                   np.asarray(jfeats), rtol=1e-4, atol=1e-5)
    if name == "resnet_split_bottom":
        got = got.permute(0, 2, 3, 1)
    scale = float(np.abs(np.asarray(want)).max())
    tol = 5e-4 if name in ("resnet56_server", "resnet110_server") else 1e-4
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=tol * scale)
    with pytest.raises(NotImplementedError, match="A2"):
        create_model(name, norm="bn", device="cpu")


def test_stump_and_tail_gradients_match_flax():
    """One loss through ``resnet5_56`` and ``resnet20_server`` (the
    tail's CE on the stump's features plus the stump's own CE): both
    parameter gradients against ``jax.grad`` within 5e-4 of each leaf's
    largest entry (the stem's gradient comes back through the tail's
    one-channel groups, which scale rounding by up to 1/sqrt(eps))."""
    rng = np.random.RandomState(2)
    x = rng.randn(4, 8, 8, 3).astype(np.float32)
    y = rng.randint(0, K, 4)
    js, jsp, ts = _pair("resnet5_56", x)
    feats = np.asarray(js.apply({"params": jsp}, jnp.asarray(x))[1])
    jt, jtp, tt = _pair("resnet20_server", feats)

    def jloss(sp, tp):
        logits, f = js.apply({"params": sp}, jnp.asarray(x))
        out = jt.apply({"params": tp}, f)
        oh = jax.nn.one_hot(y, K)
        return (-(oh * jax.nn.log_softmax(out)).sum(-1).mean()
                - (oh * jax.nn.log_softmax(logits)).sum(-1).mean())

    gs, gt = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jsp, jtp)
    logits, f = ts(torch.from_numpy(x))
    yt = torch.from_numpy(y)
    loss = (nn.functional.cross_entropy(tt(f), yt)
            + nn.functional.cross_entropy(logits, yt))
    loss.backward()
    for tm, jg in ((ts, gs), (tt, gt)):
        got = _flat(to_jax_params({k: p.grad for k, p in
                                   tm.named_parameters()}))
        for p, want in _flat(_np(jg)).items():
            np.testing.assert_allclose(got[p], want, rtol=0,
                                       atol=5e-4 * np.abs(want).max() + 1e-7,
                                       err_msg="/".join(p))


def test_stacked_conversion_round_trips():
    """A client-stacked flax tree through ``stacked_from_jax_params`` and
    back is itself; each row is that client's ``from_jax_params``."""
    rng = np.random.RandomState(3)
    stacked = {"Conv_0": {"kernel": rng.randn(3, 3, 3, 3, 16)},
               "Norm_0": {"GroupNorm_0": {"scale": rng.randn(3, 16),
                                          "bias": rng.randn(3, 16)}},
               "Dense_0": {"kernel": rng.randn(3, 16, K),
                           "bias": rng.randn(3, K)}}
    stacked = jax.tree.map(lambda a: a.astype(np.float32), stacked)
    port = stacked_from_jax_params(stacked)
    row1 = from_jax_params(jax.tree.map(lambda a: a[1], stacked))[0]
    for k, v in row1.items():
        assert torch.equal(port[k][1], v)
    _close(stacked_to_jax_params(port), stacked, atol=0)


def test_stacked_init_draws_each_client_apart():
    """``stacked_init``: each row its own lecun-normal draw (variance
    1/fan-in), GroupNorm scales 1 and biases 0."""
    tm = create_model("resnet5_56", num_classes=K, device="cpu")
    rows = stacked_init(tm, 6, torch.Generator().manual_seed(0))
    w = rows["BasicBlock_0.Conv_0.weight"]
    assert w.shape == (6, 16, 16, 3, 3)
    assert not torch.equal(w[0], w[1])
    assert abs(float(w.var()) * 16 * 9 - 1.0) < 0.1
    assert torch.equal(rows["Norm_0.GroupNorm_0.weight"], torch.ones(6, 16))
    assert torch.equal(rows["Dense_0.bias"], torch.zeros(6, K))


# --- kl_loss ------------------------------------------------------------------------

@pytest.mark.parametrize("t", [1.0, 3.0])
def test_kl_loss_matches_jax(t):
    """``kl_loss`` per example against JAX's within 1e-6, including two
    equal inputs, whose loss is ~1e-6 (the ``+ 1e-7``), not 0."""
    rng = np.random.RandomState(0)
    s = rng.randn(6, 5).astype(np.float32) * 3
    te = rng.randn(6, 5).astype(np.float32) * 3
    for a, b in ((s, te), (s, s)):
        want = np.asarray(jax_kl_loss(jnp.asarray(a), jnp.asarray(b), t))
        got = kl_loss(torch.from_numpy(a), torch.from_numpy(b), t).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    same = kl_loss(torch.from_numpy(s), torch.from_numpy(s), t)
    assert 0 < float(same.abs().max()) < 1e-4 * t * t


# --- FedGKT -------------------------------------------------------------------------

_GKT_COUNTS = (7, 4, 9, 2)
_GKT_BATCH = 4


def _replicated_images(counts, seed=0):
    """Client i holds ``counts[i]`` copies of one image with one label."""
    rng = np.random.RandomState(seed)
    protos = rng.randn(len(counts), SIDE, SIDE, 3).astype(np.float32)
    labels = rng.randint(0, K, len(counts)).astype(np.int32)
    x = np.concatenate([np.repeat(protos[i:i + 1], c, 0)
                        for i, c in enumerate(counts)])
    y = np.concatenate([np.full(c, labels[i], np.int32)
                        for i, c in enumerate(counts)])
    edges = np.concatenate([[0], np.cumsum(counts)])
    parts = {i: np.arange(edges[i], edges[i + 1])
             for i in range(len(counts))}
    return x, y, parts


def _gkt_cfg():
    return dict(client_num_in_total=len(_GKT_COUNTS),
                client_num_per_round=len(_GKT_COUNTS), comm_round=2,
                epochs=1, batch_size=_GKT_BATCH, lr=LR)


def _gkt_state(api):
    """JAX's FedGKT state as numpy: client stacks, server params, Adam
    (count, mu, nu), server logits, have_teacher."""
    adam = api.server_state[0]
    return dict(clients=_np(api.client_nets.params),
                server=_np(api.server_net.params),
                count=int(adam.count), mu=_np(adam.mu), nu=_np(adam.nu),
                logits=np.asarray(api.server_logits),
                have_teacher=api.have_teacher)


@pytest.fixture(scope="module")
def gkt_runs():
    """JAX's FedGKTAPI through rounds 0 and 1 on replicated images: the
    state before each round, the metrics and the state after it."""
    x, y, parts = _replicated_images(_GKT_COUNTS)
    api = JaxFedGKTAPI(jax_create_model("resnet5_56", num_classes=K),
                       jax_create_model("resnet20_server", num_classes=K),
                       jax_batching.build_federated_arrays(x, y, parts,
                                                           _GKT_BATCH),
                       jax_batching.batch_global(x[::2], y[::2], 4),
                       JaxFedConfig(**_gkt_cfg()), server_lr=SERVER_LR)
    runs = []
    for r in range(2):
        before = _gkt_state(api)
        metrics = api.train_one_round(r)
        runs.append((before, metrics, _gkt_state(api),
                     api.evaluate()["accuracy"]))
    return (x, y, parts), runs


def _port_gkt(data):
    x, y, parts = data
    return FedGKTAPI(create_model("resnet5_56", num_classes=K, device="cpu"),
                     create_model("resnet20_server", num_classes=K,
                                  device="cpu"),
                     build_federated_arrays(x, y, parts, _GKT_BATCH,
                                            device="cpu"),
                     batch_global(x[::2], y[::2], 4, device="cpu"),
                     FedConfig(**_gkt_cfg()), server_lr=SERVER_LR,
                     device="cpu")


def _load_gkt(api, st):
    api.client_nets = NetState(stacked_from_jax_params(st["clients"]), {})
    api.server_net = NetState(from_jax_params(st["server"])[0], {})
    api.server_state = {"0": {
        "count": torch.tensor(st["count"], dtype=torch.int32),
        "mu": from_jax_params(st["mu"])[0],
        "nu": from_jax_params(st["nu"])[0]}, "1": {}}
    api.server_logits.copy_(torch.from_numpy(np.array(st["logits"])))
    api.have_teacher = st["have_teacher"]


@pytest.mark.parametrize("round_idx", [0, 1])
def test_fedgkt_round_matches_jax(gkt_runs, round_idx):
    """Round 0 (no teacher) and round 1 (the teacher of round 0) from
    JAX's state: the client stumps within 1e-5; the server tail within 2
    server_lr (Adam's normalised step m/(√v + ε) has size ~server_lr
    whatever the gradient, so where a gradient is near 0 the two packages'
    rounding can turn a step around: 2 server_lr a flip; round 0 reads
    0.26 server_lr); Adam's count equal and its moments within 1e-5 of
    their scale; the new server logits within 1e-5 relative,
    ``have_teacher`` set; the losses within 1e-5 relative and
    ``evaluate`` equal. An all-masked batch is a no-op: Adam counts the 7
    non-empty batches."""
    data, runs = gkt_runs
    before, jmetrics, after, jacc = runs[round_idx]
    api = _port_gkt(data)
    _load_gkt(api, before)
    metrics = api.train_one_round(round_idx)
    assert api.have_teacher
    assert metrics["round"] == round_idx
    for k in ("client_loss", "server_loss"):
        assert metrics[k] == pytest.approx(jmetrics[k], rel=1e-5), k
    _close(stacked_to_jax_params(api.client_nets.params), after["clients"],
           atol=1e-5)
    _close(to_jax_params(api.server_net.params), after["server"],
           atol=2 * SERVER_LR)
    adam = api.server_state["0"]
    # Adam counts the non-empty batches: 2 + 1 + 3 + 1 of the 12.
    assert int(adam["count"]) == after["count"] == before["count"] + 7
    for got, want in ((adam["mu"], after["mu"]), (adam["nu"], after["nu"])):
        scale = max(np.abs(a).max() for a in _flat(want).values())
        _close(to_jax_params(got), want, atol=1e-5 * scale)
    logits = api.server_logits.numpy()
    np.testing.assert_allclose(logits, after["logits"], rtol=0,
                               atol=1e-5 * np.abs(after["logits"]).max())
    assert api.evaluate()["accuracy"] == pytest.approx(jacc, abs=1e-6)


def test_fedgkt_teacher_changes_the_client_loss(gkt_runs):
    """Round 1 from the same state with ``have_teacher`` forced to 0
    trains the stumps on CE alone: another loss and other stumps."""
    data, runs = gkt_runs
    before = runs[1][0]
    api = _port_gkt(data)
    _load_gkt(api, before)
    with_kl = api.train_one_round(1)["client_loss"]
    _load_gkt(api, before)
    api.have_teacher = False
    without = api.train_one_round(1)["client_loss"]
    assert abs(with_kl - without) > 1e-3


# --- SplitNN ------------------------------------------------------------------------

class JaxTinyBottom(fnn.Module):
    @fnn.compact
    def __call__(self, x, train: bool = False):
        return fnn.relu(fnn.Conv(8, (3, 3), padding="SAME")(x))


class JaxTinyTop(fnn.Module):
    num_classes: int = K

    @fnn.compact
    def __call__(self, acts, train: bool = False):
        return fnn.Dense(self.num_classes)(jnp.mean(acts, axis=(1, 2)))


class TinyBottom(nn.Module):
    """The port's counterpart: NHWC in, ``[B, 8, H, W]`` out."""

    def __init__(self):
        super().__init__()
        self.Conv_0 = nn.Conv2d(3, 8, 3, padding=1)

    def forward(self, x):
        return torch.relu(self.Conv_0(x.permute(0, 3, 1, 2)))


class TinyTop(nn.Module):
    def __init__(self):
        super().__init__()
        self.Dense_0 = nn.Linear(8, K)

    def forward(self, acts):
        return self.Dense_0(acts.mean(dim=(2, 3)))


def _image_task(n=48, n_clients=4, seed=0):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, K, size=n).astype(np.int32)
    x = rng.randn(n, SIDE, SIDE, 3).astype(np.float32) * 0.1
    x[:, :SIDE // 2, :SIDE // 2] += (y % 2)[:, None, None, None]
    x[:, SIDE // 2:, SIDE // 2:] += (y // 2)[:, None, None, None]
    sizes = (14, 10, 16, 8)[:n_clients]
    edges = np.concatenate([[0], np.cumsum(sizes)])
    parts = {i: np.arange(edges[i], edges[i + 1]) for i in range(n_clients)}
    return x, y, parts


def _split_pair(kind, order=None, lr=LR):
    """JAX's and the port's SplitNNAPI from JAX's start; ``order``
    permutes the clients (the ring order)."""
    x, y, parts = _image_task()
    if order is not None:
        parts = {i: parts[c] for i, c in enumerate(order)}
    cfg = dict(client_num_in_total=4, client_num_per_round=4, comm_round=1,
               epochs=1, batch_size=4, lr=lr)
    if kind == "tiny":
        jms, tms = (JaxTinyBottom(), JaxTinyTop()), (TinyBottom(), TinyTop())
    else:
        jms = (jax_create_model("resnet_split_bottom"),
               jax_create_model("resnet20_server", num_classes=K))
        tms = (create_model("resnet_split_bottom", device="cpu"),
               create_model("resnet20_server", num_classes=K, device="cpu"))
    japi = JaxSplitNNAPI(*jms, jax_batching.build_federated_arrays(
        x, y, parts, 4), jax_batching.batch_global(x[:16], y[:16], 8),
        JaxFedConfig(**cfg))
    api = SplitNNAPI(*tms, build_federated_arrays(x, y, parts, 4,
                                                  device="cpu"),
                     batch_global(x[:16], y[:16], 8, device="cpu"),
                     FedConfig(**cfg), device="cpu")
    rows = stacked_from_jax_params(_np(japi.client_nets.params))
    api.client_nets = NetState({k: torch.cat([v, v[:1]]) for k, v in
                                rows.items()}, {})
    api.server_net = NetState(from_jax_params(
        _np(japi.server_net.params))[0], {})
    return api, japi


def _split_distances(api, japi):
    """max |Δ| between the two packages' cycles: (client bottoms, top,
    their momenta)."""
    return (_max_diff(stacked_to_jax_params(client_rows(
                api.client_nets.params)), japi.client_nets.params),
            _max_diff(to_jax_params(api.server_net.params),
                      japi.server_net.params),
            _max_diff(stacked_to_jax_params(client_rows(
                api.client_opts["1"]["trace"])), japi.client_opts[1][0].trace),
            _max_diff(to_jax_params(api.server_opt["1"]["trace"]),
                      japi.server_opt[1][0].trace))


def _jax_spread(japi_fresh):
    """The reference against itself: a cycle from JAX's start with the
    top scaled by (1 + 1e-7) against ``japi_fresh``'s unperturbed cycle,
    as ``_split_distances`` measures it; the losses' distance; and the
    unperturbed cycle's loss."""
    perturbed = _split_pair("resnet")[1]
    perturbed.server_net = perturbed.server_net.replace(params=jax.tree.map(
        lambda a: a * (1 + 1e-7), perturbed.server_net.params))
    loss = perturbed.train_one_epoch(0)["train_loss"]
    want = japi_fresh.train_one_epoch(0)["train_loss"]
    rows = jax.tree.map(np.asarray, perturbed.client_nets.params)
    return (_max_diff(rows, japi_fresh.client_nets.params),
            _max_diff(_np(perturbed.server_net.params),
                      japi_fresh.server_net.params),
            _max_diff(_np(perturbed.client_opts[1][0].trace),
                      japi_fresh.client_opts[1][0].trace),
            _max_diff(_np(perturbed.server_opt[1][0].trace),
                      japi_fresh.server_opt[1][0].trace)), \
        abs(loss - want), want


@pytest.mark.parametrize("kind", ["tiny", "resnet"])
def test_split_nn_cycle_matches_jax(kind):
    """One relay cycle (4 clients × 3–4 steps) from JAX's start. Tiny conv
    nets (lr 0.05): every client's bottom, the top and both momenta
    within 1e-5, the loss and ``evaluate`` within 1e-5 relative.
    ``resnet_split_bottom`` + ``resnet20_server`` (lr 1e-3): the 16-step
    chain through one-channel groups amplifies rounding in the reference
    itself (a 1e-7 change of its start moves its bottoms ~1e-3 and the
    momenta ~0.5), so each distance is held to twice the reference's own
    spread under that perturbation. Both: the bottoms stay distinct and
    each moved; the dustbin row is never written (every client holds
    data)."""
    lr = 0.05 if kind == "tiny" else LR
    api, japi = _split_pair(kind, lr=lr)
    dustbin = {k: v[-1].clone() for k, v in api.client_nets.params.items()}
    start = {k: v.clone() for k, v in api.client_nets.params.items()}
    got = api.train_one_epoch(0)
    if kind == "tiny":
        want = japi.train_one_epoch(0)
        assert got["train_loss"] == pytest.approx(want["train_loss"],
                                                  rel=1e-5)
        assert max(_split_distances(api, japi)) <= 1e-5
        ev, jev = api.evaluate(), japi.evaluate()
        for k in ("loss", "accuracy"):
            assert ev[k] == pytest.approx(jev[k], rel=1e-5, abs=1e-6), k
    else:
        spread, loss_spread, want = _jax_spread(japi)
        dist = _split_distances(api, japi)
        assert all(d <= 2 * s for d, s in zip(dist, spread)), (dist, spread)
        assert abs(got["train_loss"] - want) <= 2 * loss_spread
    params = api.client_nets.params
    for k, v in params.items():
        assert torch.equal(v[-1], dustbin[k])
        for c in range(4):
            assert not torch.equal(v[c], start[k][c]), (k, c)
    first = next(iter(params))
    assert not torch.allclose(params[first][0], params[first][1])


def test_split_nn_ring_order_matters():
    """The top moves between clients: the cycle with the ring reversed
    (each client keeps its data and its bottom) ends at another top, far
    beyond the packages' distance, and matches JAX's reversed cycle."""
    api, japi = _split_pair("tiny", lr=0.05)
    rev, jrev = _split_pair("tiny", order=(3, 2, 1, 0), lr=0.05)
    rows = stacked_from_jax_params(_np(japi.client_nets.params))
    rev.client_nets = NetState({k: torch.cat([v.flip(0), v[:1]]) for k, v in
                                rows.items()}, {})
    jrev.client_nets = jrev.client_nets.replace(params=jax.tree.map(
        lambda a: a[::-1], japi.client_nets.params))
    api.train_one_epoch(0)
    rev.train_one_epoch(0)
    jrev.train_one_epoch(0)
    apart = _max_diff(to_jax_params(api.server_net.params),
                      to_jax_params(rev.server_net.params))
    assert apart > 1e-3
    _close(to_jax_params(rev.server_net.params), jrev.server_net.params,
           1e-5)


def test_split_nn_empty_client_keeps_its_row():
    """A client with no samples: its segment's steps are all masked, its
    row of the stacks is written to the dustbin instead, and stays."""
    x, y, parts = _image_task()
    parts[2] = np.array([], np.int64)
    cfg = FedConfig(client_num_in_total=4, client_num_per_round=4,
                    comm_round=1, epochs=1, batch_size=4, lr=0.05)
    api = SplitNNAPI(TinyBottom(), TinyTop(),
                     build_federated_arrays(x, y, parts, 4, device="cpu"),
                     None, cfg, device="cpu")
    start = {k: v.clone() for k, v in api.client_nets.params.items()}
    api.train_one_epoch(0)
    for k, v in api.client_nets.params.items():
        assert torch.equal(v[2], start[k][2])
        assert not torch.equal(v[1], start[k][1])
    assert api.evaluate() == {}


# --- vertical FL --------------------------------------------------------------------

def _vfl_task(n=200, dims=(10, 6), seed=0):
    rng = np.random.RandomState(seed)
    xs = [rng.randn(n, d).astype(np.float32) for d in dims]
    y = (sum(x @ rng.randn(x.shape[1]) for x in xs) > 0).astype(np.int32)
    return xs, y


def test_vfl_fit_matches_jax_per_batch():
    """``fit`` from JAX's params, 3 epochs of batch 64 over 200 samples
    (a ragged last batch of 8): every per-batch loss within 1e-5
    relative, each party's params within 1e-5, the accuracy equal and
    risen."""
    xs, y = _vfl_task()
    japi = JaxVflAPI([10, 6], rep_dim=8, lr=0.05)
    api = VflAPI([10, 6], rep_dim=8, lr=0.05, device="cpu")
    for p, jp in zip(api.parties, japi.parties):
        p.params = vfl_party_from_jax(_np(jp.params))
    acc0 = api.evaluate(xs, y)["accuracy"]
    assert acc0 == japi.evaluate(xs, y)["accuracy"]
    got = api.fit(xs, y, epochs=3, batch_size=64)
    want = japi.fit(xs, y, epochs=3, batch_size=64)
    assert len(got) == len(want) == 12
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for p, jp in zip(api.parties, japi.parties):
        _close(vfl_party_to_jax(p.params), jp.params, 1e-5)
    acc = api.evaluate(xs, y)["accuracy"]
    assert acc == japi.evaluate(xs, y)["accuracy"]
    assert acc > acc0


def test_vfl_guest_only_bias_and_party_models():
    """The guest's dense head has a bias, the hosts' do not (one bias in
    the summed logit); the registry's ``vfl_local``/``vfl_dense`` are the
    party models."""
    api = VflAPI([4, 4, 3], rep_dim=8, device="cpu")
    assert "Dense_0.bias" in api.parties[0].params["dense"]
    for host in api.parties[1:]:
        assert "Dense_0.bias" not in host.params["dense"]
        assert "Dense_0.bias" in host.params["local"]
    assert api.parties[2].params["local"]["Dense_0.weight"].shape == (8, 3)
    local = create_model("vfl_local", in_features=5, output_dim=3,
                         device="cpu")
    x = torch.randn(4, 5)
    assert torch.equal(local(x), torch.nn.functional.leaky_relu(
        local.Dense_0(x), 0.01))
    head = create_model("vfl_dense", in_features=3, use_bias=False,
                        device="cpu")
    assert head.Dense_0.bias is None


# --- records, refusals, devices ------------------------------------------------------

_CLASSES = {"FedGKT": (FedGKTAPI, JaxFedGKTAPI),
            "SplitNN": (SplitNNAPI, JaxSplitNNAPI),
            "VerticalFL": (VflAPI, JaxVflAPI)}


def _tiny_api(name):
    if name == "VerticalFL":
        return VflAPI([3, 2], rep_dim=4, device="cpu")
    x, y, parts = _image_task()
    fed = build_federated_arrays(x, y, parts, 4, device="cpu")
    cfg = FedConfig(client_num_in_total=4, client_num_per_round=4,
                    batch_size=4)
    if name == "SplitNN":
        return SplitNNAPI(TinyBottom(), TinyTop(), fed, None, cfg,
                          device="cpu")
    return FedGKTAPI(create_model("resnet5_56", num_classes=K, device="cpu"),
                     create_model("resnet20_server", num_classes=K,
                                  device="cpu"), fed, None, cfg,
                     device="cpu")


@pytest.mark.parametrize("name", list(_CLASSES))
def test_records_and_refusals_match_the_support_matrix(name):
    """Each class's record against JAX's and ``docs/EXECUTION.md``: no
    protocol, no tier, the exclusion word for word in the matrix's
    exclusions; each multi-round tier raises the record's refusal, which
    quotes it."""
    cls, jcls = _CLASSES[name]
    rec, jrec = record_for(cls), jax_capability.record_for(jcls)
    assert rec.protocol is jrec.protocol is None
    assert not (rec.fused or jrec.fused or jrec.pipelined)
    assert not (rec.on_device or jrec.on_device)
    assert rec.excluded == jrec.excluded == jcls.window_exclusion
    with open(os.path.join(REPO, "docs", "EXECUTION.md")) as f:
        matrix = f.read()
    assert f"| {name} | — | — | ✗ | ✗ | ✗ | ✗ |" in matrix
    assert f"- **{name}** — {rec.excluded}\n" in matrix
    api = _tiny_api(name)
    for tier in ("train_rounds_windowed", "train_rounds_pipelined",
                 "train_rounds_on_device"):
        with pytest.raises(NotImplementedError) as exc:
            getattr(api, tier)(2)
        assert str(exc.value) == refusal(cls, tier)
        assert f"(window_protocol=None): {jcls.window_exclusion}" in str(
            exc.value)


def test_entry_points_need_the_card_unless_asked_for_the_cpu(monkeypatch):
    """Without a CUDA device the models and the three classes raise
    unless ``device="cpu"`` is passed."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in _STUMPS + _TAILS:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_model(name)
    for name, kw in (("vfl_local", dict(in_features=3)),
                     ("vfl_dense", dict(in_features=3))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            create_model(name, **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VflAPI([3, 2])
    x, y, parts = _image_task()
    fed = build_federated_arrays(x, y, parts, 4, device="cpu")
    cfg = FedConfig(client_num_in_total=4, batch_size=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SplitNNAPI(TinyBottom(), TinyTop(), fed, None, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FedGKTAPI(create_model("resnet5_56", device="cpu"),
                  create_model("resnet20_server", device="cpu"), fed, None,
                  cfg)
