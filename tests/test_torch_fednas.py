"""The port's FedNAS (``algos/fednas.py``) against the JAX package's on the
same seeded numpy data and JAX's weights carried across with ``convert``:
the bilevel local search, first-order and unrolled (the exact second
derivative through GroupNorm), with uneven and odd step counts, the tiers
of ``FedNASAPI`` agreeing with each other, the refusals (its rounds
against JAX's ``FedNASAPI`` are in ``test_torch_nas.py``, to keep each
file's JAX compiles short); and the capability records of FedNAS, FedSeg
and FedGAN against the JAX package's support matrix
(``docs/EXECUTION.md``).

The search draws no random numbers and does not shuffle, so the port and
JAX train on the same batches in the same order. A search net at c 4, 2
layers (a normal and a reduction cell), 1 step keeps JAX's compiles
short."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algos import capability as jax_capability
from fedml_tpu.algos.fedgan import FedGanAPI as JaxFedGanAPI
from fedml_tpu.algos.fednas import FedNASAPI as JaxFedNASAPI
from fedml_tpu.algos.fednas import make_fednas_local_search as jax_search
from fedml_tpu.algos.fedseg import FedSegAPI as JaxFedSegAPI
from fedml_tpu.models import darts as jd
from fedml_tpu.trainer.local import NetState as JaxNetState
from fedml_tpu_torch.algos import FedConfig, FedGanAPI, FedNASAPI, FedSegAPI
from fedml_tpu_torch.algos.capability import record_for, refusal
from fedml_tpu_torch.algos.fednas import make_fednas_local_search
from fedml_tpu_torch.convert import from_jax_params, to_jax_params
from fedml_tpu_torch.data import build_federated_arrays
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.trainer.local import NetState

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NET = dict(c=4, layers=2, steps=1, multiplier=1, num_classes=5)
LR_W, LR_A, XI = 0.05, 0.01, 0.02
# The searched params against JAX's, as max |Δ| over the largest update
# of the weights, and of the alphas, in the round (f32, other conv and
# sum orders).
W_TOL, A_TOL = 1e-5, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _model(seed=0):
    return create_model("darts", device="cpu",
                        generator=torch.Generator().manual_seed(seed), **NET)


def _held(got, start, want):
    """``got`` (the port's params) against ``want`` (JAX's, ported) from
    ``start``: within the tolerances of the largest update."""
    def err(keys):
        upd = max((want[k] - start[k]).abs().max().item() for k in keys)
        diff = max((got[k] - want[k]).abs().max().item() for k in keys)
        assert upd > 0
        return diff / upd

    alphas = ("alphas_normal", "alphas_reduce")
    weights = [k for k in want if k not in alphas]
    assert err(weights) <= W_TOL and err(alphas) <= A_TOL


def _apply(jmod):
    def apply(net, xb, train=False, rng=None):
        return jmod.apply({"params": net.params}, xb), net.model_state
    return apply


@pytest.mark.parametrize("unrolled", [False, True])
def test_local_search_matches_jax(unrolled):
    """One client, 2 epochs over 5 steps with a partly masked step and an
    all-masked last one (5 real steps → h 2, the odd real step feeds
    neither half): the searched weights and alphas and the loss against
    JAX's ``make_fednas_local_search``. Unrolled, the arch step
    differentiates through the lookahead, GroupNorm's second derivative
    included: the alphas then move otherwise than first-order, and still
    as JAX's do."""
    rng = np.random.RandomState(0)
    s, b = 6, 3
    x = rng.randn(s, b, 8, 8, 3).astype(np.float32)
    y = rng.randint(0, 5, (s, b)).astype(np.int32)
    mask = np.ones((s, b), np.float32)
    mask[5] = 0.0
    mask[3, 2] = 0.0
    model = _model()
    params = to_jax_params(model.state_dict())
    jnet, jloss = jax.jit(jax_search(
        _apply(jd.DartsNetwork(**NET)), LR_W, LR_A, XI, 2, unrolled))(
        JaxNetState(params, {}), jnp.asarray(x), jnp.asarray(y),
        jnp.asarray(mask), jax.random.PRNGKey(1))
    search = make_fednas_local_search(
        lambda net, xb, train=False, rng=None: (
            torch.func.functional_call(model, net.params, (xb,)), {}),
        LR_W, LR_A, XI, 2, unrolled)
    start = from_jax_params(params)[0]
    net, loss = search(NetState(dict(start), {}), torch.from_numpy(x),
                       torch.from_numpy(y).long(), torch.from_numpy(mask),
                       None)
    want = from_jax_params(_np(jnet.params))[0]
    _held(net.params, start, want)
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    if unrolled:  # the second-order term moved the alphas
        first = search.__class__(search.apply_fn, LR_W, LR_A, XI, 2, False)
        fo, _ = first(NetState(dict(start), {}), torch.from_numpy(x),
                      torch.from_numpy(y).long(), torch.from_numpy(mask),
                      None)
        d = (fo.params["alphas_normal"] - net.params["alphas_normal"])
        assert d.abs().max().item() > 1e-3 * (
            net.params["alphas_normal"] - start["alphas_normal"]).abs().max()


def _task(counts=(12, 7, 10, 9), seed=0):
    """Random 8×8 images and labels, client i holding ``counts[i]``."""
    rng = np.random.RandomState(seed)
    n = sum(counts)
    x = rng.randn(n, 8, 8, 3).astype(np.float32)
    y = rng.randint(0, 5, n).astype(np.int32)
    edges = np.concatenate([[0], np.cumsum(counts)])
    parts = {i: np.arange(edges[i], edges[i + 1]) for i in range(len(counts))}
    return x, y, parts


def _cfg(**kw):
    base = dict(client_num_in_total=4, client_num_per_round=3, comm_round=2,
                epochs=1, batch_size=2, lr=LR_W, frequency_of_the_test=100)
    base.update(kw)
    return base


def _api(cfg=None, **kw):
    x, y, parts = _task()
    return FedNASAPI(_model(), build_federated_arrays(
        x, y, parts, 2, device="cpu"), None, FedConfig(**(cfg or _cfg())),
        arch_lr=LR_A, device="cpu", **kw)


def test_fednas_tiers_agree():
    """From one start: 2 ``train_one_round`` rounds, the same 2 through
    ``train_rounds_pipelined`` (bit-equal), and at full participation 2
    ``train_rounds_on_device`` rounds against 2 eager ``run_round`` +
    ``_server_update`` rounds fed the same cohorts (bit-equal)."""
    api = _api()
    start = NetState(dict(api.net.params), {})
    rng0 = api.rng.clone()
    losses = [api.train_one_round(r)["train_loss"] for r in range(2)]
    one = dict(api.net.params)
    api.net, api.rng = NetState(dict(start.params), {}), rng0.clone()
    assert api.train_rounds_pipelined(2) == losses
    assert all(torch.equal(one[k], api.net.params[k]) for k in one)

    full = _api(_cfg(client_num_per_round=4))
    full.net, full.rng = NetState(dict(start.params), {}), rng0.clone()
    dev_losses = full.train_rounds_on_device(2).tolist()
    dev = dict(full.net.params)
    full.net, full.rng = NetState(dict(start.params), {}), rng0.clone()
    full.sample_round = lambda r: np.arange(4)
    eager = []
    for r in range(2):
        avg, loss = full.run_round(r)
        full.net = full._server_update(full.net, avg)
        eager.append(loss.item())
    assert dev_losses == eager
    assert all(torch.equal(dev[k], full.net.params[k]) for k in dev)


def test_an_eager_round_keeps_the_params_layout():
    """``run_round`` + ``_server_update`` return every param with the
    strides it came in with, as a captured round's static buffers keep
    them, the search's 1x1 conv weights included (their update has
    channels-last strides on the size-1 dims): on the card cuDNN picks its
    algorithms by layout, so another layout sums the next round's
    gradients in another order than the captured round."""
    api = _api()
    start = {k: v.stride() for k, v in api.net.params.items()}
    pointwise = [k for k, v in api.net.params.items()
                 if v.dim() == 4 and v.shape[2:] == (1, 1)]
    assert pointwise
    for r in range(2):
        avg, _ = api.run_round(r)
        api.net = api._server_update(api.net, avg)
        moved = {k: (start[k], v.stride()) for k, v in api.net.params.items()
                 if v.stride() != start[k]}
        assert not moved, moved


def test_fednas_refusals():
    """A client with a single packed step, a non-sgd client optimizer and
    gradient clipping are refused as JAX refuses them; without a CUDA
    device the class raises unless asked for the CPU."""
    x, y, parts = _task(counts=(12, 2, 10, 9))
    fed = build_federated_arrays(x, y, parts, 2, device="cpu")
    with pytest.raises(ValueError, match=">= 2 packed steps"):
        FedNASAPI(_model(), fed, None, FedConfig(**_cfg()), device="cpu")
    for kw, what in ((dict(client_optimizer="adam"), "plain SGD"),
                     (dict(grad_clip=1.0), "grad_clip")):
        with pytest.raises(ValueError, match=what):
            _api(_cfg(**kw))
    api = _api(unrolled=True, xi=XI)
    assert api.xi == XI and _api(xi=XI).xi == 0.0
    orig = torch.cuda.is_available
    try:
        torch.cuda.is_available = lambda: False
        with pytest.raises(RuntimeError, match="no CUDA device"):
            FedNASAPI(_model(), fed, None, FedConfig(**_cfg()))
    finally:
        torch.cuda.is_available = orig


_CLASSES = {"FedNAS": (FedNASAPI, JaxFedNASAPI),
            "FedSeg": (FedSegAPI, JaxFedSegAPI),
            "FedGAN": (FedGanAPI, JaxFedGanAPI)}


@pytest.mark.parametrize("name", list(_CLASSES))
def test_capability_records_match_the_support_matrix(name):
    """Each class's record against JAX's and the matrix of
    ``docs/EXECUTION.md``: the "round" protocol, the fused, pipelined and
    on-device tiers, the carry word for word; the windowed tier theirs by
    inheritance (over a store), refusing the resident layout with JAX's
    reason."""
    cls, jcls = _CLASSES[name]
    rec, jrec = record_for(cls), jax_capability.record_for(jcls)
    assert rec.protocol == jrec.protocol == "round"
    assert rec.fused == jrec.fused == jrec.pipelined is True
    assert rec.on_device == jrec.on_device is True
    assert rec.windowed == jrec.windowed is True
    carry = getattr(jcls, "window_carry", "—")
    assert getattr(cls, "window_carry", "—") == carry
    with open(os.path.join(REPO, "docs", "EXECUTION.md")) as f:
        assert f"| {name} | round | {carry} | ✓ | ✓ | ✓ | ✓ |" in f.read()
    assert refusal(cls, "train_one_round").startswith(cls.__name__)
    if name == "FedNAS":
        with pytest.raises(NotImplementedError,
                           match="windowed execution streams window "
                           "superbatches from a FederatedStore"):
            _api().train_rounds_windowed(2)
