"""The FedAvg CNNs and the LSTMs of the port (``models/cnn.py``,
``models/rnn.py``) against the JAX package's on the same seeded numpy
inputs and weights: both CNNs in eval mode and, without dropout, in train
mode (both stems, a 3-dim input), both LSTMs' logits and gradients, a
FedAvg round of ``rnn`` with ``seq_softmax_ce`` at LEAF Shakespeare's pad
id -1; and the dropout of ``CNNDropOut``: its keep rates, and masks that
follow the step's key (the port's counter-hash masks, not threefry's, by
design: parity with JAX holds in eval mode and without dropout)."""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algos.config import FedConfig as JaxFedConfig
from fedml_tpu.algos.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.data import batching as jax_batching
from fedml_tpu.models.cnn import CNNDropOut as JaxCNNDropOut
from fedml_tpu.models.cnn import CNNOriginalFedAvg as JaxCNNOriginal
from fedml_tpu.models.registry import create_model as jax_create_model
from fedml_tpu.trainer.local import seq_softmax_ce as jax_seq_ce
from fedml_tpu_torch.algos import FedAvgAPI, FedConfig
from fedml_tpu_torch.convert import from_jax_params, to_jax_params
from fedml_tpu_torch.core import keys
from fedml_tpu_torch.data import build_federated_arrays
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models.cnn import CNNDropOut, CNNOriginalFedAvg, dropout
from fedml_tpu_torch.trainer.local import (NetState, make_client_optimizer,
                                           make_local_train_fn, model_fns,
                                           seq_softmax_ce)

# f32 logits within 2e-5 of their scale (other summation orders), the
# LSTMs' gradients within 1e-4 of each leaf's largest entry (80 steps of
# recurrence at most).
LOGIT_TOL, GRAD_TOL = 2e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(model, x, seed=1):
    """Random weights in the flax tree of ``model``: kernels and
    embeddings ~ N(0, 1/fan_in), biases N(0, 0.1²)."""
    rng = np.random.default_rng(seed)
    tree = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                          jnp.asarray(x))["params"]

    def leaf(path, z):
        if path[-1].key in ("kernel", "embedding"):
            fan = z.shape[-1] if path[-1].key == "embedding" else np.prod(
                z.shape[:-1])
            return rng.normal(0, 1 / np.sqrt(fan), z.shape).astype(
                np.float32)
        return rng.normal(0, 0.1, z.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _port(model, params):
    state = from_jax_params(params)[0]
    assert set(state) == set(model.state_dict())
    model.load_state_dict(state)
    return model


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


# --- the CNNs ---------------------------------------------------------------

CNN_CASES = {
    # name: (JAX model, port model, input shape, train)
    "dropout_eval": (lambda: JaxCNNDropOut(), lambda: CNNDropOut(),
                     (3, 28, 28), False),
    "dropout_eval_s2d": (lambda: JaxCNNDropOut(stem="s2d"),
                         lambda: CNNDropOut(stem="s2d"), (3, 28, 28, 1),
                         False),
    "original_train": (lambda: JaxCNNOriginal(),
                       lambda: CNNOriginalFedAvg(), (3, 28, 28, 1), True),
    "original_eval_s2d_widths": (
        lambda: JaxCNNOriginal(stem="s2d", widths=(8, 16), only_digits=True),
        lambda: CNNOriginalFedAvg(stem="s2d", widths=(8, 16),
                                  only_digits=True), (3, 28, 28), False),
}


@pytest.mark.parametrize("case", sorted(CNN_CASES))
def test_cnn_logits_match_flax(case):
    jbuild, tbuild, shape, train = CNN_CASES[case]
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    jmodel = jbuild()
    params = _jax_params(jmodel, x)
    want = jmodel.apply({"params": params}, jnp.asarray(x), train=train)
    net = _port(tbuild(), params)
    logits, _ = model_fns(net).apply(model_fns(net).init(),
                                     torch.from_numpy(x), train=train)
    _close(logits.detach(), want, LOGIT_TOL)


def test_cnn_registry_swallows_widths_and_dtype_as_jax():
    """``cnn`` builds CNNDropOut by default and CNNOriginalFedAvg with
    ``dropout=False``; ``widths`` and ``dtype`` go into ``**_`` as in the
    JAX factory; a train-mode forward without a key is refused."""
    m = create_model("cnn", widths=(8, 16), dtype="bf16", device="cpu")
    assert isinstance(m, CNNDropOut) and m.Conv_0.weight.shape[0] == 32
    assert m.Conv_0.dtype is None
    jm = jax_create_model("cnn", widths=(8, 16), dtype="bf16")
    assert isinstance(jm, JaxCNNDropOut) and jm.widths is None
    assert isinstance(create_model("cnn", dropout=False, device="cpu"),
                      CNNOriginalFedAvg)
    with pytest.raises(ValueError, match="key"):
        m.train()(torch.zeros(1, 28, 28))


# --- the LSTMs --------------------------------------------------------------

@pytest.mark.parametrize("name,vocab,t", [("rnn", 90, 12),
                                          ("rnn_stackoverflow", 200, 5)])
def test_lstm_logits_and_gradients_match_flax(name, vocab, t):
    """The cell's parameter names, gate order (i, f, g, o), zero carry and
    recurrence against flax's ``OptimizedLSTMCell`` under ``nn.RNN``."""
    rng = np.random.RandomState(2)
    x = rng.randint(0, vocab, (3, t)).astype(np.int32)
    y = rng.randint(0, vocab, (3, t)).astype(np.int32)
    y[0, -3:] = 0  # padding, pad id 0
    jmodel = jax_create_model(name, vocab_size=vocab)
    params = _jax_params(jmodel, x)
    model = _port(create_model(name, vocab_size=vocab, device="cpu"), params)

    def jloss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(x))
        return jnp.mean(jax_seq_ce(logits, jnp.asarray(y), pad_id=0)), logits

    (jl, want), jg = jax.value_and_grad(jloss, has_aux=True)(params)
    logits = model(torch.from_numpy(x))
    loss = seq_softmax_ce(logits, torch.from_numpy(y), pad_id=0).mean()
    loss.backward()
    _close(logits.detach(), want, LOGIT_TOL)
    assert loss.item() == pytest.approx(float(jl), rel=1e-5)
    tg = to_jax_params({k: p.grad for k, p in model.named_parameters()})
    got = dict(jax.tree_util.tree_leaves_with_path(tg))
    for path, w in jax.tree_util.tree_leaves_with_path(jg):
        _close(got[path], w, GRAD_TOL)


def test_rnn_fedavg_round_matches_jax():
    """Two rounds of ``rnn`` FedAvg, 3 of 4 clients, each one batch of T 10
    sequences (the shuffle only reorders a batch), ``seq_softmax_ce`` at
    pad id -1 (LEAF Shakespeare: label -1 marks padding), sgd lr 1.0:
    params within 1e-5 of JAX's, losses within 1e-5."""
    counts, batch, t = (4, 2, 3, 4), 4, 10
    rng = np.random.RandomState(3)
    n = sum(counts)
    x = rng.randint(0, 90, (n, t)).astype(np.int32)
    y = rng.randint(0, 90, (n, t)).astype(np.int32)
    y[::3, -4:] = -1
    edges = np.concatenate([[0], np.cumsum(counts)])
    parts = {i: np.arange(edges[i], edges[i + 1]) for i in range(4)}
    cfg = dict(client_num_in_total=4, client_num_per_round=3, comm_round=2,
               epochs=1, batch_size=batch, lr=1.0, frequency_of_the_test=100)
    japi = JaxFedAvgAPI(jax_create_model("rnn"),
                        jax_batching.build_federated_arrays(x, y, parts,
                                                            batch), None,
                        JaxFedConfig(**cfg),
                        loss_fn=functools.partial(jax_seq_ce, pad_id=-1),
                        pad_id=-1)
    start = jax.tree.map(np.asarray, japi.net.params)
    api = FedAvgAPI(create_model("rnn", device="cpu"),
                    build_federated_arrays(x, y, parts, batch, device="cpu"),
                    None, FedConfig(**cfg),
                    loss_fn=functools.partial(seq_softmax_ce, pad_id=-1),
                    pad_id=-1, device="cpu")
    api.net = NetState(from_jax_params(start)[0], {})
    for r in range(2):
        got, want = api.train_one_round(r), japi.train_one_round(r)
        assert got["train_loss"] == pytest.approx(want["train_loss"],
                                                  rel=1e-5)
    moved = max(np.abs(np.asarray(a) - b).max() for a, b in zip(
        jax.tree.leaves(japi.net.params), jax.tree.leaves(start)))
    assert moved > 1e-2
    for a, b in zip(jax.tree.leaves(to_jax_params(api.net.params)),
                    jax.tree.leaves(japi.net.params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)


# --- dropout ----------------------------------------------------------------

@pytest.mark.parametrize("rate", [0.25, 0.5])
def test_dropout_keep_rate_and_scale(rate):
    """Over 200,000 elements the kept share is within 3σ of 1 − rate, and
    the kept values are scaled by 1 / (1 − rate)."""
    n, keep = 200_000, 1.0 - rate
    x = torch.ones(n)
    y = dropout(x, rate, keys.key(11))
    kept = (y != 0).float().mean().item()
    assert abs(kept - keep) <= 3 * math.sqrt(keep * rate / n)
    assert torch.equal(y[y != 0], torch.full_like(y[y != 0], 1 / keep))


def test_dropout_masks_follow_the_step_keys():
    """The masks are a function of the key alone: the same key gives the
    same mask, other keys (clients, steps, rounds) others; under the
    cohort's ``vmap`` each client draws its own. A local round of
    CNNDropOut from one start and data differs between two round keys and
    repeats for one."""
    x = torch.ones(4, 64)
    a, b = dropout(x, 0.5, keys.key(1)), dropout(x, 0.5, keys.key(1))
    c = dropout(x, 0.5, keys.key(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    per_client = torch.vmap(lambda k: dropout(x, 0.5, k))(
        keys.fold_in(keys.key(3), torch.arange(3)))
    assert not torch.equal(per_client[0], per_client[1])
    model = CNNDropOut(generator=torch.Generator().manual_seed(0))
    fns = model_fns(model)
    lt = make_local_train_fn(fns.apply, make_client_optimizer("sgd", 0.1), 1)
    rng = np.random.RandomState(4)
    xs = torch.tensor(rng.randn(2, 1, 4, 28, 28).astype(np.float32))
    ys = torch.tensor(rng.randint(0, 62, (2, 1, 4)))
    ms = torch.ones(2, 1, 4)
    net = fns.init()

    def run(seed):
        out, _ = lt.run_clients(net, xs, ys, ms,
                                keys.fold_in(keys.key(seed), torch.arange(2)))
        return out.params["Dense_1.weight"]

    r1, r2, r3 = run(5), run(5), run(6)
    assert torch.equal(r1, r2) and not torch.equal(r1, r3)
    # The two clients hold the same data here: only their keys differ.
    xs[1], ys[1] = xs[0], ys[0]
    same_data = run(5)
    assert not torch.equal(same_data[0], same_data[1])
