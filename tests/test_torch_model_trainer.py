"""The port's ``ModelTrainer`` and its three task trainers
(``fedml_tpu_torch/trainer/model_trainer.py``) against the JAX package's.

Each trainer is built in both packages from one start (JAX's initial
params carried across with ``convert.from_jax_params``), trained for three
``train`` calls (five for the tagger) and tested, on data that is one
batch an epoch: the two packages' shuffle bits then only reorder a batch,
whose masked mean loss does not depend on the order beyond f32 rounding.
The losses, the params and the metrics are held within 1e-5. Also the A3
refusals by name, the ABC's surface, pre-packed input and the device
resolution.
"""

import types

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.models import create_model as jax_create_model
from fedml_tpu.models.rnn import RNNStackOverflow as JaxRNNStackOverflow
from fedml_tpu.trainer import model_trainer as jmt
from fedml_tpu_torch.convert import from_jax_params, to_jax_params
from fedml_tpu_torch.data.batching import batch_global
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models.rnn import RNNStackOverflow
from fedml_tpu_torch.trainer import model_trainer as tmt
from fedml_tpu_torch.trainer.local import NetState

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _args(**kw):
    d = dict(client_optimizer="sgd", lr=0.3, wd=0.0, epochs=2, seed=0)
    d.update(kw)
    return types.SimpleNamespace(**d)


def _pair(name, jmodel, model, args, x, **kw):
    """The JAX trainer initialised by flax, the port's from the same
    params."""
    jtr = getattr(jmt, name)(jmodel, args, **kw)
    jtr.init(jax.random.PRNGKey(0), x[:1])
    tr = getattr(tmt, name)(model, args, device="cpu", **kw)
    tr.init()
    tr.set_model_params(NetState(from_jax_params(
        jax.tree.map(np.asarray, jtr.net.params))[0], {}))
    return jtr, tr


def _params_close(tr, jtr):
    for a, b in zip(jax.tree.leaves(to_jax_params(tr.net.params)),
                    jax.tree.leaves(jtr.net.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=TOL)


def _train_and_test(jtr, tr, batches, calls=3):
    start = jax.tree.map(np.asarray, jtr.net.params)
    for _ in range(calls):
        got, want = tr.train(batches), jtr.train(batches)
        assert isinstance(got, float) and np.isfinite(got)
        assert got == pytest.approx(want, rel=TOL, abs=TOL)
    moved = max(np.abs(np.asarray(a) - b).max() for a, b in zip(
        jax.tree.leaves(jtr.net.params), jax.tree.leaves(start)))
    assert moved > 1e-2
    _params_close(tr, jtr)
    got, want = tr.test(batches), jtr.test(batches)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=TOL, abs=TOL), k
    return got


def test_classification_trainer_matches_jax():
    """LR on 10 features, 4 classes, 48 samples in one batch, 2 epochs a
    call, sgd lr 0.3: three calls, then ``test``'s loss, accuracy and
    count; the accuracy climbs."""
    rng = np.random.RandomState(0)
    w = rng.randn(10, 4)
    x = rng.randn(48, 10).astype(np.float32)
    y = np.argmax(x @ w, 1).astype(np.int32)
    jtr, tr = _pair("ClassificationTrainer",
                    jax_create_model("lr", num_classes=4),
                    create_model("lr", in_features=10, num_classes=4,
                                 device="cpu"), _args(), x)
    before = tr.test([(x, y)])["accuracy"]
    got = _train_and_test(jtr, tr, [(x, y)])
    assert got["accuracy"] > max(before, 0.5)
    assert got["num"] == 48


def test_nwp_trainer_matches_jax_and_masks_pad():
    """A narrow ``RNNStackOverflow`` (vocab 23, embed 8, LSTM 16) on 12
    sequences of T 6 whose last label is padding (id 0), one batch, sgd lr
    0.5: three calls and ``test``, whose accuracy counts no pad
    position."""
    vocab, t = 23, 6
    rng = np.random.RandomState(1)
    x = rng.randint(1, vocab, (12, t)).astype(np.int32)
    y = np.concatenate([x[:, 1:], np.zeros((12, 1), np.int32)], 1)
    jtr, tr = _pair("NwpTrainer",
                    JaxRNNStackOverflow(vocab_size=vocab, embedding_dim=8,
                                        hidden_size=16),
                    RNNStackOverflow(vocab_size=vocab, embedding_dim=8,
                                     hidden_size=16), _args(lr=0.5), x)
    got = _train_and_test(jtr, tr, [(x, y)])
    assert 0.0 <= got["accuracy"] <= 1.0


def test_tag_trainer_matches_jax():
    """LR as a 5-label tagger on 30 features (multi-hot f32 labels), 40
    samples in one batch, 3 epochs a call, sgd lr 0.5: five calls, then
    precision and recall over the 0.5 threshold."""
    rng = np.random.RandomState(2)
    x = rng.randn(40, 30).astype(np.float32)
    w = rng.randn(30, 5)
    y = ((x @ w) > 0).astype(np.float32)
    jtr, tr = _pair("TagPredictionTrainer",
                    jax_create_model("lr", num_classes=5),
                    create_model("lr", in_features=30, num_classes=5,
                                 device="cpu"), _args(lr=0.5, epochs=3), x)
    got = _train_and_test(jtr, tr, [(x, y)], calls=5)
    assert got["precision"] > 0.7 and got["recall"] > 0.7


def test_sigmoid_bce_matches_jax():
    rng = np.random.RandomState(3)
    logits = rng.randn(6, 5).astype(np.float32) * 4
    labels = (rng.rand(6, 5) > 0.5).astype(np.float32)
    got = tmt.sigmoid_bce(torch.from_numpy(logits), torch.from_numpy(labels))
    want = jmt.sigmoid_bce(logits, labels)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_prepacked_input_equals_batch_lists():
    """``(x, y, mask)`` from ``batch_global`` trains as the batch list
    does: the same loss and params, bit for bit."""
    rng = np.random.RandomState(4)
    x = rng.randn(20, 6).astype(np.float32)
    y = rng.randint(0, 3, 20).astype(np.int32)

    def trainer():
        torch.manual_seed(0)
        return tmt.ClassificationTrainer(
            create_model("lr", in_features=6, num_classes=3, device="cpu",
                         generator=torch.Generator().manual_seed(0)),
            _args(), device="cpu")

    a, b = trainer(), trainer()
    a.init()
    b.init()
    la = a.train([(x[:8], y[:8]), (x[8:16], y[8:16]), (x[16:], y[16:])])
    lb = b.train(batch_global(x, y, 8, device="cpu"))
    assert la == lb
    for k in a.net.params:
        assert torch.equal(a.net.params[k], b.net.params[k])


@pytest.mark.parametrize("flag,value", [("remat", True), ("dp_clip", 1.0),
                                        ("dp_noise_multiplier", 0.5)])
def test_a3_arguments_refused_by_name(flag, value):
    model = create_model("lr", in_features=4, num_classes=2, device="cpu")
    with pytest.raises(NotImplementedError, match=rf"args\.{flag}=.*A3"):
        tmt.ClassificationTrainer(model, _args(**{flag: value}),
                                  device="cpu")
    # Unset (JAX's defaults: False, 0.0) is accepted.
    tmt.ClassificationTrainer(model, _args(remat=False, dp_clip=0.0,
                                           dp_noise_multiplier=0.0),
                              device="cpu")


def test_trainer_abc_surface_and_device(monkeypatch):
    """The reference's surface as JAX has it; the ABC itself cannot be
    built; ``device=None`` resolves to the card and refuses a machine
    without one."""
    tr = tmt.ClassificationTrainer(
        create_model("lr", in_features=4, num_classes=2, device="cpu"),
        _args(), device="cpu")
    tr.set_id(7)
    assert tr.id == 7
    net = tr.init()
    assert tr.get_model_params() is net
    tr.set_model_params(net)
    assert tr.test_on_the_server({}, {}) is False
    assert tr.device == torch.device("cpu")
    with pytest.raises(TypeError):
        tmt.ModelTrainer(None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmt.NwpTrainer(RNNStackOverflow(vocab_size=5, embedding_dim=2,
                                        hidden_size=2), _args())
