"""The port's FedSeg slice — ``models/unet.py`` and ``algos/fedseg.py`` —
against the JAX package on the same seeded numpy inputs and weights: the
UNet at even and odd sizes, the segmentation losses with ignored pixels,
``confusion_matrix``, ``evaluator_scores``, ``EvaluationMetricsKeeper``,
``FedSegAPI``'s rounds and evaluation, its tiers agreeing, and the
refusals.

FedSeg's rounds use data where each client holds copies of one image and
label map: the port's epoch shuffle draws from ``core/keys.py``, not
threefry, and with identical samples every permutation gives the same
batches."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call, grad

from fedml_tpu.algos import fedseg as jseg
from fedml_tpu.algos.config import FedConfig as JaxFedConfig
from fedml_tpu.data import batching as jax_batching
from fedml_tpu.models.unet import UNet as JaxUNet
from fedml_tpu_torch.algos import FedConfig, FedSegAPI
from fedml_tpu_torch.algos import fedseg as seg
from fedml_tpu_torch.convert import from_jax_params, to_jax_params
from fedml_tpu_torch.data import build_federated_arrays
from fedml_tpu_torch.data.batching import batch_global
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.trainer.local import NetState

K = 5  # classes
NET = dict(num_classes=K, base=4, levels=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _model(seed=0):
    return create_model("unet", device="cpu",
                        generator=torch.Generator().manual_seed(seed), **NET)


def _carried(model, x):
    """The port UNet's seeded weights as a flax tree, after checking flax's
    structure and shapes (``eval_shape`` of flax's init)."""
    shapes = jax.eval_shape(JaxUNet(**NET).init, jax.random.PRNGKey(0),
                            jnp.asarray(x))["params"]
    params = to_jax_params(model.state_dict())
    assert jax.tree.structure(params) == jax.tree.structure(shapes)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(shapes)):
        assert a.shape == b.shape
    return params


@pytest.mark.parametrize("side", [21, 16])
def test_unet_matches_flax(side):
    """Logits ``[B, H, W, classes]`` within 1e-5 of the largest, and the
    CE gradient in every param within 1e-5 of the largest gradient, at an
    odd size (21 → 10 → 5 through the pools: the upsample edge-padded) and
    an even one (cropped)."""
    rng = np.random.RandomState(side)
    x = rng.randn(2, side, side, 3).astype(np.float32)
    y = rng.randint(0, K, (2, side, side)).astype(np.int32)
    model = _model()
    params = _carried(model, x)
    jmod = JaxUNet(**NET)

    def jloss(p):
        logits = jmod.apply({"params": p}, jnp.asarray(x))
        return jnp.mean(jseg.seg_ce_loss(logits, jnp.asarray(y))), logits

    (_, want), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert tuple(got.shape) == (2, side, side, K)
    scale = np.abs(np.asarray(want)).max()
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5 * scale

    def loss(p):
        logits = functional_call(model, p, (torch.from_numpy(x),))
        return seg.seg_ce_loss(logits, torch.from_numpy(y).long()).mean()

    got_g = grad(loss)({k: v.detach() for k, v in model.named_parameters()})
    want_g = from_jax_params(_np(jg))[0]
    gscale = max(v.abs().max().item() for v in want_g.values())
    for k in want_g:
        assert (got_g[k] - want_g[k]).abs().max().item() <= 1e-5 * gscale, k


def _seg_batch(seed=0):
    rng = np.random.RandomState(seed)
    logits = rng.randn(3, 5, 6, K).astype(np.float32) * 3
    labels = rng.randint(0, K, (3, 5, 6)).astype(np.int32)
    labels[rng.rand(3, 5, 6) < 0.3] = 255
    labels[2] = 255  # a sample with every pixel ignored
    return logits, labels


@pytest.mark.parametrize("mode", ["ce", "focal"])
def test_seg_losses_match_jax(mode):
    """Per-example ``[B]`` losses with ignored pixels (and one sample all
    ignored: 0) and their gradient in the logits, within 1e-6 relative."""
    logits, labels = _seg_batch()
    jfn, fn = jseg.build_seg_loss(mode), seg.build_seg_loss(mode)
    want = jfn(jnp.asarray(logits), jnp.asarray(labels))
    jg = jax.grad(lambda z: jnp.sum(jfn(z, jnp.asarray(labels)) ** 2))(
        jnp.asarray(logits))
    lt = torch.from_numpy(logits)
    got = fn(lt, torch.from_numpy(labels).long())
    assert got.shape == (3,) and got[2].item() == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    g = grad(lambda z: (fn(z, torch.from_numpy(labels).long()) ** 2).sum())(
        lt)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-7)
    with pytest.raises(ValueError, match="unknown segmentation loss"):
        seg.build_seg_loss("dice")


def test_confusion_matrix_and_scores_match_jax():
    """The matrix with ignored and out-of-range labels equal to JAX's
    ``bincount`` one; the scores of int32 counts (f32, as JAX computes
    them) within 1e-7 and of the port's int64 counts (f64) within 1e-6 of
    JAX's f32; a class absent from the labels does not count."""
    rng = np.random.RandomState(1)
    pred = rng.randint(0, K, (4, 7, 9)).astype(np.int32)
    labels = rng.randint(0, K - 1, (4, 7, 9)).astype(np.int32)
    labels[rng.rand(4, 7, 9) < 0.2] = 255
    labels[0, 0, :3] = (-1, K, K + 3)
    want = np.asarray(jseg.confusion_matrix(jnp.asarray(pred),
                                            jnp.asarray(labels), K))
    got = seg.confusion_matrix(torch.from_numpy(pred),
                               torch.from_numpy(labels), K)
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)
    jscores = jseg.evaluator_scores(jnp.asarray(want))
    s32 = seg.evaluator_scores(got.int())
    s64 = seg.evaluator_scores(got)
    for k, v in jscores.items():
        assert s32[k].dtype == torch.float32 and s64[k].dtype == torch.float64
        assert abs(s32[k].item() - float(v)) <= 1e-7
        assert abs(s64[k].item() - float(v)) <= 1e-6


def test_metrics_keeper_matches_jax():
    a, b = jseg.EvaluationMetricsKeeper(), seg.EvaluationMetricsKeeper()
    assert a.aggregate() == b.aggregate() == {}
    for cid, m in ((0, {"acc": 0.5, "mIoU": 0.25}), (3, {"acc": 0.75,
                                                         "mIoU": 0.5}),
                   (0, {"acc": 1.0, "mIoU": 0.125})):
        a.add(cid, m)
        b.add(cid, {k: torch.tensor(v) for k, v in m.items()})
    assert a.aggregate() == b.aggregate()


def _seg_task(counts=(6, 4, 5), side=12, seed=0):
    """Client i holds ``counts[i]`` copies of one image and label map
    (labels with 255 pixels)."""
    rng = np.random.RandomState(seed)
    protos = rng.randn(len(counts), side, side, 3).astype(np.float32)
    maps = rng.randint(0, K, (len(counts), side, side)).astype(np.int32)
    maps[rng.rand(*maps.shape) < 0.2] = 255
    x = np.concatenate([np.repeat(protos[i:i + 1], c, 0)
                        for i, c in enumerate(counts)])
    y = np.concatenate([np.repeat(maps[i:i + 1], c, 0)
                        for i, c in enumerate(counts)])
    edges = np.concatenate([[0], np.cumsum(counts)])
    parts = {i: np.arange(edges[i], edges[i + 1]) for i in range(len(counts))}
    return x, y, parts


def _cfg(**kw):
    base = dict(client_num_in_total=3, client_num_per_round=2, comm_round=2,
                epochs=1, batch_size=2, lr=0.05, frequency_of_the_test=100)
    base.update(kw)
    return base


@pytest.mark.parametrize("mode", ["ce", "focal"])
def test_fedseg_rounds_and_evaluate_match_jax(mode):
    """Two rounds of ``FedSegAPI`` (2 of 3 clients, batch 2, padded steps)
    from JAX's start against JAX's class, then ``evaluate`` on 7 test
    images (a padded batch) and ``evaluate_clients``: params within 1e-5
    of the largest update (f32, other conv orders), losses within 1e-5
    relative, the metrics within 1e-6."""
    x, y, parts = _seg_task()
    tx, ty, _ = _seg_task(counts=(7,), seed=5)
    cfg = _cfg()
    japi = jseg.FedSegAPI(
        JaxUNet(**NET), jax_batching.build_federated_arrays(x, y, parts, 2),
        jax_batching.batch_global(tx, ty, 4), JaxFedConfig(**cfg),
        num_classes=K, loss_mode=mode)
    api = FedSegAPI(_model(), build_federated_arrays(x, y, parts, 2,
                                                     device="cpu"),
                    batch_global(tx, ty, 4, device="cpu"), FedConfig(**cfg),
                    num_classes=K, loss_mode=mode, device="cpu")
    start = from_jax_params(_np(japi.net.params))[0]
    api.net = NetState(dict(start), {})
    for r in range(2):
        want = japi.train_one_round(r)["train_loss"]
        assert abs(api.train_one_round(r)["train_loss"] - want) <= 1e-5 * abs(
            want)
    want = from_jax_params(_np(japi.net.params))[0]
    upd = max((want[k] - start[k]).abs().max().item() for k in want)
    assert max((api.net.params[k] - want[k]).abs().max().item()
               for k in want) <= 1e-5 * upd
    jm, m = japi.evaluate(), api.evaluate()
    assert jm.keys() == m.keys()
    assert all(abs(m[k] - jm[k]) <= 1e-6 for k in jm)
    local = {0: (tx[:3], ty[:3]), 2: (tx[3:], ty[3:])}
    jc = japi.evaluate_clients({c: jax_batching.batch_global(a, b, 2)
                                for c, (a, b) in local.items()})
    pc = api.evaluate_clients({c: batch_global(a, b, 2, device="cpu")
                               for c, (a, b) in local.items()})
    assert all(abs(pc[k] - jc[k]) <= 1e-6 for k in jc)


def test_fedseg_tiers_agree():
    """From one start: 2 ``train_one_round`` rounds and the same 2 through
    ``train_rounds_pipelined``, bit-equal; at full participation
    ``train_rounds_on_device(2)`` bit-equal to 2 eager ``run_round`` +
    ``_server_update`` rounds on every client."""
    x, y, parts = _seg_task()

    def make(per_round):
        return FedSegAPI(_model(), build_federated_arrays(
            x, y, parts, 2, device="cpu"), None,
            FedConfig(**_cfg(client_num_per_round=per_round)),
            num_classes=K, device="cpu")

    api = make(2)
    start, rng0 = dict(api.net.params), api.rng.clone()
    losses = [api.train_one_round(r)["train_loss"] for r in range(2)]
    one = dict(api.net.params)
    api.net, api.rng = NetState(dict(start), {}), rng0.clone()
    assert api.train_rounds_pipelined(2) == losses
    assert all(torch.equal(one[k], api.net.params[k]) for k in one)
    full = make(3)
    dev = full.train_rounds_on_device(2).tolist()
    dev_net = dict(full.net.params)
    full.net, full.rng = NetState(dict(start), {}), rng0.clone()
    full.sample_round = lambda r: np.arange(3)
    eager = []
    for r in range(2):
        avg, loss = full.run_round(r)
        full.net = full._server_update(full.net, avg)
        eager.append(loss.item())
    assert dev == eager
    assert all(torch.equal(dev_net[k], full.net.params[k]) for k in dev_net)
    assert full.evaluate() == {}


def test_refusals(monkeypatch):
    """Without a CUDA device the model and the class raise unless asked for
    the CPU."""
    x, y, parts = _seg_task()
    fed = build_federated_arrays(x, y, parts, 2, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model("unet", **NET)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FedSegAPI(_model(), fed, None, FedConfig(**_cfg()), num_classes=K)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_federated_arrays(x, y, parts, 2)


def test_confusion_matrix_is_fixed_length():
    """Every pixel ignored still gives a ``[C, C]`` matrix of zeros: the
    bins are C² + 1 whatever the data (no size read from the data)."""
    labels = torch.full((2, 3, 3), 255)
    cm = seg.confusion_matrix(torch.zeros_like(labels), labels, K)
    assert cm.shape == (K, K) and int(cm.sum()) == 0
    scores = seg.evaluator_scores(cm)
    assert all(float(v) == 0.0 for v in scores.values())
