"""Rematerialization in the port (``fedml_tpu_torch/trainer/remat.py``):
the loss wrapped in an ``autograd.Function`` that keeps only its inputs
and recomputes the forward in its backward.

JAX pins ``remat`` as a change of memory, not of math: the trained params
equal the run without it (``tests/test_fedavg.py:78``). The port holds the
same bit for bit: ``LocalTrain`` for one client and for the cohort under
``vmap``, with and without DP-SGD (whose per-example loss is wrapped too),
``CorrectedLocalTrain`` (SCAFFOLD's and FedDyn's trainer), FedAvg rounds
through ``FedAvgAPI``, a BatchNorm model's trained state and a dropout
model's masks (the keys are inputs of the recomputed forward). Also the
Function alone: its gradient against ``torch.func.grad`` of the plain
function, under ``vmap``, with an aux output, and the refusal of
``torch.utils.checkpoint`` under ``torch.func`` that it replaces.
"""

import numpy as np
import pytest
import torch
from torch.func import grad, grad_and_value, vmap

from fedml_tpu_torch.algos import FedAvgAPI, FedConfig
from fedml_tpu_torch.core import keys
from fedml_tpu_torch.core.tree import tree_map
from fedml_tpu_torch.data import (build_federated_arrays,
                                  make_image_classification, partition_homo)
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.trainer.local import (make_client_optimizer,
                                           make_corrected_local_train,
                                           make_local_train_fn, model_fns)
from fedml_tpu_torch.trainer.remat import checkpoint

WIDTHS = (4, 8, 16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(kind):
    gen = torch.Generator().manual_seed(0)
    if kind == "gn":
        return create_model("resnet20", widths=WIDTHS, num_classes=3,
                            device="cpu", generator=gen)
    if kind == "bn":
        return create_model("resnet20", widths=WIDTHS, num_classes=3,
                            norm="bn", device="cpu", generator=gen)
    return create_model("cnn", num_classes=3, dropout=True, device="cpu",
                        generator=gen)


def _data(kind, c=2, s=2, b=3, seed=0):
    rng = np.random.RandomState(seed)
    hw = (28, 28, 1) if kind == "dropout" else (8, 8, 3)
    x = torch.from_numpy(rng.randn(c, s, b, *hw).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 3, size=(c, s, b))).long()
    mask = torch.ones(c, s, b)
    mask[1, 1, 1:] = 0.0
    return x, y, mask


def _assert_same(a, b):
    for name in a:
        assert torch.equal(a[name], b[name]), name


@pytest.mark.parametrize("kind,dp", [
    ("gn", False), ("gn", True), ("bn", False), ("dropout", False),
    ("dropout", True)])
def test_local_train_remat_bit_equal(kind, dp):
    """One client and the cohort: the params, the trained state and the
    losses with remat equal those without it, bit for bit (DP leaves the
    model state as it was, so BatchNorm's stats run without it)."""
    model = _model(kind)
    fns = model_fns(model)
    net = fns.init()
    x, y, mask = _data(kind)
    rngs = keys.fold_in(keys.key(3), torch.arange(x.shape[0]))
    kw = dict(dp_clip=0.5, dp_noise_multiplier=1.1) if dp else {}
    outs = []
    for remat in (False, True):
        lt = make_local_train_fn(fns.apply, make_client_optimizer("sgd", 0.1),
                                 2, remat=remat, **kw)
        cohort, losses = lt.run_clients(net, x, y, mask, rngs)
        one, loss = lt(net, x[0], y[0], mask[0], rngs[0])
        outs.append((cohort, losses, one, loss))
    (c0, l0, o0, s0), (c1, l1, o1, s1) = outs
    _assert_same(c0.params, c1.params)
    _assert_same(c0.model_state, c1.model_state)
    _assert_same(o0.params, o1.params)
    _assert_same(o0.model_state, o1.model_state)
    assert torch.equal(l0, l1) and torch.equal(s0, s1)
    moved = any(not torch.equal(c1.params[k][0], net.params[k])
                for k in net.params)
    assert moved
    if kind == "bn":  # the running stats moved, and the same way
        assert any(not torch.equal(c1.model_state[k][0], net.model_state[k])
                   for k in net.model_state)


def test_corrected_local_train_remat_bit_equal():
    """SCAFFOLD's corrected step (p - lr (g + correction)) over the
    cohort, with ``K``: remat bit-equal."""
    fns = model_fns(_model("gn"))
    net = fns.init()
    x, y, mask = _data("gn")
    rngs = keys.fold_in(keys.key(4), torch.arange(x.shape[0]))
    corr = tree_map(lambda p: 0.01 * torch.ones(2, *p.shape), net.params)

    def step_update(params, grads, c):
        return tree_map(lambda p, g, cc: p - 0.1 * (g + cc), params, grads,
                        c)

    outs = []
    for remat in (False, True):
        lt = make_corrected_local_train(fns.apply, 2, _ce, step_update,
                                        remat=remat, with_step_count=True)
        outs.append(lt.run_clients(net, corr, x, y, mask, rngs))
        outs.append(lt(net, tree_map(lambda t: t[0], corr), x[0], y[0],
                       mask[0], rngs[0]))
    for a, b in ((outs[0], outs[2]), (outs[1], outs[3])):
        _assert_same(a[0].params, b[0].params)
        assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])


def _ce(logits, labels):
    return torch.nn.functional.cross_entropy(logits.float(), labels,
                                             reduction="none")


@pytest.mark.parametrize("dp", [False, True], ids=["plain", "dp"])
def test_fedavg_rounds_remat_bit_equal(dp):
    """JAX's own pin: two FedAvg rounds with remat equal those without."""
    x, y = make_image_classification(48, hwc=(8, 8, 3), n_classes=3)
    fed = build_federated_arrays(x, y, partition_homo(48, 4), 6,
                                 device="cpu")
    nets = []
    for remat in (False, True):
        cfg = FedConfig(client_num_in_total=4, client_num_per_round=3,
                        epochs=1, batch_size=6, lr=0.05, remat=remat,
                        dp_clip=0.5 if dp else 0.0,
                        dp_noise_multiplier=1.1 if dp else 0.0)
        api = FedAvgAPI(_model("gn"), fed, None, cfg, device="cpu")
        for r in range(2):
            api.train_one_round(r)
        nets.append(api.net.params)
    _assert_same(*nets)


def _mlp(p, x, w_aux):
    h = torch.tanh(x @ p["w1"] + p["b1"])
    return (h @ p["w2"]).square().sum() + (w_aux * 0).sum(), {"h": h}


def _params(gen):
    return {"w1": torch.randn(4, 5, generator=gen),
            "b1": torch.randn(5, generator=gen),
            "w2": torch.randn(5, 2, generator=gen)}


def test_checkpoint_gradient_equals_plain():
    gen = torch.Generator().manual_seed(0)
    p, x, aux = _params(gen), torch.randn(3, 4, generator=gen), torch.ones(2)
    want, (loss_w, aux_w) = grad_and_value(_mlp, has_aux=True)(p, x, aux)
    got, (loss_g, aux_g) = grad_and_value(checkpoint(_mlp), has_aux=True)(
        p, x, aux)
    _assert_same(want, got)
    assert torch.equal(loss_w, loss_g) and torch.equal(aux_w["h"],
                                                       aux_g["h"])
    # Eager autograd (no torch.func) through the Function as well.
    leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    loss, _ = checkpoint(_mlp)(leaves, x, aux)
    loss.backward()
    for k in p:
        assert torch.equal(leaves[k].grad, want[k]), k


def test_checkpoint_under_vmap():
    """Per-example gradients (``vmap`` of ``grad``) through the Function,
    and over a batch of param sets: each the plain one's."""
    gen = torch.Generator().manual_seed(1)
    p, x = _params(gen), torch.randn(6, 1, 4, generator=gen)
    aux = torch.ones(2)

    def loss_only(f):
        return lambda p, x, a: f(p, x, a)[0]

    want = vmap(grad(loss_only(_mlp)), in_dims=(None, 0, None))(p, x, aux)
    got = vmap(grad(loss_only(checkpoint(_mlp))), in_dims=(None, 0, None))(
        p, x, aux)
    _assert_same(want, got)
    ps = tree_map(lambda t: torch.stack([t, 2 * t]), p)
    want = vmap(grad(loss_only(_mlp)), in_dims=(0, None, None))(ps, x[0],
                                                                aux)
    got = vmap(grad(loss_only(checkpoint(_mlp))), in_dims=(0, None, None))(
        ps, x[0], aux)
    _assert_same(want, got)


def test_torch_utils_checkpoint_does_not_compose_with_func_grad():
    """Why the port has its own Function: both modes of
    ``torch.utils.checkpoint`` fail under ``torch.func.grad``."""
    from torch.utils.checkpoint import checkpoint as torch_checkpoint

    gen = torch.Generator().manual_seed(2)
    p, x = _params(gen), torch.randn(3, 4, generator=gen)

    for reentrant in (False, True):
        def loss(p):
            return torch_checkpoint(lambda w1: (torch.tanh(x @ w1) @ p["w2"]
                                                ).sum(), p["w1"],
                                    use_reentrant=reentrant)

        with pytest.raises(RuntimeError):
            grad(loss)(p)
