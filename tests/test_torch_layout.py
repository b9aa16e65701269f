"""Compute layouts and the bf16 client step (``fedml_tpu_torch/parallel/
layout.py``, ``cfg.compute_layout``, ``cfg.client_step_dtype``) against
the JAX package's ``fedml_tpu/parallel/layout.py``: the port's
counterparts of ``tests/test_layout.py``.

The invisibility contract: the padded client step changes where the
step computes, never what anything above it sees. On the CPU the padded
GroupNorm ResNet's forward is bit-equal to the logical one, and so is
GroupNorm at the padded widths with whole extra groups (its pad channels
exactly 0); its f32 step holds 1e-6, since the convolutions' gradient
reductions over (N, H, W) take another order in oneDNN when the channel
count changes (XLA's CPU step is bit-equal in JAX's tests). The CNN's
flatten boundary and the im2col stem's forward hold the CNN family's
tolerance (rtol 1e-4, atol 1e-5); the im2col stem's step is held in f64.
The
parity runs pass ``lane=128, sublane=8`` so that the twins have JAX's
physical shapes."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.models.cnn import CNNOriginalFedAvg as JaxCNNOriginal
from fedml_tpu.models.resnet import CifarResNet as JaxCifarResNet
from fedml_tpu.parallel import layout as jl
from fedml_tpu.trainer.local import make_client_optimizer as jax_optimizer
from fedml_tpu.trainer.local import make_local_train_fn as jax_local_train
from fedml_tpu.trainer.local import model_fns as jax_model_fns
from fedml_tpu_torch.algos import (FedAdapterAPI, FedAvgAPI, FedConfig,
                                   FedProxAPI)
from fedml_tpu_torch.convert import from_jax_params, to_jax_params
from fedml_tpu_torch.core import keys
from fedml_tpu_torch.data import build_federated_arrays, partition_homo
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models.cnn import CNNDropOut, CNNOriginalFedAvg
from fedml_tpu_torch.models.resnet import CifarResNet
from fedml_tpu_torch.parallel import layout as tl
from fedml_tpu_torch.trainer.local import (NetState, make_client_optimizer,
                                           make_local_train_fn, model_fns)

# The CNN family's tolerance for a padded or rephrased contraction.
CNN_RTOL, CNN_ATOL = 1e-4, 1e-5
# A bf16 client step against JAX's: both compute in bf16 from the same f32
# params, in other summation orders, and JAX rounds the loss to bf16
# (measured up to 3.1e-3 apart after 2 steps, on params of O(0.1)).
BF16_TOL = 5e-3
# The padded ResNet's f32 step against the logical one on the CPU: the
# forward is bit-equal, but oneDNN's and ATen's gradient reductions over
# (N, H, W) take another order when the channel count changes (measured
# 4e-7 apart after 2 epochs); JAX's trajectory tolerance for 3 rounds.
PAD_STEP_TOL = 1e-6
ROUND_RTOL, ROUND_ATOL = 1e-4, 1e-6
# The im2col stem's 2-epoch step against the 5x5 stem's, both in f64: the
# two contractions are the same function summed in another order (worst
# |d| 9e-15 over 200 seeds on the CPU for each stem).
IM2COL_F64_ATOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mis_resnet(**kw):
    """The mis-sized GroupNorm ResNet of JAX's tests: widths 20/40/80, stem
    20 (the layout pads 20 -> 24)."""
    return CifarResNet(layers=(1, 1, 1), num_classes=10, widths=(20, 40, 80),
                       stem_width=20,
                       generator=torch.Generator().manual_seed(0), **kw)


# --- the pad policy ------------------------------------------------------------

@pytest.mark.parametrize("lane", [128, 64])
def test_pad_width_and_channels_match_jax(lane):
    """``pad_width`` and ``pad_channels`` equal JAX's for widths 1..300,
    with and without GroupNorm quanta, at JAX's lanes and the card's."""
    pol, jpol = tl.LayoutPolicy(lane=lane), jl.LayoutPolicy(lane=lane)
    for c in range(1, 301):
        assert tl.pad_width(c, pol) == jl.pad_width(c, jpol), c
        for quanta in ((), (3,), (1, 1), (2, 5), (4, 5)):
            assert tl.pad_channels(c, pol, quanta) == jl.pad_channels(
                c, jpol, quanta), (c, quanta)
    assert tl.LayoutPolicy() == tl.LayoutPolicy(lane=128, sublane=8,
                                                lane_snap=0.25)
    assert (tl.CARD_LANE, tl.CARD_SUBLANE) == (64, 8)
    # The card's unit: 8-channel multiples, and a snap to 64 within 16.
    card = tl.LayoutPolicy(lane=64)
    assert [tl.pad_width(c, card) for c in (12, 20, 48, 50, 96, 120)] == \
        [16, 24, 64, 64, 96, 128]


def test_reference_models_are_identity():
    """The flagship ResNet (16/32/64, both stems) and the FEMNIST CNN
    (32/64) pad nothing under either policy: the API skips the wrapper."""
    for lane in (128, 64):
        for model, shape in (
                (CifarResNet(layers=(2, 2, 2)), (2, 32, 32, 3)),
                (CifarResNet(layers=(2, 2, 2), stem="s2d"), (2, 32, 32, 3)),
                (CNNOriginalFedAvg(num_classes=62), (2, 28, 28, 1))):
            assert tl.compute_layout(model, torch.zeros(shape),
                                     lane=lane).is_identity


# --- the padded step against the logical one ----------------------------------------

def _step_pair(model, x_shape, opt_name="momentum", epochs=2, **kw):
    """One client's local training of the logical model and of the
    wrapped physical twin, from one net, on one batch set (3 steps of 4,
    the last partly masked)."""
    layout = tl.compute_layout(model, torch.zeros(x_shape), lane=128,
                               sublane=8, **kw)
    assert not layout.is_identity
    fns_log, fns_phys = model_fns(model), model_fns(layout.physical_model)
    net = fns_log.init()
    opt = make_client_optimizer(opt_name, 0.1)
    lt_log = make_local_train_fn(fns_log.apply, opt, epochs)
    lt_phys = tl.wrap_local_train(make_local_train_fn(fns_phys.apply, opt,
                                                      epochs), layout)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(3, 4, *x_shape[1:]).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 10, (3, 4)))
    mask = torch.ones(3, 4)
    mask[-1, 2:] = 0.0
    out_log = lt_log(net, x, y, mask, keys.key(7))
    out_phys = lt_phys(net, x, y, mask, keys.key(7))
    return layout, out_log, out_phys


def test_cifar_resnet_padded_step_bit_exact_fp32():
    """The padded GroupNorm ResNet (24/40/80, stem 24, whole extra groups):
    its forward bit-equal to the logical one's, its f32 step within 1e-6
    (params; the epochs' loss bit-equal); its params' shapes are JAX's
    twin's, and the physical net's pad entries stay exactly 0 through
    training."""
    model = _mis_resnet()
    layout, (n1, l1), (n2, l2) = _step_pair(model, (4, 16, 16, 3))
    assert torch.equal(l1, l2)
    for k in n1.params:
        assert n2.params[k].shape == n1.params[k].shape
        torch.testing.assert_close(n2.params[k], n1.params[k], rtol=0,
                                   atol=PAD_STEP_TOL)
    assert layout.describe()["padded_leaves"] > 0
    net = model_fns(model).init()
    x = torch.randn(4, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    for train in (False, True):
        assert torch.equal(
            model_fns(layout.physical_model).apply(layout.pad(net), x,
                                                   train)[0],
            model_fns(model).apply(net, x, train)[0])
    jtwin, _ = jl._cifar_resnet_twin(
        JaxCifarResNet(layers=(1, 1, 1), num_classes=10,
                       widths=(20, 40, 80), stem_width=20),
        jl.LayoutPolicy())
    jshapes = jax.eval_shape(
        lambda k: jax_model_fns(jtwin).init(k, jnp.zeros((4, 16, 16, 3))),
        jax.random.PRNGKey(0)).params
    phys = layout.physical_model
    want = jax.tree_util.tree_leaves_with_path(jshapes)
    got = dict(jax.tree_util.tree_leaves_with_path(to_jax_params(
        {k: v.detach() for k, v in phys.named_parameters()})))
    assert len(got) == len(want)
    for path, leaf in want:
        assert tuple(got[path].shape) == tuple(leaf.shape), path
    assert [m.num_groups for m in (phys.Norm_0,
                                   phys.BottleneckBlock_0.Norm_0)] == [24, 24]
    # The physical net after training: pad entries exactly zero.
    fns = model_fns(phys)
    lt = make_local_train_fn(fns.apply, make_client_optimizer("momentum",
                                                              0.1), 1)
    x = torch.randn(2, 4, 16, 16, 3, generator=torch.Generator()
                    .manual_seed(1))
    pnet, _ = lt(layout.pad(model_fns(model).init()), x,
                 torch.zeros(2, 4, dtype=torch.long), torch.ones(2, 4),
                 keys.key(1))
    # Zero pad entries: slicing the logical block out and padding it again
    # gives the physical net back exactly.
    again = layout.pad(layout.unpad(pnet))
    for tree, back in ((pnet.params, again.params),
                       (pnet.model_state, again.model_state)):
        for name, leaf in tree.items():
            assert torch.equal(leaf, back[name]), name


def test_padded_group_norm_count_refused_when_groups_split():
    """A padded width that is not a multiple of the logical group size is
    refused, with JAX's words."""
    from fedml_tpu_torch.models.resnet import Norm

    assert Norm("gn", 48, logical_channels=40).num_groups == 24
    with pytest.raises(ValueError, match="logical group size 5"):
        Norm("gn", 168, logical_channels=160)


def test_cnn_flatten_padded_step_close():
    """The CNN pads through its flatten boundary (Dense_0's inputs
    interleave (h, w, c)): the padded step within the CNN tolerance, the
    Dense kernel mapped so the logical forward is unchanged."""
    model = CNNOriginalFedAvg(num_classes=10, widths=(12, 20),
                              generator=torch.Generator().manual_seed(0))
    layout, (n1, l1), (n2, l2) = _step_pair(model, (4, 28, 28, 1), "sgd")
    assert layout.physical_model.widths == (16, 24)
    for k in n1.params:
        torch.testing.assert_close(n2.params[k], n1.params[k],
                                   rtol=CNN_RTOL, atol=CNN_ATOL)
    assert abs(float(l1) - float(l2)) < CNN_ATOL
    x = torch.randn(3, 28, 28, 1, generator=torch.Generator().manual_seed(0))
    net = model_fns(model).init()
    want = model_fns(model).apply(net, x)[0]
    got = model_fns(layout.physical_model).apply(layout.pad(net), x)[0]
    torch.testing.assert_close(got, want, rtol=CNN_RTOL, atol=CNN_ATOL)
    back = layout.unpad(layout.pad(net))
    assert all(torch.equal(back.params[k], net.params[k]) for k in net.params)


@pytest.mark.parametrize("stem", ["conv", "s2d"])
def test_im2col_stem_within_the_cnn_tolerance(stem):
    """The im2col twin (patches in (c, kh, kw) order + a 1x1 conv) against
    the 5x5 stem: the forward with the kernel mapped within the CNN
    family's tolerance, and a 2-epoch step held in f64 (see
    ``IM2COL_F64_ATOL``); the mapping is exact both ways. The inputs come
    from a seeded generator."""
    g = torch.Generator().manual_seed(0)
    model = CNNOriginalFedAvg(num_classes=10, stem=stem,
                              generator=torch.Generator().manual_seed(0))
    layout = tl.im2col_layout(model, torch.zeros(4, 28, 28, 1))
    phys = layout.physical_model
    cin = 4 if stem == "s2d" else 1
    assert phys.Conv_0.weight.shape == (32, cin * 25, 1, 1)
    net = model_fns(model).init()
    x = torch.randn(3, 28, 28, 1, generator=g)
    torch.testing.assert_close(
        model_fns(phys).apply(layout.pad(net), x)[0],
        model_fns(model).apply(net, x)[0], rtol=CNN_RTOL, atol=CNN_ATOL)
    back = layout.unpad(layout.pad(net))
    assert all(torch.equal(back.params[k], net.params[k]) for k in net.params)
    # The step in f64: in f32 the two stems' summation orders differ by
    # rounding that max-pool and ReLU turn into a different branch for
    # some inputs (up to 0.15 apart after 2 SGD steps at lr 0.1, 240
    # seeds), so no f32 bound is both safe and tight.
    model64, phys64 = copy.deepcopy(model).double(), copy.deepcopy(phys).double()
    net64 = NetState({k: v.double() for k, v in net.params.items()}, {})
    opt = make_client_optimizer("sgd", 0.1)
    lt_log = make_local_train_fn(model_fns(model64).apply, opt, 2)
    lt_phys = tl.wrap_local_train(make_local_train_fn(
        model_fns(phys64).apply, opt, 2), layout)
    xs = torch.randn(3, 4, 28, 28, 1, generator=g, dtype=torch.float64)
    ys = torch.randint(0, 10, (3, 4), generator=g)
    m = torch.ones(3, 4, dtype=torch.float64)
    (a, la), (b, lb) = (lt(net64, xs, ys, m, keys.key(3))
                        for lt in (lt_log, lt_phys))
    for k in a.params:
        assert a.params[k].dtype == b.params[k].dtype == torch.float64
        torch.testing.assert_close(b.params[k], a.params[k], rtol=0,
                                   atol=IM2COL_F64_ATOL)
    assert not torch.equal(a.params["Conv_0.weight"], net64.params[
        "Conv_0.weight"])
    # The JAX twin's stem: the same (c, kh, kw) channel order.
    jm = JaxCNNOriginal(num_classes=10, stem=stem)
    jnet = jax_model_fns(jm).init(jax.random.PRNGKey(0),
                                  jnp.zeros((2, 28, 28, 1)))
    jlay = jl.im2col_layout(jm, np.zeros((2, 28, 28, 1), np.float32))
    jphys = np.asarray(jlay.pad(jnet).params["Conv_0"]["kernel"])
    port = from_jax_params(jax.tree.map(np.asarray, jnet.params))[0]
    mine = layout.pad(NetState(port, {})).params["Conv_0.weight"]
    np.testing.assert_array_equal(mine.numpy(),
                                  jphys.transpose(3, 2, 0, 1))


# --- through FedAvgAPI ---------------------------------------------------------------

def _fed_cifar_small(n_clients=8, per_client=8, batch=4, hw=16):
    rng = np.random.RandomState(0)
    x = rng.randn(n_clients * per_client, hw, hw, 3).astype(np.float32)
    y = rng.randint(0, 10, len(x)).astype(np.int32)
    return build_federated_arrays(x, y, partition_homo(len(x), n_clients),
                                  batch, device="cpu")


def _cfg(**kw):
    base = dict(client_num_in_total=8, client_num_per_round=4,
                comm_round=3, epochs=1, batch_size=4, lr=0.1,
                frequency_of_the_test=100)
    base.update(kw)
    return FedConfig(**base)


def test_layout_invisible_above_the_client_step():
    """``compute_layout="auto"`` (the card's unit) against ``"none"``: 3
    rounds with the twin engaged, ``api.net`` at the logical shapes
    throughout, losses within rtol 1e-5 and params within JAX's
    trajectory tolerance (rtol 1e-4, atol 1e-6)."""
    fed = _fed_cifar_small()
    a = FedAvgAPI(_mis_resnet(), fed, None, _cfg(compute_layout="none"),
                  device="cpu")
    b = FedAvgAPI(_mis_resnet(), fed, None, _cfg(compute_layout="auto"),
                  device="cpu")
    assert b._layout is not None and a._layout is None
    for r in range(3):
        la = a.train_one_round(r)["train_loss"]
        assert b.train_one_round(r)["train_loss"] == pytest.approx(
            la, rel=1e-5)
        for k in a.net.params:
            assert b.net.params[k].shape == a.net.params[k].shape
    for k in a.net.params:
        torch.testing.assert_close(b.net.params[k], a.net.params[k],
                                   rtol=ROUND_RTOL, atol=ROUND_ATOL)


def test_bf16_step_matches_jax():
    """``step_dtype_model`` clones to bf16 compute with f32 params: 2
    local steps of the bf16 CNN against JAX's bf16 twin from the same
    weights, params within 5e-3 (both step in bf16, other summation
    orders; JAX also rounds the loss to bf16, the port takes the CE in
    f32); the trained params stay f32 and moved by more than that."""
    from fedml_tpu.parallel.layout import step_dtype_model as jax_sdm

    jm = JaxCNNOriginal(num_classes=10, widths=(8, 16), hidden=32)
    jnet = jax_model_fns(jm).init(jax.random.PRNGKey(0),
                                  jnp.zeros((2, 28, 28, 1)))
    model = CNNOriginalFedAvg(num_classes=10, widths=(8, 16), hidden=32)
    twin = tl.step_dtype_model(model, torch.bfloat16)
    assert twin.dtype == torch.bfloat16 and all(
        p.dtype == torch.float32 for p in twin.parameters())
    # One sample in every slot, so the shuffle bits cannot matter.
    rng = np.random.RandomState(0)
    x = np.broadcast_to(rng.randn(1, 1, 28, 28, 1).astype(np.float32),
                        (2, 4, 28, 28, 1)).copy()
    y = np.full((2, 4), 3, np.int32)
    m = np.ones((2, 4), np.float32)
    jlt = jax_local_train(jax_model_fns(jax_sdm(jm, jnp.bfloat16)).apply,
                          jax_optimizer("sgd", 0.05), 1)
    jout, _ = jlt(jnet, jnp.asarray(x), jnp.asarray(y), jnp.asarray(m),
                  jax.random.PRNGKey(1))
    lt = make_local_train_fn(model_fns(twin).apply,
                             make_client_optimizer("sgd", 0.05), 1)
    net = NetState(from_jax_params(jax.tree.map(np.asarray,
                                                jnet.params))[0], {})
    out, _ = lt(net, torch.from_numpy(x), torch.from_numpy(y),
                torch.from_numpy(m), keys.key(1))
    assert all(v.dtype == torch.float32 for v in out.params.values())
    got = dict(jax.tree_util.tree_leaves_with_path(to_jax_params(out.params)))
    moved = 0.0
    for path, want in jax.tree_util.tree_leaves_with_path(
            jax.tree.map(np.asarray, jout.params)):
        np.testing.assert_allclose(got[path], want, rtol=0, atol=BF16_TOL)
    for path, start in jax.tree_util.tree_leaves_with_path(
            jax.tree.map(np.asarray, jnet.params)):
        moved = max(moved, float(np.abs(got[path] - start).max()))
    assert moved > BF16_TOL


def test_bf16_and_layout_compose_through_fedavg():
    """``client_step_dtype="bf16"`` with ``compute_layout="auto"``: the
    bf16 clone is the padded twin's; a round trains, ``api.net`` stays f32
    at the logical shapes, and evaluation runs the f32 logical model."""
    fed = _fed_cifar_small()
    api = FedAvgAPI(_mis_resnet(), fed, None,
                    _cfg(compute_layout="auto", client_step_dtype="bf16"),
                    device="cpu")
    assert api._layout is not None
    twin = api.local_train.inner.apply_fn
    assert twin is api._step_fns.apply
    loss = api.train_one_round(0)["train_loss"]
    assert np.isfinite(loss)
    ref = _mis_resnet()
    for k, v in api.net.params.items():
        assert v.dtype == torch.float32
        assert v.shape == dict(ref.named_parameters())[k].shape


def test_unsupported_models_and_configs_refused():
    """The JAX package's refusals, with its words."""
    with pytest.raises(NotImplementedError, match="dropout"):
        tl.compute_layout(CNNDropOut(num_classes=62),
                          torch.zeros(2, 28, 28, 1))
    lr = create_model("lr", in_features=6, num_classes=2, device="cpu")
    with pytest.raises(NotImplementedError, match="physical-twin"):
        tl.compute_layout(lr, torch.zeros(2, 6))
    with pytest.raises(NotImplementedError, match="stem-rephrasing"):
        tl.im2col_layout(_mis_resnet(), torch.zeros(2, 16, 16, 3))
    with pytest.raises(ValueError, match="already an im2col"):
        tl.im2col_layout(CNNOriginalFedAvg(im2col=True),
                         torch.zeros(2, 28, 28, 1))
    with pytest.raises(ValueError, match="already a padded"):
        tl.compute_layout(tl.compute_layout(
            _mis_resnet(), torch.zeros(2, 16, 16, 3)).physical_model,
            torch.zeros(2, 16, 16, 3))
    gn18 = create_model("resnet10_gn", device="cpu")
    with pytest.raises(NotImplementedError, match="compute-dtype"):
        tl.step_dtype_model(gn18, torch.bfloat16)
    fed = _fed_cifar_small()
    with pytest.raises(NotImplementedError, match="local trainer"):
        FedProxAPI(_mis_resnet(), fed, None, _cfg(compute_layout="auto"),
                   device="cpu")
    with pytest.raises(NotImplementedError, match="local trainer"):
        FedProxAPI(_mis_resnet(), fed, None,
                   _cfg(client_step_dtype="bf16"), device="cpu")
    with pytest.raises(ValueError, match="compute_layout"):
        FedAvgAPI(_mis_resnet(), fed, None, _cfg(compute_layout="lanes"),
                  device="cpu")
    with pytest.raises(NotImplementedError, match="DP noise"):
        FedAvgAPI(_mis_resnet(), fed, None,
                  _cfg(compute_layout="auto", dp_clip=1.0,
                       dp_noise_multiplier=0.5), device="cpu")
    with pytest.raises(NotImplementedError, match="compute-dtype"):
        FedAvgAPI(gn18, build_federated_arrays(
            np.zeros((16, 32, 32, 3), np.float32), np.zeros(16, np.int32),
            partition_homo(16, 8), 2, device="cpu"), None,
            _cfg(client_step_dtype="bf16", batch_size=2), device="cpu")


@pytest.mark.parametrize("field,val,match", [
    ("compute_layout", "auto", "compute_layout pads the trainable tree"),
    ("client_step_dtype", "bf16", "client_step_dtype casts the trained"),
])
def test_fedadapter_refuses_both(field, val, match):
    """FedAdapter's two refusals (its net is the adapter tree behind a
    frozen base): JAX's fedadapter.py:75-85."""
    with pytest.raises(NotImplementedError, match=match):
        FedAdapterAPI(None, None, None, FedConfig(**{field: val}),
                      device="cpu")
