"""The port's FedAvg training path — vendored data helpers, the local
trainer, the client-parallel round and ``FedAvgAPI`` — against the JAX
package (``fedml_tpu.algos.fedavg`` and the modules under it), plus the
trainer's own invariants. Inputs are numpy from a seed; the JAX start
parameters reach the port through ``convert.from_jax_params``."""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fedml_tpu.algos.config import FedConfig as JaxFedConfig
from fedml_tpu.algos.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.core import sampling as jax_sampling
from fedml_tpu.data import batching as jax_batching
from fedml_tpu.data import partition as jax_partition
from fedml_tpu.data import synthetic as jax_synthetic
from fedml_tpu.models.registry import create_model as jax_create_model
from fedml_tpu.trainer.local import make_client_optimizer as jax_optimizer
from fedml_tpu_torch.algos import FedAvgAPI, FedConfig
from fedml_tpu_torch.convert import from_jax_params, to_jax_params
from fedml_tpu_torch.core import keys, sampling
from fedml_tpu_torch.core.tree import tree_map, tree_weighted_mean
from fedml_tpu_torch.data import batching, partition, synthetic
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.parallel.shard import client_rngs, make_vmap_round
from fedml_tpu_torch.trainer.local import (NetState, apply_updates,
                                           epoch_perm, make_client_optimizer,
                                           make_local_train_fn, model_fns)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
WIDTHS = (4, 8, 16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _task(n=60, clients=6, seed=0):
    x, y = synthetic.make_image_classification(n, (8, 8, 3), 4, seed=seed)
    parts = partition.partition_dirichlet(y, clients, 0.5, min_size=4,
                                          seed=seed)
    return x, y, parts


def _model(**kw):
    return create_model("resnet20", widths=WIDTHS, num_classes=4,
                        device="cpu", generator=torch.Generator().manual_seed(0),
                        **kw)


# --- vendored helpers ---------------------------------------------------------

def test_vendored_helpers_equal_the_originals():
    for r in range(5):
        np.testing.assert_array_equal(sampling.sample_clients(r, 128, 8),
                                      jax_sampling.sample_clients(r, 128, 8))
    counts = np.random.RandomState(1).randint(0, 50, 40)
    np.testing.assert_array_equal(
        sampling.sample_clients_weighted(3, 40, 10, counts),
        jax_sampling.sample_clients_weighted(3, 40, 10, counts))
    for a, b in zip(sampling.pad_to_multiple(np.arange(5, dtype=np.int32), 4),
                    jax_sampling.pad_to_multiple(np.arange(5, dtype=np.int32),
                                                 4)):
        np.testing.assert_array_equal(a, b)
    x, y = synthetic.make_image_classification(50, (4, 4, 3), 5, seed=3)
    jx, jy = jax_synthetic.make_image_classification(50, (4, 4, 3), 5, seed=3)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    for got, want in ((partition.partition_homo(50, 7, seed=2),
                       jax_partition.partition_homo(50, 7, seed=2)),
                      (partition.partition_dirichlet(y, 5, 0.3, min_size=2,
                                                     seed=4),
                       jax_partition.partition_dirichlet(y, 5, 0.3,
                                                         min_size=2, seed=4))):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_batching_equals_the_original_layout():
    x, y, parts = _task()
    fed = batching.build_federated_arrays(x, y, parts, 8, device="cpu")
    ref = jax_batching.build_federated_arrays(x, y, parts, 8)
    for name in ("x", "y", "mask", "counts"):
        np.testing.assert_array_equal(getattr(fed, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    idx = np.array([4, 0, 4])
    sub, jsub = (batching.gather_clients(fed, idx),
                 jax_batching.gather_clients(ref, idx))
    np.testing.assert_array_equal(sub.x.numpy(), np.asarray(jsub.x))
    np.testing.assert_array_equal(sub.counts.numpy(), np.asarray(jsub.counts))
    for a, b in zip(batching.batch_global(x[:13], y[:13], 4, device="cpu"),
                    jax_batching.batch_global(x[:13], y[:13], 4)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# --- trainer invariants -------------------------------------------------------

def test_all_masked_step_is_an_exact_no_op():
    """A step whose batch is all padding leaves params AND the adam state
    (count included) bit-equal, through ``torch.where``."""
    model = _model()
    fns = model_fns(model)
    net = fns.init()
    lt = make_local_train_fn(fns.apply, make_client_optimizer(
        "adam", 0.01, wd=1e-3), 1)
    opt = lt.optimizer.init(net.params)
    x = torch.randn(5, 8, 8, 3, generator=torch.Generator().manual_seed(0))
    y = torch.zeros(5, dtype=torch.long)
    p1, o1, _, _, _ = lt.step(net.params, opt, {}, x, y, torch.ones(5))
    p2, o2, _, loss, nb = lt.step(p1, o1, {}, x, y, torch.zeros(5))
    assert float(nb) == 0.0 and int(o1["1"]["count"]) == 1
    for name in p1:
        assert torch.equal(p2[name], p1[name])
    assert int(o2["1"]["count"]) == 1
    for k in ("mu", "nu", "nu_max"):
        for name in p1:
            assert torch.equal(o2["1"][k][name], o1["1"][k][name])


def test_shuffle_keys_are_prefix_stable():
    """Growing S with all-masked steps leaves the real slots' permutation
    unchanged, so a larger step bucket is an exact training no-op."""
    mask = torch.zeros(3, 4)
    mask.view(-1)[:10] = 1.0
    big = torch.zeros(6, 4)
    big.view(-1)[:10] = 1.0
    k = keys.fold_in(keys.key(7), 0)
    small_p, big_p = epoch_perm(mask, k), epoch_perm(big, k)
    assert torch.equal(small_p[:10], big_p[:10])
    assert set(small_p[:10].tolist()) == set(range(10))
    # Batched over clients: row i uses its own key.
    ks = torch.stack([k, keys.fold_in(keys.key(7), 1)])
    both = epoch_perm(torch.stack([mask, mask]), ks)
    assert torch.equal(both[0], small_p)
    # End to end: two extra padded steps change nothing.
    x, y, parts = _task()
    fns = model_fns(_model())
    lt = make_local_train_fn(fns.apply, make_client_optimizer("sgd", 0.05), 2)
    fed = batching.build_federated_arrays(x, y, parts, 4, device="cpu")
    c = int(np.argmin(fed.counts.numpy()))
    pad = fed.steps_per_epoch + 2

    def grow(a):
        out = torch.zeros((pad,) + a.shape[2:], dtype=a.dtype)
        out[:a.shape[1]] = a[c]
        return out

    net = fns.init()
    rng = keys.key(3)
    a, la = lt(net, fed.x[c], fed.y[c], fed.mask[c], rng)
    b, lb = lt(net, grow(fed.x), grow(fed.y), grow(fed.mask), rng)
    assert torch.equal(la, lb)
    for k_ in a.params:
        assert torch.equal(a.params[k_], b.params[k_])


@pytest.mark.parametrize("name,wd,clip", [("adam", 1e-2, 0.0),
                                          ("adam", 0.0, 0.5),
                                          ("momentum", 0.0, 0.0),
                                          ("sgd", 0.0, 0.3)])
def test_optimizers_match_optax(name, wd, clip):
    """Four steps of random gradients on a toy tree: updates and params
    within 1e-6 of optax (amsgrad over the bias-corrected second moment,
    coupled L2, global-norm clipping)."""
    rng = np.random.RandomState(0)
    params = {"a": rng.randn(3, 4).astype(np.float32),
              "b": {"c": rng.randn(5).astype(np.float32)}}
    jopt = jax_optimizer(name, 0.1, wd, clip)
    topt = make_client_optimizer(name, 0.1, wd, clip)
    jp = jax.tree.map(jnp.asarray, params)
    tp = tree_map(torch.from_numpy, params)
    jst, tst = jopt.init(jp), topt.init(tp)
    for _ in range(4):
        g = jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32),
                         params)
        ju, jst = jopt.update(jax.tree.map(jnp.asarray, g), jst, jp)
        tu, tst = topt.update(tree_map(torch.from_numpy, g), tst, tp)
        jp, tp = optax.apply_updates(jp, ju), apply_updates(tp, tu)
        np.testing.assert_allclose(tu["a"].numpy(), np.asarray(ju["a"]),
                                   rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tp["b"]["c"].numpy(), np.asarray(jp["b"]["c"]),
                               rtol=1e-6, atol=1e-6)


def test_torch_amsgrad_differs_from_optax():
    """Why the port writes its own adam: torch's ``Adam(amsgrad=True)``
    keeps the max over the raw second moment, not the bias-corrected one,
    and drifts from optax within a few steps."""
    rng = np.random.RandomState(1)
    w = rng.randn(6).astype(np.float32)
    grads = [rng.randn(6).astype(np.float32) * s for s in (1.0, 0.1, 0.1)]
    tw = torch.nn.Parameter(torch.from_numpy(w.copy()))
    opt = torch.optim.Adam([tw], lr=0.1, amsgrad=True)
    port = make_client_optimizer("adam", 0.1)
    pp = {"w": torch.from_numpy(w.copy())}
    st = port.init(pp)
    for g in grads:
        tw.grad = torch.from_numpy(g)
        opt.step()
        u, st = port.update({"w": torch.from_numpy(g)}, st, pp)
        pp = apply_updates(pp, u)
    assert (tw.detach() - pp["w"]).abs().max() > 1e-3


# --- the round ------------------------------------------------------------------

def _cohort(batch=8, n=3):
    x, y, parts = _task()
    fed = batching.build_federated_arrays(x, y, parts, batch, device="cpu")
    return batching.gather_clients(fed, np.arange(n))


def test_vmap_round_equals_a_sequential_client_loop():
    """One round with every client's steps under vmap against a Python
    loop of ``local_train`` per client + the weighted mean: 1e-5 (the
    vmapped convs run as one grouped conv, which rounds differently; lr
    5e-3 keeps the model's amplification of that rounding, see E2E below,
    under the bound)."""
    sub = _cohort()
    fns = model_fns(_model())
    net = fns.init()
    lt = make_local_train_fn(fns.apply, make_client_optimizer(
        "momentum", 5e-3), 2)
    w = sub.counts.float()
    rng = keys.key(11)
    avg, loss = make_vmap_round(lt)(net, sub.x, sub.y, sub.mask, w, w, rng)
    rngs = client_rngs(rng, 3)
    outs = [lt(net, sub.x[i], sub.y[i], sub.mask[i], rngs[i])
            for i in range(3)]
    stacked = {k: torch.stack([o.params[k] for o, _ in outs])
               for k in net.params}
    want = tree_weighted_mean(stacked, w)
    want_loss = sum(l * wi for (_, l), wi in zip(outs, w)) / w.sum()
    for k in want:
        torch.testing.assert_close(avg.params[k], want[k], rtol=1e-5,
                                   atol=1e-5)
    torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=1e-6)


def test_nan_guard_keeps_the_previous_model():
    """Every client diverges: the guarded round returns the previous params
    bit-equal and a finite (zero) loss; one diverged client of three is
    excluded from the average."""
    sub = _cohort()
    fns = model_fns(_model())
    net = fns.init()
    lt = make_local_train_fn(fns.apply, make_client_optimizer("sgd", 0.05), 1)
    w = sub.counts.float()
    bad = sub.x.clone().fill_(float("nan"))
    guarded = make_vmap_round(lt, nan_guard=True)
    avg, loss = guarded(net, bad, sub.y, sub.mask, w, w, keys.key(0))
    assert float(loss) == 0.0
    for k in net.params:
        assert torch.equal(avg.params[k], net.params[k])
    one_bad = sub.x.clone()
    one_bad[1] = float("nan")
    avg, loss = guarded(net, one_bad, sub.y, sub.mask, w, w, keys.key(0))
    w2 = w * torch.tensor([1.0, 0.0, 1.0])
    want, want_loss = make_vmap_round(lt)(net, sub.x, sub.y, sub.mask, w2,
                                          w2, keys.key(0))
    assert torch.isfinite(loss)
    for k in net.params:
        torch.testing.assert_close(avg.params[k], want.params[k], rtol=1e-6,
                                   atol=1e-6)
    torch.testing.assert_close(loss, want_loss)


# --- end to end against JAX -----------------------------------------------------

# batch_size >= the largest client: one step per epoch, so the per-epoch
# shuffle only reorders a masked mean. lr 1e-3: ResNet-20 at this width
# amplifies f32 rounding strongly (GroupNorms of single channels over a few
# positions: a 1e-6 change of the start moves the params after two SGD steps
# by ~0.04 at lr 0.05 and ~2e-3 at lr 0.01, measured on the port alone); at
# lr 1e-3 that spread is ~1e-5 against a ~3e-3 update.
E2E = dict(client_num_in_total=6, client_num_per_round=3, comm_round=2,
           epochs=2, lr=1e-3, frequency_of_the_test=1)


@pytest.fixture(scope="module")
def e2e():
    x, y, parts = _task()
    batch = max(len(v) for v in parts.values())
    cfg = dict(E2E, batch_size=batch)
    xt, yt = synthetic.make_image_classification(20, (8, 8, 3), 4, seed=0)
    jfed = jax_batching.build_federated_arrays(x, y, parts, batch)
    japi = JaxFedAvgAPI(
        jax_create_model("resnet20", widths=WIDTHS, num_classes=4), jfed,
        jax_batching.batch_global(xt, yt, 10), JaxFedConfig(**cfg))
    start = jax.tree.map(np.asarray, japi.net.params)
    jhist = japi.train()
    fed = batching.build_federated_arrays(x, y, parts, batch, device="cpu")
    api = FedAvgAPI(_model(), fed,
                    batching.batch_global(xt, yt, 10, device="cpu"),
                    FedConfig(**cfg), device="cpu")
    api.net = NetState(from_jax_params(start)[0], {})
    hist = api.train()
    return (start, jax.tree.map(np.asarray, japi.net.params), jhist,
            to_jax_params(api.net.params), hist)


def test_fedavg_rounds_match_jax(e2e):
    """2 rounds x 3 of 6 clients x 2 epochs: params within 1e-4 (3% of the
    ~3e-3 update; the spread above), train losses within 1e-5."""
    start, jparams, jhist, params, hist = e2e
    moved = max(np.abs(a - b).max() for a, b in zip(
        jax.tree.leaves(jparams), jax.tree.leaves(start)))
    assert moved > 1e-3
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(jparams)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    for h, j in zip(hist, jhist):
        assert h["round"] == j["round"]
        np.testing.assert_allclose(h["train_loss"], j["train_loss"],
                                   rtol=1e-5, atol=1e-5)


def test_fedavg_evaluation_matches_jax(e2e):
    """Held-out loss and accuracy after each round: loss within 1e-4,
    accuracy and count exact."""
    _, _, jhist, _, hist = e2e
    for h, j in zip(hist, jhist):
        np.testing.assert_allclose(h["loss"], j["loss"], rtol=1e-4,
                                   atol=1e-4)
        assert h["accuracy"] == pytest.approx(j["accuracy"])
        assert h["num"] == j["num"] == 20


def test_fedavg_refuses_what_is_not_ported(monkeypatch):
    x, y, parts = _task()
    fed = batching.build_federated_arrays(x, y, parts, 32, device="cpu")
    for field, val in (("group_reduce", True), ("wire_codec", "int8")):
        cfg = FedConfig(client_num_in_total=6, batch_size=32,
                        **{field: val})
        with pytest.raises(NotImplementedError, match=f"cfg.{field}"):
            FedAvgAPI(_model(), fed, None, cfg, device="cpu")
    # FedAvgAPI's knobs are ported: a value outside their set is refused
    # by value, as JAX refuses it.
    for field, val in (("compress", "zip"), ("compute_layout", "lanes"),
                       ("client_step_dtype", "fp16")):
        cfg = FedConfig(client_num_in_total=6, batch_size=32,
                        **{field: val})
        with pytest.raises(ValueError, match=field.split("_")[-1]):
            FedAvgAPI(_model(), fed, None, cfg, device="cpu")
    cfg = FedConfig(client_num_in_total=6, batch_size=32,
                    client_selection="fedcs")
    with pytest.raises(ValueError, match="client_selection"):
        FedAvgAPI(_model(), fed, None, cfg, device="cpu").sample_round(0)
    cfg = FedConfig(client_num_in_total=6, batch_size=32)
    with pytest.raises(NotImplementedError, match="mesh"):
        FedAvgAPI(_model(), fed, None, cfg, mesh=object(), device="cpu")
    api = FedAvgAPI(_model(), fed, None, cfg, device="cpu")
    for name in ("train_rounds_windowed", "train_windowed"):
        with pytest.raises(NotImplementedError,
                           match="windowed execution streams window "
                           "superbatches from a FederatedStore"):
            getattr(api, name)(2)
    from fedml_tpu_torch.models.cnn import CNNOriginalFedAvg
    assert CNNOriginalFedAvg(im2col=True).Conv_0.weight.shape == (32, 25, 1,
                                                                  1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FedAvgAPI(_model(), fed, None, cfg)


def test_chip_smoke_imports_no_jax_and_needs_a_card():
    """chip_smoke.py imports neither JAX nor the JAX package, and without a
    CUDA device it exits non-zero before printing any result."""
    path = os.path.join(ROOT, "chip_smoke.py")
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|fedml_tpu)\b")
    with open(path) as fh:
        assert not [ln for ln in fh if pat.match(ln)]
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": ROOT}
    out = subprocess.run([sys.executable, path], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
