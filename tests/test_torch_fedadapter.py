"""The port's FedAdapter path — ``seq_softmax_ce`` and the sequence branch
of evaluation, the adapter seam (``models/adapter.py``) and
``FedAdapterAPI`` — against the JAX package (``fedml_tpu.algos.fedadapter``
and the modules under it), plus the frozen base's invariance. Inputs are
numpy from a seed; the JAX base and adapters reach the port through
``convert.from_jax_params``. Both sides run flash attention: the Pallas
kernels in interpret mode and the port's plain twins on the CPU."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad

from fedml_tpu.algos.config import FedConfig as JaxFedConfig
from fedml_tpu.algos.fedadapter import FedAdapterAPI as JaxFedAdapterAPI
from fedml_tpu.comm.codec import tree_to_vector_np as jax_vec
from fedml_tpu.data import batching as jax_batching
from fedml_tpu.models.adapter import merge_params as jax_merge_params
from fedml_tpu.models.registry import create_model as jax_create_model
from fedml_tpu.trainer.local import NetState as JaxNetState
from fedml_tpu.trainer.local import make_eval_fn as jax_make_eval_fn
from fedml_tpu.trainer.local import seq_softmax_ce as jax_seq_softmax_ce
from fedml_tpu_torch.algos import FedAdapterAPI, FedAvgAPI, FedConfig
from fedml_tpu_torch.convert import from_jax_params
from fedml_tpu_torch.core.flat import tree_to_vector_np
from fedml_tpu_torch.data import batching, partition
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models.adapter import (adapter_model_fns, merge_params,
                                            param_count, split_frozen)
from fedml_tpu_torch.trainer.local import (NetState, make_eval_fn,
                                           seq_softmax_ce)

V, T = 32, 32
LOSS = partial(seq_softmax_ce, pad_id=0)
JLOSS = partial(jax_seq_softmax_ce, pad_id=0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(rank=4, scope="attn", attn="flash"):
    return dict(vocab_size=V, d_model=32, n_heads=2, n_layers=2, max_len=T,
                adapter_rank=rank, adapter_scope=scope, attn=attn)


def _model(rank=4, scope="attn", attn="flash", seed=0):
    return create_model("transformer_lm", device="cpu",
                        generator=torch.Generator().manual_seed(seed),
                        **_kw(rank, scope, attn))


def _tokens(n_clients=6, per=8, seed=0):
    """Next-token data with ids in [1, V) (0 is the pad id), homogeneous
    clients of ``per`` sequences."""
    rng = np.random.RandomState(seed)
    seqs = rng.randint(1, V, size=(n_clients * per, T + 1))
    x, y = seqs[:, :T].astype(np.int32), seqs[:, 1:].astype(np.int32)
    return x, y, partition.partition_homo(len(x), n_clients)


def _cfg(**kw):
    base = dict(client_num_in_total=6, client_num_per_round=3, comm_round=2,
                batch_size=4, lr=0.1, epochs=1, frequency_of_the_test=1000)
    base.update(kw)
    return FedConfig(**base)


def _fed(batch=4, **kw):
    x, y, parts = _tokens(**kw)
    return batching.build_federated_arrays(x, y, parts, batch, device="cpu")


def _toks(b=2, seed=1):
    return torch.as_tensor(np.random.RandomState(seed).randint(1, V, (b, T)))


# --- the loss and the sequence branch of evaluation -----------------------------

def test_seq_softmax_ce_and_sequence_eval_match_jax():
    """Per-example CE over non-pad positions (rows with pad tails and one
    all-pad row) within 1e-6; evaluation's loss and pad-aware token
    accuracy over [S, B, T] batches within 1e-6, count exact."""
    rng = np.random.RandomState(0)
    logits = rng.randn(3, 4, T, V).astype(np.float32)
    labels = rng.randint(1, V, (3, 4, T)).astype(np.int32)
    labels[0, 1, T // 2:] = 0
    labels[1, 2, :] = 0
    mask = np.ones((3, 4), np.float32)
    mask[2, 3] = 0.0
    np.testing.assert_allclose(
        seq_softmax_ce(torch.from_numpy(logits[0]),
                       torch.from_numpy(labels[0])).numpy(),
        np.asarray(JLOSS(jnp.asarray(logits[0]), jnp.asarray(labels[0]))),
        rtol=1e-6, atol=1e-6)
    # apply_fn looks the logits up by batch index: x carries that index.
    x = np.broadcast_to(np.arange(3)[:, None, None], (3, 4, 1)).copy()

    def tapply(net, xb, train=False):
        return net.params["logits"][xb[0, 0]], {}

    def japply(net, xb, train=False):
        return net.params["logits"][xb[0, 0]], {}

    got = make_eval_fn(tapply, LOSS, pad_id=0)(
        NetState({"logits": torch.from_numpy(logits)}, {}),
        torch.from_numpy(x), torch.from_numpy(labels), torch.from_numpy(mask))
    want = jax_make_eval_fn(japply, JLOSS, pad_id=0)(
        JaxNetState({"logits": jnp.asarray(logits)}, {}), jnp.asarray(x),
        jnp.asarray(labels), jnp.asarray(mask))
    for key in ("loss", "accuracy"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-6, atol=1e-6)
    assert float(got["num"]) == float(want["num"]) == 11.0


# --- the adapter seam ------------------------------------------------------------

def test_split_merge_bijection_on_the_port_tree():
    """split_frozen / merge_params over the port's own tree (base state
    nested by module path, adapters as the model nests them) is lossless,
    and the split is exactly the lora_ leaves."""
    model = _model(scope="all")
    tree = {}
    for key, val in model.state_dict().items():
        node = tree
        *path, leaf = key.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = val
    adapters = model.init_adapters(torch.Generator().manual_seed(1))
    full = merge_params(tree, adapters)
    base, ad = split_frozen(full)
    assert param_count(ad) == param_count(adapters) > 0
    assert param_count(base) == param_count(tree)
    again = merge_params(base, ad)
    assert split_frozen(again) == (base, ad)


def test_rank0_model_equals_the_dense_model():
    """adapter_rank=0 gives the dense model's state dict and forward
    bitwise (same generator), and refuses adapters."""
    dense = create_model("transformer_lm", device="cpu",
                         generator=torch.Generator().manual_seed(3),
                         **{**_kw(0), "adapter_rank": 0})
    rank0 = _model(rank=0, seed=3)
    a, b = dense.state_dict(), rank0.state_dict()
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    toks = _toks()
    assert torch.equal(dense(toks), rank0(toks))
    with pytest.raises(ValueError, match="adapter_rank=0"):
        rank0(toks, {})


def test_adapter_init_is_the_exact_identity():
    """B = 0 at init: the adapted model's training apply and serving infer
    equal the rank-0 model's forward bitwise."""
    toks = _toks()
    dense = _model(rank=0, seed=5)(toks)
    fns = adapter_model_fns(_model(rank=4, scope="all", seed=5))
    net = fns.init(torch.Generator().manual_seed(0))
    logits, state = fns.apply(net, toks, train=True)
    assert state == {} and torch.equal(logits, dense)
    assert torch.equal(fns.infer(net.params, toks), dense)


def test_pretrained_base_params_swap_and_structure_refusal():
    toks = _toks(seed=2)
    ckpt = _model(rank=0, seed=7)
    fns = adapter_model_fns(_model(rank=4, seed=8),
                            base_params=ckpt.state_dict())
    base = fns.holder["base"].state_dict()
    assert all(torch.equal(base[k], v) for k, v in ckpt.state_dict().items())
    net = fns.init(torch.Generator().manual_seed(0))
    assert torch.equal(fns.apply(net, toks)[0], ckpt(toks))
    with pytest.raises(ValueError, match="structure"):
        adapter_model_fns(_model(), base_params={"wrong": torch.zeros(3)})
    shapes = {k: torch.zeros(1) for k in ckpt.state_dict()}
    with pytest.raises(ValueError, match="structure"):
        adapter_model_fns(_model(), base_params=shapes)


def test_gradients_reach_the_adapters_and_not_the_base():
    """The training apply carries the gradient to the adapters (all of
    them, through every layer); the base's parameters never require one;
    the serving infer runs without autograd."""
    fns = adapter_model_fns(_model(rank=4, scope="all", seed=9))
    net = fns.init(torch.Generator().manual_seed(0))
    # B != 0, so that A's gradient is not zero either
    net = NetState(jax.tree.map(lambda t: t + 0.01, net.params,
                                is_leaf=torch.is_tensor), {})
    toks = _toks(seed=3)

    def loss(params):
        logits, _ = fns.apply(NetState(params, {}), toks, train=True)
        return LOSS(logits, toks).mean()

    g = grad(loss)(net.params)
    leaves = jax.tree.leaves(g, is_leaf=torch.is_tensor)
    assert leaves and all(bool(leaf.abs().sum() > 0) for leaf in leaves)
    base = fns.holder["base"]
    assert not any(p.requires_grad for p in base.parameters())
    ad = jax.tree.map(lambda t: t.clone().requires_grad_(), net.params,
                      is_leaf=torch.is_tensor)
    LOSS(fns.apply(NetState(ad, {}), toks)[0], toks).mean().backward()
    assert all(p.grad is None for p in base.parameters())
    assert not fns.infer(net.params, toks).requires_grad


# --- FedAdapterAPI -----------------------------------------------------------------

def test_dense_model_and_adapter_cfg_on_fedavg_refused():
    fed = _fed()
    with pytest.raises(ValueError, match="adapter_rank > 0"):
        FedAdapterAPI(_model(rank=0), fed, None, _cfg(), loss_fn=LOSS,
                      device="cpu")
    with pytest.raises(NotImplementedError, match="FedAdapterAPI"):
        FedAvgAPI(_model(), fed, None, _cfg(adapter_rank=4), loss_fn=LOSS,
                  device="cpu")


@pytest.mark.parametrize("kw,err,match", [
    ({"cfg": {"compute_layout": "auto"}}, NotImplementedError,
     "compute_layout"),
    ({"cfg": {"client_step_dtype": "bf16"}}, NotImplementedError,
     "client_step_dtype"),
    ({"mesh": object()}, NotImplementedError, "mesh"),
    ({"personal_interp": 1.5}, ValueError, "personal_interp"),
    ({"personal_interp": -0.1}, ValueError, "personal_interp"),
])
def test_constructor_refusals(kw, err, match):
    args = {k: v for k, v in kw.items() if k != "cfg"}
    with pytest.raises(err, match=match):
        FedAdapterAPI(_model(), _fed(), None, _cfg(**kw.get("cfg", {})),
                      loss_fn=LOSS, device="cpu", **args)


def test_unported_tiers_and_checkpoints_raise_by_name():
    api = FedAdapterAPI(_model(), _fed(), None, _cfg(), loss_fn=LOSS,
                        device="cpu")
    with pytest.raises(NotImplementedError,
                       match="windowed execution streams window "
                       "superbatches from a FederatedStore"):
        api.train_rounds_windowed(2)
    # Checkpoints are ported: a never-personalized run has no run state
    # to save and allocates no store (tests/test_torch_checkpoint.py).
    assert api.checkpoint_extra_state() == {}
    api.load_checkpoint_extra_state({})
    assert api._personal_store is None


def test_frozen_base_bitwise_invariant_over_rounds():
    """The acceptance pin: the f32 frozen base bitwise unchanged across 5
    rounds, the adapters moved, and the profile counts the adapter tree."""
    api = FedAdapterAPI(_model(), _fed(), None, _cfg(comm_round=5),
                        loss_fn=LOSS, device="cpu")
    base0 = {k: v.clone() for k, v in api.base.state_dict().items()}
    ad0 = jax.tree.map(torch.clone, api.net.params, is_leaf=torch.is_tensor)
    hist = api.train()
    assert len(hist) == 5 and all(np.isfinite(h["train_loss"]) for h in hist)
    after = api.base.state_dict()
    assert all(torch.equal(base0[k], after[k]) for k in base0)
    moved = [not torch.equal(a, b) for a, b in zip(
        jax.tree.leaves(ad0, is_leaf=torch.is_tensor),
        jax.tree.leaves(api.net.params, is_leaf=torch.is_tensor))]
    assert any(moved)
    prof = api.adapter_profile()
    assert prof["adapter_params"] == param_count(api.net.params)
    assert prof["base_params"] == sum(p.numel() for p in api.base.parameters())
    assert 0 < prof["adapter_ratio"] < 0.5


@pytest.mark.parametrize("scope", ["attn", "all"])
def test_converted_rank16_trees_compute_what_jax_computes(scope):
    """JAX's FedAdapterAPI base and adapter tree at rank 16, carried across
    by from_jax_params into the port's FedAdapterAPI: the adapter trees
    flatten alike and the global evaluation agrees within 1e-5."""
    x, y, parts = _tokens()
    kw = {**_kw(16, scope, "dense")}
    jfed = jax_batching.build_federated_arrays(x, y, parts, 4)
    jtest = jax_batching.batch_global(x[:12], y[:12], 4)
    japi = JaxFedAdapterAPI(jax_create_model("transformer_lm", **kw), jfed,
                            jtest, JaxFedConfig(**vars(_cfg())),
                            loss_fn=JLOSS)
    rng = np.random.default_rng(0)
    jadapters = jax.tree.map(lambda a: np.asarray(a) + rng.normal(
        0, 0.05, a.shape).astype(np.float32), japi.net.params)
    japi.net = JaxNetState(jax.tree.map(jnp.asarray, jadapters), {})
    state, adapters = from_jax_params(jax_merge_params(
        jax.tree.map(np.asarray, japi.base), jadapters))
    api = FedAdapterAPI(create_model("transformer_lm", device="cpu", **kw),
                        _fed(), batching.batch_global(x[:12], y[:12], 4,
                                                      device="cpu"),
                        _cfg(), loss_fn=LOSS, base_params=state,
                        device="cpu")
    api.net = NetState(adapters, {})
    assert param_count(adapters) == sum(
        np.size(a) for a in jax.tree.leaves(jadapters))
    want, got = japi.evaluate(), api.evaluate()
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5,
                               atol=1e-5)
    assert got["accuracy"] == pytest.approx(want["accuracy"])


# --- end to end against JAX, flash attention on both sides ----------------------------

@pytest.fixture(scope="module")
def e2e():
    """2 rounds x 3 of 6 clients with attn="flash" in both packages, from
    one base and one adapter tree; batch 8 = the largest client, so each
    epoch is one step and the shuffle only reorders a masked mean. Then one
    personalize_cohort at personal_interp 1.0 and evaluate_personalized."""
    x, y, parts = _tokens()
    cfg = dict(vars(_cfg(epochs=2, frequency_of_the_test=1)), batch_size=8)
    jfed = jax_batching.build_federated_arrays(x, y, parts, 8)
    jtest = jax_batching.batch_global(x[:16], y[:16], 8)
    japi = JaxFedAdapterAPI(jax_create_model("transformer_lm", **_kw()),
                            jfed, jtest, JaxFedConfig(**cfg), loss_fn=JLOSS,
                            personal_interp=1.0)
    rng = np.random.default_rng(1)
    start = jax.tree.map(lambda a: np.asarray(a) + rng.normal(
        0, 0.05, a.shape).astype(np.float32), japi.net.params)
    japi.net = JaxNetState(jax.tree.map(jnp.asarray, start), {})
    state, adapters = from_jax_params(jax_merge_params(
        jax.tree.map(np.asarray, japi.base), start))
    jhist = japi.train()
    jlosses = japi.personalize_cohort([0, 3, 5])
    jpers = japi.evaluate_personalized(clients=[0, 1, 3, 5])
    jrows = japi.personal_store().gather([0, 3, 5], japi.net.params)

    fed = batching.build_federated_arrays(x, y, parts, 8, device="cpu")
    api = FedAdapterAPI(create_model("transformer_lm", device="cpu", **_kw()),
                        fed, batching.batch_global(x[:16], y[:16], 8,
                                                   device="cpu"),
                        FedConfig(**cfg), loss_fn=LOSS, base_params=state,
                        personal_interp=1.0, device="cpu")
    api.net = NetState(adapters, {})
    base0 = {k: v.clone() for k, v in api.base.state_dict().items()}
    hist = api.train()
    losses = api.personalize_cohort([0, 3, 5])
    pers = api.evaluate_personalized(clients=[0, 1, 3, 5])
    rows = api.personal_store().gather([0, 3, 5], api.net.params)
    return dict(start=start, jparams=jax.tree.map(np.asarray,
                                                  japi.net.params),
                jhist=jhist, jlosses=jlosses, jpers=jpers, jrows=jrows,
                api=api, base0=base0, hist=hist, losses=losses, pers=pers,
                rows=rows)


def test_fedadapter_rounds_match_jax(e2e):
    """Adapters after 2 rounds within 1e-6 (f32, other summation orders on
    the two sides: 3e-8 measured against an update of 2e-2), train losses
    within 1e-5 (a few f32 ulps of a loss near 3.9), and the base bitwise as
    it was."""
    api = e2e["api"]
    got, want = tree_to_vector_np(api.net.params), jax_vec(e2e["jparams"])
    moved = np.abs(want - jax_vec(e2e["start"])).max()
    assert moved > 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    for h, j in zip(e2e["hist"], e2e["jhist"]):
        assert h["round"] == j["round"]
        np.testing.assert_allclose(h["train_loss"], j["train_loss"],
                                   rtol=1e-5, atol=1e-5)
    after = api.base.state_dict()
    assert all(torch.equal(v, after[k]) for k, v in e2e["base0"].items())


def test_fedadapter_evaluation_matches_jax(e2e):
    """Held-out loss within 1e-5 and token accuracy within 1e-6 after
    each round; the count exact."""
    for h, j in zip(e2e["hist"], e2e["jhist"]):
        np.testing.assert_allclose(h["loss"], j["loss"], rtol=1e-5,
                                   atol=1e-5)
        assert h["accuracy"] == pytest.approx(j["accuracy"], abs=1e-6)
        assert h["num"] == j["num"] == 16


def test_personalize_cohort_matches_jax(e2e):
    """One personalization pass at personal_interp 1.0 (every client starts
    at the global): per-client losses within 1e-5, the stored rows within
    1e-6, the rows marked seen; the personalized evaluation within 1e-5."""
    np.testing.assert_allclose(e2e["losses"], e2e["jlosses"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(e2e["rows"], e2e["jrows"], rtol=0, atol=1e-6)
    seen = e2e["api"].personal_store().seen
    assert seen[[0, 3, 5]].all() and not seen[[1, 2, 4]].any()
    for key, val in e2e["jpers"].items():
        np.testing.assert_allclose(e2e["pers"][key], val, rtol=1e-5,
                                   atol=1e-5)
