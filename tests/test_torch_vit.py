"""The port's ViT (``fedml_tpu_torch/models/vit.py``) against the JAX
package's (``fedml_tpu/models/vit.py``): the logits and the parameter
gradients from the same params (carried by ``convert.from_jax_params``),
with dense attention and with flash attention (JAX's Pallas kernels in
interpret mode against the port's plain twins, which its flash path runs
on the CPU), the patch-size refusal, the ``attn_fn`` plumbing, and two
FedAvg rounds of both packages from one start. Inputs are numpy from a
seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fedml_tpu.algos.config import FedConfig as JaxFedConfig
from fedml_tpu.algos.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.data import batching as jax_batching
from fedml_tpu.models.registry import create_model as jax_create_model
from fedml_tpu.ops.flash_attention import flash_attention as jax_flash
from fedml_tpu_torch.algos import FedAvgAPI, FedConfig
from fedml_tpu_torch.convert import from_jax_params, to_jax_params
from fedml_tpu_torch.data import build_federated_arrays, partition_homo
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models.transformer import (dense_attention,
                                                flash_attention_out)
from fedml_tpu_torch.trainer.local import NetState

KW = dict(num_classes=5, patch=4, d_model=32, n_heads=2, n_layers=2)
SIDE = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images(n=6, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, SIDE, SIDE, 3).astype(np.float32),
            rng.randint(0, 5, n).astype(np.int32))


def _pair(jattn=None, attn=None):
    """The flax ViT's params and the port's ViT carrying them."""
    jm = jax_create_model("vit", attn_fn=jattn, **KW)
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, SIDE, SIDE, 3)))["params"]
    params = jax.tree.map(np.asarray, params)
    model = create_model("vit", attn_fn=attn, image_size=SIDE, device="cpu",
                         **KW)
    model.load_state_dict(from_jax_params(params)[0])
    return jm, params, model


def _jax_loss(jm, params, x, y):
    logits = jm.apply({"params": params}, x)
    lp = jax.nn.log_softmax(logits)
    return -jnp.mean(jnp.take_along_axis(lp, y[:, None], axis=1))


@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_vit_logits_and_grads_match_flax(attn):
    """Logits within 1e-5 and every parameter's CE gradient within 1e-5 of
    flax's; with ``attn="flash"`` both sides run their flash attention
    (JAX: the Pallas kernels in interpret mode; the port on the CPU: the
    plain twins of its kernels)."""
    jattn, pattn = ((jax_flash, flash_attention_out) if attn == "flash"
                    else (None, None))
    jm, params, model = _pair(jattn, pattn)
    x, y = _images()
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5)
    jgrads = jax.grad(_jax_loss, argnums=1)(jm, params, jnp.asarray(x),
                                            jnp.asarray(y))
    loss = F.cross_entropy(got, torch.from_numpy(y).long())
    names, leaves = zip(*model.named_parameters())
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    pg = to_jax_params(grads)
    assert jax.tree.structure(pg) == jax.tree.structure(jgrads)
    for a, b in zip(jax.tree.leaves(pg), jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)


def test_flash_and_dense_vit_agree():
    """The port's flash path (the twins on the CPU) and its dense path
    give the same logits within 1e-5 from one model."""
    _, _, model = _pair()
    x, _ = _images()
    dense = model(torch.from_numpy(x))
    for i in range(KW["n_layers"]):
        getattr(model, f"Block_{i}").MHA_0.attn_fn = flash_attention_out
    flash = model(torch.from_numpy(x))
    torch.testing.assert_close(flash, dense, rtol=0, atol=1e-5)


def test_indivisible_patch_raises():
    """As the JAX model: an image size the patch size does not divide
    raises ValueError, at construction and at call."""
    with pytest.raises(ValueError, match="not divisible by patch size 5"):
        create_model("vit", num_classes=5, patch=5, image_size=16,
                     device="cpu")
    model = create_model("vit", image_size=SIDE, device="cpu", **KW)
    with pytest.raises(ValueError, match="not divisible by patch size 4"):
        model(torch.zeros(1, 18, 18, 3))
    with pytest.raises(ValueError, match="patches"):
        model(torch.zeros(1, 8, 8, 3))
    with pytest.raises(ValueError):
        jm = jax_create_model("vit", num_classes=5, patch=5)
        jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)))


def test_vit_attn_fn_is_plumbed():
    """As ``test_models.py:153``: the injected attention runs in every
    block, non-causal, at [B, T, H, D]; the default is the dense one."""
    calls = []

    def counting_attn(q, k, v, causal=True):
        calls.append((tuple(q.shape), causal))
        return dense_attention(q, k, v, causal=causal)

    model = create_model("vit", num_classes=3, patch=4, d_model=32,
                         n_heads=2, n_layers=3, attn_fn=counting_attn,
                         image_size=8, device="cpu")
    model(torch.zeros(2, 8, 8, 3))
    assert calls == [((2, 4, 2, 16), False)] * 3
    plain = create_model("vit", image_size=8, device="cpu", n_layers=1)
    assert plain.Block_0.MHA_0.attn_fn is dense_attention
    assert all(p.requires_grad for p in plain.parameters())


def test_fedavg_rounds_match_jax():
    """2 FedAvg rounds of 3 of 4 clients (one step an epoch: the batch
    holds a client's shard), both packages from flax's start: params
    within 1e-5 of JAX's, train losses within 1e-5."""
    rng = np.random.RandomState(0)
    x = rng.randn(24, SIDE, SIDE, 3).astype(np.float32)
    y = rng.randint(0, 5, 24).astype(np.int32)
    parts = partition_homo(len(x), 4)
    cfg = dict(client_num_in_total=4, client_num_per_round=3, comm_round=2,
               epochs=1, batch_size=6, lr=0.05)
    japi = JaxFedAvgAPI(jax_create_model("vit", **KW),
                        jax_batching.build_federated_arrays(x, y, parts, 6),
                        None, JaxFedConfig(**cfg))
    start = jax.tree.map(np.asarray, japi.net.params)
    jlosses = [japi.train_one_round(r)["train_loss"] for r in range(2)]
    api = FedAvgAPI(create_model("vit", image_size=SIDE, device="cpu", **KW),
                    build_federated_arrays(x, y, parts, 6, device="cpu"),
                    None, FedConfig(**cfg), device="cpu")
    api.net = NetState(from_jax_params(start)[0], {})
    losses = [api.train_one_round(r)["train_loss"] for r in range(2)]
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=1e-5)
    moved = max(np.abs(np.asarray(a) - b).max() for a, b in zip(
        jax.tree.leaves(japi.net.params), jax.tree.leaves(start)))
    assert moved > 1e-3
    got = to_jax_params(api.net.params)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(japi.net.params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)
