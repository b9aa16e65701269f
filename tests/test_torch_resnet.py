"""The port's CIFAR ResNets and their weight converter against the JAX
package (``fedml_tpu.models.resnet``). Weights come from the flax init,
are perturbed with numpy from a seed, and reach the port through
``convert.from_jax_params``; inputs are numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.models.registry import create_model as jax_create_model
from fedml_tpu.models.resnet import space_to_depth as jax_space_to_depth
from fedml_tpu_torch.convert import from_jax_params, to_jax_params
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models.resnet import norm_groups, space_to_depth

WIDTHS = (4, 8, 16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params(stem="conv", norm="gn", seed=1, model=None, shape=None):
    """Random weights in the flax tree of ``resnet20`` (or ``model``):
    conv and dense kernels ~ N(0, 1/fan_in), GroupNorm scales
    1 + N(0, 0.1²), biases N(0, 0.1²) — numpy from a seed, shapes from
    ``eval_shape``."""
    model = model or jax_create_model("resnet20", widths=WIDTHS, stem=stem,
                                      norm=norm)
    rng = np.random.default_rng(seed)

    def leaf(path, z):
        name = path[-1].key
        if name == "kernel":
            std = 1.0 / np.sqrt(np.prod(z.shape[:-1]))
            return (rng.normal(0, std, z.shape)).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + rng.normal(0, 0.1, z.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, _jax_shapes(model, shape))


def _jax_shapes(model, shape=None):
    """The flax param tree as zeros of the right shapes (``eval_shape``:
    nothing is computed)."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros(shape or (1, 8, 8, 3)))["params"]
    return jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)


@pytest.fixture(scope="module")
def params():
    return _jax_params()


@pytest.fixture(scope="module")
def x():
    return np.random.RandomState(0).randn(2, 8, 8, 3).astype(np.float32)


def _jax_logits(params, x, **kw):
    model = jax_create_model("resnet20", widths=WIDTHS, **kw)
    return np.asarray(model.apply({"params": params}, jnp.asarray(x)))


def _port(params, **kw):
    model = create_model("resnet20", widths=WIDTHS, device="cpu", **kw)
    state, adapters = from_jax_params(params)
    assert adapters == {}
    model.load_state_dict(state)
    return model


def test_logits_match_jax_f32(params, x):
    """f32 logits within 5e-5 of flax ``norm="gn"`` (|logit| ~ 2; the
    convs and the GroupNorm statistics sum in other orders)."""
    want = _jax_logits(params, x, norm="gn")
    got = _port(params)(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=5e-5)


def test_gn_fused_is_gn_in_the_port(params, x):
    """Both kinds run the same op: bit-equal logits; and flax's gn_fused
    tree converts to the same state dict keys."""
    a = _port(params, norm="gn")(torch.from_numpy(x))
    b = _port(params, norm="gn_fused")(torch.from_numpy(x))
    assert torch.equal(a, b)
    fused = _jax_shapes(jax_create_model("resnet20", widths=WIDTHS,
                                         norm="gn_fused"))
    assert set(from_jax_params(fused)[0]) == set(from_jax_params(params)[0])


def test_logits_match_jax_bf16(params, x):
    """bf16 compute (f32 params, f32 mean and head) against flax's bf16
    twin: within one bf16 ulp at |logit| in [2, 4) (2^-6)."""
    want = _jax_logits(params, x, norm="gn", dtype="bf16")
    got = _port(params, dtype="bf16")(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=2.0 ** -6)


def test_s2d_stem_matches_jax():
    """At 16×16 input: after the 2×2 space-to-depth, 8×8 would leave
    single positions in stage 3, whose GroupNorms over one value per group
    amplify rounding without bound."""
    x = np.random.RandomState(1).randn(2, 16, 16, 3).astype(np.float32)
    params = _jax_params(stem="s2d", seed=2)
    want = _jax_logits(params, x, stem="s2d")
    got = _port(params, stem="s2d")(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=5e-5)
    np.testing.assert_array_equal(
        space_to_depth(torch.from_numpy(x)).numpy(),
        np.asarray(jax_space_to_depth(jnp.asarray(x))))


def test_norm_none_matches_jax(x):
    params = _jax_params(norm="none", seed=3)
    want = _jax_logits(params, x, norm="none")
    got = _port(params, norm="none")(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_converter_round_trip_is_bit_equal(params):
    """JAX → torch → JAX leaves the tree and every leaf bit-equal, and the
    state dict covers the port's model exactly."""
    model = _port(params)
    assert set(model.state_dict()) == set(from_jax_params(params)[0])
    back = to_jax_params(model.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_resnet56_tree_matches_flax_shapes():
    """The primary config's parameter tree: every flax leaf has a port
    weight of the converted shape (58 GroupNorms, 3 downsample paths)."""
    state, _ = from_jax_params(_jax_shapes(jax_create_model("resnet56")))
    model = create_model("resnet56", device="cpu")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == {k: tuple(v.shape) for k, v in state.items()}
    assert sum(k.endswith("GroupNorm_0.weight") for k in got) == 58
    assert sum(k.endswith("downsample.weight") for k in got) == 3


@pytest.mark.parametrize("block,cin,planes,strides", [
    ("BottleneckBlock", 16, 8, 2), ("BottleneckBlock", 32, 8, 1),
    ("BasicBlock", 8, 16, 2), ("BasicBlock", 16, 16, 1)])
def test_blocks_match_flax(block, cin, planes, strides):
    """Each block alone, with and without its downsample path: f32 within
    5e-5 of flax (the stride-2 3×3 conv's explicit (1, 1) padding)."""
    import fedml_tpu.models.resnet as jax_resnet
    import fedml_tpu_torch.models.resnet as resnet

    jblock = getattr(jax_resnet, block)(planes, strides, "gn")
    params = _jax_params(model=jblock, shape=(1, 8, 8, cin), seed=4)
    x = np.random.RandomState(5).randn(2, 8, 8, cin).astype(np.float32)
    want = np.asarray(jblock.apply({"params": params}, jnp.asarray(x)))
    tblock = getattr(resnet, block)(cin, planes, strides)
    tblock.load_state_dict(from_jax_params(params)[0])
    got = tblock(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=5e-5,
                               atol=5e-5)


def test_norm_groups_policy_and_unported_bn():
    """The group policy; ``norm="bn"`` builds BatchNorms
    whose running stats are buffers under flax's ``batch_stats`` names
    (tests/test_torch_batchnorm.py holds them against flax)."""
    assert [norm_groups(c) for c in (16, 48, 64, 72, 200)] == [16, 24, 32,
                                                              24, 25]
    bn = create_model("resnet20", norm="bn", device="cpu")
    assert "Norm_0.BatchNorm_0.mean" in dict(bn.named_buffers())
    assert not any(".GroupNorm_0." in k for k in bn.state_dict())


def test_groupnorm_reads_channels_last_views(params, x):
    """Outside vmap, every GroupNorm input is a view with its channels at
    stride 1 (the conv output kept in channels-last memory)."""
    from fedml_tpu_torch.ops.group_norm import group_norm

    seen = []

    def spy(t, g, b, groups, eps):
        seen.append(t.stride(-1))
        return group_norm(t, g, b, groups, eps)

    model = create_model("resnet20", widths=WIDTHS, device="cpu", gn_fn=spy)
    model.load_state_dict(from_jax_params(params)[0])
    model(torch.from_numpy(x))
    assert len(seen) == 21 and set(seen) == {1}  # stem + 6 x 3 + 2


def test_create_model_without_device_refuses_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model("resnet56")
