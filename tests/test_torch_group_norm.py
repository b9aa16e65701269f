"""The port's GroupNorm (``fedml_tpu_torch.ops.group_norm``) against the JAX
package's ``fedml_tpu.ops.group_norm.group_norm`` — the Pallas kernels,
run in interpret mode on the CPU as ``tests/test_group_norm.py`` runs them.

On the CPU the port's ops run their plain twins; the CUDA kernels are held
against the same twins on the card (``tests/test_torch_cuda.py``). Inputs
are made with numpy from a seed and handed to both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from fedml_tpu.ops.group_norm import group_norm as jax_group_norm
from fedml_tpu_torch.ops import group_norm as gn

# The five shapes of tests/test_group_norm.py:21-27, then the eight
# (S, C, groups) that ResNet-56's GroupNorms give the kernels on CIFAR
# (S = 32², 16², 8²), at N 2.
SHAPES = [((6, 8, 8, 32), 32), ((4, 4, 4, 64), 32), ((3, 2, 2, 128), 32),
          ((5, 7, 48), 8), ((9, 16), 4),
          ((2, 32, 32, 16), 16), ((2, 32, 32, 64), 32), ((2, 32, 32, 32), 32),
          ((2, 16, 16, 32), 32), ((2, 16, 16, 128), 32),
          ((2, 16, 16, 64), 32), ((2, 8, 8, 64), 32), ((2, 8, 8, 256), 32)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    return (rng.randn(*shape).astype(np.float32),
            (rng.rand(c) + 0.5).astype(np.float32),
            rng.randn(c).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("shape,groups", SHAPES)
def test_forward_matches_jax(shape, groups):
    """f32 forward within 2e-5 (the JAX package's own bound against flax):
    the two sum the statistics in other orders."""
    x, g, b = _inputs(shape, 0)
    want = np.asarray(jax_group_norm(jnp.asarray(x), jnp.asarray(g),
                                     jnp.asarray(b), groups))
    got = gn.group_norm(*_t(x, g, b), groups)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape,groups", SHAPES)
def test_grads_match_jax(shape, groups):
    """dx, dγ, dβ of sum(sin(y)) within 5e-5 (the JAX package's bound;
    dγ/dβ sum over every sample and position)."""
    x, g, b = _inputs(shape, 1)

    def jloss(x, g, b):
        return jnp.sum(jnp.sin(jax_group_norm(x, g, b, groups)))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))

    def tloss(x, g, b):
        return torch.sin(gn.group_norm(x, g, b, groups)).sum()

    got = grad(tloss, argnums=(0, 1, 2))(*_t(x, g, b))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=5e-5,
                                   atol=5e-5)


def test_vmap_grad_with_per_client_gamma_matches_jax_and_a_loop():
    """``vmap(grad)`` over 3 clients with their own γ/β: one call of each
    op for all clients, equal to ``jax.vmap(jax.grad)`` within 5e-5 and to
    a per-client loop of the port within 1e-6 (same twin, other batch)."""
    rng = np.random.RandomState(4)
    x = rng.randn(3, 2, 4, 4, 32).astype(np.float32)
    g = (rng.rand(3, 32) + 0.5).astype(np.float32)
    b = rng.randn(3, 32).astype(np.float32)

    def jloss(x, g, b):
        return jnp.sum(jnp.sin(jax_group_norm(x, g, b, 8)))

    want = jax.vmap(jax.grad(jloss, argnums=(0, 1, 2)))(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))

    def tloss(x, g, b):
        return torch.sin(gn.group_norm(x, g, b, 8)).sum()

    calls = []
    fwd, bwd = gn.group_norm_fwd_plain, gn.group_norm_bwd_plain
    try:
        gn.group_norm_fwd_plain = lambda *a: calls.append("f") or fwd(*a)
        gn.group_norm_bwd_plain = lambda *a: calls.append("b") or bwd(*a)
        got = vmap(grad(tloss, argnums=(0, 1, 2)))(*_t(x, g, b))
    finally:
        gn.group_norm_fwd_plain, gn.group_norm_bwd_plain = fwd, bwd
    assert sorted(calls) == ["b", "f"]
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=5e-5,
                                   atol=5e-5)
    for i in range(3):
        one = grad(tloss, argnums=(0, 1, 2))(*_t(x[i], g[i], b[i]))
        for a, w in zip(got, one):
            torch.testing.assert_close(a[i], w, rtol=1e-6, atol=1e-6)


def test_backward_twin_equals_autograd_of_the_forward_twin():
    """The explicit backward twin (what the bwd kernel computes) against
    autograd through the plain forward, with R = 2 rows of γ: 1e-5."""
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(2, 3, 10, 24).astype(np.float32))
    dy = torch.from_numpy(rng.randn(2, 3, 10, 24).astype(np.float32))
    g = torch.from_numpy((rng.rand(2, 24) + 0.5).astype(np.float32))
    b = torch.from_numpy(rng.randn(2, 24).astype(np.float32))
    xr, gr, br = (t.clone().requires_grad_() for t in (x, g, b))
    y = gn.group_norm_fwd_plain(xr, gr, br, 6)
    want = torch.autograd.grad(y, (xr, gr, br), dy)
    got = gn.group_norm_bwd_plain(x, dy, g, 6)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)


def test_bf16_output_dtype_and_f32_stats():
    """bf16 in, bf16 out; against JAX's bf16 output within 2e-2 (the JAX
    package's own bf16 bound: a bf16 ulp at |y| ~ 3 is 1.6e-2)."""
    rng = np.random.RandomState(2)
    x = rng.randn(2, 4, 4, 32).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    y = gn.group_norm(xt, torch.ones(32), torch.zeros(32), 32)
    assert y.dtype == torch.bfloat16
    want = jax_group_norm(jnp.asarray(x, jnp.bfloat16),
                          jnp.ones(32, jnp.float32),
                          jnp.zeros(32, jnp.float32), 32)
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)


def test_rejects_bad_groups():
    with pytest.raises(ValueError, match="divide"):
        gn.group_norm(torch.zeros(2, 3, 30), torch.ones(30),
                      torch.zeros(30), 4)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch on cuda or raise: there is no quiet
    route from them to the plain twin."""
    x = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match="launches on cuda"):
        gn.group_norm_fwd(x, torch.ones(1, 8), torch.zeros(1, 8), 2)
    with pytest.raises(ValueError, match="launches on cuda"):
        gn.group_norm_bwd(x, x, torch.ones(1, 8), 2)


def test_a_client_interleaved_view_reaches_the_op_without_a_copy():
    """What a vmapped channels-last conv hands over — clients next to the
    channels, ``[M, H, W, R, C]`` memory seen as ``[R, M, H, W, C]`` —
    reaches the op, forward and backward, as a view of the same storage,
    and ``group_norm.copies`` stays put. Dims that no view can merge are
    copied once and counted; the values are those of a contiguous input
    (exact: the same twin on the same numbers)."""
    rng = np.random.RandomState(6)
    phys = torch.from_numpy(rng.randn(2, 4, 4, 3, 32).astype(np.float32))
    x = phys.permute(3, 0, 1, 2, 4)
    g = torch.from_numpy((rng.rand(3, 32) + 0.5).astype(np.float32))
    b = torch.from_numpy(rng.randn(3, 32).astype(np.float32))

    def tloss(x, g, b):
        return torch.sin(gn.group_norm(x, g, b, 8)).sum()

    seen = []
    fwd, bwd = gn.group_norm_fwd_plain, gn.group_norm_bwd_plain
    copies = gn.group_norm.copies
    try:
        gn.group_norm_fwd_plain = lambda x_, *a: seen.append(x_) or fwd(x_,
                                                                         *a)
        gn.group_norm_bwd_plain = lambda x_, *a: seen.append(x_) or bwd(x_,
                                                                         *a)
        got = vmap(grad(tloss, argnums=(0, 1, 2)))(x, g, b)
    finally:
        gn.group_norm_fwd_plain, gn.group_norm_bwd_plain = fwd, bwd
    assert gn.group_norm.copies == copies
    assert [t.data_ptr() for t in seen] == [phys.data_ptr()] * 2
    want = vmap(grad(tloss, argnums=(0, 1, 2)))(x.contiguous(), g, b)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=0)

    xt = torch.from_numpy(rng.randn(2, 4, 5, 32).astype(np.float32))
    xt = xt.transpose(1, 2)  # H and W cannot merge as a view
    y = gn.group_norm(xt, g[0], b[0], 8)
    assert gn.group_norm.copies == copies + 1
    torch.testing.assert_close(
        y, gn.group_norm(xt.contiguous(), g[0], b[0], 8), rtol=0, atol=0)
