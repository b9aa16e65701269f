"""GroupNorm's second derivative in the port (``ops/group_norm.py``
``_GroupNormBackward``): through ``group_norm`` (the kernel route; the
plain twins on the CPU) against ordinary autograd through
``group_norm_plain`` and against JAX differentiating flax's GroupNorm
twice, under ``torch.func.grad`` of ``grad``, ``vmap`` and plain autograd
with ``create_graph``; ``gradgradcheck`` in f64; and a first derivative
that records nothing for a second.

Before the second derivative was written, the backward ran under
``no_grad``, and the GroupNorm terms of a second derivative came out as
zero with no error; these tests pin that they do not."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from fedml_tpu_torch.ops import group_norm as gn

RTOL = 1e-5  # f32: max |Δ| / max |want|, other summation orders


def _inputs(seed=0, shape=(2, 16, 8)):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    return (rng.randn(*shape).astype(np.float32) * 2 + 0.5,
            (rng.rand(c) + 0.5).astype(np.float32),
            rng.randn(c).astype(np.float32),
            rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


def _rel(got, want):
    return (got - want).abs().max().item() / want.abs().max().item()


def _second(fn, x, g, b, t, w):
    """grad of (x, γ, β) ↦ ⟨∇x L, w⟩ + ⟨∇γ L, γ⟩ + ⟨∇β L, β·γ⟩ with
    L = Σ (GN(x) − t)³: every term of the double backward."""

    def loss(x, g, b):
        return ((fn(x, g, b, 4) - t) ** 3).sum()

    def inner(x, g, b):
        gx, gg, gb = grad(loss, argnums=(0, 1, 2))(x, g, b)
        return (gx * w).sum() + (gg * g).sum() + (gb * b * g).sum()

    return grad(inner, argnums=(0, 1, 2))(x, g, b)


def test_second_derivative_matches_the_plain_twin():
    """The case that read 0.0 through the kernel route and ~3e2 through
    the twin: now within 1e-5 relative, for x, γ and β."""
    x, g, b, t, w = map(torch.from_numpy, _inputs())
    got = _second(gn.group_norm, x, g, b, t, w)
    want = _second(gn.group_norm_plain, x, g, b, t, w)
    assert want[0].norm().item() > 100.0
    for a, e in zip(got, want):
        assert _rel(a, e) <= RTOL


def test_second_derivative_matches_jax_flax_group_norm():
    """The same second derivative against JAX differentiating flax's
    ``nn.GroupNorm`` (eps 1e-6) twice, which is what FedNAS's unrolled
    step gets in the reference."""
    xn, gn_, bn, tn, wn = _inputs(1)
    mod = fnn.GroupNorm(num_groups=4, epsilon=1e-6)

    def jfn(x, g, b):
        return mod.apply({"params": {"scale": g, "bias": b}}, x)

    def jloss(x, g, b):
        return jnp.sum((jfn(x, g, b) - tn) ** 3)

    def jinner(x, g, b):
        gx, gg, gb = jax.grad(jloss, argnums=(0, 1, 2))(x, g, b)
        return jnp.sum(gx * wn) + jnp.sum(gg * g) + jnp.sum(gb * b * g)

    want = jax.grad(jinner, argnums=(0, 1, 2))(xn, gn_, bn)
    got = _second(gn.group_norm, *map(torch.from_numpy,
                                      (xn, gn_, bn, tn, wn)))
    for a, e in zip(got, want):
        assert _rel(a, torch.from_numpy(np.array(e))) <= 1e-4


def test_gradgradcheck_in_f64():
    """``gradgradcheck`` of (x, γ, β) ↦ GN in f64 (the plain twins take f64
    on the CPU), over a ragged group size and a 4-d input."""
    rng = np.random.RandomState(2)
    for shape, groups in (((2, 5, 6), 3), ((2, 3, 2, 4), 2)):
        c = shape[-1]
        x = torch.tensor(rng.randn(*shape), dtype=torch.float64,
                         requires_grad=True)
        g = torch.tensor(rng.rand(c) + 0.5, requires_grad=True)
        b = torch.tensor(rng.randn(c), requires_grad=True)
        assert torch.autograd.gradgradcheck(
            lambda x, g, b: gn.group_norm(x, g, b, groups), (x, g, b))


def test_second_derivative_under_vmap_and_create_graph():
    """vmap over 3 clients of grad of grad, and plain autograd with
    ``create_graph``: both match the twin."""
    x, g, b, _, w = map(torch.from_numpy, _inputs(3))
    xs = torch.stack([x, x * 0.5 - 1.0, x ** 2])

    def hess_vec(fn):
        def f(x):
            gx = grad(lambda x: (fn(x, g, b, 4) ** 3 * w).sum())(x)
            return (gx * w).sum()
        return vmap(grad(f))(xs)

    assert _rel(hess_vec(gn.group_norm), hess_vec(gn.group_norm_plain)) \
        <= RTOL

    def create_graph(fn):
        xr, gr = x.clone().requires_grad_(), g.clone().requires_grad_()
        out = (fn(xr, gr, b, 4) ** 3 * w).sum()
        gx, = torch.autograd.grad(out, xr, create_graph=True)
        return torch.autograd.grad((gx * w).sum(), (xr, gr))

    for a, e in zip(create_graph(gn.group_norm),
                    create_graph(gn.group_norm_plain)):
        assert _rel(a, e) <= RTOL


def test_a_first_derivative_records_no_second(monkeypatch):
    """One ``grad``, ``vmap(grad)`` and ``loss.backward()`` run the backward
    op under ``no_grad`` (nothing kept beyond x and γ); only a
    differentiated backward goes through ``_GroupNormBackward``."""
    calls = []
    apply = gn._GroupNormBackward.apply

    def counted(*args):
        calls.append(1)
        return apply(*args)

    monkeypatch.setattr(gn._GroupNormBackward, "apply", counted)
    x, g, b, t, w = map(torch.from_numpy, _inputs(4))

    def loss(x, g, b):
        return ((gn.group_norm(x, g, b, 4) - t) ** 2).sum()

    grad(loss, argnums=(0, 1, 2))(x, g, b)
    vmap(grad(loss), in_dims=(0, None, None))(torch.stack([x, x]), g, b)
    xr = x.clone().requires_grad_()
    loss(xr, g, b).backward()
    assert not calls
    _second(gn.group_norm, x, g, b, t, w)
    assert calls


def test_the_twins_take_f64_with_f64_params_and_nothing_narrower():
    """f64 is the plain twins' type for the checks above (γ/β in f64 with
    it); f16 is taken nowhere, and the kernel wrappers launch on cuda
    only."""
    x = torch.zeros(1, 1, 4, 8, dtype=torch.float64)
    g64, g32 = torch.ones(1, 8, dtype=torch.float64), torch.ones(1, 8)
    assert gn.group_norm_fwd_plain(x, g64, g64, 4).dtype == torch.float64
    with pytest.raises(ValueError, match="gamma/beta must be"):
        gn.group_norm_fwd_plain(x, g32, g32, 4)
    with pytest.raises(ValueError, match="dtype must be one of"):
        gn.group_norm_fwd_plain(x.half(), g32, g32, 4)
    with pytest.raises(ValueError, match="launches on cuda"):
        gn.group_norm_fwd(x.float(), g32, g32, 4)
