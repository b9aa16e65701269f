"""The port's flash-attention backward (fedml_tpu_torch.ops.flash_attention)
against the JAX package's Pallas kernels, run in interpret mode on the CPU
as tests/test_flash_attention.py runs them: ``flash_attention_bwd_plain``
against ``_bwd`` (the dq and dk/dv kernels) fed the lse of ``_fwd``, and
the gradient of the port's differentiable ``flash_attention`` against
``jax.grad`` of JAX's. Inputs are made with numpy from a seed and handed
to both.

On the CPU the ops run the plain twins; the CUDA kernels are held against
those twins on the card (tests/test_torch_cuda.py and chip_smoke.py)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from fedml_tpu.ops.flash_attention import _bwd, _fwd
from fedml_tpu.ops.flash_attention import flash_attention as jax_flash
from fedml_tpu_torch.ops.flash_attention import (flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_plain)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(n, b=2, t=64, h=2, d=16, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, t, h, d).astype(np.float32) for _ in range(n)]


def _jax_bwd(q, k, v, do, causal, blk, dtype):
    """JAX's _fwd then _bwd at block ``blk``: (dq, dk, dv) as [B, T, H, D]
    f32, and o [B, T, H, D] and lse [B, H, T] for the port's twin."""
    b, t, h, d = q.shape

    def to3(x):
        return jnp.asarray(x, dtype).transpose(0, 2, 1, 3).reshape(b * h, t, d)

    def to4(x):
        return np.array(x.astype(jnp.float32)).reshape(b, h, t, d).transpose(
            0, 2, 1, 3)

    q3, k3, v3, do3 = map(to3, (q, k, v, do))
    scale = 1.0 / d ** 0.5
    o3, lse = _fwd(q3, k3, v3, scale, causal, blk, blk)
    grads = _bwd(q3, k3, v3, o3, lse, do3, scale, causal, blk, blk)
    return ([to4(g) for g in grads], to4(o3),
            np.array(lse[:, 0, :]).reshape(b, h, t))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,blk", [(64, 16), (128, 32)])
def test_plain_bwd_matches_jax_kernels_f32(causal, t, blk):
    """dq, dk, dv at atol 2e-5 (f32; only the summation order differs: the
    Pallas kernels fold 16/32-row blocks, the twin sums dense rows)."""
    q, k, v, do = _arrays(4, t=t)
    want, o, lse = _jax_bwd(q, k, v, do, causal, blk, jnp.float32)
    got = flash_attention_bwd_plain(*map(torch.from_numpy, (q, k, v, o, lse,
                                                            do)), causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_bwd_matches_jax_kernels_bf16(causal):
    """bf16 inputs: within 2e-2 of max |want| (the Pallas kernels round dS
    and P to bf16 before their products and write bf16; the f32 twin
    rounds only its outputs)."""
    q, k, v, do = _arrays(4, t=64, seed=1)
    want, o, lse = _jax_bwd(q, k, v, do, causal, 16, jnp.bfloat16)
    tq, tk, tv, to, tdo = (torch.from_numpy(x).to(torch.bfloat16)
                           for x in (q, k, v, o, do))
    got = flash_attention_bwd_plain(tq, tk, tv, to, torch.from_numpy(lse),
                                    tdo, causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        err = np.abs(g.float().numpy() - w).max() / np.abs(w).max()
        assert err <= 2e-2, err


@pytest.mark.parametrize("causal", [False, True])
def test_flash_gradient_matches_jax_grad(causal):
    """The port's flash_attention through autograd (CPU route: the plain
    twins under the autograd Function) against jax.grad of JAX's
    flash_attention (Pallas kernels in interpret mode), for the loss
    Σ sin(o)·w: atol 2e-5 in f32."""
    q, k, v, w = _arrays(4, t=64, seed=2)

    def jloss(q, k, v):
        o = jax_flash(q, k, v, causal=causal, block_q=16, block_k=32)
        return jnp.sum(jnp.sin(o) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    o, lse = flash_attention(tq, tk, tv, causal=causal)
    assert not lse.requires_grad
    (torch.sin(o) * torch.from_numpy(w)).sum().backward()
    for t_, w_ in zip((tq, tk, tv), want):
        np.testing.assert_allclose(t_.grad.numpy(), np.asarray(w_),
                                   rtol=2e-5, atol=2e-5)


def test_ragged_t_gradient_matches_dense_autograd():
    """The port takes any T (the kernels mask the ragged edge); JAX's
    kernels need a block multiple, so a ragged T is held against autograd
    through the dense forward twin: atol 1e-5."""
    q, k, v = (torch.from_numpy(x) for x in _arrays(3, t=50, seed=3))
    for causal in (False, True):
        def loss(fn):
            return lambda q, k, v: torch.sin(fn(q, k, v, causal)[0]).sum()

        got = grad(loss(flash_attention), argnums=(0, 1, 2))(q, k, v)
        want = grad(loss(flash_attention_plain), argnums=(0, 1, 2))(q, k, v)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_vmap_grad_over_clients_equals_a_client_loop():
    """vmap(grad) over a client dim (the trainer's cohort step) equals the
    per-client loop bit for bit on the CPU route, whichever dim the clients
    sit in, and counts no copy."""
    q, k, v = (torch.from_numpy(x) for x in _arrays(3, b=6, t=32, seed=4))
    q, k, v = (x.view(3, 2, 32, 2, 16) for x in (q, k, v))

    def loss(q, k, v):
        return torch.sin(flash_attention(q, k, v, causal=True)[0]).sum()

    copies = flash_attention.copies
    got = vmap(grad(loss, argnums=(0, 1, 2)))(q, k, v)
    # the clients next to T, as the trainer lays token batches out
    moved = vmap(grad(loss, argnums=(0, 1, 2)), in_dims=1)(
        *(x.movedim(0, 1).contiguous() for x in (q, k, v)))
    assert flash_attention.copies == copies
    for c in range(3):
        want = grad(loss, argnums=(0, 1, 2))(q[c], k[c], v[c])
        for a, m, w in zip(got, moved, want):
            assert torch.equal(a[c], w) and torch.equal(m[c], w)


def test_bwd_api_equals_autograd_and_counts_no_launch_on_cpu():
    q, k, v, do = (torch.from_numpy(x) for x in _arrays(4, t=32, seed=5))
    o, lse = flash_attention(q, k, v, causal=True)
    before = (flash_attention_bwd.dq_launches,
              flash_attention_bwd.dkv_launches)
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    assert (flash_attention_bwd.dq_launches,
            flash_attention_bwd.dkv_launches) == before
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "do_shape", "lse_shape",
                                 "lse_dtype", "o_dtype"])
def test_bwd_wrapper_rejects_what_the_kernels_do_not_take(bad):
    q, k, v, do = (torch.from_numpy(x) for x in _arrays(4, t=16, seed=6))
    o, lse = flash_attention_plain(q, k, v)
    if bad == "head_dim":
        q, k, v, o, do = (torch.zeros(2, 16, 2, 24) for _ in range(5))
    elif bad == "dtype":
        k = k.double()
    elif bad == "do_shape":
        do = do[:, :8]
    elif bad == "lse_shape":
        lse = lse[..., :8]
    elif bad == "lse_dtype":
        lse = lse.double()
    else:
        o = o.to(torch.bfloat16)
    with pytest.raises(ValueError):
        flash_attention_bwd(q, k, v, o, lse, do)


@pytest.mark.parametrize("case,copied", [
    ("contiguous", False),
    ("qkv_view", False),        # MHA's view: T stride 3·H·D, base + 2·H·D
    ("size1_odd_stride", False),  # a dim of size 1: its stride is unused
    ("t_stride_514_bytes", True),
    ("base_off_by_2_bytes", True),
    ("broadcast_stride_0", True),
])
def test_tma_ready_copies_only_what_tma_cannot_take(case, copied):
    """The bf16 route's operand check: TMA takes a base and (r, b, t, h)
    strides that are multiples of 16 bytes; anything else is copied once
    into a fresh contiguous buffer and counted, with the same values."""
    fa = importlib.import_module("fedml_tpu_torch.ops.flash_attention")
    base = torch.arange(3 * 2 * 40 * 4 * 16 * 3, dtype=torch.float32)
    base = base.to(torch.bfloat16)
    x = {
        "contiguous": lambda: base[:2 * 40 * 4 * 16].view(1, 2, 40, 4, 16),
        "qkv_view": lambda: base[:2 * 40 * 192].view(1, 2, 40, 192)[
            ..., 128:].unflatten(-1, (4, 16)),
        "size1_odd_stride": lambda: base[:40 * 65].view(40, 65)[
            :, :64].unflatten(-1, (4, 16))[None, None, :1],
        "t_stride_514_bytes": lambda: base[:2 * 40 * 257].view(2, 40, 257)[
            ..., :64].unflatten(-1, (4, 16))[None],
        "base_off_by_2_bytes": lambda: base[1:1 + 2 * 40 * 64].view(
            1, 2, 40, 4, 16),
        "broadcast_stride_0": lambda: base[:40 * 64].view(1, 1, 40, 4, 16)
        .expand(3, 1, 40, 4, 16),
    }[case]()
    before = fa.flash_attention.copies
    got = fa._tma_ready(x)
    assert fa.flash_attention.copies - before == int(copied)
    assert (got is not x) == copied
    assert torch.equal(got, x)
    if copied:
        assert got.is_contiguous() and got.data_ptr() % 16 == 0
