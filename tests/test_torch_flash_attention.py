"""The port's flash-attention forward (fedml_tpu_torch.ops.flash_attention)
against the JAX package's Pallas kernel, run in interpret mode on the CPU
as tests/test_flash_attention.py runs it. Inputs are made with numpy from
a seed and handed to both.

On the CPU the wrapper runs the plain PyTorch twin; the CUDA kernel is
held against that twin on the card (tests/test_torch_cuda.py and
chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.ops.flash_attention import _fwd
from fedml_tpu.ops.flash_attention import flash_attention as jax_flash
from fedml_tpu.parallel.ring_attention import reference_attention
from fedml_tpu_torch.ops.flash_attention import (flash_attention,
                                                 flash_attention_plain)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes at once; torch's own
    thread pool per process would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _qkv(b=2, t=64, h=2, d=16, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, t, h, d).astype(np.float32) for _ in range(3)]


def _jax_lse(q, k, v, causal, blk):
    """Row 0 of the Pallas kernel's [B*H, 8, T] lse, as [B, H, T]."""
    b, t, h, d = q.shape
    to3 = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, t, d)
    _, lse = _fwd(to3(q), to3(k), to3(v), 1.0 / d ** 0.5, causal, blk, blk)
    return np.asarray(lse)[:, 0, :].reshape(b, h, t)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,blk", [(64, 16), (128, 32)])
def test_plain_matches_jax_flash_f32(causal, t, blk):
    """o and lse at rtol = atol = 2e-5 (f32; only the summation order
    differs: the Pallas kernel folds 16/32-key blocks online, the plain
    twin sums one dense row)."""
    q, k, v = _qkv(t=t)
    want_o = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  block_q=blk, block_k=blk))
    want_lse = _jax_lse(q, k, v, causal, blk)
    o, lse = flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                   causal=causal)
    assert o.dtype == torch.float32 and lse.shape == (2, 2, t)
    np.testing.assert_allclose(o.numpy(), want_o, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=2e-5, atol=2e-5)


def test_plain_matches_jax_flash_bf16():
    """bf16 inputs: o at atol 2e-2 (the Pallas kernel rounds P to bf16
    before P·V and writes bf16; the twin keeps P in f32 — a few bf16 ulps
    of an O(1) output)."""
    q, k, v = _qkv(t=64)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jax_flash(jq, jk, jv, causal=True, block_q=16,
                                block_k=16).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    o, lse = flash_attention_plain(tq, tk, tv, causal=True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(o.float().numpy(), want, atol=2e-2)


def test_plain_ragged_t_matches_dense_reference():
    """The port takes any T (the kernel masks the ragged edge); the JAX
    flash kernel needs T to be a block multiple, so a ragged T is held
    against the JAX dense oracle instead, at 2e-5."""
    q, k, v = _qkv(t=50, seed=3)
    for causal in (False, True):
        want = np.asarray(reference_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
        o, _ = flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                     causal=causal)
        np.testing.assert_allclose(o.numpy(), want, rtol=2e-5, atol=2e-5)


def test_cpu_tensors_take_the_plain_twin_and_count_no_launch():
    q, k, v = map(torch.from_numpy, _qkv(t=32))
    before = flash_attention.launches
    o, lse = flash_attention(q, k, v, causal=True)
    po, plse = flash_attention_plain(q, k, v, causal=True)
    assert torch.equal(o, po) and torch.equal(lse, plse)
    assert flash_attention.launches == before


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "shape"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, k, v = map(torch.from_numpy, _qkv(t=16, d=16))
    if bad == "head_dim":
        q, k, v = (torch.zeros(1, 16, 2, 24) for _ in range(3))
    elif bad == "dtype":
        k = k.double()
    else:
        v = v[:, :8]
    with pytest.raises(ValueError):
        flash_attention(q, k, v)

