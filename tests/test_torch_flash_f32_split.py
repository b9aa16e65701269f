"""The arithmetic of the port's f32 flash kernels
(``fedml_tpu_torch/ops/csrc/flash_fwd.cu`` and ``flash_bwd.cu``), emulated
in plain torch on the CPU and held against the JAX package's Pallas
kernels (``_fwd`` and ``_bwd`` in interpret mode, as
tests/test_torch_flash_backward.py runs them).

The kernels run every product on the tensor cores as three TF32 passes,
``a·b ≈ a_hi·b_hi + a_hi·b_lo + a_lo·b_hi`` with ``a_hi = tf32(a)`` and
``a_lo = tf32(a − a_hi)``, where tf32 rounds to nearest, ties away from
zero, at 10 mantissa bits (the bits of ``cvt.rna.tf32.f32``, which the
kernels form with an integer add and mask, as ``tf32`` below does); the
forward runs an online softmax over 64-key tiles; the dq kernel computes
δ = rowsum(dO∘O) from the dO and O it holds. The emulation below does the
same with whole matrices (the forward tile by tile); it lives in this file
and on no path. Inputs are made with numpy from a seed. On the card the
kernels themselves are held against the plain twin
(tests/test_torch_cuda.py, chip_smoke.py)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.ops.flash_attention import _bwd, _fwd

NEG_INF = -1e30


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tf32(x):
    """x rounded to TF32 on its int32 view: half a TF32 ulp (bit 12) added
    to the magnitude, then the 13 low mantissa bits cleared, so ties go
    away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm_split(a, b):
    """a @ b in three TF32 passes, the small terms first, summed in f32."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def mm_one(a, b):
    """a @ b in one TF32 pass."""
    return tf32(a) @ tf32(b)


def emulated_fwd(q, k, v, causal, mm, blk=64):
    """The forward kernel over ``[BH, T, D]`` f32: an online softmax over
    ``blk``-key tiles, each product through ``mm``, each tile's P·V added
    to the rescaled running O in f32; (o, lse)."""
    t, d = q.shape[1:]
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    m = torch.full((*q.shape[:2], 1), NEG_INF)
    l = torch.zeros(*q.shape[:2], 1)
    acc = torch.zeros_like(q)
    rows = torch.arange(t)[:, None]
    for k0 in range(0, t, blk):
        kt, vt = k[:, k0:k0 + blk], v[:, k0:k0 + blk]
        s = mm(q, kt.transpose(1, 2)) * scale
        if causal:
            cols = torch.arange(k0, k0 + kt.shape[1])[None, :]
            s = s.masked_fill(cols > rows, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        c = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * c + p.sum(-1, keepdim=True)
        acc = acc * c + mm(p, vt)
        m = m_new
    l_safe = torch.where(l > 0, l, torch.ones_like(l))
    return acc / l_safe, (m + torch.log(l_safe))[..., 0]


def emulated_bwd(q, k, v, o, lse, do, causal, mm):
    """The kernels' backward over ``[BH, T, D]`` f32 with every product
    through ``mm``: (dq, dk, dv)."""
    t, d = q.shape[1:]
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    s = mm(q, k.transpose(1, 2)) * scale
    if causal:
        keep = torch.ones(t, t, dtype=torch.bool).tril()
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.exp(s - lse[..., None])
    dp = mm(do, v.transpose(1, 2))
    delta = (do * o).sum(-1)
    ds = p * (dp - delta[..., None])
    dq = mm(ds, k) * scale
    dk = mm(ds.transpose(1, 2), q) * scale
    dv = mm(p.transpose(1, 2), do)
    return dq, dk, dv


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10  # TF32's ulp at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                      one + 3 * ulp / 4, one + ulp * 1.5, 3.0e-30,
                      -7.25, 0.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + ulp,
                         one + 2 * ulp], dtype=torch.float32)
    got = tf32(x)
    assert torch.equal(got[:5], want)
    assert torch.equal(got[6:], x[6:])  # exact in TF32
    assert (got.view(torch.int32) & 0x1FFF).eq(0).all()
    assert abs(got[5].item() / 3.0e-30 - 1) <= 2.0 ** -11


def test_split_keeps_about_21_bits():
    """|x − hi − lo| ≤ 2⁻²² |x| for the split of any f32."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy((rng.randn(4096) * 10.0 ** rng.uniform(
        -6, 6, 4096)).astype(np.float32))
    hi, lo = split(x)
    err = (x.double() - hi.double() - lo.double()).abs()
    assert (err <= 2.0 ** -22 * x.double().abs()).all()


@pytest.mark.parametrize("b,t,h,d,causal,blk", [
    (4, 64, 4, 32, False, 64),  # the ViT's launch, B cut from 256 to 4
    (2, 200, 2, 64, True, 40),
])
def test_split_tf32_bwd_matches_jax_kernels(b, t, h, d, causal, blk):
    """dq, dk, dv of the emulated split-TF32 backward against JAX's
    ``_fwd`` then ``_bwd``, within 1e-4 of max |want| (the kernels' bound
    on the card); the one-pass TF32 distance is printed beside it."""
    rng = np.random.RandomState(20)
    q, k, v, do = (rng.randn(b * h, t, d).astype(np.float32)
                   for _ in range(4))
    scale = 1.0 / d ** 0.5
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    o, lse = _fwd(jq, jk, jv, scale, causal, blk, blk)
    want = [np.asarray(g) for g in _bwd(jq, jk, jv, o, lse, jdo, scale,
                                        causal, blk, blk)]
    args = [torch.from_numpy(x) for x in (q, k, v, np.array(o),
                                          np.array(lse)[:, 0, :], do)]
    for mm, name in ((mm_split, "split TF32"), (mm_one, "one TF32 pass")):
        got = emulated_bwd(*args, causal, mm)
        errs = [np.abs(g.numpy() - w).max() / np.abs(w).max()
                for g, w in zip(got, want)]
        print(f"{name} [{b}x{h}, {t}, {d}] causal={causal}: max|d-jax|/"
              f"max|jax| dq {errs[0]:.3e}, dk {errs[1]:.3e}, dv "
              f"{errs[2]:.3e}")
        if mm is mm_split:
            for g, e in zip(("dq", "dk", "dv"), errs):
                assert e <= 1e-4, (g, e)


@pytest.mark.parametrize("b,t,h,d,causal,blk", [
    (4, 64, 4, 32, False, 64),  # the ViT's launch, B cut from 256 to 4
    (2, 200, 2, 64, True, 40),  # a ragged walk over 64-key tiles
])
def test_split_tf32_fwd_matches_jax_kernels(b, t, h, d, causal, blk):
    """o and lse of the emulated split-TF32 forward against JAX's ``_fwd``:
    o within 1e-4 of max |want|, lse within 1e-3 (the kernel's bounds on
    the card); the one-pass TF32 distance is printed beside it."""
    rng = np.random.RandomState(21)
    q, k, v = (rng.randn(b * h, t, d).astype(np.float32) for _ in range(3))
    o, lse = _fwd(*map(jnp.asarray, (q, k, v)), 1.0 / d ** 0.5, causal, blk,
                  blk)
    want_o, want_lse = np.asarray(o), np.asarray(lse)[:, 0, :]
    args = [torch.from_numpy(x) for x in (q, k, v)]
    for mm, name in ((mm_split, "split TF32"), (mm_one, "one TF32 pass")):
        got_o, got_lse = emulated_fwd(*args, causal, mm)
        err_o = np.abs(got_o.numpy() - want_o).max() / np.abs(want_o).max()
        err_lse = np.abs(got_lse.numpy() - want_lse).max()
        print(f"{name} [{b}x{h}, {t}, {d}] causal={causal}: max|o-jax|/"
              f"max|jax| {err_o:.3e}, max|lse-jax| {err_lse:.3e}")
        if mm is mm_split:
            assert err_o <= 1e-4 and err_lse <= 1e-3, (err_o, err_lse)
