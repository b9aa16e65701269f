"""Tests of the port that need an NVIDIA card: the CUDA kernels against
their plain twins, and the model's flash path against its plain-attention
twin. They skip without a CUDA device. This file imports neither JAX nor
``fedml_tpu``, so it runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import pytest
import torch

from fedml_tpu_torch.ops.flash_attention import (flash_attention,
                                                 flash_attention_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,t,h,d,causal", [
    (torch.bfloat16, 2048, 4, 64, True),
    (torch.bfloat16, 2048, 4, 64, False),
    (torch.float32, 1000, 4, 64, True),
    (torch.float32, 77, 3, 16, True),
    (torch.bfloat16, 130, 2, 32, False),
    (torch.float32, 200, 2, 128, True),
    (torch.float32, 64, 4, 32, False),  # the ViT's shape: f32, full, D 32
    *[(torch.bfloat16, t, 2 if d == 128 else 4, d, causal)
      for t in (2048, 1000) for d in (16, 32, 64, 128)
      for causal in (True, False) if (t, d) != (2048, 64)],
    # f32 on one tile a head at every head dim, full at T 64 and causal at
    # a ragged T 50, and the walk's three shapes.
    *[(torch.float32, t, 4, d, causal)
      for d in (16, 32, 64, 128) for t, causal in ((64, False), (50, True))
      if (t, d) != (64, 32)],
    (torch.float32, 2048, 8, 64, True),
    (torch.float32, 1000, 8, 64, True),
    (torch.float32, 130, 2, 16, False),
])
def test_flash_kernel_matches_plain_twin(cuda, dtype, t, h, d, causal):
    """The kernel against the f32 twin on the same inputs: o within 2e-2
    (bf16: the kernel rounds P to bf16 before P·V) or 1e-4 (f32), lse
    within 1e-3; ragged T and every head dim included, bf16 (the
    tensor-core kernel) at every head dim with and without the mask at
    T 2048 and 1000, f32 (the split-TF32 kernel) in both of its builds
    at every head dim."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(2, t, h, d, device=cuda, generator=g).to(dtype)
               for _ in range(3))
    before = flash_attention.launches
    o, lse = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert o.dtype == dtype and lse.shape == (2, h, t)
    po, plse = flash_attention_plain(q.float(), k.float(), v.float(), causal)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert (o.float() - po).abs().max().item() <= tol
    assert (lse - plse).abs().max().item() <= 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_reads_strided_views(cuda, dtype):
    """q, k, v as views into one [B, T, 3·H·D] buffer (what MHA passes):
    no copy (in bf16 the tensor maps take the views' strides), same result
    as contiguous inputs."""
    g = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn(2, 300, 3 * 4 * 32, device=cuda, generator=g).to(dtype)
    q, k, v = (z.reshape(2, 300, 4, 32) for z in qkv.split(128, dim=-1))
    copies = flash_attention.copies
    o, lse = flash_attention(q, k, v, causal=True)
    assert flash_attention.copies == copies
    co, clse = flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=True)
    assert torch.equal(o, co) and torch.equal(lse, clse)


def test_flash_kernel_refuses_a_strided_head_dim(cuda):
    q = torch.zeros(1, 8, 2, 64, device=cuda)[..., ::2]  # stride 2 in D
    with pytest.raises(RuntimeError, match="contiguous"):
        flash_attention(q, q, q)


def test_flash_fwd_bf16_reruns_are_bit_equal_at_the_slice_shape(cuda):
    """No sum crosses blocks: two bf16 forwards at the FedAdapter shape
    give the same bits."""
    g = torch.Generator(device=cuda).manual_seed(12)
    q, k, v = (torch.randn(16, 2048, 8, 64, device=cuda, generator=g)
               .to(torch.bfloat16) for _ in range(3))
    a = flash_attention(q, k, v, causal=True)
    b = flash_attention(q, k, v, causal=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_flash_fwd_bf16_copies_a_view_tma_cannot_take(cuda):
    """A bf16 q whose T stride (257 elements, 514 bytes) is no multiple of
    16 bytes: copied once and counted once, with the same bits as the
    contiguous q."""
    g = torch.Generator(device=cuda).manual_seed(14)
    buf = torch.randn(2, 300, 4 * 64 + 1, generator=g, device=cuda).to(
        torch.bfloat16)
    q = buf[..., :256].unflatten(-1, (4, 64))
    k, v = (torch.randn(2, 300, 4, 64, generator=g, device=cuda)
            .to(torch.bfloat16) for _ in range(2))
    copies = flash_attention.copies
    got = flash_attention(q, k, v, causal=True)
    assert flash_attention.copies == copies + 1
    want = flash_attention(q.contiguous(), k, v, causal=True)
    assert flash_attention.copies == copies + 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_flash_fwd_f32_reruns_are_bit_equal_at_the_vit_shape(cuda):
    """The split-TF32 forward sums in a fixed order with no atomics: two
    runs at the ViT's launch (8 clients x batch 32, T 64, 4 heads, D 32)
    give the same bits."""
    g = torch.Generator(device=cuda).manual_seed(18)
    q, k, v = (torch.randn(256, 64, 4, 32, device=cuda, generator=g)
               for _ in range(3))
    a = flash_attention(q, k, v)
    b = flash_attention(q, k, v)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_flash_fwd_f32_reads_a_misaligned_view_in_place(cuda):
    """f32 q, k, v at an odd offset into buffers whose T stride (385
    floats) is no multiple of 16 bytes: read with 4-byte copies inside the
    kernel, no copy counted, the same bits as contiguous inputs, and
    within 1e-4 (o) and 1e-3 (lse) of the twin."""
    g = torch.Generator(device=cuda).manual_seed(19)
    q, k, v = (torch.randn(2, 300, 3 * 4 * 32 + 1, generator=g,
                           device=cuda)[..., 1:129].unflatten(-1, (4, 32))
               for _ in range(3))
    assert q.data_ptr() % 16 and q.stride(1) % 4
    copies = flash_attention.copies
    o, lse = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_attention.copies == copies
    dense = [x.contiguous() for x in (q, k, v)]
    co, clse = flash_attention(*dense, causal=True)
    assert torch.equal(o, co) and torch.equal(lse, clse)
    po, plse = flash_attention_plain(*dense, True)
    assert (o - po).abs().max().item() <= 1e-4
    assert (lse - plse).abs().max().item() <= 1e-3


def _bwd_inputs(b, t, h, d, dtype, causal, gen, device):
    """q, k, v, dO in ``dtype`` and the kernel's forward (o, lse)."""
    q, k, v, do = (torch.randn(b, t, h, d, generator=gen, device=device)
                   .to(dtype) for _ in range(4))
    o, lse = flash_attention(q, k, v, causal=causal)
    return q, k, v, do, o, lse


def _scaled_err(got, want):
    """max |Δ| as a share of max |want|."""
    return ((got.float() - want).abs().max() / want.abs().max()).item()


# The slice's shape (8 clients x batch 2, T 2048, 8 heads, D 64), f32 at
# T 2048, bf16 without the mask, a ragged T, and the other head dims. f32
# reaches the split-TF32 kernels (one tile at T 64, with and without the
# mask, and one row past it at T 65); bf16 the tensor-core kernels, at
# every head dim with and without the mask, and at the ragged T 77 and
# 1000.
FLASH_BWD_CASES = [(16, 2048, 8, 64, torch.bfloat16, True),
                   (2, 2048, 4, 64, torch.float32, True),
                   (2, 1024, 4, 64, torch.bfloat16, False),
                   (2, 1000, 4, 64, torch.float32, True),
                   (2, 77, 3, 16, torch.float32, False),
                   (2, 300, 4, 32, torch.bfloat16, True),
                   (2, 200, 2, 128, torch.float32, True),
                   (1, 130, 2, 128, torch.bfloat16, False),
                   (2, 77, 3, 16, torch.bfloat16, True),
                   (2, 1000, 2, 16, torch.bfloat16, False),
                   (2, 1000, 4, 32, torch.bfloat16, False),
                   (2, 1000, 4, 64, torch.bfloat16, True),
                   (2, 77, 3, 64, torch.bfloat16, False),
                   (2, 1000, 2, 128, torch.bfloat16, True),
                   (2, 77, 2, 128, torch.bfloat16, True),
                   (256, 64, 4, 32, torch.float32, False),  # the ViT's
                   (2, 64, 4, 32, torch.float32, True),
                   (2, 65, 4, 32, torch.float32, False)]  # one tile's edge


@pytest.mark.parametrize("b,t,h,d,dtype,causal", FLASH_BWD_CASES)
def test_flash_bwd_kernels_match_plain_twin(cuda, b, t, h, d, dtype, causal):
    """dq, dk, dv from the two backward kernels against the f32 twin on the
    same inputs (and the kernel's lse): within 1e-4 of max |want| in f32
    (another summation order) and 2e-2 in bf16 (the kernels round dS and P
    to bf16 before the products, as the TPU kernels do, and write bf16)."""
    from fedml_tpu_torch.ops.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain)

    g = torch.Generator(device=cuda).manual_seed(4)
    q, k, v, do, o, lse = _bwd_inputs(b, t, h, d, dtype, causal, g, cuda)
    dq0 = flash_attention_bwd.dq_launches
    dkv0 = flash_attention_bwd.dkv_launches
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert (flash_attention_bwd.dq_launches - dq0,
            flash_attention_bwd.dkv_launches - dkv0) == (1, 1)
    want = flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                     o.float(), lse, do.float(), causal)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == q.shape
        assert _scaled_err(a, w) <= tol, (name, _scaled_err(a, w))


def test_flash_bwd_kernels_read_strided_views(cuda):
    """q, k, v as views into one [B, T, 3·H·D] buffer: the same bits as
    contiguous inputs, and no copy counted."""
    from fedml_tpu_torch.ops.flash_attention import flash_attention_bwd

    g = torch.Generator(device=cuda).manual_seed(5)
    qkv = torch.randn(2, 300, 3 * 4 * 64, generator=g, device=cuda).to(
        torch.bfloat16)
    q, k, v = (z.reshape(2, 300, 4, 64) for z in qkv.split(256, dim=-1))
    do = torch.randn(2, 300, 4, 64, generator=g, device=cuda).to(
        torch.bfloat16)
    o, lse = flash_attention(q, k, v, causal=True)
    copies = flash_attention.copies
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    assert flash_attention.copies == copies
    want = flash_attention_bwd(q.contiguous(), k.contiguous(), v.contiguous(),
                               o, lse, do, causal=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_flash_bwd_kernels_are_deterministic(cuda):
    from fedml_tpu_torch.ops.flash_attention import flash_attention_bwd

    g = torch.Generator(device=cuda).manual_seed(6)
    args = _bwd_inputs(4, 512, 4, 64, torch.bfloat16, True, g, cuda)
    q, k, v, do, o, lse = args
    a = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    b = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_flash_bwd_bf16_reruns_are_bit_equal_at_the_slice_shape(cuda):
    """The tensor-core kernels sum in a fixed order with no atomics: two
    runs at the FedAdapter shape give the same bits."""
    from fedml_tpu_torch.ops.flash_attention import flash_attention_bwd

    g = torch.Generator(device=cuda).manual_seed(8)
    q, k, v, do, o, lse = _bwd_inputs(16, 2048, 8, 64, torch.bfloat16, True,
                                      g, cuda)
    a = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    b = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_flash_bwd_bf16_copies_a_view_tma_cannot_take(cuda):
    """A bf16 q whose T stride (257 elements, 514 bytes) is no multiple of
    16 bytes: copied once and counted once, with the same bits as the
    contiguous q."""
    from fedml_tpu_torch.ops.flash_attention import flash_attention_bwd

    g = torch.Generator(device=cuda).manual_seed(9)
    buf = torch.randn(2, 300, 4 * 64 + 1, generator=g, device=cuda).to(
        torch.bfloat16)
    q = buf[..., :256].unflatten(-1, (4, 64))
    k, v, do = (torch.randn(2, 300, 4, 64, generator=g, device=cuda)
                .to(torch.bfloat16) for _ in range(3))
    o, lse = flash_attention(q, k, v, causal=True)
    copies = flash_attention.copies
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    assert flash_attention.copies == copies + 1
    want = flash_attention_bwd(q.contiguous(), k, v, o, lse, do, causal=True)
    assert flash_attention.copies == copies + 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))


VIT_FLASH = (256, 64, 4, 32)  # the ViT's launch: 8 clients x batch 32


def test_flash_bwd_f32_reruns_are_bit_equal_at_the_vit_shape(cuda):
    """The split-TF32 kernels sum in a fixed order with no atomics: two
    runs at the ViT's shape give the same bits."""
    from fedml_tpu_torch.ops.flash_attention import flash_attention_bwd

    g = torch.Generator(device=cuda).manual_seed(15)
    q, k, v, do, o, lse = _bwd_inputs(*VIT_FLASH, torch.float32, False, g,
                                      cuda)
    a = flash_attention_bwd(q, k, v, o, lse, do, causal=False)
    b = flash_attention_bwd(q, k, v, o, lse, do, causal=False)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_flash_bwd_f32_reads_strided_views(cuda):
    """f32 q, k, v as views into one [B, T, 3·H·D] buffer (16-byte rows at
    a stride of 3·H·D): the same bits as contiguous inputs, and no copy
    counted."""
    from fedml_tpu_torch.ops.flash_attention import flash_attention_bwd

    g = torch.Generator(device=cuda).manual_seed(16)
    qkv = torch.randn(2, 300, 3 * 4 * 32, generator=g, device=cuda)
    q, k, v = (z.reshape(2, 300, 4, 32) for z in qkv.split(128, dim=-1))
    do = torch.randn(2, 300, 4, 32, generator=g, device=cuda)
    o, lse = flash_attention(q, k, v, causal=True)
    copies = flash_attention.copies
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    assert flash_attention.copies == copies
    want = flash_attention_bwd(q.contiguous(), k.contiguous(), v.contiguous(),
                               o, lse, do, causal=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_flash_bwd_f32_reads_a_misaligned_view_in_place(cuda):
    """f32 q, k, v, dO and O at an odd offset into buffers whose T stride
    (385 floats) is no multiple of 16 bytes: read with 4-byte copies inside
    the kernels, no copy counted, the same bits as contiguous inputs, and
    within 1e-4 of max |want| of the twin."""
    from fedml_tpu_torch.ops.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain)

    g = torch.Generator(device=cuda).manual_seed(17)

    def odd_view(x=None):
        buf = torch.randn(2, 300, 3 * 4 * 32 + 1, generator=g, device=cuda)
        view = buf[..., 1:129].unflatten(-1, (4, 32))
        if x is not None:
            view.copy_(x)
        return view

    q, k, v, do = (odd_view() for _ in range(4))
    o, lse = flash_attention(q, k, v, causal=True)
    o = odd_view(o)
    assert q.data_ptr() % 16 and q.stride(1) % 4
    copies = flash_attention.copies
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    assert flash_attention.copies == copies
    dense = [x.contiguous() for x in (q, k, v, o)]
    want = flash_attention_bwd(*dense, lse, do.contiguous(), causal=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    plain = flash_attention_bwd_plain(*dense, lse, do.contiguous(), True)
    for name, a, w in zip(("dq", "dk", "dv"), got, plain):
        assert _scaled_err(a, w) <= 1e-4, (name, _scaled_err(a, w))


@pytest.mark.parametrize("b,t,h,d,causal", [(*VIT_FLASH, False),
                                            (2, 77, 3, 16, True)])
def test_flash_dq_f32_writes_delta(cuda, b, t, h, d, causal):
    """δ that the f32 dq kernel writes for dk/dv: rowsum(dO∘O) as
    [R, B, H, T], within 1e-6 of the sum in f64."""
    from fedml_tpu_torch.ops.build import extension

    g = torch.Generator(device=cuda).manual_seed(18)
    q, k, v, do, o, lse = _bwd_inputs(b, t, h, d, torch.float32, causal, g,
                                      cuda)
    dq, delta = extension().flash_dq(q[None], k[None], v[None], do[None],
                                     o[None], lse[None], causal)
    torch.cuda.synchronize()
    want = (do.double() * o.double()).sum(-1).transpose(1, 2)
    assert delta.shape == (1, b, h, t) and delta.is_contiguous()
    assert (delta[0].double() - want).abs().max().item() <= 1e-6


@pytest.mark.parametrize("t,h,d", [(256, 4, 32), (2048, 8, 64)])
def test_flash_bf16_under_vmap_grad_launches_once(cuda, t, h, d):
    """vmap(grad) over 8 clients in bf16 with the clients next to T, as the
    trainer lays tokens out ([B, C, T, 3·H·D] memory, q, k, v views of it),
    small and at the FedAdapter shape: one launch of each of the three
    kernels, no copy, and per-client gradients within 2e-2 of max |want|
    of the plain twin's autograd."""
    from torch.func import grad, vmap

    from fedml_tpu_torch.ops.flash_attention import flash_attention_bwd

    g = torch.Generator(device=cuda).manual_seed(10)
    qkv = torch.randn(2, 8, t, 3 * h * d, generator=g, device=cuda).to(
        torch.bfloat16)
    q, k, v = (z.unflatten(-1, (h, d)) for z in qkv.split(h * d, dim=-1))

    def loss(fn):
        return lambda q, k, v: torch.sin(
            fn(q, k, v, causal=True)[0].float()).sum()

    counts = (flash_attention.launches, flash_attention_bwd.dq_launches,
              flash_attention_bwd.dkv_launches, flash_attention.copies)
    got = vmap(grad(loss(flash_attention), argnums=(0, 1, 2)), in_dims=1)(
        q, k, v)
    after = (flash_attention.launches, flash_attention_bwd.dq_launches,
             flash_attention_bwd.dkv_launches, flash_attention.copies)
    assert tuple(a - b for a, b in zip(after, counts)) == (1, 1, 1, 0)
    want = vmap(grad(loss(flash_attention_plain), argnums=(0, 1, 2)),
                in_dims=1)(*(x.float() for x in (q, k, v)))
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16
        assert _scaled_err(a, w) <= 2e-2, _scaled_err(a, w)


def test_flash_under_vmap_grad_launches_once(cuda):
    """vmap(grad) over 4 clients: one launch of each of the three kernels,
    no copy, and per-client gradients equal to the plain twin's autograd
    within 1e-4 (f32)."""
    from torch.func import grad, vmap

    from fedml_tpu_torch.ops.flash_attention import flash_attention_bwd

    g = torch.Generator(device=cuda).manual_seed(7)
    q, k, v = (torch.randn(4, 2, 256, 4, 32, generator=g, device=cuda)
               for _ in range(3))

    def loss(fn):
        return lambda q, k, v: torch.sin(fn(q, k, v, causal=True)[0]).sum()

    counts = (flash_attention.launches, flash_attention_bwd.dq_launches,
              flash_attention_bwd.dkv_launches, flash_attention.copies)
    got = vmap(grad(loss(flash_attention), argnums=(0, 1, 2)))(q, k, v)
    after = (flash_attention.launches, flash_attention_bwd.dq_launches,
             flash_attention_bwd.dkv_launches, flash_attention.copies)
    assert tuple(a - b for a, b in zip(after, counts)) == (1, 1, 1, 0)
    want = vmap(grad(loss(flash_attention_plain), argnums=(0, 1, 2)))(q, k, v)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_model_flash_path_matches_plain_attention(cuda):
    """A small bf16 transformer with adapters: the flash kernel in every
    block against the plain twin as attention, same weights; logits
    within 0.1 (a few bf16 ulps at |logit| ~ 4)."""
    from fedml_tpu_torch.models import create_model

    kw = dict(vocab_size=97, d_model=64, n_heads=2, n_layers=2, max_len=256,
              dtype="bf16", adapter_rank=4, adapter_scope="all")
    gen = torch.Generator().manual_seed(0)
    flash = create_model("transformer_lm", attn="flash", generator=gen, **kw)
    plain = create_model(
        "transformer_lm", attn_fn=lambda q, k, v, causal: (
            flash_attention_plain(q, k, v, causal)[0]), **kw)
    plain.load_state_dict(flash.state_dict())

    def fill(tree):  # non-zero A and B (the init has B = 0)
        return {k: fill(v) if isinstance(v, dict) else
                torch.randn(v.shape, generator=gen).mul(0.02).to(cuda)
                for k, v in tree.items()}

    adapters = fill(flash.init_adapters(gen))
    toks = torch.randint(0, 97, (3, 200), generator=gen).to(cuda)
    before = flash_attention.launches
    with torch.inference_mode():
        got, want = flash(toks, adapters), plain(toks, adapters)
    assert flash_attention.launches == before + 2
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 0.1


# --- GroupNorm kernels --------------------------------------------------------

# The main path's shapes: 8 clients x 32 samples, every (S, C, groups) that
# ResNet-56's 58 GroupNorms give the kernels.
GN_MAIN_SHAPES = [((256, 1024, 16), 16), ((256, 1024, 64), 32),
                  ((256, 1024, 32), 32), ((256, 256, 32), 32),
                  ((256, 256, 128), 32), ((256, 256, 64), 32),
                  ((256, 64, 64), 32), ((256, 64, 256), 32)]
# resnet56_server's GroupNorm shapes at batch 32 (f32, the split family).
GN_SPLIT_SHAPES = [((32,) + shape[1:], groups)
                   for shape, groups in GN_MAIN_SHAPES]
# The simulator zoo's f32 shapes on the cluster route, 8 clients' rows: the
# DARTS search net at batch 32 on 32 x 32 (the stem's 48 channels in 24
# groups, one-channel groups at 16 and 32 channels), UNet at batch 8 on
# 256 x 256, levels 2 and 3.
GN_ZOO_SHAPES = [((256, 1024, 48), 24), ((256, 1024, 16), 16),
                 ((256, 1024, 32), 32), ((256, 256, 32), 32),
                 ((256, 256, 64), 32), ((256, 64, 64), 32),
                 ((64, 4096, 64), 32), ((64, 1024, 128), 32)]
# ResNet-18-GN's f32 shapes at fed_cifar100's cohort, 10 clients' rows
# of 20 samples: 64 to 512 channels in 32 groups, 32² down to 4².
GN_R18_SHAPES = [(200, 1024, 64), (200, 256, 128), (200, 64, 256),
                 (200, 16, 512)]
# The cross-silo CV zoo's new f32 shapes at 32 px, 10 clients' rows of 64
# samples: EfficientNet-b0's 96 channels in groups of 3 at 32², MobileNetV3's
# 72 in 24 groups, SMALL's 88 in 22, LARGE's 480 and 672 at 4², 960 and
# EfficientNet's 1280 at 2² (S = 4).
GN_CV_SHAPES = [((640, 1024, 96), 32), ((640, 256, 72), 24),
                ((640, 64, 88), 22), ((640, 16, 480), 32),
                ((640, 16, 672), 32), ((640, 4, 960), 32),
                ((640, 4, 1280), 32)]


def _gn_inputs(shape, rows, dtype, gen, device, interleaved=False):
    """x [R, M, S, C] and dy in ``dtype``, per-row γ in [0.5, 1.5), β ~
    N(0, 1). ``interleaved``: x and dy lie in memory as ``[M, S, R, C]``,
    the clients next to the channels, as a vmapped channels-last conv
    hands them over."""
    n, s, c = shape
    m = n // rows
    phys = (m, s, rows, c) if interleaved else (rows, m, s, c)
    x = torch.randn(phys, generator=gen, device=device) * 2 + 0.5
    dy = torch.randn(phys, generator=gen, device=device)
    gamma = torch.rand(rows, c, generator=gen, device=device) + 0.5
    beta = torch.randn(rows, c, generator=gen, device=device)
    x, dy = x.to(dtype), dy.to(dtype)
    if interleaved:
        x, dy = x.permute(2, 0, 1, 3), dy.permute(2, 0, 1, 3)
    return x, dy, gamma, beta


def _within_bf16_ulp(got, want):
    """One rounding to bf16 of the f32 value: |Δ| ≤ 2^-8·|want|, plus 1e-5
    of the tensor's scale for the f32 noise of another sum order."""
    err = (got.float() - want).abs()
    lim = want.abs() * 2.0 ** -8 + 1e-5 * want.abs().max()
    return bool((err <= lim).all()), err.max().item()


def _sum_order_bound(terms, chain):
    """|Δ| of two f32 sums of the same terms in other orders: at most
    chain·2^-24·Σ|terms| per channel (recursive summation's bound with
    `chain` sequential adds)."""
    return chain * 2.0 ** -24 * terms.abs().sum(dim=(1, 2)) + 1e-7


@pytest.mark.parametrize("shape,groups,rows,dtype,interleaved", [
    *[(s, g, 1, torch.bfloat16, False) for s, g in GN_MAIN_SHAPES],
    ((256, 1024, 64), 32, 8, torch.bfloat16, False),
    *[(s, g, 8, torch.bfloat16, True) for s, g in GN_MAIN_SHAPES],
    ((6, 49, 48), 8, 1, torch.float32, False),
    ((6, 49, 48), 8, 3, torch.float32, False),
    ((9, 1, 16), 4, 1, torch.float32, False),
    ((2, 4096, 64), 32, 1, torch.float32, False),
    ((3, 1001, 64), 32, 1, torch.bfloat16, False),
    ((3, 1001, 64), 32, 1, torch.float32, False),
    ((6, 49, 48), 8, 1, torch.bfloat16, False),
    ((4, 1024, 128), 32, 1, torch.bfloat16, False),
    *[(s, g, 1, torch.float32, False) for s, g in GN_SPLIT_SHAPES],
    ((4096, 1024, 16), 16, 128, torch.float32, True),
    *[(s, g, 8, torch.float32, inter) for s, g in GN_ZOO_SHAPES
      for inter in (False, True)],
    *[(s, 32, 10, torch.float32, inter) for s in GN_R18_SHAPES
      for inter in (False, True)],
    *[(s, g, 10, torch.float32, inter) for s, g in GN_CV_SHAPES
      for inter in (False, True)],
])
def test_group_norm_kernels_match_plain_twin(cuda, shape, groups, rows,
                                             dtype, interleaved):
    """Forward and backward kernels against the f32 plain twins on the same
    inputs: y and dx within one bf16 rounding (bf16) or 1e-5 (f32); dγ and
    dβ within the sum-order bound; no copy, the forward on its cluster
    route, and reruns of both give the same bits. The interleaved cases are
    the training path's layout at every ResNet-56 shape: 8 clients' rows of
    γ/β, x a strided view. The f32 sample of 4096 x 64 (1 MB of x and of
    dy) is more than a cluster of 8 blocks holds of both: the backward
    keeps x in shared memory and reads dy twice. S 1001 is ragged for the
    forward's clusters (CL 4 of 251 rows in bf16, CL 8 of 126 in f32), and
    the bf16 sample of 1024 x 128 takes CL 8. The f32 cases at batch 32
    are resnet56_server's shapes in the split family, and the 128 rows of
    32 samples its stump's under the FedGKT client phase's vmap. The f32
    cases of 8 rows are FedNAS's and FedSeg's, those of 10 rows
    ResNet-18-GN's and the cross-silo CV zoo's (groups of 3 to 40
    channels, S down to 4), in both layouts."""
    from fedml_tpu_torch.ops import group_norm as gn

    g = torch.Generator(device=cuda).manual_seed(0)
    x, dy, gamma, beta = _gn_inputs(shape, rows, dtype, g, cuda, interleaved)
    f0, b0 = gn.group_norm_fwd.launches, gn.group_norm_bwd.launches
    r0, c0 = gn.group_norm_bwd.reduce_launches, gn.group_norm.copies
    s0 = gn.group_norm_fwd.streamed
    y = gn.group_norm_fwd(x, gamma, beta, groups)
    y_again = gn.group_norm_fwd(x, gamma, beta, groups)
    dx, dgamma, dbeta = gn.group_norm_bwd(x, dy, gamma, groups)
    again = gn.group_norm_bwd(x, dy, gamma, groups)
    torch.cuda.synchronize()
    assert (gn.group_norm_fwd.launches - f0, gn.group_norm_bwd.launches - b0,
            gn.group_norm_bwd.reduce_launches - r0) == (2, 2, 2)
    assert gn.group_norm_fwd.streamed == s0
    assert gn.group_norm.copies == c0
    assert torch.equal(y, y_again)
    assert all(torch.equal(a, b) for a, b in zip((dx, dgamma, dbeta), again))
    assert y.dtype == dtype and dx.dtype == dtype
    want_y = gn.group_norm_fwd_plain(x.float(), gamma, beta, groups)
    want_dx, want_dg, want_db = gn.group_norm_bwd_plain(
        x.float(), dy.float(), gamma, groups)
    if dtype == torch.bfloat16:
        for got, want in ((y, want_y), (dx, want_dx)):
            ok, err = _within_bf16_ulp(got, want)
            assert ok, err
    else:
        torch.testing.assert_close(y, want_y, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(dx, want_dx, rtol=1e-5, atol=1e-5)
    r, m, s, c = x.shape
    chain = s + m + 64
    mu, rstd = gn._stats(x.float(), groups, gn.EPS)
    xhat = (x.float() - mu) * rstd
    d32 = dy.float()
    assert bool(((dgamma - want_dg).abs()
                 <= _sum_order_bound(d32 * xhat, chain)).all())
    assert bool(((dbeta - want_db).abs()
                 <= _sum_order_bound(d32, chain)).all())


def test_group_norm_kernel_reads_strided_views(cuda):
    """A client-interleaved view (what a vmapped conv hands over): same bits
    as the contiguous copy, output in the input's strides, no copy counted."""
    from fedml_tpu_torch.ops import group_norm as gn

    g = torch.Generator(device=cuda).manual_seed(1)
    phys = torch.randn(32, 64, 8, 64, generator=g, device=cuda)  # [M, S, R, C]
    x = phys.to(torch.bfloat16).permute(2, 0, 1, 3)  # [R, M, S, C] view
    gamma = torch.rand(8, 64, generator=g, device=cuda) + 0.5
    beta = torch.randn(8, 64, generator=g, device=cuda)
    dy = torch.empty_like(x).normal_(generator=g)
    copies = gn.group_norm.copies
    y = gn.group_norm_fwd(x, gamma, beta, 32)
    dx, dg, db = gn.group_norm_bwd(x, dy, gamma, 32)
    assert gn.group_norm.copies == copies
    assert y.stride() == x.stride()
    yc = gn.group_norm_fwd(x.contiguous(), gamma, beta, 32)
    dxc, dgc, dbc = gn.group_norm_bwd(x.contiguous(), dy, gamma, 32)
    assert torch.equal(y, yc) and torch.equal(dx, dxc)
    assert torch.equal(dg, dgc) and torch.equal(db, dbc)


def test_group_norm_kernels_are_deterministic(cuda):
    from fedml_tpu_torch.ops import group_norm as gn

    g = torch.Generator(device=cuda).manual_seed(2)
    x, dy, gamma, _ = _gn_inputs((256, 256, 128), 8, torch.bfloat16, g, cuda)
    a = gn.group_norm_bwd(x, dy, gamma, 32)
    b = gn.group_norm_bwd(x, dy, gamma, 32)
    assert all(torch.equal(p, q) for p, q in zip(a, b))


@pytest.mark.parametrize("s,c,is_bf16,tensors,want_cl,ragged", [
    (1024, 64, True, 1, 4, False),   # the main shape's forward: 32 KB
    (1024, 64, True, 2, 8, False),   # its backward: 16 KB of x and of dy
    (1024, 128, True, 1, 8, False),
    (1001, 64, True, 1, 4, True),
    (1001, 64, False, 1, 8, True),
    (64, 64, True, 1, 1, False),
    (8192, 64, False, 1, 0, False),  # 2 MB: the forward streams
])
def test_group_norm_cluster_plan(cuda, s, c, is_bf16, tensors, want_cl,
                                 ragged):
    """The cluster plan by shape (the plan's first four fields): CL, rows
    per block (ragged when CL does not divide S), and a block's shared
    memory within the card's."""
    from fedml_tpu_torch.ops.build import extension

    cl, rows, resident, smem = extension().group_norm_plan(
        s, c, is_bf16, tensors)[:4]
    assert cl == want_cl
    if cl:
        assert rows == -(-s // cl) and (s % rows != 0) == ragged
        assert resident == tensors
        props = torch.cuda.get_device_properties(cuda)
        limit = getattr(props, "shared_memory_per_block_optin", 232448)
        assert 0 < smem <= limit
    else:
        assert (rows, resident, smem) == (0, 0, 0)


def test_group_norm_fwd_streams_a_sample_larger_than_a_cluster_holds(cuda):
    """x past the shared memory of a cluster of 8 blocks (8192 x 64 f32, 2
    MB) takes the streamed route: chosen by shape, counted, and within the
    twin's bound; the backward streams the same sample, counted."""
    from fedml_tpu_torch.ops import group_norm as gn

    g = torch.Generator(device=cuda).manual_seed(4)
    x, dy, gamma, beta = _gn_inputs((2, 8192, 64), 1, torch.float32, g, cuda)
    f0, s0 = gn.group_norm_fwd.launches, gn.group_norm_fwd.streamed
    y = gn.group_norm_fwd(x, gamma, beta, 32)
    torch.cuda.synchronize()
    assert (gn.group_norm_fwd.launches - f0,
            gn.group_norm_fwd.streamed - s0) == (1, 1)
    torch.testing.assert_close(
        y, gn.group_norm_fwd_plain(x, gamma, beta, 32), rtol=1e-5, atol=1e-5)
    b0 = gn.group_norm_bwd.streamed
    dx, _, _ = gn.group_norm_bwd(x, dy, gamma, 32)
    assert gn.group_norm_bwd.streamed - b0 == 1
    torch.testing.assert_close(
        dx, gn.group_norm_bwd_plain(x, dy, gamma, 32)[0], rtol=1e-5,
        atol=1e-5)


def test_binding_checks_raise_with_numbers_in_the_message(cuda):
    """A failed check in the binding whose message carries numbers raises a
    RuntimeError (it used to crash the process on the card)."""
    from fedml_tpu_torch.ops.build import extension

    ext = extension()
    x = torch.zeros(1, 1, 16, 60, device=cuda)
    g = torch.ones(1, 60, device=cuda)
    with pytest.raises(RuntimeError, match="groups 7 must divide channels 60"):
        ext.group_norm_fwd(x, g, g, 7, 1e-6)
    q = torch.zeros(1, 1, 8, 2, 24, device=cuda)
    with pytest.raises(RuntimeError, match="got 24"):
        ext.flash_fwd(q, q, q, True)


def test_group_norm_under_vmap_grad_launches_once(cuda):
    """vmap(grad) over 4 clients: one forward and one backward launch, and
    the same gradients as the plain twin per client."""
    from torch.func import grad, vmap

    from fedml_tpu_torch.ops import group_norm as gn

    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(4, 6, 8, 8, 64, generator=g, device=cuda)
    gamma = torch.rand(4, 64, generator=g, device=cuda) + 0.5
    beta = torch.randn(4, 64, generator=g, device=cuda)

    def loss(fn):
        return lambda x, g_, b_: torch.sin(fn(x, g_, b_, 32)).sum()

    f0, b0 = gn.group_norm_fwd.launches, gn.group_norm_bwd.launches
    got = vmap(grad(loss(gn.group_norm), argnums=(0, 1, 2)))(x, gamma, beta)
    assert (gn.group_norm_fwd.launches - f0,
            gn.group_norm_bwd.launches - b0) == (1, 1)
    want = vmap(grad(loss(gn.group_norm_plain), argnums=(0, 1, 2)))(
        x, gamma, beta)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_group_norm_copies_and_counts_a_strided_channel_dim(cuda):
    from fedml_tpu_torch.ops import group_norm as gn

    x = torch.zeros(1, 2, 4, 32, device=cuda).transpose(2, 3)  # C stride 4
    copies = gn.group_norm.copies
    gn.group_norm_fwd(x, torch.ones(1, 4, device=cuda),
                      torch.zeros(1, 4, device=cuda), 2)
    assert gn.group_norm.copies == copies + 1


def test_fedavg_round_on_the_card_matches_a_client_loop(cuda, monkeypatch):
    """A small ResNet-20-GN round on the card: every local step of the
    3-client cohort launches each GroupNorm kernel once per layer (21
    layers), no channel-dim copies, and the vmapped round equals a loop of
    per-client ``local_train`` within 1e-4 (f32, cuDNN without TF32, other
    conv kernels for the grouped convs; lr 5e-3 keeps the small model's
    amplification of rounding under the bound)."""
    import numpy as np

    from fedml_tpu_torch.core import keys
    from fedml_tpu_torch.core.tree import tree_weighted_mean
    from fedml_tpu_torch.data import (build_federated_arrays,
                                      gather_clients,
                                      make_image_classification,
                                      partition_homo)
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.ops import group_norm as gn
    from fedml_tpu_torch.parallel.shard import client_rngs, make_vmap_round
    from fedml_tpu_torch.trainer.local import (make_client_optimizer,
                                               make_local_train_fn,
                                               model_fns)

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    x, y = make_image_classification(48, (16, 16, 3), 4, seed=0)
    fed = build_federated_arrays(x, y, partition_homo(48, 4), 4,
                                 device=cuda)
    sub = gather_clients(fed, np.arange(3))
    model = create_model("resnet20", widths=(4, 8, 16), num_classes=4,
                         device=cuda,
                         generator=torch.Generator().manual_seed(0))
    fns = model_fns(model)
    net = fns.init()
    lt = make_local_train_fn(fns.apply, make_client_optimizer("sgd", 5e-3),
                             1)
    w = sub.counts.float()
    rng = keys.key(1, cuda)
    f0, b0, c0 = (gn.group_norm_fwd.launches, gn.group_norm_bwd.launches,
                  gn.group_norm.copies)
    avg, loss = make_vmap_round(lt)(net, sub.x, sub.y, sub.mask, w, w, rng)
    steps = sub.x.shape[1]
    assert (gn.group_norm_fwd.launches - f0,
            gn.group_norm_bwd.launches - b0) == (21 * steps, 21 * steps)
    assert gn.group_norm.copies == c0
    rngs = client_rngs(rng, 3)
    outs = [lt(net, sub.x[i], sub.y[i], sub.mask[i], rngs[i])
            for i in range(3)]
    want = tree_weighted_mean(
        {k: torch.stack([o.params[k] for o, _ in outs]) for k in net.params},
        w)
    assert torch.isfinite(loss)
    for k in want:
        torch.testing.assert_close(avg.params[k], want[k], rtol=1e-4,
                                   atol=1e-4)


# --- the captured round tiers (core/graph.py) ----------------------------------

def _small_fedavg(cuda, cls=None, per_round=3, sizes=None, **cfg_kw):
    """ResNet-20-GN at widths (4, 8, 16), 4 clients x 12 images of 16x16
    (or ``sizes[i]`` images for client i), batch 4 (3 local steps), sgd lr
    5e-3; ``cfg_kw`` further FedConfig fields and the class's own
    constructor arguments."""
    import numpy as np

    from fedml_tpu_torch.algos import FedAvgAPI, FedConfig
    from fedml_tpu_torch.data import (build_federated_arrays,
                                      make_image_classification,
                                      partition_homo)
    from fedml_tpu_torch.models import create_model

    n = 48 if sizes is None else sum(sizes)
    x, y = make_image_classification(n, (16, 16, 3), 4, seed=0)
    if sizes is None:
        parts = partition_homo(48, 4)
    else:
        edges = np.cumsum([0, *sizes])
        parts = {i: np.arange(edges[i], edges[i + 1])
                 for i in range(len(sizes))}
    fed = build_federated_arrays(x, y, parts, 4, device=cuda)
    api_kw = {k: cfg_kw.pop(k) for k in list(cfg_kw)
              if k not in FedConfig.__dataclass_fields__}
    cfg = FedConfig(client_num_in_total=len(parts),
                    client_num_per_round=per_round, epochs=1, batch_size=4,
                    lr=5e-3, **cfg_kw)
    model = create_model("resnet20", widths=(4, 8, 16), num_classes=4,
                         device=cuda,
                         generator=torch.Generator().manual_seed(0))
    return (cls or FedAvgAPI)(model, fed, None, cfg, device=cuda, **api_kw)


def _small_fedadapter(cuda):
    """transformer_lm d_model 64, 2 heads (D 32), 2 layers, T 128, bf16,
    flash, LoRA rank 4 on attention; 4 clients x 4 sequences, batch 2,
    3 clients per round."""
    from functools import partial

    import numpy as np

    from fedml_tpu_torch.algos import FedAdapterAPI, FedConfig
    from fedml_tpu_torch.data import build_federated_arrays, partition_homo
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.trainer.local import seq_softmax_ce

    rng = np.random.RandomState(0)
    seqs = rng.randint(1, 64, size=(16, 129))
    fed = build_federated_arrays(seqs[:, :128].astype(np.int32),
                                 seqs[:, 1:].astype(np.int32),
                                 partition_homo(16, 4), 2, device=cuda)
    model = create_model("transformer_lm", vocab_size=64, d_model=64,
                         n_heads=2, n_layers=2, max_len=128, dtype="bf16",
                         attn="flash", adapter_rank=4, adapter_scope="attn",
                         device=cuda,
                         generator=torch.Generator().manual_seed(0))
    cfg = FedConfig(client_num_in_total=4, client_num_per_round=3,
                    epochs=1, batch_size=2, lr=0.1, adapter_rank=4)
    return FedAdapterAPI(model, fed, None, cfg,
                         loss_fn=partial(seq_softmax_ce, pad_id=0),
                         device=cuda)


def _copy(net):
    from fedml_tpu_torch.core.tree import tree_map
    from fedml_tpu_torch.trainer.local import NetState

    return NetState(tree_map(torch.clone, net.params),
                    tree_map(torch.clone, net.model_state))


def _vec(net):
    from fedml_tpu_torch.core.tree import tree_leaves

    return torch.cat([t.float().flatten() for t in tree_leaves(net.params)])


def _eager(api, r):
    avg, loss = api.run_round(r)
    api.net = api._server_update(api.net, avg)
    return loss.item()


@pytest.mark.parametrize("make", ["fedavg", "fedadapter"])
def test_captured_round_matches_the_eager_round(cuda, monkeypatch, make):
    """From one start, key and cohort: the captured fused round
    (``train_one_round``, one capture) is bit-equal to the eager round
    (``run_round`` + ``_server_update``), params and loss, and two eager
    rounds are bit-equal to each other. cuDNN runs in deterministic mode:
    otherwise the small f32 ResNet's backward differs by an ulp between
    two eager rounds now and then (its convolution algorithms add with
    atomics), which a spread measured on two rounds can miss. FedAdapter's
    base stays bitwise unchanged."""
    from fedml_tpu_torch.core.graph import CapturedStep

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    api = (_small_fedavg if make == "fedavg" else _small_fedadapter)(cuda)
    base0 = {k: v.clone() for k, v in api.model.state_dict().items()}
    start, key = _copy(api.net), api.rng.clone()
    eager = []
    for _ in range(2):
        api.net, api.rng = _copy(start), key.clone()
        eager.append((_eager(api, 1), _vec(api.net)))
    api.net, api.rng = _copy(start), key.clone()
    captures = CapturedStep.captures
    loss = api.train_one_round(1)["train_loss"]
    assert CapturedStep.captures == captures + 1
    assert eager[0][0] == eager[1][0] and torch.equal(eager[0][1],
                                                      eager[1][1])
    assert loss == eager[0][0] and torch.equal(_vec(api.net), eager[0][1])
    assert torch.isfinite(_vec(api.net)).all()
    if make == "fedadapter":
        after = api.base.state_dict()
        assert all(torch.equal(v, after[k]) for k, v in base0.items())


def test_replays_count_the_kernel_launches(cuda):
    """A replay adds to each wrapper's counters what the captured call
    added: per fused round, 21 GroupNorm forward, backward and reduce
    launches per local step (ResNet-20) with no copy; per on-device round
    the same; FedAdapter: one launch of each flash kernel per layer and
    step for the whole cohort, no copy. The warm-up before a capture runs
    the step once for real and counts; the capture itself does not."""
    import importlib

    from fedml_tpu_torch.core.graph import CapturedStep
    from fedml_tpu_torch.ops import group_norm as gn

    fa = importlib.import_module("fedml_tpu_torch.ops.flash_attention")

    def gn_counts():
        return (gn.group_norm_fwd.launches, gn.group_norm_bwd.launches,
                gn.group_norm_bwd.reduce_launches, gn.group_norm.copies,
                gn.group_norm_fwd.streamed)

    def flash_counts():
        return (fa.flash_attention.launches,
                fa.flash_attention_bwd.dq_launches,
                fa.flash_attention_bwd.dkv_launches,
                fa.flash_attention.copies)

    for api, counts, per_step in (
            (_small_fedavg(cuda), gn_counts, (21, 21, 21, 0, 0)),
            (_small_fedadapter(cuda), flash_counts, (2, 2, 2, 0))):
        steps = api.train_fed.steps_per_epoch
        per_round = tuple(n * steps for n in per_step)
        for tier in (lambda r: api.train_one_round(r),
                     lambda r: api.train_rounds_on_device(1)):
            c0, captures = counts(), CapturedStep.captures
            tier(0)  # warm-up (counts once), capture (does not), replay
            assert CapturedStep.captures == captures + 1
            assert tuple(b - a for a, b in zip(c0, counts())) == tuple(
                2 * n for n in per_round)
            c1, replays = counts(), CapturedStep.replays
            for r in range(1, 4):
                tier(r)
            torch.cuda.synchronize()
            assert CapturedStep.replays == replays + 3
            assert CapturedStep.captures == captures + 1
            assert tuple(b - a for a, b in zip(c1, counts())) == tuple(
                3 * n for n in per_round)


def test_a_replaced_net_is_copied_in_and_a_replaced_dataset_recaptured(
        cuda, monkeypatch):
    """The fused round's carry is donated: after a replay ``api.net`` is
    the graph's static buffers. A replaced ``api.net`` is copied into them
    (the same start and key give the same round, without a new capture);
    a replaced ``api.train_fed`` is captured anew. cuDNN in deterministic
    mode, as above."""
    from fedml_tpu_torch.core.graph import CapturedStep
    from fedml_tpu_torch.data import FederatedArrays

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    api = _small_fedavg(cuda)
    api.train_one_round(0)
    start, key = _copy(api.net), api.rng.clone()
    runs = []
    for _ in range(2):
        api.net, api.rng = _copy(start), key.clone()
        captures = CapturedStep.captures
        runs.append((api.train_one_round(1)["train_loss"], _vec(api.net)))
        assert CapturedStep.captures == captures
    assert runs[0][0] == runs[1][0] and torch.equal(runs[0][1], runs[1][1])
    f = api.train_fed
    api.train_fed = FederatedArrays(f.x.clone(), f.y.clone(),
                                    f.mask.clone(), f.counts.clone())
    api.net, api.rng = _copy(start), key.clone()
    captures = CapturedStep.captures
    loss = api.train_one_round(1)["train_loss"]
    assert CapturedStep.captures == captures + 1
    assert loss == runs[0][0] and torch.equal(_vec(api.net), runs[0][1])


def test_a_capture_failure_raises_instead_of_running_eagerly(cuda):
    """A host sync planted inside the step: the capture fails and raises
    ``GraphCaptureError`` on every call, the round is never taken eagerly
    (``api.net`` untouched, no replay), and the counters keep only the
    warm-up's launches."""
    from fedml_tpu_torch.algos import FedAvgAPI
    from fedml_tpu_torch.core.graph import CapturedStep, GraphCaptureError
    from fedml_tpu_torch.ops import group_norm as gn

    class _Syncing(FedAvgAPI):
        def _build_fused_step(self):
            step = super()._build_fused_step()

            def synced(*args):
                carry, loss = step(*args)
                float(loss)  # a host sync inside the captured step
                return carry, loss

            return synced

    api = _small_fedavg(cuda, cls=_Syncing)
    net0 = _copy(api.net)
    steps = api.train_fed.steps_per_epoch
    for _ in range(2):
        fwd, replays = gn.group_norm_fwd.launches, CapturedStep.replays
        with pytest.raises(GraphCaptureError, match="does not run eagerly"):
            api.train_one_round(0)
        assert gn.group_norm_fwd.launches == fwd + 21 * steps  # warm-up
        assert CapturedStep.replays == replays
        assert torch.equal(_vec(api.net), _vec(net0))
    torch.cuda.synchronize()
    assert torch.isfinite(torch.ones(4, device=cuda).sum())


# --- the algorithms on the captured round -------------------------------------

def _assert_same_state(a, b):
    assert torch.equal(_vec(a.net), _vec(b.net))


def test_captured_fedadam_rounds_keep_advancing_the_bias_correction(
        cuda, monkeypatch):
    """FedAdam's server step count is a device tensor in the captured
    step's carry: 3 fused rounds (one capture, 3 replays) are bit-equal to
    3 eager rounds, params, losses and Adam's moments, with the count at 3
    (a Python int would freeze the bias correction at round 1 while the
    replays stayed equal to each other); the on-device round at full
    participation likewise, the count advancing by 3 per call."""
    from fedml_tpu_torch.algos import FedOptAPI
    from fedml_tpu_torch.core.graph import CapturedStep

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    kw = dict(server_optimizer="adam", server_lr=0.05)
    for per_round in (3, 4):
        host = _small_fedavg(cuda, FedOptAPI, per_round=per_round, **kw)
        want = [_eager(host, r) for r in range(3)]
        api = _small_fedavg(cuda, FedOptAPI, per_round=per_round, **kw)
        captures, replays = CapturedStep.captures, CapturedStep.replays
        if per_round == 3:
            got = [api.train_one_round(r)["train_loss"] for r in range(3)]
            assert CapturedStep.replays == replays + 3
        else:  # full participation: the host loop's cohorts
            got = api.train_rounds_on_device(3).tolist()
            assert CapturedStep.replays == replays + 3
        assert CapturedStep.captures == captures + 1
        assert got == want
        _assert_same_state(api, host)
        st, hst = api.server_opt_state["0"], host.server_opt_state["0"]
        assert int(st["count"]) == int(hst["count"]) == 3
        for k in ("mu", "nu"):
            for name in st[k]:
                assert torch.equal(st[k][name], hst[k][name])
    api.train_rounds_on_device(3)
    assert int(api.server_opt_state["0"]["count"]) == 6


@pytest.mark.parametrize("spec", ["coord_median", "trimmed_mean0.2", "krum1",
                                  "geometric_median8"])
def test_captured_robust_aggregator_equals_its_eager_round(cuda, monkeypatch,
                                                           spec):
    """FedAvgRobustAPI with the norm clip, the scale drill on one adversary
    in every round and each robust aggregator: 2 captured fused rounds
    bit-equal to 2 eager rounds; the aggregator's device-side indices need
    no host sync, so the round captures."""
    from fedml_tpu_torch.algos import FedAvgRobustAPI

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    kw = dict(aggregator=spec, robust_norm_bound=0.5, corrupt_mode="scale",
              attack_freq=1)
    host = _small_fedavg(cuda, FedAvgRobustAPI, **kw)
    want = [_eager(host, r) for r in range(2)]
    api = _small_fedavg(cuda, FedAvgRobustAPI, **kw)
    assert [api.train_one_round(r)["train_loss"] for r in range(2)] == want
    _assert_same_state(api, host)
    assert 3 in api.sample_round(1).tolist()


def test_captured_fednova_rounds_follow_changing_operands(cuda, monkeypatch):
    """FedNova on clients of 6, 10, 14 and 18 images (2 to 5 local steps):
    the cohorts' (q, γ) change from round to round and are copied into the
    captured step at each replay, so 3 fused rounds are bit-equal to 3
    eager rounds (a baked-in q would replay round 0's weights)."""
    from fedml_tpu_torch.algos import FedNovaAPI

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    sizes = (6, 10, 14, 18)
    host = _small_fedavg(cuda, FedNovaAPI, sizes=sizes)
    gammas = [float(host._round_aux(r, host.sample_round(r))[1])
              for r in range(3)]
    assert gammas[0] != gammas[1] != gammas[2]
    want = [_eager(host, r) for r in range(3)]
    api = _small_fedavg(cuda, FedNovaAPI, sizes=sizes)
    assert [api.train_one_round(r)["train_loss"] for r in range(3)] == want
    _assert_same_state(api, host)


# --- the "custom" carry protocol on the captured round -----------------------

def _custom_leaves(api):
    """The carry (a tree: dicts, tuples, Ditto's ``NetState`` of personal
    params and states) as one f32 vector."""
    from fedml_tpu_torch.core.graph import _leaves

    return torch.cat([t.float().flatten()
                      for t in _leaves(api._window_carry_init())])


def _eager_custom(api, r):
    """The eager reference of a "custom" round: the published step through
    the same cohort gather, uncaptured."""
    return api._train_round_fused(r, api._gather_step()).item()


@pytest.mark.parametrize("name", ["ScaffoldAPI", "FedDynAPI", "DittoAPI",
                                  "FedBNAPI"])
def test_captured_custom_rounds_equal_the_eager_step(cuda, monkeypatch,
                                                     name):
    """Each "custom" class on the small ResNet: 3 captured fused rounds
    (one capture, 2 replays) bit-equal to 3 eager calls of its published
    step, params, losses and the carried client stacks; the carry keeps
    advancing across replays (each round's stack differs from the last);
    ``train_rounds_pipelined(3)`` equals them too."""
    import fedml_tpu_torch.algos as algos
    from fedml_tpu_torch.core.graph import CapturedStep

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cls = getattr(algos, name)
    host = _small_fedavg(cuda, cls)
    want, host_carry = [], []
    for r in range(3):
        want.append(_eager_custom(host, r))
        host_carry.append(_custom_leaves(host).clone())
    api = _small_fedavg(cuda, cls)
    captures, replays = CapturedStep.captures, CapturedStep.replays
    got = []
    for r in range(3):
        got.append(api.train_one_round(r)["train_loss"])
        assert torch.equal(_custom_leaves(api), host_carry[r])
    assert CapturedStep.captures == captures + 1
    assert CapturedStep.replays == replays + 3
    assert got == want
    _assert_same_state(api, host)
    assert not torch.equal(host_carry[1], host_carry[2])
    pipe = _small_fedavg(cuda, cls)
    assert pipe.train_rounds_pipelined(3) == want
    _assert_same_state(pipe, host)
    assert torch.equal(_custom_leaves(pipe), host_carry[2])


def test_captured_scatter_drops_masked_slots(cuda):
    """``scatter_stacked`` inside a captured step, replayed with changing
    cohorts: a masked slot (a padded duplicate of ``idx[0]``) never
    writes, and a row outside the cohort keeps its bits across replays."""
    from fedml_tpu_torch.core.graph import CapturedStep
    from fedml_tpu_torch.core.tree import (client_rows, client_stack,
                                           scatter_stacked)

    def step(stack, idx, values, umask):
        return scatter_stacked(stack, idx, values, umask), idx.sum()

    stack = client_stack({"w": torch.zeros(3, device=cuda)}, 6)
    cap = CapturedStep(step, cuda, lambda: [])
    for r, (idx, umask) in enumerate([([2, 0, 4, 2], [1, 1, 1, 0]),
                                      ([5, 1, 3, 5], [1, 1, 0, 0])]):
        before = client_rows(stack)["w"].clone()
        vals = {"w": torch.arange(12, dtype=torch.float32, device=cuda)
                .reshape(4, 3) + 100 * (r + 1)}
        stack, _ = cap(stack, torch.tensor(idx, device=cuda),
                       vals, torch.tensor(umask, dtype=torch.float32,
                                          device=cuda))
        rows = client_rows(stack)["w"]
        for slot, (i, m) in enumerate(zip(idx, umask)):
            if m:
                assert torch.equal(rows[i], vals["w"][slot])
        written = {i for i, m in zip(idx, umask) if m}
        for i in set(range(6)) - written:
            assert torch.equal(rows[i], before[i]), (r, i)
    assert CapturedStep.captures >= 1


def test_ditto_replays_count_two_trainings_of_group_norm(cuda):
    """Ditto trains the cohort twice a round (global, then personal): a
    replayed round adds 2 x 21 GroupNorm forward, backward and reduce
    launches per local step, none copied or streamed."""
    from fedml_tpu_torch.algos import DittoAPI
    from fedml_tpu_torch.ops import group_norm as gn

    api = _small_fedavg(cuda, DittoAPI)
    steps = api.train_fed.steps_per_epoch
    api.train_one_round(0)  # warm-up and capture

    def counts():
        return (gn.group_norm_fwd.launches, gn.group_norm_bwd.launches,
                gn.group_norm_bwd.reduce_launches, gn.group_norm.copies,
                gn.group_norm_fwd.streamed)

    c0 = counts()
    for r in range(1, 3):
        api.train_one_round(r)
    torch.cuda.synchronize()
    want = 2 * 2 * 21 * steps
    assert tuple(b - a for a, b in zip(c0, counts())) == (want, want, want,
                                                           0, 0)


def test_a_dropped_graph_is_not_freed_during_another_capture(cuda):
    """The cyclic collector is paused while a step is captured (its
    warm-up runs with it on) and on again after: an api dropped with its
    graph is garbage in reference cycles, and freeing that graph during
    another capture would invalidate it. A new api captures after an old
    one was dropped, with the collector running at every allocation."""
    import gc

    from fedml_tpu_torch.algos import DittoAPI, ScaffoldAPI
    from fedml_tpu_torch.core.graph import CapturedStep

    seen = []

    def step(carry, x):
        seen.append(gc.isenabled())
        return carry * 2, x + 1

    cap = CapturedStep(step, cuda, lambda: [])
    carry, _ = cap(torch.ones(4, device=cuda), torch.zeros(4, device=cuda))
    assert seen == [True, False] and gc.isenabled()
    assert carry.tolist() == [2.0] * 4
    thresholds = gc.get_threshold()
    try:
        old = _small_fedavg(cuda, ScaffoldAPI)
        old.train_one_round(0)
        del old
        gc.set_threshold(1, 1, 1)
        api = _small_fedavg(cuda, DittoAPI)
        loss = api.train_one_round(0)["train_loss"]
    finally:
        gc.set_threshold(*thresholds)
    assert loss == loss and gc.isenabled()


# --- the rest of the FedAvg-round family on the captured round ---------------

@pytest.mark.parametrize("name,kw", [("FedAcAPI", dict(gamma=2.0)),
                                     ("ServerAvgAPI", dict(avg_coef=0.5)),
                                     ("QFedAvgAPI", dict(q=1.0))])
def test_captured_zoo_rounds_equal_the_eager_rounds(cuda, monkeypatch, name,
                                                    kw):
    """FedAc, ServerAvg and q-FedAvg on the small ResNet: 3 captured fused
    rounds (one capture) bit-equal to 3 eager ``run_round`` +
    ``_server_update``, params, losses and the carry (FedAc's sequences,
    ServerAvg's running mean and counters); at full participation
    ``train_rounds_on_device(3)`` likewise. q-FedAvg's round runs the
    GroupNorm forward twice as often as the backward (F_global's
    forward-only pass)."""
    import fedml_tpu_torch.algos as algos
    from fedml_tpu_torch.core.graph import CapturedStep, _leaves
    from fedml_tpu_torch.ops import group_norm as gn

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cls = getattr(algos, name)

    def carry(api):
        return [t.clone() for t in _leaves(api._window_carry_init())]

    for per_round in (3, 4):
        host = _small_fedavg(cuda, cls, per_round=per_round, **kw)
        want = [_eager(host, r) for r in range(3)]
        api = _small_fedavg(cuda, cls, per_round=per_round, **kw)
        captures = CapturedStep.captures
        if per_round == 3:
            got = [api.train_one_round(r)["train_loss"] for r in range(3)]
        else:
            fwd, bwd = gn.group_norm_fwd.launches, gn.group_norm_bwd.launches
            got = api.train_rounds_on_device(3).tolist()
            fwd = gn.group_norm_fwd.launches - fwd
            bwd = gn.group_norm_bwd.launches - bwd
            assert fwd == (2 if name == "QFedAvgAPI" else 1) * bwd > 0
        assert CapturedStep.captures == captures + 1
        assert got == want
        _assert_same_state(api, host)
        assert all(torch.equal(a, b) for a, b in zip(carry(api),
                                                     carry(host)))


def test_captured_hierarchical_groups_equal_eager_groups(cuda, monkeypatch):
    """Hierarchical FL over groups of 1 and 2 sampled clients (padded to
    1 and 2), 2 inner rounds each: 2 rounds through the captured group
    steps (one capture per padded size) bit-equal to the same rounds with
    each group's step run uncaptured."""
    import numpy as np

    from fedml_tpu_torch.algos import HierarchicalFedAvgAPI
    from fedml_tpu_torch.core.graph import CapturedStep

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    kw = dict(group_ids=np.array([0, 1, 0, 1]), group_comm_round=2)
    host = _small_fedavg(cuda, HierarchicalFedAvgAPI, **kw)
    host._group_step = lambda size: host._group_round()
    want = [host.train_one_round(r)["train_loss"] for r in range(2)]
    api = _small_fedavg(cuda, HierarchicalFedAvgAPI, **kw)
    captures = CapturedStep.captures
    got = [api.train_one_round(r)["train_loss"] for r in range(2)]
    assert got == want
    _assert_same_state(api, host)
    assert CapturedStep.captures - captures == len(api._graphs) == 2


def test_turboaggregate_device_stack_equals_the_cpu_host_input(cuda,
                                                                monkeypatch):
    """TurboAggregate's captured cohort training on the card hands the
    MPC the same client stack as the uncaptured step (bit-equal), and the
    round's new model is the host MPC of that stack, as on the CPU."""
    import numpy as np

    from fedml_tpu_torch.algos import TurboAggregateAPI

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    stacks = {}

    def recording(api, tag):
        train = api._train_clients

        def record(idx, key):
            params, losses = train(idx, key)
            stacks[tag] = ({k: v.cpu().clone() for k, v in params.items()},
                           losses.cpu().clone())
            return params, losses

        api._train_clients = record

    host = _small_fedavg(cuda, TurboAggregateAPI, n_groups=3)
    host._local_batch = host._cohort_training
    recording(host, "eager")
    api = _small_fedavg(cuda, TurboAggregateAPI, n_groups=3)
    recording(api, "captured")
    assert host.train_one_round(0) == api.train_one_round(0)
    (a, la), (b, lb) = stacks["eager"], stacks["captured"]
    assert torch.equal(la, lb)
    assert all(torch.equal(a[k], b[k]) for k in a)
    _assert_same_state(api, host)
    w = api.train_fed.counts.cpu().numpy()[api.sample_round(0)]
    w = w / w.sum()
    for k, p in b.items():
        mean = np.tensordot(w, p.numpy().astype(np.float64), axes=1)
        err = np.abs(api.net.params[k].cpu().numpy() - mean)
        assert (err <= len(w) * 0.5 / 2 ** 16 + np.abs(mean) * 2.0 ** -23
                ).all()


@pytest.mark.parametrize("mode", ["dsgd", "pushsum"])
def test_captured_gossip_rounds_equal_the_eager_rounds(cuda, monkeypatch,
                                                       mode):
    """DSGD and PushSum over 4 clients of the small ResNet: 2 captured
    rounds bit-equal to 2 uncaptured gossip steps, then
    ``train_rounds_on_device(2)`` and ``train_rounds_pipelined(2)`` from
    one start bit-equal to the host loop; the push weights sum to n."""
    from fedml_tpu_torch.algos import DecentralizedAPI, FedConfig
    from fedml_tpu_torch.core.topology import (AsymmetricTopologyManager,
                                               SymmetricTopologyManager)
    from fedml_tpu_torch.core.tree import tree_map
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.trainer.local import NetState

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    fed = _small_fedavg(cuda).train_fed

    def build():
        topo = (SymmetricTopologyManager(4, neighbor_num=3, seed=0)
                if mode == "dsgd" else
                AsymmetricTopologyManager(4, neighbor_num=2, seed=0))
        model = create_model("resnet20", widths=(4, 8, 16), num_classes=4,
                             device=cuda,
                             generator=torch.Generator().manual_seed(0))
        cfg = FedConfig(client_num_in_total=4, client_num_per_round=4,
                        epochs=1, batch_size=4, lr=5e-3)
        return DecentralizedAPI(model, fed, None, cfg, topo, mode=mode,
                                device=cuda)

    def state(api):
        return (torch.cat([p.flatten() for p in api.nets.params.values()]),
                api.push_weights.clone(), api.rng.clone())

    host = build()
    host._round_step = host._gossip_step
    want = [host.train_one_round(r)["train_loss"] for r in range(2)]
    mid = state(host)
    want += [host.train_one_round(r)["train_loss"] for r in range(2, 4)]
    api = build()
    got = [api.train_one_round(r)["train_loss"] for r in range(2)]
    assert got == want[:2]
    assert all(torch.equal(a, b) for a, b in zip(state(api), mid))
    start = (NetState(tree_map(torch.clone, api.nets.params), {}),
             api.push_weights.clone(), api.rng.clone())
    assert api.train_rounds_on_device(2).tolist() == want[2:]
    assert all(torch.equal(a, b) for a, b in zip(state(api), state(host)))
    api.nets, api.push_weights, api.rng = start
    assert api.train_rounds_pipelined(2) == want[2:]
    assert all(torch.equal(a, b) for a, b in zip(state(api), state(host)))
    assert float(api.push_weights.sum()) == pytest.approx(4.0, abs=1e-5)


def _small_split(cuda, cls):
    """FedGKT (resnet5_56 + resnet20_server) or SplitNN
    (resnet_split_bottom + resnet20_server) over 4 clients x 12 images of
    16x16, batch 4 (3 steps), f32."""
    from fedml_tpu_torch.algos import FedConfig, FedGKTAPI
    from fedml_tpu_torch.data import (build_federated_arrays,
                                      make_image_classification,
                                      partition_homo)
    from fedml_tpu_torch.models import create_model

    x, y = make_image_classification(48, (16, 16, 3), 4, seed=0)
    fed = build_federated_arrays(x, y, partition_homo(48, 4), 4, device=cuda)
    cfg = FedConfig(client_num_in_total=4, client_num_per_round=4, epochs=1,
                    batch_size=4, lr=5e-3)
    gen = torch.Generator().manual_seed(0)
    tail = create_model("resnet20_server", num_classes=4, device=cuda,
                        generator=gen)
    if cls is FedGKTAPI:
        return cls(create_model("resnet5_56", num_classes=4, device=cuda,
                                generator=gen), tail, fed, None, cfg,
                   device=cuda)
    return cls(create_model("resnet_split_bottom", device=cuda,
                            generator=gen), tail, fed, None, cfg, device=cuda)


def test_captured_fedgkt_steps_equal_the_eager_steps(cuda, monkeypatch):
    """FedGKT's three captured steps against the same steps uncaptured,
    from one start: the client phase (stumps, losses, features, client
    logits) with the teacher off and on, every server step of an epoch
    (tail, Adam state, the loss sums; Adam's count advancing under
    replay) and every relabel step (server logits), bit-equal under
    ``cudnn.deterministic``; ``have_teacher`` is an argument, not baked
    into the graph; the GroupNorm launches of a round counted under
    replay."""
    from fedml_tpu_torch.algos import FedGKTAPI
    from fedml_tpu_torch.core import keys
    from fedml_tpu_torch.core.graph import CapturedStep, _leaves, _map
    from fedml_tpu_torch.ops import group_norm as gn
    from fedml_tpu_torch.trainer.local import NetState

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    api = _small_split(cuda, FedGKTAPI)
    clone = lambda tree: _map(torch.clone, tree)  # noqa: E731

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))

    start = clone(api.client_nets)
    key = keys.fold_in(api.rng, 1)
    phase = api._build_client_phase()
    for flag in (0, 1):
        want = phase(clone(start), api._flags[flag], key)
        want_out = (api.feats.clone(), api.client_logits.clone())
        api.client_nets = clone(start)
        api.have_teacher = bool(flag)
        got = api._run_client_phase(key)
        assert same((api.client_nets, got), want)
        assert same((api.feats, api.client_logits), want_out)
        if flag == 0:
            loss_without = got.clone()
        else:
            assert not torch.equal(got, loss_without)
    assert api._graphs["client"] is not None
    cs = api.n_clients * api.n_steps
    carry0 = (clone(api.server_net), clone(api.server_state),
              torch.zeros(2, device=cuda),
              torch.zeros((), dtype=torch.int64, device=cuda),
              keys.fold_in(api.rng, 2))
    sstep = api._build_server_step()
    want = clone(carry0)
    for _ in range(cs):
        want, _ = sstep(want)
    step = api._captured("server", api._build_server_step)
    got = clone(carry0)
    for _ in range(cs):
        got, _ = step(got)
    assert same(got, want)
    assert int(got[1]["0"]["count"]) == int(got[3]) == cs
    relabel = api._build_relabel_step()
    carry = (want[0], torch.zeros((), dtype=torch.int64, device=cuda))
    for _ in range(cs):
        carry, _ = relabel(carry)
    want_logits = api.server_logits.clone()
    api.server_logits.zero_()
    api.server_net = want[0]
    api._run_relabel()
    assert torch.equal(api.server_logits, want_logits)
    # A round under replay: the stump's 3 GroupNorms in training and the
    # sweep, the tail's 21 in training and the relabel.
    f0, b0 = gn.group_norm_fwd.launches, gn.group_norm_bwd.launches
    captures = CapturedStep.captures
    api.train_one_round(0)
    assert CapturedStep.captures == captures
    assert gn.group_norm_fwd.launches - f0 == 2 * 3 * 3 + 2 * cs * 21
    assert gn.group_norm_bwd.launches - b0 == 3 * 3 + cs * 21


def test_captured_split_nn_segments_equal_the_eager_segments(cuda,
                                                             monkeypatch):
    """SplitNN's captured segment, replayed for clients 0, 2 and 1 in turn
    from one start, bit-equal to the uncaptured segment under
    ``cudnn.deterministic``: each client's row of the stacks, the top and
    its momentum, the loss sum; the rows of clients not yet trained (and
    the dustbin) untouched; a whole cycle through ``train_one_epoch``
    bit-equal to the uncaptured segments in ring order."""
    from fedml_tpu_torch.algos import SplitNNAPI
    from fedml_tpu_torch.core import keys
    from fedml_tpu_torch.core.graph import CapturedStep, _leaves, _map

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    api = _small_split(cuda, SplitNNAPI)
    clone = lambda tree: _map(torch.clone, tree)  # noqa: E731

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))

    start = (clone(api.client_nets), clone(api.client_opts),
             clone(api.server_net), clone(api.server_opt),
             torch.zeros((), device=cuda))
    ks = keys.split(keys.fold_in(api.rng, 3), 4)
    seg = api._build_segment()
    want, got = clone(start), clone(start)
    step = api._segment_step()
    for c in (0, 2, 1):
        want, _ = seg(want, api._ids[c], ks[c])
        got, _ = step(got, api._ids[c], ks[c])
        assert same(got, want)
        for k, v in got[0].params.items():
            assert torch.equal(v[3:], start[0].params[k][3:])
    pair = keys.split(api.rng)
    ring = keys.split(pair[1], 4)
    want = (clone(api.client_nets), clone(api.client_opts),
            clone(api.server_net), clone(api.server_opt),
            torch.zeros((), device=cuda))
    for c in range(4):
        want, _ = seg(want, api._ids[c], ring[c])
    captures = CapturedStep.captures
    loss = api.train_one_epoch(0)["train_loss"]
    assert CapturedStep.captures == captures
    assert same((api.client_nets, api.client_opts,
                 api.server_net, api.server_opt), want[:4])
    assert loss == float(want[4] / 4)



# --- GroupNorm's streamed route and second derivative; the simulator zoo ---

# Samples past a cluster of 8 blocks, which take the streamed route (shape
# [N, S, C], groups, rows of γ/β, dtype, interleaved): FedSeg's UNet at
# 256 x 256, levels 0 and 1, in f32; a bf16 sample; the level-0 shape with
# 8 clients' rows interleaved; S 20001 and 30001, which the cluster's
# granules of rows do not divide (30001 all resident); a 102 MB sample,
# which the backward once refused; one sample alone (R·M = 1, every block of
# the cluster on it); 17 channels (vectors of 1) and a client-interleaved
# view of 18 (vectors of 2); 4096 channels, of which a block holds 4 rows.
GN_STREAMED_CASES = [
    ((16, 65536, 16), 16, 1, torch.float32, False),
    ((16, 16384, 32), 32, 1, torch.float32, False),
    ((4, 65536, 32), 32, 1, torch.bfloat16, False),
    ((64, 65536, 16), 16, 8, torch.float32, True),
    ((3, 20001, 64), 32, 1, torch.float32, False),
    ((1, 400_000, 64), 32, 1, torch.float32, False),
    ((1, 65536, 16), 16, 1, torch.float32, False),
    ((2, 30001, 16), 16, 1, torch.float32, False),
    ((2, 32768, 17), 17, 1, torch.float32, False),
    ((4, 32768, 18), 6, 2, torch.float32, True),
    ((2, 128, 4096), 32, 1, torch.float32, False),
]


@pytest.mark.parametrize("shape,groups,rows,dtype,interleaved",
                         GN_STREAMED_CASES)
def test_group_norm_streamed_backward_matches_plain_twin(
        cuda, shape, groups, rows, dtype, interleaved):
    """The backward's streamed route at GN_STREAMED_CASES against the f32
    twin: dx within one bf16 rounding or 1e-5, dγ/dβ within the sum-order
    bound; counted once a launch as streamed; reruns bit-equal."""
    from fedml_tpu_torch.ops import group_norm as gn

    g = torch.Generator(device=cuda).manual_seed(5)
    x, dy, gamma, _ = _gn_inputs(shape, rows, dtype, g, cuda, interleaved)
    b0, s0 = gn.group_norm_bwd.launches, gn.group_norm_bwd.streamed
    got = gn.group_norm_bwd(x, dy, gamma, groups)
    again = gn.group_norm_bwd(x, dy, gamma, groups)
    torch.cuda.synchronize()
    assert (gn.group_norm_bwd.launches - b0,
            gn.group_norm_bwd.streamed - s0) == (2, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    dx, dgamma, dbeta = got
    want_dx, want_dg, want_db = gn.group_norm_bwd_plain(
        x.float(), dy.float(), gamma, groups)
    if dtype == torch.bfloat16:
        ok, err = _within_bf16_ulp(dx, want_dx)
        assert ok, err
    else:
        torch.testing.assert_close(dx, want_dx, rtol=1e-5, atol=1e-5)
    r, m, s, c = x.shape
    chain = s + m + 64
    mu, rstd = gn._stats(x.float(), groups, gn.EPS)
    d32 = dy.float()
    assert bool(((dgamma - want_dg).abs() <= _sum_order_bound(
        d32 * (x.float() - mu) * rstd, chain)).all())
    assert bool(((dbeta - want_db).abs() <= _sum_order_bound(
        d32, chain)).all())


@pytest.mark.parametrize("shape,groups,rows,dtype,interleaved",
                         GN_STREAMED_CASES)
def test_group_norm_streamed_forward_matches_plain_twin(
        cuda, shape, groups, rows, dtype, interleaved):
    """The forward's streamed route at GN_STREAMED_CASES against the f32
    twin: y within one bf16 rounding or 1e-5, in x's strides; counted once
    a launch as streamed; reruns bit-equal."""
    from fedml_tpu_torch.ops import group_norm as gn

    g = torch.Generator(device=cuda).manual_seed(6)
    x, _, gamma, beta = _gn_inputs(shape, rows, dtype, g, cuda, interleaved)
    f0, s0 = gn.group_norm_fwd.launches, gn.group_norm_fwd.streamed
    y = gn.group_norm_fwd(x, gamma, beta, groups)
    again = gn.group_norm_fwd(x, gamma, beta, groups)
    torch.cuda.synchronize()
    assert (gn.group_norm_fwd.launches - f0,
            gn.group_norm_fwd.streamed - s0) == (2, 2)
    assert torch.equal(y, again) and y.stride() == x.stride()
    want = gn.group_norm_fwd_plain(x.float(), gamma, beta, groups)
    if dtype == torch.bfloat16:
        ok, err = _within_bf16_ulp(y, want)
        assert ok, err
    else:
        torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("s,c,is_bf16", [(65536, 16, False),
                                         (16384, 32, False),
                                         (65536, 32, True), (30001, 16, False),
                                         (128, 4096, False)])
def test_group_norm_streamed_plan(cuda, s, c, is_bf16):
    """The streamed route's plan (the plan's trailing fields) for a sample
    past a cluster of 8: a cluster of 8 or 16 whose blocks own every row,
    resident rows of x then dy within a block's rows (dy only once all of
    x is resident), shared memory within the card's opt-in, and at least
    one such cluster on the card at once."""
    from fedml_tpu_torch.ops.build import extension

    props = torch.cuda.get_device_properties(cuda)
    limit = getattr(props, "shared_memory_per_block_optin", 232448)
    for tensors in (1, 2):
        plan = extension().group_norm_plan(s, c, is_bf16, tensors)
        assert len(plan) == 10 and plan[:4] == [0, 0, 0, 0]
        cl, rows, res_x, res_dy, smem, active = plan[4:]
        assert cl in (8, 16) and active >= 1
        assert rows * cl >= s and 0 <= res_x <= rows
        assert 0 <= res_dy <= rows and (res_dy == 0 or res_x == rows)
        assert res_dy == 0 or tensors == 2
        assert 0 < smem <= limit


def test_group_norm_second_derivative_through_the_kernels(cuda):
    """grad of grad through ``group_norm`` on the card (the backward kernel
    differentiated by ``_GroupNormBackward``, which launches it again)
    against ordinary autograd through the plain twin, f32: x, γ and β
    within 1e-4 of the largest."""
    from torch.func import grad

    from fedml_tpu_torch.ops import group_norm as gn

    g = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn(8, 16, 16, 32, generator=g, device=cuda) * 2 + 0.5
    t, w = (torch.randn(x.shape, generator=g, device=cuda) for _ in range(2))
    gam = torch.rand(32, generator=g, device=cuda) + 0.5
    bet = torch.randn(32, generator=g, device=cuda)

    def second(fn):
        def loss(x, g_, b_):
            return ((fn(x, g_, b_, 16) - t) ** 3).sum()

        def inner(x, g_, b_):
            gx, gg, gb = grad(loss, argnums=(0, 1, 2))(x, g_, b_)
            return (gx * w).sum() + (gg * g_).sum() + (gb * b_ * g_).sum()

        return grad(inner, argnums=(0, 1, 2))(x, gam, bet)

    b0 = gn.group_norm_bwd.launches
    got = second(gn.group_norm)
    assert gn.group_norm_bwd.launches - b0 >= 3
    for a, b in zip(got, second(gn.group_norm_plain)):
        assert ((a - b).abs().max() / b.abs().max()).item() <= 1e-4


def _small_zoo(cuda, name, per_round=3):
    """FedNAS over a small DARTS net, FedSeg over a small UNet, FedGAN over
    the MNIST GAN, on seeded data on the card."""
    import numpy as np

    from fedml_tpu_torch.algos import (FedConfig, FedGanAPI, FedNASAPI,
                                       FedSegAPI)
    from fedml_tpu_torch.data import build_federated_arrays
    from fedml_tpu_torch.models import create_model

    rng = np.random.RandomState(0)
    counts = (8, 6, 8, 4)
    edges = np.concatenate([[0], np.cumsum(counts)])
    parts = {i: np.arange(edges[i], edges[i + 1]) for i in range(4)}
    gen = torch.Generator().manual_seed(0)
    cfg = FedConfig(client_num_in_total=4, client_num_per_round=per_round,
                    comm_round=3, epochs=1, batch_size=2, lr=0.01)
    if name == "FedNASAPI":
        x = rng.randn(26, 16, 16, 3).astype(np.float32)
        y = rng.randint(0, 5, 26).astype(np.int32)
        model = create_model("darts", num_classes=5, c=4, layers=3, steps=2,
                             multiplier=2, device=cuda, generator=gen)
        return FedNASAPI(model, build_federated_arrays(
            x, y, parts, 2, device=cuda), None, cfg, device=cuda)
    if name == "FedSegAPI":
        x = rng.randn(26, 20, 20, 3).astype(np.float32)
        y = rng.randint(0, 5, (26, 20, 20)).astype(np.int32)
        y[rng.rand(*y.shape) < 0.2] = 255
        model = create_model("unet", num_classes=5, base=8, levels=2,
                             device=cuda, generator=gen)
        return FedSegAPI(model, build_federated_arrays(
            x, y, parts, 2, device=cuda), None, cfg, num_classes=5,
            loss_mode="focal", device=cuda)
    x = np.tanh(rng.randn(26, 28, 28, 1)).astype(np.float32)
    model = create_model("mnist_gan", device=cuda, generator=gen)
    return FedGanAPI(model, build_federated_arrays(
        x, np.zeros(26, np.int32), parts, 2, device=cuda), cfg, device=cuda)


@pytest.mark.parametrize("name", ["FedNASAPI", "FedSegAPI", "FedGanAPI"])
def test_captured_extra_rounds_equal_the_eager_rounds(cuda, monkeypatch,
                                                      name):
    """FedNAS, FedSeg (focal, ignored pixels) and FedGAN: 3 captured fused
    rounds (one capture) bit-equal to 3 eager ``run_round`` +
    ``_server_update`` rounds, params and losses, under cuDNN's
    deterministic mode; at full participation ``train_rounds_on_device(3)``
    likewise (FedGAN's noise drawn inside the step from the replayed
    round's key); 4 clients are FedNAS's case that needs a host loop to
    keep the params' layout as the static buffers do
    (``parallel/shard._in_layout_of``). FedSeg runs the GroupNorm forward
    and backward equally
    often, FedNAS's search fewer backwards (its arch step's gradient is
    in the alphas alone); FedGAN has no GroupNorm."""
    from fedml_tpu_torch.core.graph import CapturedStep
    from fedml_tpu_torch.ops import group_norm as gn

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    for per_round in (3, 4):
        host = _small_zoo(cuda, name, per_round)
        want = [_eager(host, r) for r in range(3)]
        api = _small_zoo(cuda, name, per_round)
        captures = CapturedStep.captures
        fwd, bwd = gn.group_norm_fwd.launches, gn.group_norm_bwd.launches
        if per_round == 3:
            got = [api.train_one_round(r)["train_loss"] for r in range(3)]
        else:
            got = api.train_rounds_on_device(3).tolist()
        fwd = gn.group_norm_fwd.launches - fwd
        bwd = gn.group_norm_bwd.launches - bwd
        assert CapturedStep.captures == captures + 1
        assert got == want
        _assert_same_state(api, host)
        if name == "FedGanAPI":
            assert fwd == bwd == 0
        elif name == "FedSegAPI":
            assert fwd == bwd > 0
        else:  # the arch step's gradient in the alphas skips the backward
            assert fwd > bwd > 0  # of the GroupNorms before their first use


def test_captured_unrolled_fednas_round_equals_the_eager_round(cuda,
                                                               monkeypatch):
    """The unrolled (second-order) search on the small DARTS net: one
    captured round bit-equal to the eager round under cuDNN's
    deterministic mode, and its alphas moved otherwise than the
    first-order round's."""
    from fedml_tpu_torch.algos import FedNASAPI

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    base = _small_zoo(cuda, "FedNASAPI")

    def unrolled():
        return FedNASAPI(base.model, base.train_fed, None, base.cfg,
                         xi=0.02, unrolled=True, device=cuda)

    host, api = unrolled(), unrolled()
    want = _eager(host, 0)
    assert api.train_one_round(0)["train_loss"] == want
    _assert_same_state(api, host)
    _eager(base, 0)
    assert not torch.equal(base.net.params["alphas_normal"],
                           api.net.params["alphas_normal"])


def _zoo_model_api(cuda, name, n_clients=4, per_client=8, batch=4):
    """FedAvg over a model of the zoo's first half on small random data, 3
    clients a round: ``resnet10_gn`` and ``resnet20(norm="bn")`` at widths
    (4, 8, 16) on 16 x 16 images, ``cnn`` (dropout) on 28 x 28; sgd lr
    0.05."""
    import numpy as np

    from fedml_tpu_torch.algos import FedAvgAPI, FedConfig
    from fedml_tpu_torch.data import build_federated_arrays, partition_homo
    from fedml_tpu_torch.models import create_model

    rng = np.random.RandomState(0)
    n = n_clients * per_client
    gen = torch.Generator().manual_seed(0)
    if name == "cnn":
        x = rng.randn(n, 28, 28).astype(np.float32)
        model = create_model("cnn", device=cuda, generator=gen)
    else:
        x = rng.randn(n, 16, 16, 3).astype(np.float32)
        model = (create_model("resnet10_gn", num_classes=10, device=cuda,
                              generator=gen) if name == "resnet10_gn" else
                 create_model("resnet20", widths=(4, 8, 16), norm="bn",
                              num_classes=10, device=cuda, generator=gen))
    y = rng.randint(0, 10, n).astype(np.int32)
    fed = build_federated_arrays(x, y, partition_homo(n, n_clients), batch,
                                 device=cuda)
    cfg = FedConfig(client_num_in_total=n_clients, client_num_per_round=3,
                    epochs=1, batch_size=batch, lr=0.05)
    return FedAvgAPI(model, fed, None, cfg, device=cuda)


def _net_state_vec(net):
    from fedml_tpu_torch.core.tree import tree_leaves

    return torch.cat([t.float().flatten() for t in
                      tree_leaves(net.params) + tree_leaves(net.model_state)])


@pytest.mark.parametrize("name", ["resnet10_gn", "resnet20_bn", "cnn"])
def test_captured_zoo_model_rounds_equal_eager_rounds(cuda, monkeypatch,
                                                      name):
    """From one start and key: 3 captured rounds (one capture, 3 replays)
    bit-equal to 3 eager rounds under cuDNN's deterministic mode, the
    params AND the running stats, which a replay must advance (they are
    new tensors every round, carried in the graph's static buffers);
    ``resnet10_gn``'s GroupNorms on the kernels (12 forwards a step: the
    stem, 8 in the blocks, 3 downsamples; 2 steps a round)."""
    from fedml_tpu_torch.core.graph import CapturedStep
    from fedml_tpu_torch.ops import group_norm as gn

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    api = _zoo_model_api(cuda, name)
    start, key = _copy(api.net), api.rng.clone()
    want = [_eager(api, r) for r in range(3)]
    eager = _net_state_vec(api.net)
    api.net, api.rng = _copy(start), key.clone()
    captures, fwd = CapturedStep.captures, gn.group_norm_fwd.launches
    got = [api.train_one_round(r)["train_loss"] for r in range(3)]
    assert CapturedStep.captures == captures + 1
    assert got == want and torch.equal(_net_state_vec(api.net), eager)
    if name == "resnet20_bn":
        moved = [not torch.equal(v, start.model_state[k])
                 for k, v in api.net.model_state.items()]
        assert moved and all(moved)
    if name == "resnet10_gn":  # 3 replays and the capture's warm-up
        assert gn.group_norm_fwd.launches - fwd == (3 + 1) * 2 * 12


def test_dropout_masks_differ_across_replays(cuda, monkeypatch):
    """The CNN's dropout draws from the step's key, which a replay copies
    in: a replayed round from one start with another round key trains
    otherwise, and with the same key bit-equal (the graph froze no
    generator offset)."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    api = _zoo_model_api(cuda, "cnn")
    api.sample_round = lambda r: [0, 1, 2]
    start, key = _copy(api.net), api.rng.clone()
    api.train_one_round(0)
    first = _net_state_vec(api.net).clone()
    api.net, api.rng = _copy(start), key.clone()
    api.train_one_round(0)
    again = _net_state_vec(api.net).clone()
    api.net = _copy(start)  # api.rng has moved on: another round key
    api.train_one_round(0)
    other = _net_state_vec(api.net)
    assert torch.equal(first, again) and not torch.equal(first, other)


# --- ViT, run checkpoints and the rollout gate -----------------------------------

def _small_vit(cuda, cls=None, **kw):
    """ViT d_model 64, 2 heads (D 32), 2 layers, 32 x 32 x 3 (T 64), f32,
    the flash kernels as its attention; 4 clients x 8 images, batch 4 (2
    local steps), 3 clients a round, sgd lr 0.01."""
    from fedml_tpu_torch.algos import FedAvgAPI, FedConfig
    from fedml_tpu_torch.data import (build_federated_arrays,
                                      make_image_classification,
                                      partition_homo)
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.models.transformer import flash_attention_out

    x, y = make_image_classification(32, (32, 32, 3), 10, seed=0)
    fed = build_federated_arrays(x, y, partition_homo(32, 4), 4, device=cuda)
    cfg = FedConfig(client_num_in_total=4, client_num_per_round=3, epochs=1,
                    batch_size=4, lr=0.01, **kw)
    model = create_model("vit", d_model=64, n_heads=2, n_layers=2,
                         attn_fn=flash_attention_out, device=cuda,
                         generator=torch.Generator().manual_seed(0))
    return (cls or FedAvgAPI)(model, fed, None, cfg, device=cuda)


def test_captured_vit_round_equals_the_eager_round(cuda, monkeypatch):
    """The ViT through the f32 flash kernels (non-causal, D 32, T 64): the
    captured fused round bit-equal to the eager round from one start, key
    and cohort (the flash kernels add without atomics; cuDNN's patch conv
    in deterministic mode), and a replayed round counting one launch of
    each flash kernel per layer and local step for the whole cohort."""
    from fedml_tpu_torch.core.graph import CapturedStep
    from fedml_tpu_torch.ops.flash_attention import flash_attention_bwd

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    api = _small_vit(cuda)
    start, key = _copy(api.net), api.rng.clone()
    eager = _eager(api, 1), _vec(api.net)
    api.net, api.rng = _copy(start), key.clone()
    captures = CapturedStep.captures
    loss = api.train_one_round(1)["train_loss"]
    assert CapturedStep.captures == captures + 1
    assert loss == eager[0] and torch.equal(_vec(api.net), eager[1])
    counts = (flash_attention.launches, flash_attention_bwd.dq_launches,
              flash_attention_bwd.dkv_launches, flash_attention.copies)
    api.train_one_round(2)
    torch.cuda.synchronize()
    want = api.train_fed.steps_per_epoch * 2
    got = (flash_attention.launches, flash_attention_bwd.dq_launches,
           flash_attention_bwd.dkv_launches, flash_attention.copies)
    assert tuple(b - a for a, b in zip(counts, got)) == (want, want, want, 0)


@pytest.mark.parametrize("name", ["FedOptAPI", "ScaffoldAPI"])
def test_resume_across_a_captured_tier_is_bit_exact(cuda, monkeypatch,
                                                    tmp_path, name):
    """4 captured rounds straight against 2 + save_run (async) +
    restore_run + 2, restored both into a fresh api and into the api that
    captured and replayed rounds past the checkpoint (its static buffers
    must take the restored net, server optimizer state and client
    stacks): every leaf bit-equal."""
    import fedml_tpu_torch.algos as algos
    from fedml_tpu_torch.obs import CheckpointManager, restore_run, save_run
    from fedml_tpu_torch.obs.checkpoint import _walk

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cls = getattr(algos, name)
    kw = (dict(server_optimizer="adam", server_lr=0.05)
          if name == "FedOptAPI" else {})

    def state(api):
        return [t for _, t in _walk({
            "net": api.net, "rng": api.rng,
            "opt": getattr(api, "server_opt_state", None),
            "extra": api.checkpoint_extra_state()})]

    straight = _small_fedavg(cuda, cls, **kw)
    for r in range(4):
        straight.train_one_round(r)
    api = _small_fedavg(cuda, cls, **kw)
    for r in range(2):
        api.train_one_round(r)
    mgr = CheckpointManager(str(tmp_path))
    save_run(mgr, api, 1, wait=False)
    api.train_one_round(2)  # overwrites the static buffers in place
    mgr.wait()
    for target in (_small_fedavg(cuda, cls, **kw), api):
        assert restore_run(mgr, target) == 2
        for r in (2, 3):
            target.train_one_round(r)
        for a, b in zip(state(straight), state(target)):
            assert torch.equal(a, b)


def test_rollout_rollback_is_bit_equal_on_the_card(cuda, tmp_path):
    """The serving plane on the card: a candidate published, mirrored and
    promoted, then rolled back: the live vector bit-equal to the one
    before; a restarted coordinator restores it."""
    import numpy as np

    from fedml_tpu_torch.core.flat import vector_to_tree_np
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.models.adapter import adapter_model_fns
    from fedml_tpu_torch.serve import (RolloutCoordinator, ServeForward,
                                       ServeManager)

    model = create_model("transformer_lm", vocab_size=64, d_model=64,
                         n_heads=2, n_layers=2, max_len=32, adapter_rank=4,
                         adapter_scope="all", device=cuda,
                         generator=torch.Generator().manual_seed(0))
    fns = adapter_model_fns(model)
    glob = model.init_adapters(torch.Generator().manual_seed(1))
    fwd = ServeForward(fns, glob, device=cuda)
    mgr = ServeManager(fwd, None, glob, seq_len=16, max_batch=4, device=cuda)
    co = RolloutCoordinator(mgr, directory=str(tmp_path), min_shadow_tokens=8,
                            regression_tol=1e9)
    before = mgr._vec(mgr.live_adapters()).copy()
    cand = before + np.random.RandomState(0).normal(
        0, 0.05, before.shape).astype(np.float32)
    co.publish(vector_to_tree_np(cand, fwd.spec), epoch=1)
    for _ in range(4):
        req = mgr.submit(0, [1, 2, 3, 4, 5])
        mgr.serve_batch([mgr._q.get_nowait()])
        req.result(30)
    assert co.try_promote()["promoted"]
    assert np.array_equal(mgr._vec(mgr.live_adapters()), cand)
    assert co.rollback() == 0
    assert np.array_equal(mgr._vec(mgr.live_adapters()), before)
    co.close()
    mgr2 = ServeManager(fwd, None, glob, seq_len=16, max_batch=4,
                        device=cuda)
    co2 = RolloutCoordinator(mgr2, directory=str(tmp_path))
    assert co2.live_version == 0 and co2.prev_version == 1
    assert np.array_equal(mgr2._vec(mgr2.live_adapters()), before)
    co2.close()


# --- the host-resident client store and the windowed tier -------------------

def _power_law_store_data(counts=(130, 17, 0, 30, 12, 25, 8, 21, 3, 0, 64,
                                  5), shape=(28, 28, 1), seed=0):
    import numpy as np

    rng = np.random.RandomState(seed)
    tot = int(sum(counts))
    x = rng.rand(tot, *shape).astype(np.float32)
    y = rng.randint(0, 10, tot).astype(np.int32)
    edges = np.concatenate([[0], np.cumsum(counts)])
    return x, y, {c: np.arange(edges[c], edges[c + 1])
                  for c in range(len(counts))}


def _same_fields(a, b):
    return all(torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu())
               for f in ("x", "y", "mask", "counts"))


def test_pinned_store_gathers_equal_the_cpu_store(cuda):
    """The store on the card (pinned host buffers filled in place, copies
    on a copy stream the consumer waits on) gathers byte-equal to the CPU
    store: cohorts, windows (twice at one shape: the staging buffers are
    reused after their copy completed, and the first window keeps its
    bytes) and both prefetchers; a sharded memmapped store too."""
    import numpy as np

    from fedml_tpu_torch.data.directory import ShardedFederatedStore
    from fedml_tpu_torch.data.store import (CohortPrefetcher,
                                            FederatedStore, WindowPrefetcher)

    x, y, parts = _power_law_store_data()
    gpu = FederatedStore(x, y, parts, 8, device=cuda)
    cpu = FederatedStore(x, y, parts, 8, device="cpu")
    for idx in ([0, 1, 2], [2, 9], [4, 4, 7, 4], [5, 11]):
        got = gpu.gather_cohort(idx)
        assert got.x.is_cuda and _same_fields(got, cpu.gather_cohort(idx))
    w1 = np.array([[0, 1, 2], [3, 4, 5]])
    w2 = np.array([[6, 7, 8], [10, 11, 1]])
    first = gpu.gather_window(w1, 32)
    keep = first.x.clone()
    second = gpu.gather_window(w2, 32)
    torch.cuda.synchronize()
    assert torch.equal(first.x, keep)
    assert _same_fields(first, cpu.gather_window(w1, 32))
    assert _same_fields(second, cpu.gather_window(w2, 32))
    pf, wpf = CohortPrefetcher(gpu), WindowPrefetcher(gpu)
    pf.prefetch(3, [3, 4, 10])
    wpf.prefetch(1, w2, 32)
    assert _same_fields(pf.get(3, [3, 4, 10]), cpu.gather_cohort([3, 4, 10]))
    assert _same_fields(wpf.get(1, w2, 32), cpu.gather_window(w2, 32))
    sh = ShardedFederatedStore.from_flat(x, y, parts, 8, num_shards=5,
                                         device=cuda)
    assert _same_fields(sh.gather_window(w1, 32), cpu.gather_window(w1, 32))


def _store_api(cuda, cls=None, **kw):
    from fedml_tpu_torch.algos import FedAvgAPI, FedConfig
    from fedml_tpu_torch.data.store import FederatedStore
    from fedml_tpu_torch.models import create_model

    x, y, parts = _power_law_store_data()
    cfg = FedConfig(client_num_in_total=12, client_num_per_round=4,
                    comm_round=100, epochs=1, batch_size=4, lr=0.05,
                    **{k: kw.pop(k) for k in list(kw)
                       if k in FedConfig.__dataclass_fields__})
    model = create_model("cnn", num_classes=10, device=cuda,
                         generator=torch.Generator().manual_seed(0))
    return (cls or FedAvgAPI)(model, FederatedStore(x, y, parts, 4,
                                                    device=cuda),
                              None, cfg, device=cuda, **kw)


@pytest.mark.parametrize("name", ["FedAvgAPI", "ScaffoldAPI", "FedOptAPI"])
def test_windowed_rounds_equal_the_synced_loop_on_the_card(cuda, name):
    """8 captured windowed rounds (W 3: two windows at their largest
    bucket and two remainder rounds) bit-equal to 8 replayed synced
    rounds from a store, params and carry, under cuDNN's deterministic
    mode (f32 convolutions)."""
    from fedml_tpu_torch import algos

    cls = getattr(algos, name)
    kw = dict(server_optimizer="adam", server_lr=0.01) \
        if name == "FedOptAPI" else {}
    torch.backends.cudnn.deterministic = True
    try:
        host, win = _store_api(cuda, cls, **kw), _store_api(cuda, cls, **kw)
        want = [host.train_one_round(r)["train_loss"] for r in range(8)]
        got = win.train_rounds_windowed(8, window=3)
    finally:
        torch.backends.cudnn.deterministic = False
    assert all(v == v for v in got)
    for a, b in zip(_state_leaves(host), _state_leaves(win)):
        assert torch.equal(a, b)
    assert win._window_stats["host_rounds"] == 2
    assert max(abs(a - b) for a, b in zip(got, want)) <= 1e-5


def _state_leaves(api):
    from fedml_tpu_torch.core.graph import _leaves

    return _leaves(api.net.params) + _leaves(api._window_carry_init())


def test_alternating_buckets_capture_once_each(cuda):
    """8 rounds whose cohorts alternate between two step buckets capture
    one graph per bucket and replay it after: no capture after a bucket's
    first, each graph's pool its own."""
    import numpy as np

    from fedml_tpu_torch.core.graph import CapturedStep

    api = _store_api(cuda)
    small, big = [1, 4, 5, 7], [0, 1, 4, 5]  # buckets 8 and 64 at batch 4
    assert api.train_fed.cohort_steps(small) != \
        api.train_fed.cohort_steps(big)
    api.sample_round = lambda r: np.asarray(big if r % 2 else small)
    c0 = CapturedStep.captures
    losses = [api.train_one_round(r)["train_loss"] for r in range(8)]
    step = api._graphs["fused_store"]
    stats = step.graph_stats()
    assert CapturedStep.captures - c0 == 2 == len(stats)
    assert sorted(g["replays"] for g in stats) == [4, 4]
    assert all(g["capture_ms"] > 0 for g in stats)
    assert all(v == v for v in losses)


def test_a_capture_while_a_prefetch_is_in_flight_succeeds(cuda):
    """A window's gather and copy run on the prefetcher's worker while the
    main thread captures a new bucket's round: the capture waits out the
    worker's device work (``core.graph.capture_lock``), succeeds, and the
    prefetched window equals a direct gather."""
    import numpy as np

    from fedml_tpu_torch.data.store import FederatedStore, WindowPrefetcher

    x, y, parts = _power_law_store_data(counts=(600,) * 40)
    big = FederatedStore(x, y, parts, 4, device=cuda)
    pf = WindowPrefetcher(big)
    idx2d = np.arange(40).reshape(4, 10)
    pf.prefetch(0, idx2d, 256)  # ~100 MB of host gather and copy
    api = _store_api(cuda)
    loss = api.train_one_round(0)["train_loss"]  # the first capture
    got = pf.get(0, idx2d, 256)
    assert loss == loss
    assert _same_fields(got, big.gather_window(idx2d, 256))


def test_a_worker_failure_surfaces_in_get(cuda):
    """A failing window gather on the worker raises in ``get`` on the main
    thread, and the prefetcher serves the next window."""
    import numpy as np

    from fedml_tpu_torch.data.store import FederatedStore, WindowPrefetcher

    x, y, parts = _power_law_store_data()
    store = FederatedStore(x, y, parts, 8, device=cuda)
    pf = WindowPrefetcher(store)
    bad = np.array([[0, 1], [2, 3]])
    pf.prefetch(0, bad, 1)
    with pytest.raises(ValueError, match="forced steps 1 < cohort need"):
        pf.get(0, bad, 1)
    good = np.array([[3, 4], [5, 6]])
    pf.prefetch(1, good, 8)
    assert _same_fields(pf.get(1, good, 8), store.gather_window(good, 8))


# --- the observability layer on the card -------------------------------------

def test_sanitized_traps_a_sync_and_passes_pinned_copies(cuda):
    """In a region: ``.item()`` raises where it happens and the sync mode is
    restored after; inside ``planned_transfer`` it passes; a pinned
    ``non_blocking`` copy passes, from this thread and from the store's
    prefetch worker (its gather's pinned copies), and ``RoundTimer.fence``
    passes."""
    from fedml_tpu_torch.data.store import CohortPrefetcher, FederatedStore
    from fedml_tpu_torch.obs import RoundTimer, planned_transfer, sanitized

    x, y, parts = _power_law_store_data()
    store = FederatedStore(x, y, parts, 8, device=cuda)
    store.gather_cohort([0, 1])  # the copy stream and the pinned pool
    pf = CohortPrefetcher(store)
    t = torch.ones(3, device=cuda)
    with pytest.raises(RuntimeError, match="synchroniz"):
        with sanitized():
            t.sum().item()
    assert torch.cuda.get_sync_debug_mode() == 0
    host = torch.arange(4096.0).pin_memory()
    with sanitized() as rep:
        with planned_transfer():
            assert t.sum().item() == 3.0
        dev = host.to(cuda, non_blocking=True)
        pf.prefetch(0, [2, 3, 5])
        sub = pf.get(0, [2, 3, 5])
        timer = RoundTimer()
        with timer.phase("copy"):
            timer.fence((dev, sub.x))
    assert rep.compiles == 0
    assert torch.equal(dev.cpu(), host)
    assert _same_fields(sub, store.gather_cohort([2, 3, 5]))


def test_compile_count_rises_once_for_one_capture(cuda):
    """A captured step: its first call captures (+1), a replay adds
    nothing, a new shape (a new step bucket) captures once more, and a
    strict region around that capture raises ``SanitizerError``."""
    from fedml_tpu_torch.core.graph import CapturedStep
    from fedml_tpu_torch.obs import SanitizerError, compile_count, sanitized

    step = CapturedStep(lambda carry, x: (carry + x.sum(), x * 2), cuda,
                        lambda: [])
    carry = torch.zeros((), device=cuda)
    n0 = compile_count()
    carry, _ = step(carry, torch.ones(4, device=cuda))
    assert compile_count() == n0 + 1
    with sanitized() as rep:
        carry, _ = step(carry, torch.ones(4, device=cuda))
    assert rep.compiles == 0 and compile_count() == n0 + 1
    with pytest.raises(SanitizerError, match="bucket"):
        with sanitized():
            carry, _ = step(carry, torch.ones(8, device=cuda))
    assert compile_count() == n0 + 2
    assert carry.item() == 16.0


def test_flop_formulas_count_the_kernels_on_the_card(cuda):
    """``model_cost`` on the card launches the kernels and counts them: a
    bf16 ``transformer_lm`` at T 256 through the flash forward counts as
    the dense model does, and a GroupNorm 7 flops an element."""
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.obs import model_cost
    from fedml_tpu_torch.ops.group_norm import group_norm, group_norm_fwd

    kw = dict(vocab_size=512, d_model=128, n_heads=2, n_layers=2,
              max_len=256, dtype="bf16", device=cuda)
    x = torch.ones(2, 256, dtype=torch.int32)
    n = flash_attention.launches
    flash = model_cost(create_model("transformer_lm", attn="flash", **kw), x)
    assert flash_attention.launches == n + 2
    dense = model_cost(create_model("transformer_lm", **kw), x)
    assert flash["flops"] == dense["flops"] > 0

    class Net(torch.nn.Module):
        def forward(self, x):
            return group_norm(x, torch.ones(64, device=cuda),
                              torch.zeros(64, device=cuda), 32)

    n = group_norm_fwd.launches
    xg = torch.zeros(8, 16, 16, 64, device=cuda, dtype=torch.bfloat16)
    assert model_cost(Net(), xg)["flops"] == 7 * xg.numel()
    assert group_norm_fwd.launches == n + 1


def test_round_timer_fence_waits_for_a_long_kernel(cuda):
    """A phase around a ~50 ms device sleep: fenced, it lasts at least the
    sleep's event-timed length; unfenced, the host returns long before."""
    from fedml_tpu_torch.obs import RoundTimer

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(50_000_000)
    end.record()
    torch.cuda.synchronize()
    sleep_s = start.elapsed_time(end) / 1e3
    assert sleep_s > 5e-3
    t = RoundTimer()
    marker = torch.zeros(1, device=cuda)
    with t.phase("unfenced"):
        torch.cuda._sleep(50_000_000)
    torch.cuda.synchronize()
    with t.phase("fenced"):
        torch.cuda._sleep(50_000_000)
        t.fence({"out": [marker]})
    s = t.summary()
    assert s["fenced"]["last_s"] >= 0.9 * sleep_s
    assert s["unfenced"]["last_s"] < 0.5 * sleep_s


@pytest.mark.parametrize("name", ["FedAvgAPI", "ScaffoldAPI", "FedOptAPI"])
def test_steady_store_loops_are_clean_under_the_sanitizer(cuda, name):
    """After their buckets' warm-up, the synced store loop
    (``train_rounds_pipelined`` with the cohort prefetcher) and the
    windowed loop replay the same rounds in strict ``disallow`` regions:
    no capture, no implicit sync (SCAFFOLD's cohort indices and FedOpt's
    server state included); the donation audit of the pipelined rounds
    holds within 0.25 of its baseline."""
    from fedml_tpu_torch import algos
    from fedml_tpu_torch.obs import donation_audit, sanitized

    cls = getattr(algos, name)
    kw = dict(server_optimizer="adam", server_lr=0.01) \
        if name == "FedOptAPI" else {}
    synced, win = _store_api(cuda, cls, **kw), _store_api(cuda, cls, **kw)
    synced.train_rounds_pipelined(8)
    win.train_rounds_windowed(8, window=4)
    with sanitized() as rep:
        with donation_audit(synced.net) as audit:
            base = audit.sample()
            for r in range(0, 8, 2):
                synced.train_rounds_pipelined(2, start_round=r)
                audit.sample()
        losses = win.train_rounds_windowed(8, window=4)
    assert rep.compiles == 0
    assert all(v == v for v in losses)
    assert audit.peak <= base + 0.25, (audit.peak, base)


# --- FedAvgAPI's knobs: padded GroupNorm widths, compression, the host
# round, selection, layouts, bf16 --------------------------------------------

# (N, S, logical C, padded C, logical groups, dtype): the GroupNorm widths
# of the mis-sized ResNet (widths 20/40/80, stem 20) under the layout,
# 20 -> 24 (one-channel groups: 24 groups) and 80 -> 96 (groups of 4: 24),
# at CIFAR's 32² and 8², f32 and bf16 on the cluster route; and 20 -> 24
# on a sample past a cluster (the streamed routes).
GN_PADDED = [(8, 1024, 20, 24, 20, torch.float32),
             (8, 64, 80, 96, 20, torch.float32),
             (8, 1024, 20, 24, 20, torch.bfloat16),
             (8, 64, 80, 96, 20, torch.bfloat16),
             (2, 65536, 20, 24, 20, torch.float32)]


@pytest.mark.parametrize("n,s,c,cp,groups,dtype", GN_PADDED)
def test_group_norm_kernels_at_padded_widths(cuda, n, s, c, cp, groups,
                                             dtype):
    """x and dy padded with zero channels, γ/β with zeros, the padded
    count in groups of the logical size: the kernels against the plain
    twins on the padded inputs (y and dx within one bf16 rounding or
    1e-5); y, dx, dγ and dβ exactly 0 on the pad channels; the logical
    channels against the logical call within one bf16 ulp or 1e-5 (not
    bit-equal: the kernels' vector width and thread-to-channel map follow
    the channel count, so the per-channel sums over S run in another
    order); the streamed routes taken by the sample past a cluster."""
    from fedml_tpu_torch.ops import group_norm as gn

    g = torch.Generator(device=cuda).manual_seed(9)
    x, dy, gamma, beta = _gn_inputs((n, s, c), 1, dtype, g, cuda)
    pad = cp - c
    xp = torch.nn.functional.pad(x, (0, pad))
    dyp = torch.nn.functional.pad(dy, (0, pad))
    gp, bp = (torch.nn.functional.pad(t, (0, pad)) for t in (gamma, beta))
    gpad = cp // (c // groups)
    fs, bs = gn.group_norm_fwd.streamed, gn.group_norm_bwd.streamed
    y = gn.group_norm_fwd(xp, gp, bp, gpad)
    dx, dgamma, dbeta = gn.group_norm_bwd(xp, dyp, gp, gpad)
    y_log = gn.group_norm_fwd(x, gamma, beta, groups)
    dx_log, dg_log, db_log = gn.group_norm_bwd(x, dy, gamma, groups)
    torch.cuda.synchronize()
    streamed = s > 4096  # 6.3 MB of f32 a sample: past a cluster
    assert (gn.group_norm_fwd.streamed - fs > 0) == streamed
    assert (gn.group_norm_bwd.streamed - bs > 0) == streamed
    for t in (y, dx):
        assert torch.equal(t[..., c:], torch.zeros_like(t[..., c:]))
    assert not dgamma[:, c:].any() and not dbeta[:, c:].any()
    want_y = gn.group_norm_fwd_plain(xp.float(), gp, bp, gpad)
    want_dx, _, _ = gn.group_norm_bwd_plain(xp.float(), dyp.float(), gp,
                                            gpad)
    for got, want in ((y, want_y), (dx, want_dx)):
        if dtype == torch.bfloat16:
            ok, err = _within_bf16_ulp(got, want)
            assert ok, err
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for got, want in ((y[..., :c], y_log), (dx[..., :c], dx_log)):
        # Two kernel outputs, each one rounding of its f32 value: in bf16
        # within one ulp of each other (2^-7 of the value at most).
        err = (got.float() - want.float()).abs()
        lim = (want.float().abs() * (2.0 ** -7 if dtype == torch.bfloat16
                                     else 1e-5)
               + 1e-5 * want.float().abs().max())
        assert bool((err <= lim).all()), err.max().item()
    chain = s + n + 64
    mu, rstd = gn._stats(x.float(), groups, gn.EPS)
    for got, want, terms in (
            (dgamma[:, :c], dg_log, dy.float() * (x.float() - mu) * rstd),
            (dbeta[:, :c], db_log, dy.float())):
        assert bool(((got - want).abs() <= 2 * _sum_order_bound(
            terms, chain)).all())


def _knob_api(cuda, per_round=3, **cfg_kw):
    return _small_fedavg(cuda, per_round=per_round, **cfg_kw)


@pytest.mark.parametrize("compress", ["topk0.05", "q8"])
def test_compressed_rounds_captured_equal_eager(cuda, monkeypatch, compress):
    """``torch.topk`` (under the round's vmap) and the q8 transform (its
    per-client streams from the round's key) inside a captured round: 2
    captured fused rounds bit-equal to 2 eager rounds (``run_round`` +
    ``_server_update``) under ``cudnn.deterministic``; every q8 client
    delta on its 255-level grid."""
    from fedml_tpu_torch.core import compression as tc
    from fedml_tpu_torch.core import keys
    from fedml_tpu_torch.trainer.local import NetState

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    fused, eager = (_knob_api(cuda, compress=compress) for _ in range(2))
    for r in range(2):
        assert fused.train_one_round(r)["train_loss"] == _eager(eager, r)
    _assert_same_state(fused, eager)
    if compress == "q8":
        t = fused._client_transform()
        g = fused.net
        gen = torch.Generator(device=cuda).manual_seed(0)
        c = NetState({k: v + 0.01 * torch.randn(
            v.shape, generator=gen, dtype=v.dtype, device=v.device)
                      for k, v in g.params.items()}, {})
        out = t(g, c, keys.key(3, cuda))
        delta = tc.tree_to_vector(out.params) - tc.tree_to_vector(g.params)
        raw = tc.tree_to_vector(c.params) - tc.tree_to_vector(g.params)
        levels = delta / (raw.abs().max() / 127)
        assert float((levels - levels.round()).abs().max()) < 1e-2


def test_topk_one_is_plain_fedavg_on_the_card(cuda, monkeypatch):
    """``topk1.0`` keeps every client value: 2 captured rounds bit-equal
    to plain FedAvg's."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    plain, full = _knob_api(cuda), _knob_api(cuda, compress="topk1.0")
    for r in range(2):
        assert plain.train_one_round(r) == full.train_one_round(r)
    _assert_same_state(plain, full)


def test_host_round_and_selection_on_the_card(cuda, monkeypatch):
    """The host round (oort's three-output round) is a captured step:
    3 rounds of oort bit-equal to 3 eager ``run_round`` +
    ``_server_update`` rounds with the same utility updates; pow_d's
    candidate eval is one captured step, its cohort the same as the
    eager eval's."""
    from fedml_tpu_torch.core.graph import CapturedStep

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    api, ref = (_knob_api(cuda, per_round=2, client_selection="oort")
                for _ in range(2))
    for r in range(3):
        loss = api.train_one_round(r)["train_loss"]
        assert loss == _eager(ref, r)
        ref._update_oort_state(r, ref.sample_round(r))
    _assert_same_state(api, ref)
    assert (api._oort_utility == ref._oort_utility).all()
    assert "host" in api._graphs and api._graphs["host"].graph_stats()
    pow_d = _knob_api(cuda, per_round=2, client_selection="pow_d",
                      pow_d_candidates=4)
    captures = CapturedStep.captures
    idx = pow_d.sample_round(0)
    assert CapturedStep.captures == captures + 1
    fed = pow_d.train_fed
    losses = {int(c): float(pow_d.eval_fn(pow_d.net, fed.x[c], fed.y[c],
                                          fed.mask[c])["loss"])
              for c in range(4)}
    top = sorted(losses, key=losses.get, reverse=True)[:2]
    assert sorted(int(i) for i in idx) == sorted(top)


def test_im2col_stem_against_the_5x5_conv_on_the_card(cuda):
    """The im2col stem (``F.unfold`` + a 1x1 conv) against the 5x5 stem on
    the card, f32 with TF32 off: the forward within the CNN family's
    tolerance (rtol 1e-4, atol 1e-5), and in bf16 within 2 bf16 ulps."""
    from fedml_tpu_torch.models.cnn import CNNOriginalFedAvg
    from fedml_tpu_torch.parallel.layout import im2col_layout
    from fedml_tpu_torch.trainer.local import model_fns

    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dtype in (None, torch.bfloat16):
            model = CNNOriginalFedAvg(num_classes=10, dtype=dtype,
                                      generator=torch.Generator()
                                      .manual_seed(0)).to(cuda)
            layout = im2col_layout(model, torch.zeros(4, 28, 28, 1))
            net = model_fns(model).init()
            x = torch.randn(16, 28, 28, 1, device=cuda, generator=torch
                            .Generator(device=cuda).manual_seed(0))
            want = model_fns(model).apply(net, x)[0].float()
            got = model_fns(layout.physical_model).apply(layout.pad(net),
                                                         x)[0].float()
            if dtype is None:
                torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
            else:
                lim = want.abs() * 2.0 ** -7 + 1e-2 * want.abs().max()
                assert bool(((got - want).abs() <= lim).all())
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def test_dp_step_on_the_card_against_its_cpu_twin(cuda, monkeypatch):
    """One DP-SGD local training (2 steps, noise from the port's keys) of
    the small GroupNorm ResNet on the card, through the kernels and under
    the cohort's vmap, against the same training on the CPU (the plain
    twins): within 1e-4 of the update's norm (f32, TF32 off; other conv
    and reduction orders)."""
    from fedml_tpu_torch.core import keys
    from fedml_tpu_torch.core.tree import tree_map
    from fedml_tpu_torch.trainer.local import (make_client_optimizer,
                                               make_local_train_fn,
                                               model_fns)

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    api = _small_fedavg(cuda)
    fed = api.train_fed
    out = {}
    for dev in (cuda, torch.device("cpu")):
        model = api.model.to(dev)
        fns = model_fns(model)
        lt = make_local_train_fn(fns.apply, make_client_optimizer("sgd", 0.1),
                                 1, dp_clip=0.5, dp_noise_multiplier=1.1)
        net = fns.init()
        rngs = keys.fold_in(keys.key(5, dev), torch.arange(3, device=dev))
        nets, losses = lt.run_clients(net, fed.x[:3].to(dev),
                                      fed.y[:3].to(dev),
                                      fed.mask[:3].to(dev), rngs)
        out[dev.type] = (tree_map(lambda t: t.cpu(), nets.params),
                         losses.cpu(), tree_map(lambda t: t.cpu(),
                                                net.params))
    (g, gl, start), (c, cl, _) = out["cuda"], out["cpu"]
    num = sum(float(((g[k] - c[k]) ** 2).sum()) for k in g)
    den = sum(float(((c[k] - start[k][None]) ** 2).sum()) for k in c)
    assert (num / den) ** 0.5 <= 1e-4
    assert torch.allclose(gl, cl, rtol=1e-4)


@pytest.mark.parametrize("dp", [False, True], ids=["plain", "dp"])
def test_remat_captured_rounds_bit_equal_on_the_card(cuda, monkeypatch, dp):
    """remat under a captured step: 2 captured fused rounds with remat
    bit-equal to 2 without it (cuDNN deterministic), with and without
    DP-SGD; the forward's GroupNorm launches doubled, the backward's
    not."""
    from fedml_tpu_torch.ops import group_norm as gn

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    kw = dict(dp_clip=0.5, dp_noise_multiplier=1.1) if dp else {}
    plain, remat = _knob_api(cuda, **kw), _knob_api(cuda, remat=True, **kw)
    counts = {}
    for name, api in (("plain", plain), ("remat", remat)):
        api.train_one_round(0)
        fwd, bwd = gn.group_norm_fwd.launches, gn.group_norm_bwd.launches
        api.train_one_round(1)
        counts[name] = (gn.group_norm_fwd.launches - fwd,
                        gn.group_norm_bwd.launches - bwd)
    _assert_same_state(plain, remat)
    assert counts["remat"][0] == 2 * counts["plain"][0] > 0
    assert counts["remat"][1] == counts["plain"][1]


def test_group_norm_kernels_at_single_sample_rows(cuda):
    """The DP step's GroupNorm shapes: ResNet-56's eight shapes with R =
    256 single-sample rows (8 clients x 32 examples, each row its own
    gamma/beta), bf16, against the plain twins; reruns bit-equal."""
    from fedml_tpu_torch.ops import group_norm as gn

    g = torch.Generator(device=cuda).manual_seed(18)
    for (n, s, c), groups in GN_MAIN_SHAPES:
        x = (torch.randn(n, 1, s, c, device=cuda, generator=g) * 2 + 0.5
             ).to(torch.bfloat16)
        dy = torch.randn(n, 1, s, c, device=cuda, generator=g).to(
            torch.bfloat16)
        gamma = torch.rand(n, c, device=cuda, generator=g) + 0.5
        beta = torch.randn(n, c, device=cuda, generator=g)
        y = gn.group_norm_fwd(x, gamma, beta, groups)
        assert torch.equal(y, gn.group_norm_fwd(x, gamma, beta, groups))
        dx, dgamma, dbeta = gn.group_norm_bwd(x, dy, gamma, groups)
        want = gn.group_norm_fwd_plain(x.float(), gamma, beta, groups)
        wdx, wdg, wdb = gn.group_norm_bwd_plain(x.float(), dy.float(),
                                                gamma, groups)
        for got, ref in ((y, want), (dx, wdx)):
            err = (got.float() - ref).abs()
            lim = ref.abs() * 2.0 ** -8 + 1e-5 * ref.abs().max()
            assert bool((err <= lim).all()), err.max().item()
        mu, rstd = gn._stats(x.float(), groups, gn.EPS)
        chain = s + 64
        assert bool(((dgamma - wdg).abs() <= _sum_order_bound(
            dy.float() * (x.float() - mu) * rstd, chain)).all())
        assert bool(((dbeta - wdb).abs() <= _sum_order_bound(
            dy.float(), chain)).all())


# --- the federation plane (algos/fedavg_distributed.py) -----------------------


def _tiny_federation(device, **kw):
    """A loopback federation of a narrow GroupNorm ResNet, 6 clients of
    seeded 8x8x3 samples, 3 silos a round, 2 rounds, every message through
    the tensor wire, on ``device``."""
    from fedml_tpu_torch.algos import FedConfig
    from fedml_tpu_torch.algos.fedavg_distributed import (
        FedML_FedAvg_distributed)
    from fedml_tpu_torch.data import batching, partition, synthetic
    from fedml_tpu_torch.models import create_model

    x, y = synthetic.make_image_classification(60, (8, 8, 3), 4, seed=0)
    parts = partition.partition_dirichlet(y, 6, 0.5, min_size=4, seed=0)
    batch = max(len(v) for v in parts.values())
    fed = batching.build_federated_arrays(x, y, parts, batch, device=device)
    test = batching.batch_global(x[:20], y[:20], 10, device=device)
    cfg = FedConfig(client_num_in_total=6, client_num_per_round=3,
                    comm_round=2, epochs=1, batch_size=batch, lr=1e-3,
                    frequency_of_the_test=1, **kw)
    model = create_model("resnet20", widths=(4, 8, 16), num_classes=4,
                         device=device,
                         generator=torch.Generator().manual_seed(0))
    return FedML_FedAvg_distributed(model, fed, test, cfg,
                                    loopback_wire="tensor", device=device,
                                    idle_timeout_s=60.0)


@pytest.mark.parametrize("workers", [0, 2])
def test_loopback_federation_on_the_card(cuda, workers, monkeypatch):
    """The federation on the card: the silos' captured step launches the
    GroupNorm kernels, and the run ends near its CPU twin (the kernels and
    cuDNN's f32 convolutions, TF32 off, against the CPU's ops: within 1e-4
    after 2 rounds)."""
    from fedml_tpu_torch.ops import group_norm as gn

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)

    fwd, bwd = gn.group_norm_fwd.launches, gn.group_norm_bwd.launches
    agg = _tiny_federation("cuda", ingest_workers=workers)
    assert gn.group_norm_fwd.launches > fwd
    assert gn.group_norm_bwd.launches > bwd
    assert agg.local_train.capture_ms is not None  # the step was captured
    assert agg.final_health["members"] == 3
    ref = _tiny_federation("cpu", ingest_workers=workers)
    for k, v in ref.net.params.items():
        got = agg.net.params[k]
        assert got.device.type == "cuda"
        torch.testing.assert_close(got.cpu(), v, rtol=0, atol=1e-4)
    for got, want in zip(agg.test_history, ref.test_history):
        assert abs(got["loss"] - want["loss"]) <= 1e-4


def test_server_fold_on_the_card_against_the_cpu(cuda):
    """The streaming f32 fold and the pooled int64 fold of the same
    uploads on the card and on the CPU: the pooled means bit-equal (the
    fold is host numpy, only the finalize lands on the device), the f32
    means within 1e-6."""
    import numpy as np

    from fedml_tpu_torch.algos import FedConfig
    from fedml_tpu_torch.algos.fedavg_distributed import FedAVGAggregator
    from fedml_tpu_torch.comm.ingest import IngestPool
    from fedml_tpu_torch.trainer.local import NetState

    rng = np.random.RandomState(0)
    uploads = [(NetState({"w": rng.randn(64, 9).astype(np.float32),
                          "b": rng.randn(9).astype(np.float32)}, {}),
                float(rng.randint(1, 300))) for _ in range(6)]
    start = NetState({"w": np.zeros((64, 9), np.float32),
                      "b": np.zeros(9, np.float32)}, {})
    cfg = FedConfig(client_num_in_total=6, client_num_per_round=6)
    means = {}
    for device in ("cuda", "cpu"):
        stream = FedAVGAggregator(start, 6, cfg, device=device)
        for i, (up, w) in enumerate(uploads):
            stream.add_local_trained_result(i, up, w)
        pool = IngestPool(3)
        for up, w in uploads:
            pool.submit(lambda up=up, w=w: ([up.params["b"], up.params["w"]],
                                            w))
        assert pool.drain() == []
        pooled = FedAVGAggregator(start, 6, cfg, device=device)
        pooled.aggregate_pooled(range(6), pool)
        pool.close()
        means[device] = (stream.aggregate_from(range(6)), pooled.net)
    for k in ("w", "b"):
        assert means["cuda"][1].params[k].device.type == "cuda"
        assert torch.equal(means["cuda"][1].params[k].cpu(),
                           means["cpu"][1].params[k])
        torch.testing.assert_close(means["cuda"][0].params[k].cpu(),
                                   means["cpu"][0].params[k], rtol=1e-6,
                                   atol=1e-7)


# --- the asynchronous tiers (algos/fedasync.py, algos/fedbuff.py) -------------


def test_fedasync_on_the_card(cuda, monkeypatch):
    """FedAsync over the narrow GroupNorm ResNet with one worker (ordered
    arrivals): the captured step launches the GroupNorm kernels, and the
    run ends near its CPU twin (within 1e-4 after 3 versions, as the sync
    tier's)."""
    from fedml_tpu_torch.algos import FedConfig
    from fedml_tpu_torch.algos.fedasync import FedML_FedAsync_distributed
    from fedml_tpu_torch.data import batching, partition, synthetic
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.ops import group_norm as gn

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    x, y = synthetic.make_image_classification(60, (8, 8, 3), 4, seed=0)
    parts = partition.partition_dirichlet(y, 6, 0.5, min_size=4, seed=0)
    batch = max(len(v) for v in parts.values())

    def run(device):
        fed = batching.build_federated_arrays(x, y, parts, batch,
                                              device=device)
        cfg = FedConfig(client_num_in_total=6, client_num_per_round=1,
                        comm_round=3, epochs=1, batch_size=batch, lr=1e-3)
        model = create_model("resnet20", widths=(4, 8, 16), num_classes=4,
                             device=device,
                             generator=torch.Generator().manual_seed(0))
        return FedML_FedAsync_distributed(
            model, fed, None, cfg, wire_codec="bf16", loopback_wire="tensor",
            device=device, idle_timeout_s=60.0)

    fwd, bwd = gn.group_norm_fwd.launches, gn.group_norm_bwd.launches
    srv = run("cuda")
    assert gn.group_norm_fwd.launches > fwd
    assert gn.group_norm_bwd.launches > bwd
    assert srv.local_train.capture_ms is not None
    assert srv.version == 3 and srv.final_health["codec_refusals"] == 0
    ref = run("cpu")
    for k, v in ref.net.params.items():
        assert srv.net.params[k].device.type == "cuda"
        torch.testing.assert_close(srv.net.params[k].cpu(), v, rtol=0,
                                   atol=1e-4)


def test_fedbuff_adapter_federation_on_the_card(cuda):
    """FedBuff over a bf16 flash transformer's LoRA adapters at T 2048:
    the captured step launches the flash forward, dq and dk/dv kernels,
    the uploads are topk+int8 adapter deltas, and the frozen base is
    bit-equal after the run."""
    import functools

    import numpy as np

    from fedml_tpu_torch.algos import FedConfig
    from fedml_tpu_torch.algos.fedbuff import FedML_FedBuff_distributed
    from fedml_tpu_torch.data import batching, partition
    from fedml_tpu_torch.models import create_model
    from fedml_tpu_torch.ops.flash_attention import flash_attention_bwd
    from fedml_tpu_torch.trainer.local import seq_softmax_ce

    t = 2048
    rng = np.random.RandomState(0)
    seqs = rng.randint(1, 64, size=(8, t + 1))
    fed = batching.build_federated_arrays(
        seqs[:, :t].astype(np.int32), seqs[:, 1:].astype(np.int32),
        partition.partition_homo(8, 4), 2, device=cuda)
    model = create_model("transformer_lm", vocab_size=64, d_model=128,
                         n_heads=2, n_layers=2, max_len=t, dtype="bf16",
                         attn="flash", adapter_rank=4, adapter_scope="attn",
                         device=cuda,
                         generator=torch.Generator().manual_seed(0))
    base0 = {k: v.clone() for k, v in model.state_dict().items()}
    cfg = FedConfig(client_num_in_total=4, client_num_per_round=2,
                    comm_round=2, epochs=1, batch_size=2, lr=0.1,
                    adapter_rank=4)
    before = (flash_attention.launches, flash_attention_bwd.dq_launches,
              flash_attention_bwd.dkv_launches)
    srv = FedML_FedBuff_distributed(
        model, fed, None, cfg, buffer_k=2, wire_codec="topk0.01+int8",
        loopback_wire="tensor", loss_fn=functools.partial(seq_softmax_ce,
                                                          pad_id=0),
        device=cuda, idle_timeout_s=120.0)
    after = (flash_attention.launches, flash_attention_bwd.dq_launches,
             flash_attention_bwd.dkv_launches)
    assert all(a > b for a, b in zip(after, before))
    assert srv.version == 2 and srv.final_health["codec_refusals"] == 0
    assert srv.adapter_holder["base"] is model
    now = model.state_dict()
    assert all(torch.equal(v, now[k]) for k, v in base0.items())
    for leaf in srv.net.params["Block_0"]["MHA_0"].values():
        assert leaf.device.type == "cuda" and bool(torch.isfinite(leaf).all())


# --- the secure, sharded and simulated plane (comm/secagg.py,
# comm/shardplane.py, sim/) -----------------------------------------------------


def _plane_data(device):
    from fedml_tpu_torch.data import batching, partition, synthetic

    x, y = synthetic.make_image_classification(96, (8, 8, 3), 4, seed=0)
    fed = batching.build_federated_arrays(
        x, y, partition.partition_homo(len(x), 6), 16, device=device)
    return fed, batching.batch_global(x[:32], y[:32], 16, device=device)


def _plane_model(device):
    from fedml_tpu_torch.models import create_model

    return create_model("resnet20", widths=(4, 8, 16), num_classes=4,
                        device=device,
                        generator=torch.Generator().manual_seed(0))


def _wrapped_sum(frames):
    """The int64 sum of a list of contributions' leaves, wrapping."""
    out = None
    for leaves in frames:
        u = [l.view("uint64") for l in leaves]
        out = [x.copy() for x in u] if out is None else [a + b for a, b in
                                                         zip(out, u)]
    return [x.view("int64") for x in out]


def test_secagg_loopback_on_the_card_is_the_clear_fold(cuda, monkeypatch):
    """A masked federation of 4 silos on the card (the narrow GroupNorm
    ResNet, 2 ingest workers, 2 rounds): every round's merged total after
    mask cancellation is the wrapped sum of the silos' clear
    contributions, recorded before masking, bit for bit; no masked frame
    equals its clear contribution; the kernels ran."""
    import numpy as np

    from fedml_tpu_torch.algos import FedConfig
    from fedml_tpu_torch.algos import fedavg_distributed as fd
    from fedml_tpu_torch.comm import secagg
    from fedml_tpu_torch.ops import group_norm as gn

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    clear, masked, totals = {}, {}, {}
    mask = secagg.SecAggClient.mask
    check = fd.FedAVGServerManager._secagg_envelope_check

    def mask_spy(client, leaves, round_idx, roster):
        clear[(client.rank, round_idx)] = [np.array(l, copy=True)
                                           for l in leaves]
        out = mask(client, leaves, round_idx, roster)
        masked[(client.rank, round_idx)] = [np.array(l, copy=True)
                                            for l in out]
        return out

    def check_spy(server, total):
        totals[server.round_idx] = ([np.array(l, copy=True)
                                     for l in total.leaves], total.count)
        return check(server, total)

    monkeypatch.setattr(secagg.SecAggClient, "mask", mask_spy)
    monkeypatch.setattr(fd.FedAVGServerManager, "_secagg_envelope_check",
                        check_spy)
    fed, test = _plane_data(cuda)
    cfg = FedConfig(client_num_in_total=6, client_num_per_round=4,
                    comm_round=2, epochs=1, batch_size=16, lr=1e-3,
                    frequency_of_the_test=1, secagg=True, ingest_workers=2)
    fwd = gn.group_norm_fwd.launches
    agg = fd.FedML_FedAvg_distributed(_plane_model(cuda), fed, test, cfg,
                                      loopback_wire="tensor", device=cuda,
                                      idle_timeout_s=60.0)
    assert gn.group_norm_fwd.launches > fwd
    assert agg.final_health["seed_reveals"] == 0
    for r in (0, 1):
        got, count = totals[r]
        want = _wrapped_sum([clear[(w, r)] for w in (1, 2, 3, 4)])
        assert count == 4
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert all(any(not np.array_equal(a, b) for a, b in zip(masked[k],
                                                             clear[k]))
               for k in clear)
    for leaf in agg.net.params.values():
        assert leaf.device.type == "cuda" and bool(torch.isfinite(leaf).all())


def test_agg_shards_on_the_card_equal_the_single_pool(cuda, monkeypatch):
    """agg_shards 2 over 4 silos on the card: each round's merged shard
    partials equal the single pool's fold of the same uploads (what
    agg_shards 0 folds), and the global equals that fold's mean, bit for
    bit."""
    import collections

    import numpy as np

    from fedml_tpu_torch.algos import FedConfig
    from fedml_tpu_torch.algos import fedavg_distributed as fd
    from fedml_tpu_torch.comm import pytree
    from fedml_tpu_torch.comm import shardplane as sp
    from fedml_tpu_torch.comm.ingest import PartialAccumulator
    from fedml_tpu_torch.core.tree import sorted_leaves

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    uploads, totals = collections.defaultdict(list), []
    submit, finalize = (sp.AggregatorShardManager._submit_upload,
                        sp.finalize_partial_mean)

    def submit_spy(shard, sender, t, msg):
        uploads[t].append((sender, msg.get(fd.MSG_ARG_KEY_MODEL_PARAMS),
                           float(msg.get(fd.MSG_ARG_KEY_NUM_SAMPLES))))
        return submit(shard, sender, t, msg)

    def finalize_spy(total, ref):
        out = finalize(total, ref)
        totals.append(([np.array(l, copy=True) for l in total.leaves],
                       total.wsum, total.count, out[0]))
        return out

    monkeypatch.setattr(sp.AggregatorShardManager, "_submit_upload",
                        submit_spy)
    monkeypatch.setattr(sp, "finalize_partial_mean", finalize_spy)
    fed, test = _plane_data(cuda)
    cfg = FedConfig(client_num_in_total=6, client_num_per_round=4,
                    comm_round=2, epochs=1, batch_size=16, lr=1e-3,
                    frequency_of_the_test=1)
    agg = fd.FedML_FedAvg_distributed(_plane_model(cuda), fed, test, cfg,
                                      agg_shards=2, loopback_wire="tensor",
                                      device=cuda, idle_timeout_s=60.0)
    assert agg.final_health["shards"] == 2
    for r in (0, 1):
        single = PartialAccumulator()
        for _, payload, w in sorted(uploads[r], key=lambda u: u[0]):
            single.add([pytree.np_leaf(l) for l in sorted_leaves(payload)],
                       w)
        got, wsum, count, _ = totals[r]
        assert (wsum, count) == (single.wsum, single.count) and count == 4
        assert all(np.array_equal(a, b) for a, b in zip(got, single.leaves))
    mean, _ = finalize(single, agg.net)
    assert all(torch.equal(a, b) for a, b in zip(sorted_leaves(mean),
                                                  sorted_leaves(agg.net)))


def test_fleet_sim_two_runs_identical_on_the_card(cuda, monkeypatch):
    """Two FleetSimulator runs of FedBuff on the card from one seed, under
    deterministic cuDNN: the same deliveries in the same virtual order
    and bit-equal globals."""
    from fedml_tpu_torch.algos import FedConfig
    from fedml_tpu_torch.sim import (FleetSimulator, FleetSpec,
                                     make_fleet_trace, transport)

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    deliver = transport.SimNetwork._deliver
    runs = []
    for _ in range(2):
        events = []

        def spy(network, msg, t_sent=0.0, blob=None, events=events):
            events.append((network.events.clock.now, int(msg.get_type()),
                           int(msg.get_sender_id()),
                           int(msg.get_receiver_id())))
            return deliver(network, msg, t_sent, blob)

        monkeypatch.setattr(transport.SimNetwork, "_deliver", spy)
        fed, test = _plane_data(cuda)
        sim = FleetSimulator(
            _plane_model(cuda), fed, test,
            FedConfig(client_num_in_total=6, client_num_per_round=6,
                      comm_round=6, epochs=1, batch_size=16, lr=1e-3,
                      frequency_of_the_test=2),
            make_fleet_trace(FleetSpec(n_devices=6, seed=3,
                                       horizon_s=3600.0)),
            mode="fedbuff", buffer_k=2, device=cuda)
        res = sim.run()
        assert res.completed
        runs.append((events, res.arrival_log,
                     [v.clone() for v in sim.server.net.params.values()]))
    assert runs[0][:2] == runs[1][:2] and len(runs[0][0]) > 20
    assert all(torch.equal(a, b) for a, b in zip(runs[0][2], runs[1][2]))
