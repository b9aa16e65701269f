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
])
def test_flash_kernel_matches_plain_twin(cuda, dtype, t, h, d, causal):
    """The kernel against the f32 twin on the same inputs: o within 2e-2
    (bf16: the kernel rounds P to bf16 before P·V) or 1e-4 (f32), lse
    within 1e-3; ragged T and every head dim included."""
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


def test_flash_kernel_reads_strided_views(cuda):
    """q, k, v as views into one [B, T, 3·H·D] buffer (what MHA passes):
    no copy, same result as contiguous inputs."""
    g = torch.Generator(device=cuda).manual_seed(1)
    qkv = torch.randn(2, 300, 3 * 4 * 32, device=cuda, generator=g)
    q, k, v = (z.reshape(2, 300, 4, 32) for z in qkv.split(128, dim=-1))
    o, lse = flash_attention(q, k, v, causal=True)
    co, clse = flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=True)
    assert torch.equal(o, co) and torch.equal(lse, clse)


def test_flash_kernel_refuses_a_strided_head_dim(cuda):
    q = torch.zeros(1, 8, 2, 64, device=cuda)[..., ::2]  # stride 2 in D
    with pytest.raises(RuntimeError, match="contiguous"):
        flash_attention(q, q, q)


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
