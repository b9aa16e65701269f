"""The port's transformer LM, adapters and weight converter against the
JAX package (fedml_tpu.models.transformer / adapter, comm.codec), plus the
port's isolation from JAX and its refusal to run on the CPU unasked.

Weights come from the flax init, are perturbed with numpy from a seed (so
LoRA B is non-zero), and reach the port through ``from_jax_params``."""

import os
import re
import subprocess
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fedml_tpu.comm.codec import tree_to_vector_np as jax_tree_to_vector
from fedml_tpu.models.adapter import split_frozen as jax_split_frozen
from fedml_tpu.models.registry import create_model as jax_create_model
from fedml_tpu.trainer.local import NetState, model_fns
from fedml_tpu_torch.convert import from_jax_params, to_jax_params
from fedml_tpu_torch.core.flat import (tree_spec, tree_to_vector_np,
                                       vector_to_tree_np)
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models.adapter import merge_params, split_frozen
from fedml_tpu_torch.models.transformer import (_layer_norm, lora_delta,
                                                lora_delta_batched)

V, T = 61, 64
PKG = os.path.join(os.path.dirname(__file__), "..", "fedml_tpu_torch")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes at once; torch's own
    thread pool per process would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(rank, scope, attn, dtype=None):
    return dict(vocab_size=V, d_model=32, n_heads=2, n_layers=2, max_len=128,
                adapter_rank=rank, adapter_scope=scope, attn=attn,
                dtype=dtype)


def _jax_params(rank, scope, attn="dense", dtype=None, seed=1):
    """(flax module, perturbed param tree as numpy)."""
    model = jax_create_model("transformer_lm", **_kw(rank, scope, attn, dtype))
    net = model_fns(model).init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 8), jnp.int32))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda x: np.asarray(x) + rng.normal(0, 0.05, x.shape)
        .astype(np.float32), net.params)
    return model, params


def _toks(b=2, t=T, seed=0):
    return np.random.RandomState(seed).randint(0, V, (b, t)).astype(np.int32)


def _both(rank, scope, attn, dtype=None):
    model, params = _jax_params(rank, scope, dtype=dtype)
    jax_model = jax_create_model("transformer_lm",
                                 **_kw(rank, scope, attn, dtype))
    toks = _toks()
    want, _ = model_fns(jax_model).apply(NetState(params, {}),
                                         jnp.asarray(toks))
    state, adapters = from_jax_params(params)
    port = create_model("transformer_lm", device="cpu",
                        **_kw(rank, scope, attn, dtype))
    port.load_state_dict(state)
    got = port(torch.as_tensor(toks, dtype=torch.long),
               adapters if rank else None)
    return np.asarray(want), got


@pytest.mark.parametrize("attn", ["dense", "flash"])
@pytest.mark.parametrize("rank,scope", [(0, "attn"), (2, "attn"),
                                        (2, "mlp"), (2, "all")])
def test_forward_matches_jax_f32(attn, rank, scope):
    """f32 logits within atol 1e-4 (GEMM blocking differs between XLA and
    torch on the CPU: last-ulp differences through 2 layers)."""
    want, got = _both(rank, scope, attn)
    assert got.dtype == torch.float32 and got.shape == (2, T, V)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_forward_matches_jax_bf16(attn):
    """bf16 compute, f32 head: logits within atol 0.1 (|logits| ≤ ~4 here,
    where a bf16 ulp is 2^-6; the two frameworks round at different
    points, measured gap ~3 ulps)."""
    want, got = _both(2, "all", attn, dtype="bf16")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=0.1, rtol=0)


def test_flat_adapter_vector_bitwise_equals_jax():
    """The converted adapters flatten to JAX's tree_to_vector_np bit for
    bit (leaf order: keys sorted as strings, Block_10 < Block_2); and a
    JAX-written row decodes to the converted tree."""
    model = jax_create_model("transformer_lm", **{**_kw(2, "all", "dense"),
                                                 "n_layers": 11})
    net = model_fns(model).init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 4), jnp.int32))
    params = jax.tree.map(np.asarray, net.params)
    _, jax_adapters = jax_split_frozen(params)
    want = jax_tree_to_vector(jax_adapters)
    _, adapters = from_jax_params(params)
    got = tree_to_vector_np(adapters)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    spec = tree_spec(adapters)
    assert spec.paths[0][0] == "Block_0" and spec.paths[-1][0] == "Block_9"
    back = vector_to_tree_np(want, spec)
    for (pa, a), (pb, b) in zip(sorted(_leaves(back)),
                                sorted(_leaves(adapters))):
        assert pa == pb and np.array_equal(a, b.numpy())


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_converter_round_trip_and_state_dict_keys():
    _, params = _jax_params(2, "all")
    state, adapters = from_jax_params(params)
    assert state["Block_0.MHA_0.Dense_0.weight"].shape == (96, 32)
    assert state["Embed_1.weight"].shape == (128, 32)
    assert "Dense_0.bias" not in state  # the head has no bias
    port = create_model("transformer_lm", device="cpu",
                        **_kw(2, "all", "dense"))
    assert set(port.state_dict()) == set(state)
    back = to_jax_params(state, adapters)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert np.array_equal(a, b)


def test_split_frozen_merge_round_trip_matches_jax():
    _, params = _jax_params(2, "all")
    base, adapters = split_frozen(params)
    jbase, jadapters = jax_split_frozen(params)
    assert jax.tree.structure(base) == jax.tree.structure(jbase)
    assert jax.tree.structure(adapters) == jax.tree.structure(jadapters)
    merged = merge_params(base, adapters)
    assert jax.tree.structure(merged) == jax.tree.structure(params)
    with pytest.raises(ValueError, match="collide"):
        merge_params(base, {"Embed_0": {"embedding": 0}})


def test_model_adapter_shapes_match_flax_tree():
    _, params = _jax_params(3, "all")
    _, jadapters = jax_split_frozen(params)
    port = create_model("transformer_lm", device="cpu",
                        **_kw(3, "all", "dense"))
    fresh = port.init_adapters(torch.Generator().manual_seed(0))
    want = {p: np.shape(x) for p, x in _leaves(jadapters)}
    assert {p: tuple(x.shape) for p, x in _leaves(fresh)} == want
    assert all(not x.any() for p, x in _leaves(fresh) if p[-1].endswith("_b"))


def test_lora_delta_batched_slice_equals_single():
    rng = np.random.default_rng(1)
    a, b, x = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               for s in ((16, 4), (4, 8), (5, 16)))
    one = lora_delta(a, b, x, alpha=16.0, rank=4)
    bat = lora_delta_batched(a[None], b[None], x[None], alpha=16.0, rank=4)
    torch.testing.assert_close(bat[0], one, atol=1e-6, rtol=1e-6)


def test_gelu_is_the_tanh_approximation():
    """flax nn.gelu defaults to the tanh form; torch's default is erf."""
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    want = np.asarray(fnn.gelu(jnp.asarray(x)))
    got = F.gelu(torch.from_numpy(x), approximate="tanh").numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    erf = F.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - want).max() > 1e-4


def test_layer_norm_eps_is_flax_1e6():
    """A low-variance row where eps 1e-5 vs 1e-6 shows: the port's
    LayerNorm equals flax's."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 32)) * 1e-3).astype(np.float32)
    ln = fnn.LayerNorm()
    p = ln.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(ln.apply(p, jnp.asarray(x)))
    port = torch.nn.LayerNorm(32, eps=1e-6)
    got = _layer_norm(port, torch.from_numpy(x), None).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    torch_default = F.layer_norm(torch.from_numpy(x), (32,)).numpy()
    assert np.abs(torch_default - want).max() > 1e-2


def test_create_model_without_device_refuses_the_cpu(monkeypatch):
    """No CUDA and no explicit device='cpu': the entry point raises rather
    than quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_model("transformer_lm", **_kw(2, "all", "flash"))
    with pytest.raises(KeyError, match="unknown model"):
        create_model("nope", device="cpu")


def test_port_imports_without_jax():
    """Every module of fedml_tpu_torch imports with jax made unimportable,
    and no source line imports jax, flax, optax or fedml_tpu."""
    mods = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), PKG)
                mod = "fedml_tpu_torch." + rel[:-3].replace(os.sep, ".")
                mods.append(mod.replace(".__init__", ""))
    code = ("import sys\n"
            "for name in ('jax', 'flax', 'optax', 'fedml_tpu'):\n"
            "    sys.modules[name] = None\n"
            "import importlib\n"
            f"for m in {sorted(mods)!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok', len(sys.modules))\n")
    root = os.path.dirname(os.path.abspath(PKG))
    env = {**os.environ, "PYTHONPATH": root}
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(mods) >= 15
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|optax|fedml_tpu)\b")
    for root_dir, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root_dir, f)) as fh:
                    for line in fh:
                        assert not pat.match(line), (f, line)
