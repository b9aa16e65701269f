"""Update compression (``fedml_tpu_torch/core/compression.py`` and
``cfg.compress`` in the FedAvg round) against the JAX package's
``fedml_tpu/core/compression.py`` and ``FedAvgAPI._compress_transform``.

Top-k is compared element for element (its selection, values and
residual); the stochastic quantizer bit for bit given JAX's own uniform
draws (``jax.random.bernoulli(key, p)`` is ``uniform(key, p.shape) < p``),
since the port draws from ``core/keys.py`` and not threefry. The q8
rounds are held to the 255-level grid and to the unquantized round's
mean; the topk0.05 rounds to JAX's within 1e-5, on data where each client
holds copies of one sample (the port's shuffle bits cannot matter)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algos.config import FedConfig as JaxFedConfig
from fedml_tpu.algos.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.core import compression as jc
from fedml_tpu.data import batching as jax_batching
from fedml_tpu.models.lr import LogisticRegression as JaxLogisticRegression
from fedml_tpu_torch.algos import (FedAvgAPI, FedAvgRobustAPI, FedConfig,
                                   ScaffoldAPI, TurboAggregateAPI)
from fedml_tpu_torch.convert import from_jax_params, to_jax_params
from fedml_tpu_torch.core import compression as tc
from fedml_tpu_torch.core import keys
from fedml_tpu_torch.data import build_federated_arrays
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.trainer.local import NetState

# The compressed rounds against JAX's (f32 LR, other summation orders).
ROUND_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- the functions ------------------------------------------------------------

def test_vector_tree_round_trip_matches_jax():
    """A nested tree built with sorted keys flattens to JAX's vector, and
    back to the same structure, shapes and dtypes (a bf16 leaf stays
    bf16)."""
    rng = np.random.RandomState(0)
    a = rng.randn(2, 3).astype(np.float32)
    c = rng.randn(4).astype(np.float32)
    tree = {"a": torch.from_numpy(a),
            "b": {"c": torch.from_numpy(c).bfloat16(),
                  "d": torch.tensor(2.5)}}
    jtree = {"a": jnp.asarray(a),
             "b": {"c": jnp.asarray(c).astype(jnp.bfloat16),
                   "d": jnp.float32(2.5)}}
    vec = tc.tree_to_vector(tree)
    np.testing.assert_array_equal(vec.numpy(),
                                  np.asarray(jc.tree_to_vector(jtree)))
    back = tc.vector_to_tree(vec, tc.tree_spec(tree))
    assert list(back) == ["a", "b"] and list(back["b"]) == ["c", "d"]
    assert back["b"]["c"].dtype == torch.bfloat16
    assert back["b"]["d"].shape == ()
    for x, y in zip((back["a"], back["b"]["c"], back["b"]["d"]),
                    (tree["a"], tree["b"]["c"], tree["b"]["d"])):
        assert torch.equal(x, y)
    assert tc.tree_to_vector({}).shape == (0,)


@pytest.mark.parametrize("k", [1, 7, 100])
def test_topk_matches_jax(k):
    """The kept set, its values, the residual and the decompressed vector
    equal JAX's (``lax.top_k`` of |v|)."""
    v = np.random.RandomState(k).randn(100).astype(np.float32)
    values, idx, residual = tc.topk_compress(torch.from_numpy(v), k)
    jvalues, jidx, jresidual = jc.topk_compress(jnp.asarray(v), k)
    assert set(idx.tolist()) == set(np.asarray(jidx).tolist())
    order = np.argsort(idx.numpy())
    jorder = np.argsort(np.asarray(jidx))
    np.testing.assert_array_equal(values.numpy()[order],
                                  np.asarray(jvalues)[jorder])
    np.testing.assert_array_equal(residual.numpy(), np.asarray(jresidual))
    np.testing.assert_array_equal(
        tc.topk_decompress(values, idx, 100).numpy(),
        np.asarray(jc.topk_decompress(jvalues, jidx, 100)))


@pytest.mark.parametrize("bits", [2, 4, 8, 12, 16])
def test_quantize_bit_equal_given_jax_draws(bits):
    """Given JAX's uniform draws, the levels, their dtype and the scale
    equal JAX's bit for bit, and so does the dequantized vector."""
    v = (np.random.RandomState(bits).randn(333) * 0.01).astype(np.float32)
    key = jax.random.PRNGKey(bits)
    jq, jscale = jc.quantize_stochastic(jnp.asarray(v), bits, key)
    u = np.array(jax.random.uniform(key, v.shape, jnp.float32))
    q, scale = tc.quantize_stochastic(torch.from_numpy(v), bits, None,
                                      uniform=torch.from_numpy(u))
    assert str(q.dtype).split(".")[-1] == str(jq.dtype)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale)
    np.testing.assert_array_equal(tc.dequantize(q, scale).numpy(),
                                  np.asarray(jc.dequantize(jq, jscale)))


def test_quantizer_is_unbiased_and_bounded():
    """The port's own draws: every dequantized entry within one level of
    the input, and the mean of 200 draws within 0.3 levels (JAX's
    test_quantizer_is_unbiased_and_bounded)."""
    vec = torch.from_numpy(np.random.RandomState(0).randn(512)
                           .astype(np.float32))
    deqs = []
    for s in range(200):
        q, scale = tc.quantize_stochastic(vec, 4, keys.key(s))
        assert q.dtype == torch.int8
        deq = tc.dequantize(q, scale)
        assert float((deq - vec).abs().max()) <= float(scale) + 1e-6
        deqs.append(deq)
    err = torch.stack(deqs).mean(0) - vec
    assert float(err.abs().max()) < 0.3 * float(scale)
    with pytest.raises(ValueError, match="bits"):
        tc.quantize_stochastic(vec, 1, keys.key(0))


@pytest.mark.parametrize("name", ["none", "", "topk0.05", "topk1e-05",
                                  "topk1.0", "q8", "q16", "zip", "topk1.5",
                                  "topk", "qx", "q1", "q17"])
def test_make_compressor_parsing_matches_jax(name):
    """Every name parses to the codec JAX's parses to (its name, ratio or
    bits), or is refused as JAX refuses it."""
    try:
        want = jc.make_compressor(name)
    except ValueError:
        with pytest.raises(ValueError):
            tc.make_compressor(name)
        return
    got = tc.make_compressor(name)
    assert type(got).__name__ == type(want).__name__
    assert got.name == want.name
    assert getattr(got, "ratio", None) == getattr(want, "ratio", None)
    assert getattr(got, "bits", None) == getattr(want, "bits", None)
    assert tc.make_compressor(got.name).name == got.name


def test_codecs_round_trip_and_error_feedback():
    """Top-k with error feedback transmits the whole signal over rounds
    (JAX's test_topk_error_feedback_recovers_signal); the quantizing codec
    decodes within one level per leaf, with int8 payloads."""
    comp = tc.TopKCompression(0.25)
    update = {"w": torch.tensor([1.0, 0.6, 0.3, 0.1])}
    spec = tc.tree_spec(update)
    state, received = None, torch.zeros(4)
    for r in range(24):
        payload, state = comp.encode(update, state, keys.key(r))
        assert payload["idx"].dtype == np.int32
        received = received + tc.tree_to_vector(comp.decode(payload, spec))
    target = 24 * tc.tree_to_vector(update)
    assert float((received - target).abs().max()) <= 2.0 + 1e-6
    assert float(received.abs().min()) > 0.0
    q = tc.QuantizeCompression(8)
    g = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn(5, 3, generator=g),
            "b": {"c": torch.randn(7, generator=g)}}
    payload, st = q.encode(tree, "kept", keys.key(1))
    assert st == "kept" and all(p.dtype == np.int8 for p in payload["qs"])
    back = q.decode(payload, tc.tree_spec(tree))
    for leaf, got, scale in ((tree["a"], back["a"], payload["scales"][0]),
                             (tree["b"]["c"], back["b"]["c"],
                              payload["scales"][1])):
        assert float((leaf - got).abs().max()) <= scale + 1e-6


# --- compress in the round ---------------------------------------------------------

def _replicated_task(counts=(5, 9, 13, 3, 17, 8), seed=0):
    """Client i holds ``counts[i]`` copies of one sample with one label."""
    rng = np.random.RandomState(seed)
    protos = rng.randn(len(counts), 10).astype(np.float32)
    labels = rng.randint(0, 4, len(counts)).astype(np.int32)
    x = np.concatenate([np.repeat(protos[i:i + 1], c, 0)
                        for i, c in enumerate(counts)])
    y = np.concatenate([np.full(c, labels[i], np.int32)
                        for i, c in enumerate(counts)])
    edges = np.concatenate([[0], np.cumsum(counts)])
    return x, y, {i: np.arange(edges[i], edges[i + 1])
                  for i in range(len(counts))}


def _cfg(**kw):
    return dict(client_num_in_total=6, client_num_per_round=4,
                comm_round=3, epochs=2, batch_size=4, lr=0.1,
                frequency_of_the_test=100, **kw)


def _lr_model(seed=0):
    return create_model("lr", in_features=10, num_classes=4, device="cpu",
                        generator=torch.Generator().manual_seed(seed))


def _api(cls=FedAvgAPI, **kw):
    x, y, parts = _replicated_task()
    return cls(_lr_model(), build_federated_arrays(x, y, parts, 4,
                                                   device="cpu"),
               None, FedConfig(**_cfg(**kw)), device="cpu")


def test_topk_ratio_one_is_plain_fedavg():
    """``topk1.0`` keeps every entry at the client's own value: 3 rounds
    bit-equal to plain FedAvg, params and losses."""
    plain, full = _api(), _api(compress="topk1.0")
    la = [plain.train_one_round(r)["train_loss"] for r in range(3)]
    lb = [full.train_one_round(r)["train_loss"] for r in range(3)]
    assert la == lb
    for k in plain.net.params:
        assert torch.equal(plain.net.params[k], full.net.params[k])


def test_topk_rounds_match_jax():
    """2 ``topk0.05`` rounds from JAX's start weights: params within 1e-5 of
    JAX's, losses within 1e-5; each client's applied delta keeps
    round(0.05 · 44) = 2 entries."""
    x, y, parts = _replicated_task()
    cfg = _cfg(compress="topk0.05")
    japi = JaxFedAvgAPI(JaxLogisticRegression(num_classes=4),
                        jax_batching.build_federated_arrays(x, y, parts, 4),
                        None, JaxFedConfig(**cfg))
    api = FedAvgAPI(_lr_model(), build_federated_arrays(x, y, parts, 4,
                                                        device="cpu"),
                    None, FedConfig(**cfg), device="cpu")
    api.net = NetState(from_jax_params(jax.tree.map(
        np.asarray, japi.net.params))[0], {})
    la = [api.train_one_round(r)["train_loss"] for r in range(2)]
    lb = [japi.train_one_round(r)["train_loss"] for r in range(2)]
    np.testing.assert_allclose(la, lb, rtol=0, atol=ROUND_TOL)
    for a, b in zip(jax.tree.leaves(to_jax_params(api.net.params)),
                    jax.tree.leaves(jax.tree.map(np.asarray,
                                                 japi.net.params))):
        np.testing.assert_allclose(a, b, rtol=0, atol=ROUND_TOL)
    transform = api._client_transform()
    g = api.net
    gen = torch.Generator().manual_seed(0)
    c = NetState({k: v + torch.randn(v.shape, generator=gen)
                  for k, v in g.params.items()}, {})
    out = transform(g, c)
    changed = sum(int((out.params[k] != g.params[k]).sum())
                  for k in g.params)
    assert changed == 2


def test_q8_rounds_on_the_grid_and_unbiased():
    """``q8``: each client's applied delta lies on its 255-level grid
    (an integer multiple of max|delta| / 127, within f32 rounding); the
    round's average over 64 round keys approaches the unquantized round
    (JAX's test_simulator_qsgd_rounds_unbiased_and_trainable, at 4 bits
    where a draw's error is visible); 2 q8 rounds train."""
    api = _api(compress="q8")
    transform = api._client_transform()
    assert transform.wants_rng
    g = api.net
    gen = torch.Generator().manual_seed(0)
    for s in range(4):
        c = NetState({k: v + 0.1 * torch.randn(v.shape, generator=gen)
                      for k, v in g.params.items()}, {})
        out = transform(g, c, keys.key(s))
        delta = tc.tree_to_vector(out.params) - tc.tree_to_vector(g.params)
        raw = tc.tree_to_vector(c.params) - tc.tree_to_vector(g.params)
        scale = raw.abs().max() / 127
        levels = delta / scale
        assert float((levels - levels.round()).abs().max()) < 1e-3
        assert float(levels.abs().max()) <= 127 + 1e-3
    ref, q4 = _api(), _api(compress="q4")
    fed = ref.train_fed
    w = fed.counts.float()
    ref_avg, _ = ref.round_fn(ref.net, fed.x, fed.y, fed.mask, w, w,
                              keys.key(7))
    ref_vec = tc.tree_to_vector(ref_avg.params)
    draws = torch.stack([tc.tree_to_vector(q4.round_fn(
        q4.net, fed.x, fed.y, fed.mask, w, w, keys.key(7 + 1000 * s))[0]
        .params) for s in range(64)])
    per_draw = (draws - ref_vec).abs().amax(1).mean()
    assert float((draws.mean(0) - ref_vec).abs().max()) < 0.3 * float(
        per_draw)
    losses = [api.train_one_round(r)["train_loss"] for r in range(2)]
    assert np.isfinite(losses).all()


def test_compress_guards_match_jax():
    """The JAX package's guards (``tests/test_compression.py``): bad names
    and ratios at construction; robust clipping refuses compression;
    SCAFFOLD's corrected step and TurboAggregate's MPC bypass the
    transform and refuse it."""
    for name, match in (("zip", "q<bits>"), ("qx", "q<bits>"),
                        ("topk1.5", "ratio"), ("topk", "topk"),
                        ("q1", "bits")):
        with pytest.raises(ValueError, match=match):
            _api(compress=name)
    with pytest.raises(ValueError, match="clip"):
        _api(FedAvgRobustAPI, compress="topk0.1")
    for cls in (ScaffoldAPI, TurboAggregateAPI):
        with pytest.raises(ValueError, match="compress"):
            _api(cls, compress="topk0.1")
