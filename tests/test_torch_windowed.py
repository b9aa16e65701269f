"""The port's windowed tier (``FedAvgAPI.train_rounds_windowed`` and
``train_windowed``) and the capability records behind it.

- ``plan_window_spans`` and ``eval_segments`` against the JAX package's;
- for every class of the zoo that rides the tier — FedAvg, FedOpt, FedAc,
  ServerAvg, FedNova, FedAvgRobust with its attack drill and its noise,
  SCAFFOLD, FedDyn, Ditto, FedBN and FedAdapter — windowed rounds
  bit-equal to the host loop's (``train_one_round``) on a power-law
  store: the params, the carry and the losses, with a window that does
  not divide the round count and windows whose rounds have different
  step buckets;
- ``train_windowed``'s history against ``train``'s;
- the port's ``render_matrix`` against JAX's, row for row;
- the refusals, each with JAX's words: the windowed tier over a resident
  layout, the on-device tier over a store, ``pow_d``/``oort`` on the
  windowed tier, and the classes that sit the tier out.

On the CPU the captured steps run eagerly; their capture per bucket is
tested on the card (``tests/test_torch_cuda.py``)."""

from functools import partial

import numpy as np
import pytest
import torch

from fedml_tpu.algos import capability as jax_capability
from fedml_tpu.algos.config import FedConfig as JaxFedConfig
from fedml_tpu.algos.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.algos.fedavg import plan_window_spans as jax_plan
from fedml_tpu.algos.loop import eval_segments as jax_eval_segments
from fedml_tpu.data import batching as jax_batching
from fedml_tpu.data import store as jax_store
from fedml_tpu.models.lr import LogisticRegression as JaxLogisticRegression
from fedml_tpu_torch.algos import (DittoAPI, FedAdapterAPI, FedAvgAPI,
                                   FedAvgRobustAPI, FedBNAPI, FedConfig,
                                   FedDynAPI, FedNovaAPI, FedOptAPI,
                                   ScaffoldAPI)
from fedml_tpu_torch.algos.capability import (record_for, refusal,
                                              render_matrix)
from fedml_tpu_torch.algos.fedac import FedAcAPI, ServerAvgAPI
from fedml_tpu_torch.algos.fedavg import plan_window_spans
from fedml_tpu_torch.algos.loop import eval_segments
from fedml_tpu_torch.core.tree import tree_leaves
from fedml_tpu_torch.data import build_federated_arrays, store
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.trainer.local import NetState, seq_softmax_ce


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


COUNTS = (130, 17, 0, 30, 12, 25, 8, 21, 3, 0, 64, 5)


def _power_law(counts=COUNTS, d=4, seed=0):
    """A giant client (bucket 64 at batch 4), two empty ones, ragged
    tails: the rounds of one window fall in different buckets."""
    rng = np.random.RandomState(seed)
    tot = int(sum(counts))
    x = rng.randn(tot, d).astype(np.float32)
    y = rng.randint(0, 5, tot).astype(np.int32)
    edges = np.concatenate([[0], np.cumsum(counts)])
    return x, y, {c: np.arange(edges[c], edges[c + 1])
                  for c in range(len(counts))}


def _cfg(rounds=7, **kw):
    base = dict(client_num_in_total=len(COUNTS), client_num_per_round=4,
                comm_round=rounds, epochs=1, batch_size=4, lr=0.1,
                frequency_of_the_test=1000)
    base.update(kw)
    return FedConfig(**base)


def _lr_api(cls, fed=None, rounds=7, **kw):
    x, y, parts = _power_law()
    fed = fed or store.FederatedStore(x, y, parts, 4, device="cpu")
    cfg = _cfg(rounds, **{k: kw.pop(k) for k in list(kw)
                          if k in FedConfig.__dataclass_fields__})
    model = create_model("lr", in_features=4, num_classes=5, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    return cls(model, fed, None, cfg, device="cpu", **kw)


V, T = 16, 8


def _token_api(cls, rounds=7, **kw):
    """A tiny ``transformer_lm`` (LayerNorms for FedBN; adapters for
    FedAdapter) over a power-law store of token sequences."""
    rng = np.random.RandomState(0)
    counts = (40, 3, 0, 9, 14, 6, 22, 1, 8, 11, 5, 17)
    seqs = rng.randint(1, V, size=(sum(counts), T + 1))
    edges = np.concatenate([[0], np.cumsum(counts)])
    parts = {c: np.arange(edges[c], edges[c + 1])
             for c in range(len(counts))}
    fed = store.FederatedStore(seqs[:, :T], seqs[:, 1:], parts, 4,
                               device="cpu")
    mkw = dict(vocab_size=V, d_model=16, n_heads=2, n_layers=1, max_len=T)
    if cls is FedAdapterAPI:
        mkw.update(adapter_rank=2, adapter_scope="attn")
    model = create_model("transformer_lm", device="cpu",
                         generator=torch.Generator().manual_seed(0), **mkw)
    cfg = _cfg(rounds, adapter_rank=2 if cls is FedAdapterAPI else 0)
    return cls(model, fed, None, cfg, loss_fn=partial(seq_softmax_ce,
                                                      pad_id=0),
               device="cpu", **kw)


def _state(api):
    """The params, the model state and the carry's leaves."""
    out = tree_leaves(api.net.params) + tree_leaves(api.net.model_state)

    def walk(e):
        if e is None:
            return
        if isinstance(e, NetState):
            out.extend(tree_leaves(e.params) + tree_leaves(e.model_state))
        elif isinstance(e, (tuple, list)):
            for part in e:
                walk(part)
        else:
            out.extend(tree_leaves(e))

    walk(api._window_carry_init())
    return out


# --- the planners -------------------------------------------------------------

def test_plan_window_spans_and_eval_segments_match_jax():
    rng = np.random.RandomState(0)
    for n in range(0, 13):
        buckets = [int(b) for b in 2 ** rng.randint(0, 5, n)]
        for window in (1, 3, 4, 16):
            assert plan_window_spans(buckets, window) == \
                jax_plan(buckets, window)
    with pytest.raises(ValueError, match="window must be >= 1"):
        plan_window_spans([1], 0)
    for rounds, freq, start in ((10, 3, 0), (10, 1, 0), (7, 100, 0),
                                (9, 4, 2), (1, 5, 0)):
        assert list(eval_segments(rounds, freq, start)) == \
            list(jax_eval_segments(rounds, freq, start))


# --- windowed = host loop, bit for bit ------------------------------------------

_CASES = {
    "fedavg": lambda: _lr_api(FedAvgAPI),
    "fedopt": lambda: _lr_api(FedOptAPI, server_optimizer="adam",
                              server_lr=0.05),
    "fedac": lambda: _lr_api(FedAcAPI, gamma=2.0),
    "serveravg": lambda: _lr_api(ServerAvgAPI, avg_coef=0.5),
    "fednova": lambda: _lr_api(FedNovaAPI),
    "robust": lambda: _lr_api(
        FedAvgRobustAPI, aggregator="coord_median", robust_norm_bound=0.5,
        robust_stddev=0.01, corrupt_mode="scale", corrupt_scale=3.0,
        attack_freq=2, attack_num_adversaries=2),
    "scaffold": lambda: _lr_api(ScaffoldAPI),
    "feddyn": lambda: _lr_api(FedDynAPI, alpha=0.05),
    "ditto": lambda: _lr_api(DittoAPI, lam=0.1),
    "fedbn": lambda: _token_api(FedBNAPI),
    "fedadapter": lambda: _token_api(FedAdapterAPI),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_windowed_rounds_equal_the_host_loop(case):
    """7 rounds at window 3 (two windows and a remainder round through the
    fused host round) against 7 ``train_one_round`` calls from one start:
    params, model state, carry and losses bit-equal. Each window runs at
    its largest bucket while most of its rounds need less."""
    host, win = _CASES[case](), _CASES[case]()
    assert record_for(type(win)).windowed
    want = [host.train_one_round(r)["train_loss"] for r in range(7)]
    got = win.train_rounds_windowed(7, window=3)
    assert got == want
    assert win._window_stats == {"windows": 2, "scanned_rounds": 6,
                                 "host_rounds": 1}
    store_ = win.train_fed
    buckets = [store_.cohort_steps(win.sample_round(r)) for r in range(6)]
    assert len(set(buckets)) > 1
    for a, b in zip(_state(host), _state(win)):
        assert torch.equal(a, b)
    # And on from there: the carry was committed after each window.
    assert win.train_rounds_windowed(3, start_round=7, window=3) == \
        [host.train_one_round(r)["train_loss"] for r in range(7, 10)]
    for a, b in zip(_state(host), _state(win)):
        assert torch.equal(a, b)


def test_robust_drill_reaches_the_windowed_rounds():
    """The attack drill's ``[W, C]`` adversary mask is a sliced operand:
    without it (``corrupt_mode="none"``) the same windowed rounds end
    elsewhere, and the mask is 1 at the adversaries' slots (both of them
    in the attack rounds)."""
    armed = _CASES["robust"]()
    idx2d = np.stack([armed.sample_round(r) for r in range(4)])
    (mask,) = armed._window_scan_extras(0, idx2d)
    assert mask.shape == (4, 4)
    np.testing.assert_array_equal(
        mask.numpy(), np.isin(idx2d, armed.adversary_clients))
    assert mask[0].sum() == mask[2].sum() == 2
    quiet = _lr_api(FedAvgRobustAPI, aggregator="coord_median",
                    robust_norm_bound=0.5, robust_stddev=0.01,
                    attack_freq=2, attack_num_adversaries=2)
    armed.train_rounds_windowed(4, window=4)
    quiet.train_rounds_windowed(4, window=4)
    assert not all(torch.equal(a, b) for a, b in zip(
        tree_leaves(armed.net.params), tree_leaves(quiet.net.params)))


def test_train_windowed_history_equals_train():
    """``train_windowed`` splits at the eval rounds and gives ``train``'s
    history (losses and the eval's metrics) bit for bit."""
    x, y, parts = _power_law()
    test = (torch.as_tensor(x[:8]).view(2, 4, 4),
            torch.as_tensor(y[:8].astype(np.int64)).view(2, 4),
            torch.ones(2, 4))

    def api():
        a = _lr_api(FedAvgAPI, rounds=9, frequency_of_the_test=4)
        a.test_global = test
        return a

    assert api().train_windowed(window=2) == api().train()


# --- the records and their refusals --------------------------------------------

def test_render_matrix_equals_jax():
    """The port's algorithm x tier matrix, row for row, is JAX's: the
    protocol, the carry and the pipelined, fused, windowed and on-device
    columns, and the record-derived exclusions."""
    got, want = render_matrix(), jax_capability.render_matrix()
    assert got.splitlines() == want.splitlines()
    assert got.count("| ✓ |") and "FedNAS | round" in got


def _jax_store_api(**cfg_kw):
    x, y, parts = _power_law()
    cfg = dict(client_num_in_total=len(COUNTS), client_num_per_round=4,
               comm_round=3, epochs=1, batch_size=4, lr=0.1)
    cfg.update(cfg_kw)
    return JaxFedAvgAPI(JaxLogisticRegression(num_classes=5),
                        jax_store.FederatedStore(x, y, parts, 4), None,
                        JaxFedConfig(**cfg))


def _message(call):
    with pytest.raises(NotImplementedError) as exc:
        call()
    return str(exc.value)


def test_tier_refusals_use_jax_words():
    """The windowed tier over resident arrays, the on-device tier over a
    store and the windowed tier under loss-biased selection refuse with
    the JAX package's messages; the classes that sit the tier out with
    their record's."""
    x, y, parts = _power_law()
    resident = _lr_api(FedAvgAPI, build_federated_arrays(x, y, parts, 4,
                                                         device="cpu"))
    jres = JaxFedAvgAPI(JaxLogisticRegression(num_classes=5),
                        jax_batching.build_federated_arrays(x, y, parts, 4),
                        None, JaxFedConfig(
                            client_num_in_total=len(COUNTS),
                            client_num_per_round=4, epochs=1, batch_size=4))
    assert _message(lambda: resident.train_rounds_windowed(2)) == \
        _message(lambda: jres.train_rounds_windowed(2))
    assert _message(lambda: resident.train_windowed()) == \
        _message(lambda: jres.train_windowed())
    streamed, jstreamed = _lr_api(FedAvgAPI), _jax_store_api()
    assert _message(lambda: streamed.train_rounds_on_device(2)) == \
        _message(lambda: jstreamed.train_rounds_on_device(2))
    for sel in ("pow_d", "oort"):
        api = _lr_api(FedAvgAPI)
        api.cfg.client_selection = sel
        japi = _jax_store_api(client_selection=sel)
        msg = _message(lambda: api.train_rounds_windowed(2))
        assert msg == _message(lambda: japi.train_rounds_windowed(2))
        assert "only seeded-random selection permits" in msg
    from fedml_tpu.algos.hierarchical import \
        HierarchicalFedAvgAPI as JaxHierarchical
    from fedml_tpu_torch.algos.hierarchical import HierarchicalFedAvgAPI
    assert refusal(HierarchicalFedAvgAPI, "train_rounds_windowed") \
        .startswith("HierarchicalFedAvgAPI opts out of the carry protocol")
    assert JaxHierarchical.window_exclusion in refusal(
        HierarchicalFedAvgAPI, "train_rounds_windowed")


def test_a_class_without_streaming_is_refused_a_store():
    """A subclass that declares ``supports_streaming = False`` is refused a
    store at construction with JAX's words, and its record refuses the
    windowed tier with JAX's reason."""

    class Resident(FedAvgAPI):
        supports_streaming = False

    class JaxResident(JaxFedAvgAPI):
        supports_streaming = False

    with pytest.raises(NotImplementedError) as exc:
        _lr_api(Resident)
    x, y, parts = _power_law()
    with pytest.raises(NotImplementedError) as jexc:
        JaxResident(JaxLogisticRegression(num_classes=5),
                    jax_store.FederatedStore(x, y, parts, 4), None,
                    JaxFedConfig(client_num_in_total=len(COUNTS),
                                 batch_size=4))
    assert str(exc.value) == str(jexc.value).replace("JaxResident",
                                                     "Resident")
    want = jax_capability.refusal(JaxResident, "train_rounds_windowed")
    assert refusal(Resident, "train_rounds_windowed") == \
        want.replace("JaxResident", "Resident")
