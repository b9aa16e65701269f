"""The port's synthetic generators (``fedml_tpu_torch/data/synthetic.py``)
against the JAX package's, and FedAvg over the StackOverflow-NWP law.

- each of the eight generators byte-equal to ``fedml_tpu.data.synthetic``'s
  at two seeds: the StackOverflow shard under both token laws (the
  ``"dialect"`` law with a group offset and ``count_scale``), the flat
  federation built from it, and the refusals of an unknown law and of an
  active vocabulary that does not fit;
- 3 FedAvg rounds over a narrow ``RNNStackOverflow`` from a
  ``FederatedStore`` of ``make_stackoverflow_nwp(64, ...)`` against JAX's
  rounds from its own store, within 1e-5 (one batch a client, so the two
  packages' shuffle bits only reorder a batch).
"""

from functools import partial

import jax
import numpy as np
import pytest

from fedml_tpu.algos.config import FedConfig as JaxFedConfig
from fedml_tpu.algos.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.data import store as jax_store
from fedml_tpu.data import synthetic as jsyn
from fedml_tpu.models.rnn import RNNStackOverflow as JaxRNNStackOverflow
from fedml_tpu.trainer.local import seq_softmax_ce as jax_seq_softmax_ce
from fedml_tpu_torch.algos import FedAvgAPI, FedConfig
from fedml_tpu_torch.convert import from_jax_params, to_jax_params
from fedml_tpu_torch.data import store
from fedml_tpu_torch.data import synthetic as tsyn
from fedml_tpu_torch.models.rnn import RNNStackOverflow
from fedml_tpu_torch.trainer.local import NetState, seq_softmax_ce

SEEDS = (0, 7)

# name: (generator name, kwargs) — small client counts only.
CASES = {
    "classification": ("make_classification", dict(n_samples=50)),
    "image_classification": ("make_image_classification",
                             dict(n_samples=20, hwc=(8, 8, 3))),
    "segmentation": ("make_segmentation",
                     dict(n_samples=6, hw=(16, 16), n_classes=5)),
    "alpha_beta": ("synthetic_alpha_beta",
                   dict(alpha=0.5, beta=0.5, n_clients=12, n_features=10)),
    "so_shard_uniform": ("make_stackoverflow_shard",
                         dict(n_clients=40, seq_len=6, vocab=50)),
    "so_shard_dialect": ("make_stackoverflow_shard",
                         dict(n_clients=40, seq_len=6, vocab=50,
                              law="dialect", kgroup=4, active_tokens=12,
                              dialect_seed=3, group_offset=5,
                              count_scale=2)),
    "so_nwp_uniform": ("make_stackoverflow_nwp",
                       dict(n_clients=30, seq_len=5, vocab=40)),
    "so_nwp_dialect": ("make_stackoverflow_nwp",
                       dict(n_clients=30, seq_len=5, vocab=40,
                            law="dialect", active_tokens=9, peak=0.7)),
    "hetero_charlm": ("make_hetero_charlm",
                      dict(n_clients=20, seq_len=7, vocab=30, kgroup=4)),
    "femnist_shaped": ("make_femnist_shaped",
                       dict(n_clients=10, n_classes=7, per=5, maxper=8,
                            n_test=20)),
}


def _same(got, want):
    """Byte-equal: same types, dtypes, shapes and bytes, through tuples
    and client-index dicts."""
    assert type(got) is type(want)
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b)
    elif isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _same(got[k], want[k])
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_generator_byte_equal_to_jax(case, seed):
    name, kw = CASES[case]
    _same(getattr(tsyn, name)(seed=seed, **kw),
          getattr(jsyn, name)(seed=seed, **kw))


def test_stackoverflow_laws_share_counts_and_refuse_as_jax():
    """The two token laws draw the same per-client counts at one seed
    (``count_scale`` scales them), and both packages refuse an unknown law
    and an active vocabulary outside [1, vocab) with the same words."""
    kw = dict(n_clients=25, seq_len=4, vocab=30, seed=3)
    _, _, uni = tsyn.make_stackoverflow_shard(**kw)
    _, _, dia = tsyn.make_stackoverflow_shard(law="dialect",
                                              active_tokens=10, **kw)
    _, _, scaled = tsyn.make_stackoverflow_shard(count_scale=3, **kw)
    np.testing.assert_array_equal(uni, dia)
    np.testing.assert_array_equal(scaled, 3 * uni)
    for bad in (dict(law="zipf"), dict(law="dialect", active_tokens=30)):
        with pytest.raises(ValueError) as got:
            tsyn.make_stackoverflow_shard(**kw, **bad)
        with pytest.raises(ValueError) as want:
            jsyn.make_stackoverflow_shard(**kw, **bad)
        assert str(got.value) == str(want.value)


def test_stackoverflow_fedavg_rounds_from_a_store_match_jax():
    """3 rounds of FedAvg over ``RNNStackOverflow`` (vocab 40, embed 8,
    LSTM 16) from a ``FederatedStore`` of ``make_stackoverflow_nwp(64,
    seq_len=6, vocab=40)``, 8 clients a round, batch 64 (every client one
    step), sgd lr 10^-0.5, ``seq_softmax_ce`` at pad id 0, from one start:
    the losses and the params within 1e-5 of JAX's, and the params
    moved."""
    vocab, t, n, batch = 40, 6, 64, 64
    x, y, parts = tsyn.make_stackoverflow_nwp(n, seq_len=t, vocab=vocab)
    assert max(len(p) for p in parts.values()) <= batch
    cfg = dict(client_num_in_total=n, client_num_per_round=8, comm_round=3,
               epochs=1, batch_size=batch, lr=10 ** -0.5,
               frequency_of_the_test=1000)
    jmodel = JaxRNNStackOverflow(vocab_size=vocab, embedding_dim=8,
                                 hidden_size=16)
    japi = JaxFedAvgAPI(jmodel, jax_store.FederatedStore(x, y, parts, batch),
                        None, JaxFedConfig(**cfg),
                        loss_fn=partial(jax_seq_softmax_ce, pad_id=0),
                        pad_id=0)
    start = jax.tree.map(np.asarray, japi.net.params)
    model = RNNStackOverflow(vocab_size=vocab, embedding_dim=8,
                             hidden_size=16)
    api = FedAvgAPI(model, store.FederatedStore(x, y, parts, batch,
                                                device="cpu"),
                    None, FedConfig(**cfg),
                    loss_fn=partial(seq_softmax_ce, pad_id=0), pad_id=0,
                    device="cpu")
    api.net = NetState(from_jax_params(start)[0], {})
    for r in range(3):
        got = api.train_one_round(r)["train_loss"]
        want = japi.train_one_round(r)["train_loss"]
        assert np.isfinite(got)
        assert got == pytest.approx(want, rel=1e-5, abs=1e-5), r
    moved = max(np.abs(np.asarray(a) - b).max() for a, b in zip(
        jax.tree.leaves(japi.net.params), jax.tree.leaves(start)))
    assert moved > 1e-3
    for a, b in zip(jax.tree.leaves(to_jax_params(api.net.params)),
                    jax.tree.leaves(japi.net.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=1e-5)
