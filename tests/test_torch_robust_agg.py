"""The port's robust aggregation and attack drill — ``core/robust_agg``,
``core/robustness``, ``core/faults.UpdateCorruptor``, ``keys.normal`` and
``FedAvgRobustAPI`` — against the JAX package on the same seeded numpy
inputs: every aggregator at odd and even participant counts, with zero
weights, a tied Krum score and Krum's lone survivor, within 1e-6; every
``make_aggregator`` spec and error; the clip and the deterministic
corruptions; the forced adversary cohorts. The weak-DP noise and the
``random`` corruption draw from ``core/keys.py``, not threefry, so they
are held to their statistics, and the round tiers to each other."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algos.config import FedConfig as JaxFedConfig
from fedml_tpu.algos.robust import FedAvgRobustAPI as JaxFedAvgRobustAPI
from fedml_tpu.core import faults as jax_faults
from fedml_tpu.core import robust_agg as jax_agg
from fedml_tpu.core.robustness import \
    norm_diff_clipping as jax_norm_diff_clipping
from fedml_tpu.data import batching as jax_batching
from fedml_tpu.models.lr import LogisticRegression as JaxLogisticRegression
from fedml_tpu_torch.algos import FedAvgRobustAPI, FedConfig
from fedml_tpu_torch.algos.robust import attack_success_rate
from fedml_tpu_torch.core import keys
from fedml_tpu_torch.core import robust_agg as agg
from fedml_tpu_torch.core.faults import UpdateCorruptor
from fedml_tpu_torch.core.robustness import (add_gaussian_noise,
                                             norm_diff_clipping)
from fedml_tpu_torch.data import (build_federated_arrays,
                                  make_classification, partition_dirichlet)
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.trainer.local import NetState


def _stack(seed=0, c=7, shapes=((3, 2), (4,))):
    rng = np.random.RandomState(seed)
    return {f"l{i}": rng.randn(c, *s).astype(np.float32)
            for i, s in enumerate(shapes)}


def _both(fn_t, fn_j, stack, w):
    got = fn_t({k: torch.from_numpy(v) for k, v in stack.items()},
               torch.from_numpy(np.asarray(w, np.float32)))
    want = fn_j({k: jnp.asarray(v) for k, v in stack.items()},
                jnp.asarray(np.asarray(w, np.float32)))
    return ({k: v.numpy() for k, v in got.items()},
            {k: np.asarray(v) for k, v in want.items()})


_AGGS = ["mean", "coord_median", "trimmed_mean0.2", "trimmed_mean0.0",
         "krum1", "krum2", "multi_krum1-3", "geometric_median8"]
_WEIGHTS = {
    7: [np.ones(7), [3, 1, 0, 2, 5, 0, 1]],
    6: [np.ones(6), [0, 2, 1, 4, 1, 3]],
}


@pytest.mark.parametrize("c", [7, 6])
@pytest.mark.parametrize("spec", _AGGS)
def test_aggregators_match_jax(spec, c):
    """Odd and even participant counts, all weights one and with zero
    weights (excluded from the order statistics, weighted in the mean):
    within 1e-6 of JAX's aggregator on the same stacked tree."""
    for w in _WEIGHTS[c]:
        got, want = _both(agg.make_aggregator(spec),
                          jax.jit(jax_agg.make_aggregator(spec)),
                          _stack(seed=c, c=c), w)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       atol=1e-6)


def test_coord_median_averages_the_two_middles_and_excludes_zero_weight():
    st = _stack(c=6)
    got, _ = _both(agg.coord_median(), jax_agg.coord_median(), st,
                   np.ones(6))
    for k in st:
        np.testing.assert_allclose(got[k], np.median(st[k], axis=0),
                                   rtol=1e-6)
    poisoned = {k: v.copy() for k, v in st.items()}
    for v in poisoned.values():
        v[3] = 1e9
    w = np.ones(6)
    w[3] = 0
    got, want = _both(agg.coord_median(), jax_agg.coord_median(), poisoned,
                      w)
    for k in st:
        np.testing.assert_allclose(got[k], np.median(np.delete(st[k], 3, 0),
                                                     axis=0), rtol=1e-6)
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)


def test_krum_tie_picks_the_first_client_as_jax_does():
    """Four clients on the corners of a square (integer coordinates, so
    every summation order is exact) tie on their score; the stable sort
    picks client 0 for Krum and clients 0 and 1 for Multi-Krum, in both
    packages. The far client is never picked."""
    x = np.array([[0, 0], [2, 0], [0, 2], [2, 2], [100, 100]], np.float32)
    for spec, want_w in (("krum1", [0, 0]), ("multi_krum1-2", [1, 0])):
        got, want = _both(agg.make_aggregator(spec),
                          jax_agg.make_aggregator(spec), {"w": x},
                          np.ones(5))
        np.testing.assert_array_equal(got["w"], want["w"])
        np.testing.assert_array_equal(got["w"], np.float32(want_w))


def test_krum_lone_survivor_is_selected_not_an_excluded_slot():
    """Every client but one excluded: every score is +inf, and the valid
    survivor is still the one selected (JAX's regression case)."""
    x = np.zeros((4, 3), np.float32)
    x[2] = 5.0
    for spec in ("krum1", "multi_krum1-2"):
        got, want = _both(agg.make_aggregator(spec),
                          jax_agg.make_aggregator(spec), {"w": x},
                          [0, 0, 1, 0])
        np.testing.assert_array_equal(got["w"], np.full(3, 5.0, np.float32))
        np.testing.assert_array_equal(got["w"], want["w"])


def test_make_aggregator_specs_and_errors_match_jax():
    for spec in ("mean", "coord_median", "trimmed_mean", "trimmed_mean0.25",
                 "krum", "krum3", "multi_krum", "multi_krum2",
                 "multi_krum2-4", "geometric_median", "geometric_median16",
                 " krum2 "):
        a, b = agg.make_aggregator(spec), jax_agg.make_aggregator(spec)
        assert (a.name, a.is_mean, a.group_composable) == (
            b.name, b.is_mean, b.group_composable)
    custom = agg.make_aggregator(lambda st, w: st)
    assert callable(custom) and not custom.is_mean
    for bad in ("foo", "trimmed_mean0.6", "krumX", "multi_krum1-0",
                "geometric_median0", "trimmed_meanx", "multi_krum-1"):
        with pytest.raises(ValueError) as got:
            agg.make_aggregator(bad)
        with pytest.raises(ValueError) as want:
            jax_agg.make_aggregator(bad)
        assert str(got.value) == str(want.value)


def test_norm_diff_clipping_matches_jax():
    rng = np.random.RandomState(3)
    g = {"a": rng.randn(4, 3).astype(np.float32),
         "b": rng.randn(5).astype(np.float32)}
    for scale, bound in ((0.1, 5.0), (10.0, 5.0), (3.0, 0.5)):
        c = {k: v + scale * rng.randn(*v.shape).astype(np.float32)
             for k, v in g.items()}
        got = norm_diff_clipping({k: torch.from_numpy(v) for k, v in
                                  c.items()},
                                 {k: torch.from_numpy(v) for k, v in
                                  g.items()}, bound)
        want = jax_norm_diff_clipping(c, g, bound)
        for k in g:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["sign_flip", "scale", "nan"])
def test_corruptor_device_fn_matches_jax(mode):
    """The deterministic corruptions of the device drill on a client
    stack, only at the adversary slots."""
    st = _stack(c=5)
    gp = {k: v[0] * 0.5 for k, v in st.items()}
    adv = np.array([0, 1, 0, 0, 1], np.float32)
    fn = UpdateCorruptor(mode, scale=4.0).device_fn()
    jfn = jax_faults.UpdateCorruptor(mode, scale=4.0).device_fn()
    got = fn({k: torch.from_numpy(v) for k, v in gp.items()},
             {k: torch.from_numpy(v) for k, v in st.items()},
             torch.from_numpy(adv), keys.fold_in(keys.key(0),
                                                 torch.arange(5)))
    want = jfn({k: jnp.asarray(v) for k, v in gp.items()},
               {k: jnp.asarray(v) for k, v in st.items()},
               jnp.asarray(adv), jax.random.split(jax.random.PRNGKey(0), 5))
    for k in st:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6)
        np.testing.assert_array_equal(got[k].numpy()[[0, 2, 3]],
                                      st[k][[0, 2, 3]])
    with pytest.raises(ValueError, match="unknown corruption mode"):
        UpdateCorruptor("flip")


def test_random_corruption_and_normals_have_the_stated_statistics():
    """``keys.normal``: 2e5 draws with mean and std within 4σ of their
    estimates' spread, children of one key independent of each other;
    the ``random`` corruption is ``scale`` x such draws at the adversary
    slots, the same for the same streams."""
    z = keys.normal(keys.key(5), (200000,))
    n = z.numel()
    assert abs(float(z.mean())) < 4 / n ** 0.5
    assert abs(float(z.std()) - 1.0) < 4 * (0.5 / n) ** 0.5
    pair = keys.normal(keys.fold_in(keys.key(5), torch.arange(2)), (50000,))
    assert abs(float(torch.corrcoef(pair)[0, 1])) < 4 / 50000 ** 0.5
    st = {"w": torch.zeros(4, 30000)}
    fn = UpdateCorruptor("random", scale=2.0).device_fn()
    rngs = keys.fold_in(keys.key(9), torch.arange(4))
    adv = torch.tensor([1.0, 0.0, 1.0, 0.0])
    out = fn({"w": torch.zeros(30000)}, st, adv, rngs)["w"]
    assert torch.equal(out, fn({"w": torch.zeros(30000)}, st, adv,
                               rngs)["w"])
    assert torch.equal(out[[1, 3]], torch.zeros(2, 30000))
    for row in out[[0, 2]]:
        assert abs(float(row.std()) - 2.0) < 4 * 2.0 * (0.5 / 30000) ** 0.5
    assert not torch.equal(out[0], out[2])


# --- FedAvgRobustAPI ----------------------------------------------------------

def _lr_task():
    x, y = make_classification(400, n_features=10, n_classes=4, seed=0)
    parts = partition_dirichlet(y, 10, 0.5, min_size=5, seed=0)
    return x, y, parts


def _robust(per_round=4, **kw):
    x, y, parts = _lr_task()
    fed = build_federated_arrays(x, y, parts, 16, device="cpu")
    cfg = FedConfig(client_num_in_total=10, client_num_per_round=per_round,
                    epochs=1, batch_size=16, lr=0.1, **kw)
    model = create_model("lr", in_features=10, num_classes=4, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    return FedAvgRobustAPI(model, fed, None, cfg, device="cpu")


def test_adversary_cohorts_equal_jax_for_ten_rounds():
    """Two adversaries forced in every other round with JAX's seeded
    eviction: the cohorts of 10 rounds equal JAX's, and the adversary
    mask marks their slots."""
    x, y, parts = _lr_task()
    kw = dict(client_num_in_total=10, client_num_per_round=4, batch_size=16,
              attack_freq=2, attack_num_adversaries=2, corrupt_mode="scale")
    japi = JaxFedAvgRobustAPI(JaxLogisticRegression(num_classes=4),
                              jax_batching.build_federated_arrays(
                                  x, y, parts, 16), None, JaxFedConfig(**kw))
    api = _robust(attack_freq=2, attack_num_adversaries=2,
                  corrupt_mode="scale")
    np.testing.assert_array_equal(api.adversary_clients, [8, 9])
    for r in range(10):
        idx, wmask = japi.sample_round(r)
        np.testing.assert_array_equal(api.sample_round(r), np.asarray(idx))
        np.testing.assert_array_equal(api._adv_mask(api.sample_round(r)),
                                      japi._adv_mask(idx, wmask))
        if r % 2 == 0:
            assert {8, 9} <= set(api.sample_round(r).tolist())


@pytest.mark.parametrize("kw", [
    dict(aggregator="coord_median", corrupt_mode="sign_flip", attack_freq=1),
    dict(aggregator="trimmed_mean0.25", robust_norm_bound=0.5),
    dict(aggregator="krum1", corrupt_mode="random", attack_freq=1),
    dict(aggregator="geometric_median4", robust_stddev=0.01),
])
def test_robust_tiers_equal_the_eager_rounds(kw):
    """The fused and pipelined rounds of FedAvgRobustAPI are bit-equal to
    the eager ``run_round`` + ``_server_update`` over 3 rounds, with the
    drill's mask and the noise; the on-device round is refused with the
    record's reason."""
    fused, pipe, host = (_robust(**kw) for _ in range(3))
    la = [fused.train_one_round(r)["train_loss"] for r in range(3)]
    lp = pipe.train_rounds_pipelined(3)
    lb = []
    for r in range(3):
        avg, loss = host.run_round(r)
        host.net = host._server_update(host.net, avg)
        lb.append(float(loss))
    assert la == lp == lb
    for k in host.net.params:
        assert torch.equal(fused.net.params[k], host.net.params[k])
        assert torch.equal(pipe.net.params[k], host.net.params[k])
    with pytest.raises(NotImplementedError,
                       match="FedAvgRobustAPI feeds its round per-round "
                       "host-computed aux operands"):
        fused.train_rounds_on_device(1)


def test_weak_dp_noise_has_the_configured_stddev():
    """The noise the server adds to the average: mean and std within 4σ
    of 0 and the configured stddev over the LR model's 44 params x 4
    seeds of round keys; a different round key draws other noise."""
    api = _robust(robust_stddev=0.5)
    avg = NetState({k: torch.zeros_like(v) for k, v in api.net.params.items()},
                   {})
    draws = []
    for r in range(40):
        api._last_round_key = keys.fold_in(keys.key(1), r)
        out = api._server_update(api.net, avg)
        draws.append(torch.cat([v.flatten() for v in out.params.values()]))
    z = torch.stack(draws).flatten()
    n = z.numel()
    assert abs(float(z.mean())) < 4 * 0.5 / n ** 0.5
    assert abs(float(z.std()) - 0.5) < 4 * 0.5 * (0.5 / n) ** 0.5
    assert not torch.equal(draws[0], draws[1])
    p = {"w": torch.zeros(1000)}
    assert torch.equal(add_gaussian_noise(p, keys.key(2), 0.5)["w"],
                       add_gaussian_noise(p, keys.key(2), 0.5)["w"])


def test_clipping_bounds_every_client_update():
    """With a tight bound and no noise, every round's update is the
    average of updates each of norm <= the bound, so its norm is too."""
    api = _robust(robust_norm_bound=0.05, per_round=4)
    for r in range(3):
        before = {k: v.clone() for k, v in api.net.params.items()}
        api.train_one_round(r)
        d = torch.sqrt(sum(((api.net.params[k] - before[k]) ** 2).sum()
                           for k in before))
        assert float(d) <= 0.05 * (1 + 1e-5)


def test_attack_success_rate_is_the_targeted_accuracy():
    api = _robust()
    x, y = make_classification(60, n_features=10, n_classes=4, seed=5)
    rate = attack_success_rate(api, x, np.zeros(60, np.int32), 16)
    logits = api.model(torch.from_numpy(x))
    assert rate == pytest.approx(float((logits.argmax(-1) == 0).float()
                                       .mean()))


def test_corrupt_mode_is_refused_off_the_robust_class():
    from fedml_tpu_torch.algos import FedAvgAPI

    x, y, parts = _lr_task()
    fed = build_federated_arrays(x, y, parts, 16, device="cpu")
    cfg = FedConfig(client_num_in_total=10, batch_size=16,
                    corrupt_mode="sign_flip")
    model = create_model("lr", in_features=10, num_classes=4, device="cpu")
    with pytest.raises(NotImplementedError,
                       match="use FedAvgRobustAPI .* silently inert"):
        FedAvgAPI(model, fed, None, cfg, device="cpu")
    with pytest.raises(ValueError, match="exceeds client_num_in_total"):
        _robust(corrupt_mode="scale", attack_num_adversaries=11)
