"""The port's run checkpoints (``fedml_tpu_torch/obs/checkpoint.py``) and
model weight files (``models/pretrained.py``) against the JAX package's
(``fedml_tpu/obs/checkpoint.py``, ``fedml_tpu/models/pretrained.py``).

A run saved after 2 rounds and restored into a fresh API resumes
bit-exactly: its params, server optimizer state and run state after 2
more rounds equal, bit for bit, those of 4 rounds straight, for every
class with checkpoint hooks in the JAX package (the JAX pins:
``tests/test_obs.py:117``, ``test_scaffold.py:126``, ``test_feddyn.py:115``,
``test_ditto.py:114``, ``test_fedbn.py:109``, ``test_fedadapter.py:256``).
The hooks' keys are JAX's. The manager's contract: strict structure on
restore, committed steps never overwritten, rotation, the snapshot taken
before an async save returns, and a monotonic federation epoch. Weight
files cross between the packages both ways with logits within 1e-5."""

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.algos.config import FedConfig as JaxFedConfig
from fedml_tpu.algos.ditto import DittoAPI as JaxDittoAPI
from fedml_tpu.algos.fedac import FedAcAPI as JaxFedAcAPI
from fedml_tpu.algos.fedac import ServerAvgAPI as JaxServerAvgAPI
from fedml_tpu.algos.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.algos.fedbn import FedBNAPI as JaxFedBNAPI
from fedml_tpu.algos.feddyn import FedDynAPI as JaxFedDynAPI
from fedml_tpu.algos.fedopt import FedOptAPI as JaxFedOptAPI
from fedml_tpu.algos.scaffold import ScaffoldAPI as JaxScaffoldAPI
from fedml_tpu.data import batching as jax_batching
from fedml_tpu.models.pretrained import load_params as jax_load_params
from fedml_tpu.models.pretrained import save_params as jax_save_params
from fedml_tpu.models.registry import create_model as jax_create_model
from fedml_tpu.trainer.local import model_fns as jax_model_fns
from fedml_tpu_torch.algos import (DittoAPI, FedAcAPI, FedAdapterAPI,
                                   FedAvgAPI, FedBNAPI, FedConfig, FedDynAPI,
                                   FedOptAPI, ScaffoldAPI, ServerAvgAPI)
from fedml_tpu_torch.core.tree import tree_leaves
from fedml_tpu_torch.data import build_federated_arrays, partition_homo
from fedml_tpu_torch.data.synthetic import make_classification
from fedml_tpu_torch.models import create_model, load_params, save_params
from fedml_tpu_torch.obs import (CheckpointManager, allocate_epoch,
                                 restore_federation, restore_run,
                                 save_federation, save_run)
from fedml_tpu_torch.obs.checkpoint import _walk
from fedml_tpu_torch.trainer.local import NetState, model_fns, seq_softmax_ce

COUNTS = (5, 9, 13, 3, 17, 8)
WIDTHS = (4, 8, 16)
KW = {FedOptAPI: dict(server_optimizer="adam", server_lr=0.01)}
CLASSES = (FedAvgAPI, FedOptAPI, ScaffoldAPI, FedDynAPI, DittoAPI, FedBNAPI,
           FedAcAPI, ServerAvgAPI)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(image=False):
    n = sum(COUNTS)
    rng = np.random.RandomState(0)
    if image:
        x = rng.randn(n, 8, 8, 3).astype(np.float32)
    else:
        x = make_classification(n, n_features=10, n_classes=4, seed=1)[0]
    y = rng.randint(0, 4, n).astype(np.int32)
    edges = np.concatenate([[0], np.cumsum(COUNTS)])
    return x, y, {i: np.arange(edges[i], edges[i + 1])
                  for i in range(len(COUNTS))}


def _cfg(cls):
    return dict(client_num_in_total=len(COUNTS), client_num_per_round=4,
                comm_round=4, epochs=1, batch_size=4,
                lr=1e-2 if cls is FedBNAPI else 0.1, **KW.get(cls, {}))


def _api(cls):
    """LR for every class but FedBN, which needs norm layers (a narrow
    GroupNorm resnet20 on 8 x 8 x 3)."""
    x, y, parts = _data(image=cls is FedBNAPI)
    fed = build_federated_arrays(x, y, parts, 4, device="cpu")
    gen = torch.Generator().manual_seed(0)
    if cls is FedBNAPI:
        model = create_model("resnet20", widths=WIDTHS, num_classes=4,
                             device="cpu", generator=gen)
    else:
        model = create_model("lr", in_features=10, num_classes=4,
                             device="cpu", generator=gen)
    return cls(model, fed, None, FedConfig(**_cfg(cls)), device="cpu")


def _state(api):
    """Every leaf a resume must restore: net, key, server optimizer, run
    state."""
    return [leaf for _, leaf in _walk({
        "net": api.net, "rng": api.rng,
        "opt": getattr(api, "server_opt_state", None),
        "extra": api.checkpoint_extra_state()})]


def _assert_equal(a, b):
    la, lb = _state(a), _state(b)
    assert len(la) == len(lb) > 0
    for u, v in zip(la, lb):
        assert torch.equal(torch.as_tensor(u), torch.as_tensor(v))


def _rounds(api, tier, lo, hi):
    if tier == "on_device":
        api.train_rounds_on_device(hi - lo)
    else:
        for r in range(lo, hi):
            api.train_one_round(r)


# --- bit-exact resume --------------------------------------------------------

@pytest.mark.parametrize("cls", CLASSES, ids=lambda c: c.__name__)
def test_resume_is_bit_exact(cls, tmp_path):
    """4 rounds straight against 2 + save_run + restore_run into a FRESH
    api + 2: every leaf of the net, the key, the server optimizer state and
    the run state bit-equal (train_one_round; the round-protocol classes
    also on the on-device tier)."""
    tiers = ["fused"] + (["on_device"]
                         if _api(cls).capability().on_device else [])
    for tier in tiers:
        straight = _api(cls)
        _rounds(straight, tier, 0, 4)
        first = _api(cls)
        _rounds(first, tier, 0, 2)
        mgr = CheckpointManager(str(tmp_path / tier))
        save_run(mgr, first, 1)
        resumed = _api(cls)
        assert restore_run(mgr, resumed) == 2
        _assert_equal(first, resumed)
        _rounds(resumed, tier, 2, 4)
        mgr.close()
        _assert_equal(straight, resumed)


@pytest.mark.parametrize("cls", (ScaffoldAPI, DittoAPI),
                         ids=lambda c: c.__name__)
def test_restore_into_a_trained_api(cls, tmp_path):
    """A restore into an api that already ran rounds (its stacks the
    step's own) replaces every leaf the next round reads: the resumed run
    still equals the straight one."""
    straight = _api(cls)
    _rounds(straight, "fused", 0, 4)
    first = _api(cls)
    _rounds(first, "fused", 0, 2)
    mgr = CheckpointManager(str(tmp_path))
    save_run(mgr, first, 1)
    other = _api(cls)
    _rounds(other, "fused", 0, 3)
    assert restore_run(mgr, other) == 2
    _rounds(other, "fused", 2, 4)
    _assert_equal(straight, other)


JAX_CLASSES = {FedAvgAPI: JaxFedAvgAPI, FedOptAPI: JaxFedOptAPI,
               ScaffoldAPI: JaxScaffoldAPI, FedDynAPI: JaxFedDynAPI,
               DittoAPI: JaxDittoAPI, FedBNAPI: JaxFedBNAPI,
               FedAcAPI: JaxFedAcAPI, ServerAvgAPI: JaxServerAvgAPI}


@pytest.mark.parametrize("cls", CLASSES, ids=lambda c: c.__name__)
def test_extra_state_keys_are_jaxs(cls):
    """Each class's run-state hook returns the JAX class's keys."""
    x, y, parts = _data(image=cls is FedBNAPI)
    fed = jax_batching.build_federated_arrays(x, y, parts, 4)
    if cls is FedBNAPI:
        model = jax_create_model("resnet20", widths=WIDTHS, num_classes=4)
    else:
        model = jax_create_model("lr", num_classes=4)
    japi = JAX_CLASSES[cls](model, fed, None, JaxFedConfig(**_cfg(cls)))
    assert set(_api(cls).checkpoint_extra_state()) == set(
        japi.checkpoint_extra_state())


# --- FedAdapter: the personal store is run state -----------------------------

V, T = 32, 16


def _adapter_api(spill_dir=None):
    rng = np.random.RandomState(0)
    seqs = rng.randint(1, V, size=(6 * 8, T + 1))
    x, y = seqs[:, :T].astype(np.int32), seqs[:, 1:].astype(np.int32)
    fed = build_federated_arrays(x, y, partition_homo(len(x), 6), 4,
                                 device="cpu")
    model = create_model("transformer_lm", vocab_size=V, d_model=32,
                         n_heads=2, n_layers=2, max_len=T, adapter_rank=4,
                         adapter_scope="attn", attn="flash", device="cpu",
                         generator=torch.Generator().manual_seed(0))
    cfg = FedConfig(client_num_in_total=6, client_num_per_round=3,
                    comm_round=4, batch_size=4, lr=0.1, epochs=1,
                    adapter_rank=4)
    return FedAdapterAPI(model, fed, None, cfg, device="cpu",
                         loss_fn=partial(seq_softmax_ce, pad_id=0),
                         personal_spill_dir=spill_dir)


@pytest.mark.parametrize("spill", [False, True], ids=["ram", "memmap"])
def test_fedadapter_resume_with_personal_stacks(spill, tmp_path):
    """After 2 rounds and a personalized cohort, save; a fresh api whose
    store is materialized (the template) restores the adapters and the
    store's rows and seen flags bit-equal — a memmap-spilled store too —
    and its 2 further rounds equal the straight run's."""
    def spill_dir(name):
        if not spill:
            return None
        os.makedirs(tmp_path / name)
        return str(tmp_path / name)

    straight = _adapter_api()
    _rounds(straight, "fused", 0, 4)
    first = _adapter_api(spill_dir("a"))
    _rounds(first, "fused", 0, 2)
    first.personalize_cohort([0, 2, 4])
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    save_run(mgr, first, 1)
    resumed = _adapter_api(spill_dir("b"))
    resumed.personal_store()
    assert restore_run(mgr, resumed) == 2
    want = first.personal_store().state_dict()
    got = resumed.personal_store().state_dict()
    for key in ("personal_vecs", "personal_seen"):
        np.testing.assert_array_equal(got[key], want[key])
    assert resumed.personal_store().memmapped == spill
    _rounds(resumed, "fused", 2, 4)
    for a, b in zip(tree_leaves(straight.net.params),
                    tree_leaves(resumed.net.params)):
        assert torch.equal(a, b)


def test_fedadapter_never_personalized_saves_no_store(tmp_path):
    """A run that never personalized checkpoints no store (and allocates
    none); a restore tolerates the absent key."""
    api = _adapter_api()
    _rounds(api, "fused", 0, 1)
    assert api.checkpoint_extra_state() == {}
    assert api._personal_store is None
    mgr = CheckpointManager(str(tmp_path))
    save_run(mgr, api, 0)
    fresh = _adapter_api()
    assert restore_run(mgr, fresh) == 1
    assert fresh._personal_store is None
    for a, b in zip(tree_leaves(api.net.params),
                    tree_leaves(fresh.net.params)):
        assert torch.equal(a, b)


# --- the manager's contract --------------------------------------------------

def _tree():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": (torch.tensor(3, dtype=torch.int64),
                  np.ones(4, np.float32)),
            "c": {"d": torch.zeros(2, dtype=torch.bfloat16)}, "e": None}


def test_restore_checks_every_key_shape_and_dtype(tmp_path):
    """restore(like=) rebuilds the template's structure (numpy where it
    holds numpy, bf16 kept) and raises, naming the key, on a missing key,
    a wrong shape, a wrong dtype and an entry the template lacks."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, _tree())
    got = mgr.restore(like=_tree())
    assert torch.equal(got["a"], _tree()["a"])
    assert isinstance(got["b"], tuple) and int(got["b"][0]) == 3
    assert isinstance(got["b"][1], np.ndarray)
    assert got["c"]["d"].dtype == torch.bfloat16 and got["e"] is None
    raw = mgr.restore()
    assert set(raw) == {"a", "b", "c"} and set(raw["b"]) == {"0", "1"}
    bad = _tree()
    bad["f"] = torch.zeros(1)
    with pytest.raises(KeyError, match="'f'"):
        mgr.restore(like=bad)
    bad = _tree()
    bad["a"] = torch.zeros(3, 2)
    with pytest.raises(ValueError, match="'a'.*shape"):
        mgr.restore(like=bad)
    bad = _tree()
    bad["c"]["d"] = torch.zeros(2)
    with pytest.raises(ValueError, match="'c/d'.*dtype"):
        mgr.restore(like=bad)
    bad = _tree()
    del bad["c"]
    with pytest.raises(ValueError, match="does not hold.*c/d"):
        mgr.restore(like=bad)


def test_committed_step_is_never_overwritten(tmp_path):
    """Saving a committed step raises "already exists" and leaves the
    step as it was; save_federation skips a durable step."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, {"x": torch.ones(2)})
    with pytest.raises(ValueError, match="already exists"):
        mgr.save(3, {"x": torch.zeros(2)})
    assert torch.equal(mgr.restore(3)["x"], torch.ones(2))
    net = NetState({"w": torch.ones(2)}, {})
    save_federation(mgr, net, 3, epoch=0, wait=True)
    assert torch.equal(mgr.restore(3)["x"], torch.ones(2))


def test_max_to_keep_rotates_and_half_steps_are_invisible(tmp_path):
    """Only the newest ``max_to_keep`` steps stay; a temporary directory
    left by a crashed save is no step."""
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in range(5):
        mgr.save(step, {"x": torch.full((2,), float(step))})
    assert mgr.steps() == [3, 4] and mgr.latest() == 4
    os.makedirs(tmp_path / ".5.crashed")
    assert mgr.steps() == [3, 4]
    assert float(mgr.restore()["x"][0]) == 4.0


def test_async_save_snapshots_before_it_returns(tmp_path):
    """wait=False returns before the write commits, but the snapshot is
    taken first: mutating the net in place after save leaves the
    checkpoint as it was at the call."""
    api = _api(FedOptAPI)
    _rounds(api, "fused", 0, 2)
    want = [leaf.clone() for leaf in tree_leaves(api.net.params)]
    mgr = CheckpointManager(str(tmp_path))
    save_run(mgr, api, 1, wait=False)
    for leaf in tree_leaves(api.net.params):
        leaf.add_(1.0)
    mgr.wait()
    fresh = _api(FedOptAPI)
    restore_run(mgr, fresh)
    for a, b in zip(tree_leaves(fresh.net.params), want):
        assert torch.equal(a, b)


def test_allocate_epoch_is_monotonic_across_restores(tmp_path):
    """As ``test_resilience.py:638``: two restarts inside one checkpoint
    window restore the same stored epoch, yet each start allocates a
    strictly larger one; restore_federation gives the stored round, epoch
    and net."""
    d = str(tmp_path / "ckpt")
    net = NetState({"w": torch.arange(3, dtype=torch.float32)}, {})
    mgr = CheckpointManager(d)
    assert restore_federation(mgr, net) is None
    e0 = allocate_epoch(mgr)
    assert e0 == 0
    save_federation(mgr, net, 0, e0, wait=True)
    mgr.close()
    epochs = []
    for _ in range(2):
        mgr = CheckpointManager(d)
        got = restore_federation(mgr, NetState({"w": torch.zeros(3)}, {}))
        assert got["round_idx"] == 0 and got["epoch"] == 0
        assert torch.equal(got["net"].params["w"], net.params["w"])
        epochs.append(allocate_epoch(mgr, got["epoch"]))
        mgr.close()
    assert epochs == [1, 2]


# --- weight files between the packages ---------------------------------------

def _jax_net(norm):
    fns = jax_model_fns(jax_create_model("resnet20", widths=WIDTHS,
                                         num_classes=4, norm=norm))
    return fns, fns.init(jax.random.PRNGKey(0),
                         np.zeros((1, 8, 8, 3), np.float32))


def _port(norm):
    model = create_model("resnet20", widths=WIDTHS, num_classes=4, norm=norm,
                         device="cpu",
                         generator=torch.Generator().manual_seed(1))
    return model, model_fns(model)


@pytest.mark.parametrize("norm", ["gn", "bn"])
def test_weight_files_cross_between_packages(norm, tmp_path):
    """JAX's save_params → the port's load_params, and the port's
    save_params → JAX's load_params: the same eval logits within 1e-5 (the
    BatchNorm model with its running stats as ``state::batch_stats``)."""
    jfns, jnet = _jax_net(norm)
    if norm == "bn":  # running stats away from their init
        stats = jax.tree.map(lambda s: s + 0.25 * jnp.ones_like(s),
                             jnet.model_state)
        jnet = type(jnet)(jnet.params, stats)
    x = np.random.RandomState(2).randn(3, 8, 8, 3).astype(np.float32)
    want = np.asarray(jfns.apply(jnet, jnp.asarray(x))[0])
    model, fns = _port(norm)
    jax_save_params(jnet, str(tmp_path / "jax.npz"))
    net = load_params(fns.init(), str(tmp_path / "jax.npz"))
    got = fns.apply(net, torch.from_numpy(x))[0].detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    save_params(net, str(tmp_path / "port.npz"))
    _, jother = _jax_net(norm)
    jback = jax_load_params(jother, str(tmp_path / "port.npz"))
    back = np.asarray(jfns.apply(jback, jnp.asarray(x))[0])
    np.testing.assert_allclose(back, want, rtol=0, atol=1e-5)
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") \
            as b:
        assert sorted(a.files) == sorted(b.files)


def test_load_params_strict_keys(tmp_path):
    """As ``test_utils_api.py:50``: a shape mismatch names the key, a
    missing key raises KeyError, an entry the model does not use raises."""
    model, fns = _port("gn")
    net = fns.init()
    save_params(net, str(tmp_path / "r20.npz"))
    other = create_model("resnet20", widths=WIDTHS, num_classes=7,
                         device="cpu")
    with pytest.raises(ValueError, match="shape"):
        load_params(model_fns(other).init(), str(tmp_path / "r20.npz"))
    arrays = dict(np.load(tmp_path / "r20.npz"))
    missing = sorted(arrays)[0]
    del arrays[missing]
    np.savez(tmp_path / "missing.npz", **arrays)
    with pytest.raises(KeyError, match="missing"):
        load_params(net, str(tmp_path / "missing.npz"))
    arrays = dict(np.load(tmp_path / "r20.npz"))
    arrays["params::extra::kernel"] = np.zeros(2, np.float32)
    np.savez(tmp_path / "extra.npz", **arrays)
    with pytest.raises(ValueError, match="does not use"):
        load_params(net, str(tmp_path / "extra.npz"))
    back = load_params(net, str(tmp_path / "r20"))
    for k, v in net.params.items():
        assert torch.equal(back.params[k], v)


def test_adapter_tree_round_trips(tmp_path):
    """FedAdapter's net (a nested ``lora_*`` tree) writes and reads back
    bit-equal, under JAX's adapter paths."""
    api = _adapter_api()
    save_params(api.net, str(tmp_path / "ad.npz"))
    with np.load(tmp_path / "ad.npz") as data:
        assert all(k.startswith("params::Block_") and "lora_" in k
                   for k in data.files)
    back = load_params(api.net, str(tmp_path / "ad.npz"))
    for a, b in zip(tree_leaves(api.net.params), tree_leaves(back.params)):
        assert torch.equal(a, b)
