"""Adapter federations over the wire (``cfg.adapter_rank > 0`` through
``fedml_tpu_torch/algos/fedavg_distributed.build_federation_setup``)
against the JAX package (``fedml_tpu/algos/fedavg_distributed.py``,
``tests/test_fedadapter.py``'s message-passing drills):

- the federation's net is the adapter tree alone: JAX's keys, shapes and
  leaf order, and JAX's bytes a upload on the wire (full trees and
  ``topk0.25+int8`` frames) — exact, since the frames carry the same
  arrays;
- the frozen base is JAX's (carried across by ``convert.from_jax_params``
  as ``pretrained_params``) and bit-equal after FedBuff, FedAsync and the
  sync tier have trained over it;
- the topk+int8 delta drill, the refusals of a mismatched delta stamp and
  of a full-model stamp, full-model adapter uploads on FedAsync, a
  chaos-trained FedBuff global through the rollout gate
  (``tests/test_serve.py:535``), and the ``main_extra`` FedBuff runner
  serving its trained global.

The port's model runs ``attn="flash"`` (the flash kernels' wrappers, their
plain versions on the CPU); JAX's runs dense attention, which changes no
shape or byte compared here."""

import json
from functools import partial

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.algos import fedasync as jfa
from fedml_tpu.algos import fedavg_distributed as jfd
from fedml_tpu.algos import fedbuff as jfb
from fedml_tpu.algos.config import FedConfig as JaxFedConfig
from fedml_tpu.data import batching as jb
from fedml_tpu.models.adapter import adapter_model_fns as jax_adapter_fns
from fedml_tpu.models.adapter import merge_params as jax_merge_params
from fedml_tpu.models.registry import create_model as jax_create_model
from fedml_tpu.trainer.local import seq_softmax_ce as jax_seq_ce
from fedml_tpu_torch.algos import FedConfig
from fedml_tpu_torch.algos import fedasync as pfa
from fedml_tpu_torch.algos import fedavg_distributed as pfd
from fedml_tpu_torch.algos import fedbuff as pfb
from fedml_tpu_torch.convert import from_jax_params
from fedml_tpu_torch.core.tree import sorted_leaves
from fedml_tpu_torch.data import batching, partition
from fedml_tpu_torch.exp import main_extra
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models.adapter import param_count
from fedml_tpu_torch.trainer.local import seq_softmax_ce
from test_torch_fedasync import IDLE_S, Harness

V, T, B, RANK = 32, 16, 4, 4
LOSS = partial(seq_softmax_ce, pad_id=0)
JAX_LOSS = partial(jax_seq_ce, pad_id=0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(rank=RANK):
    return dict(vocab_size=V, d_model=32, n_heads=2, n_layers=2, max_len=T,
                adapter_rank=rank, adapter_scope="attn")


def _tokens(n_clients=4, per=8, seed=0):
    rng = np.random.RandomState(seed)
    seqs = rng.randint(1, V, size=(n_clients * per, T + 1))
    x, y = seqs[:, :T].astype(np.int32), seqs[:, 1:].astype(np.int32)
    return x, y, partition.partition_homo(len(x), n_clients)


def _cfg(port=True, **kw):
    base = dict(client_num_in_total=4, client_num_per_round=2, comm_round=4,
                batch_size=B, lr=0.1, epochs=1, seed=0,
                frequency_of_the_test=1000, adapter_rank=RANK)
    base.update(kw)
    return (FedConfig if port else JaxFedConfig)(**base)


_JAX_BASE = {}


def jax_base():
    """JAX's frozen base (the adapter fns' fresh init from the config's
    seed) as numpy, and as the port's state dict."""
    if not _JAX_BASE:
        fns = jax_adapter_fns(jax_create_model("transformer_lm", **_kw()))
        net = fns.init(jax.random.PRNGKey(0), np.zeros((1, T), np.int32))
        base = jax.tree.map(np.asarray, fns.holder["base"])
        state, _ = from_jax_params(jax_merge_params(
            base, jax.tree.map(np.asarray, net.params)))
        _JAX_BASE.update(base=base, state=state)
    return _JAX_BASE


def _port_model():
    return create_model("transformer_lm", device="cpu", attn="flash",
                        generator=torch.Generator().manual_seed(0), **_kw())


def _port_fed():
    x, y, parts = _tokens()
    return batching.build_federated_arrays(x, y, parts, B, device="cpu")


def _jax_fed():
    x, y, parts = _tokens()
    return jb.build_federated_arrays(x, y, parts, B)


def _snapshot(holder):
    return {k: v.clone() for k, v in holder["base"].state_dict().items()}


def _assert_base_is(holder, state):
    now = holder["base"].state_dict()
    assert sorted(now) == sorted(state)
    for k, v in state.items():
        assert torch.equal(now[k], torch.as_tensor(np.asarray(v))), k


def _keys(tree):
    return {k: _keys(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in tree.items()}


def test_wire_tree_is_the_adapter_tree_in_jax_order():
    """build_federation_setup's net: the adapter tree alone, with JAX's
    keys and shapes, its leaves in JAX's order; the base is the model,
    loaded from JAX's and kept out of the net."""
    b = jax_base()
    cfg = _cfg()
    model = _port_model()
    _, net0, _, _, args = pfd.build_federation_setup(
        model, _port_fed(), None, cfg, "LOOPBACK", LOSS,
        pretrained_params=b["state"])
    _, jnet0, _, _, jargs = jfd.build_federation_setup(
        jax_create_model("transformer_lm", **_kw()), _jax_fed(), None,
        _cfg(False), "LOOPBACK", JAX_LOSS)
    assert net0.model_state == {} and not jnet0.model_state
    assert _keys(net0.params) == _keys(jax.tree.map(np.asarray,
                                                     jnet0.params))
    got = [tuple(l.shape) for l in sorted_leaves(net0)]
    want = [tuple(np.shape(l)) for l in jax.tree.leaves(jnet0)]
    assert got == want and len(got) == 4 * 2  # 4 leaves a block
    assert args.adapter_holder["base"] is model
    assert not any(p.requires_grad for p in model.parameters())
    _assert_base_is(args.adapter_holder, b["state"])
    # JAX's own run builds the same base from the same seed.
    for a, w in zip(jax.tree.leaves(jargs.adapter_holder["base"]),
                    jax.tree.leaves(b["base"])):
        np.testing.assert_array_equal(np.asarray(a), w)
    # The adapters start at the exact base: B = 0.
    assert all(float(v.abs().max()) == 0 for k, v in
               _flat(net0.params).items() if k.endswith("_b"))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("tier,codec", [("buff", "topk0.25+int8"),
                                        ("async", "none")])
def test_bytes_a_upload_and_base_are_jax_s(tier, codec):
    """FedBuff's topk+int8 adapter deltas and FedAsync's full adapter
    trees over the tensor wire: the payload bytes a upload equal JAX's,
    no refusal, every version reached, the base bit-equal to JAX's
    after the run."""
    b = jax_base()
    run = (pfb.FedML_FedBuff_distributed if tier == "buff"
           else pfa.FedML_FedAsync_distributed)
    jrun = (jfb.FedML_FedBuff_distributed if tier == "buff"
            else jfa.FedML_FedAsync_distributed)
    kw = dict(wire_codec=codec, loopback_wire="tensor")
    if tier == "buff":
        kw["buffer_k"] = 2
    srv = run(_port_model(), _port_fed(), None, _cfg(), loss_fn=LOSS,
              pretrained_params=b["state"], device="cpu",
              idle_timeout_s=IDLE_S, **kw)
    jsrv = jrun(jax_create_model("transformer_lm", **_kw()), _jax_fed(),
                None, _cfg(False), loss_fn=JAX_LOSS, **kw)
    for s in (srv, jsrv):
        assert s.version >= 4 and s.final_health["codec_refusals"] == 0
    prof, jprof = srv.ingest_profile(), jsrv.ingest_profile()
    assert prof["bytes_per_upload_mean"] == jprof["bytes_per_upload_mean"]
    _assert_base_is(srv.adapter_holder, b["state"])


def test_fedbuff_adapter_topk_int8_delta_drill():
    """test_fedadapter.py:414: FedBuff ships adapter-only topk+int8 EF
    deltas — no refusal, bytes a upload far below the dense tree's, the
    frozen base bit-equal to its start, the adapters trained."""
    model = _port_model()
    base0 = _snapshot({"base": model})
    srv = pfb.FedML_FedBuff_distributed(
        model, _port_fed(), None, _cfg(), wire_codec="topk0.25+int8",
        loopback_wire="tensor", buffer_k=2, loss_fn=LOSS, device="cpu",
        idle_timeout_s=IDLE_S)
    h = srv.final_health
    assert srv.version == 4 and h["codec_refusals"] == 0
    dense = create_model("transformer_lm", device="cpu", **_kw(rank=0))
    dense_nbytes = 4 * sum(p.numel() for p in dense.parameters())
    assert h["bytes_rx"] / max(len(srv.arrival_log), 1) < 0.25 * dense_nbytes
    _assert_base_is(srv.adapter_holder, base0)
    assert srv.adapter_holder["base"] is model
    b_leaves = [v for k, v in _flat(srv.net.params).items()
                if k.endswith("_b")]
    assert max(float(v.abs().max()) for v in b_leaves) > 0
    assert param_count(srv.net.params) < 0.25 * param_count(
        {k: v for k, v in dense.state_dict().items()})


def test_sync_tier_accepts_adapter_delta_frames():
    """test_fedadapter.py:441: the SYNC server's anchor-based decode
    folds adapter codec frames, over the same frozen base."""
    model = _port_model()
    base0 = _snapshot({"base": model})
    agg = pfd.FedML_FedAvg_distributed(
        model, _port_fed(), None, _cfg(comm_round=2),
        wire_codec="topk0.25+int8", loopback_wire="tensor", loss_fn=LOSS,
        device="cpu", idle_timeout_s=IDLE_S)
    assert agg.final_health["codec_refusals"] == 0
    assert agg.final_health["bytes_rx"] > 0
    _assert_base_is(agg.adapter_holder, base0)


@pytest.mark.parametrize("port", [True, False], ids=["port", "jax"])
def test_async_server_refuses_mismatched_delta_stamp(port):
    """test_fedadapter.py:484: a delta-stamped upload at the full-model
    async server is refused and the worker evict-and-released."""
    h = Harness(port)
    srv, _ = h.server("async", workers=2, cfg_kw={"comm_round": 4})
    assert srv._accepts_delta_frames is False
    h.upload(srv, 1, {"w": np.ones(2, np.float32)}, 0, task=0, delta=True)
    assert srv.codec_refusals == 1 and srv.version == 0
    assert not np.asarray(h.net_of(srv)["w"]).any()
    assert 1 not in srv._members


@pytest.mark.parametrize("port", [True, False], ids=["port", "jax"])
def test_fedbuff_server_refuses_full_model_stamp(port):
    """test_fedadapter.py:521: a full-model-stamped upload at the
    buffered server is refused, never buffered as a delta."""
    h = Harness(port)
    srv, _ = h.server("buff", workers=2, cfg_kw={"comm_round": 4},
                      buffer_k=2)
    assert srv._accepts_delta_frames is True
    h.upload(srv, 1, {"w": np.ones(2, np.float32)}, 0, task=0, delta=False)
    assert srv.codec_refusals == 1 and srv._count == 0


def test_main_extra_fedbuff_serves_its_global(capsys):
    """``--algorithm FedBuff --adapter_rank 8 --model transformer_lm
    --serve --serve_requests 32`` on seeded Shakespeare-shaped data: the
    federation trains, the serving plane answers every request, and the
    last line carries the serve_* stats."""
    hist = main_extra.main([
        "--algorithm", "FedBuff", "--device", "cpu",
        "--dataset", "shakespeare", "--model", "transformer_lm",
        "--adapter_rank", "8", "--serve", "--serve_requests", "32",
        "--client_num_in_total", "4", "--client_num_per_round", "2",
        "--batch_size", "8", "--comm_round", "2", "--epochs", "1",
        "--lr", "0.05"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["version"] == 2 and np.isfinite(last["loss"])
    assert last["serve_served"] == last["serve_admitted"] == 32
    assert last["serve_latency_ms_count"] == 32
    assert hist[-1]["serve_served"] == 32


def _drive_shadow(mgr, n=4):
    """Mirrored traffic through an unstarted manager, served
    synchronously."""
    for _ in range(n):
        req = mgr.submit(0, [1, 2, 3, 4, 5])
        mgr.serve_batch([mgr._q.get_nowait()])
        req.result(5)


def test_fedbuff_chaos_publishes_through_rollout_gate(tmp_path):
    """test_serve.py:535: a FedBuff adapter federation under
    ChaosTransport (duplication, delay) produces the v1 snapshot; it
    promotes through the shadow gate over the run's own frozen base, a
    NaN-poisoned v2 is blocked, and rollback restores the chaos-trained
    global bit-equal."""
    from fedml_tpu_torch.comm.resilience import ChaosSpec
    from fedml_tpu_torch.core.flat import to_numpy_tree, tree_to_vector_np
    from fedml_tpu_torch.core.tree import tree_map
    from fedml_tpu_torch.models.adapter import adapter_model_fns
    from fedml_tpu_torch.serve import (RolloutCoordinator, ServeForward,
                                       ServeManager)

    t = 10
    rng = np.random.RandomState(0)
    seqs = rng.randint(1, 61, size=(32, t + 1))
    fed = batching.build_federated_arrays(
        seqs[:, :t].astype(np.int32), seqs[:, 1:].astype(np.int32),
        partition.partition_homo(32, 4), 4, device="cpu")
    model = create_model("transformer_lm", vocab_size=61, d_model=32,
                         n_heads=2, n_layers=2, max_len=64, adapter_rank=2,
                         adapter_scope="attn", device="cpu",
                         generator=torch.Generator().manual_seed(0))
    srv = pfb.FedML_FedBuff_distributed(
        model, fed, None, _cfg(comm_round=2, adapter_rank=2), buffer_k=2,
        loss_fn=LOSS, device="cpu", idle_timeout_s=IDLE_S,
        chaos=ChaosSpec(seed=3, dup_p=0.3, delay_p=0.3, max_delay_s=0.02))
    trained = to_numpy_tree(srv.net.params)
    fwd = ServeForward(adapter_model_fns(srv.adapter_holder["base"]),
                       trained, device="cpu")
    mgr = ServeManager(fwd, None, tree_map(np.zeros_like, trained),
                       seq_len=t, max_batch=4, device="cpu")
    co = RolloutCoordinator(mgr, min_shadow_tokens=8, regression_tol=10.0)
    co.publish(trained, epoch=1)
    _drive_shadow(mgr)
    assert co.try_promote()["promoted"]
    assert np.array_equal(mgr._vec(mgr.live_adapters()),
                          tree_to_vector_np(trained))
    co.publish(tree_map(lambda v: np.full_like(v, np.nan), trained),
               epoch=99)
    _drive_shadow(mgr)
    assert not co.try_promote()["promoted"]
    co.discard()
    co.rollback()
    co.rollback()  # back to the chaos-trained global, bit-equal
    assert np.array_equal(mgr._vec(mgr.live_adapters()),
                          tree_to_vector_np(trained))
    mgr.close()
