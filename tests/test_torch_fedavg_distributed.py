"""The port's synchronous federation plane
(``fedml_tpu_torch/algos/fedavg_distributed.py``) against the JAX
package's ``fedml_tpu/algos/fedavg_distributed.py``:

- loopback federations over ``lr`` and a narrow GroupNorm ResNet, from
  JAX's start weights through the port's converter, every message through
  the tensor wire: each round's ``test_history`` and the final net within
  1e-5 of JAX's, for the wire codecs ``none``, ``bf16`` and ``topk0.1``
  and ``ingest_workers`` 0 and 2 (top-k on the ResNet is left out: its
  selection flips on near-tied magnitudes that the two packages round
  apart, and the error feedback carries the flip on);
- the fake-clock protocol drills of ``tests/test_resilience.py`` replayed
  against both packages' managers (handlers invoked directly): the
  evicted sets, ``health()``, the messages each rank was sent and the nets
  are equal;
- crash-resume bit-equal to the uninterrupted run, first-k rounds, the
  sharded plane, secure aggregation and a controller through the entry
  point, and every refusal of what ROADMAP.md A10d still holds.

``batch_size`` ≥ the largest client, so the port's shuffle (its own keys)
only reorders a masked mean."""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.algos import fedavg_distributed as jfd
from fedml_tpu.algos.config import FedConfig as JaxFedConfig
from fedml_tpu.comm import loopback as jax_loopback
from fedml_tpu.comm.message import Message as JaxMessage
from fedml_tpu.data import batching as jax_batching
from fedml_tpu.models.registry import create_model as jax_create_model
from fedml_tpu.trainer.local import model_fns as jax_model_fns
from fedml_tpu_torch.algos import FedConfig
from fedml_tpu_torch.algos import fedavg_distributed as pfd
from fedml_tpu_torch.comm import loopback
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.comm.resilience import ChaosSpec
from fedml_tpu_torch.convert import from_jax_params, to_jax_params
from fedml_tpu_torch.core import compression, keys
from fedml_tpu_torch.core.sampling import sample_clients
from fedml_tpu_torch.data import batching, partition, synthetic
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.trainer.local import NetState, softmax_ce

WIDTHS = (4, 8, 16)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _task(seed=0):
    x, y = synthetic.make_image_classification(60, (8, 8, 3), 4, seed=seed)
    parts = partition.partition_dirichlet(y, 6, 0.5, min_size=4, seed=seed)
    xt, yt = synthetic.make_image_classification(20, (8, 8, 3), 4, seed=seed)
    return x, y, parts, xt, yt, max(len(v) for v in parts.values())


def _models(name):
    if name == "lr":
        return (jax_create_model("lr", num_classes=4),
                lambda: create_model("lr", num_classes=4, in_features=192,
                                     device="cpu"))
    return (jax_create_model("resnet20", widths=WIDTHS, num_classes=4),
            lambda: create_model("resnet20", widths=WIDTHS, num_classes=4,
                                 device="cpu",
                                 generator=torch.Generator().manual_seed(0)))


def _port_run(name, cfg_kw, start, **kw):
    x, y, parts, xt, yt, batch = _task()
    _, port_model = _models(name)
    fed = batching.build_federated_arrays(x, y, parts, batch, device="cpu")
    test = batching.batch_global(xt, yt, 10, device="cpu")
    return pfd.FedML_FedAvg_distributed(
        port_model(), fed, test, FedConfig(batch_size=batch, **cfg_kw),
        pretrained_params=from_jax_params(start)[0], **RUN, **kw)


CFG = dict(client_num_in_total=6, client_num_per_round=3, epochs=1,
           frequency_of_the_test=1)
#: Every run on the CPU; a silo quits after 30 s without its server, so a
#: server that fails fails the test instead of hanging it.
RUN = dict(device="cpu", idle_timeout_s=30.0)


def _federations(name, cfg_kw, **kw):
    """(the port's aggregator, JAX's) of one loopback federation from JAX's
    start weights, every message through the tensor wire, and the start
    weights."""
    x, y, parts, xt, yt, batch = _task()
    jax_model, _ = _models(name)
    net0 = jax_model_fns(jax_model).init(jax.random.PRNGKey(0),
                                          np.zeros((1, 8, 8, 3), np.float32))
    start = jax.tree.map(np.asarray, net0.params)
    cfg = dict(CFG, **cfg_kw)
    jagg = jfd.FedML_FedAvg_distributed(
        jax_model, jax_batching.build_federated_arrays(x, y, parts, batch),
        jax_batching.batch_global(xt, yt, 10),
        JaxFedConfig(batch_size=batch, **cfg), loopback_wire="tensor",
        pretrained_params=start, **kw)
    agg = _port_run(name, cfg, start, loopback_wire="tensor", **kw)
    return agg, jagg, start


def _assert_same_federation(agg, jagg, start, rounds):
    """Each round's eval and the final net within 1e-5 of JAX's."""
    assert len(agg.test_history) == len(jagg.test_history) == rounds
    for got, want in zip(agg.test_history, jagg.test_history):
        assert got["round"] == want["round"] and got["num"] == want["num"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(got["accuracy"], want["accuracy"],
                                   rtol=0, atol=1e-5)
    got = jax.tree.leaves(to_jax_params(dict(agg.net.params)))
    want = jax.tree.leaves(jax.tree.map(np.asarray, jagg.net.params))
    moved = max(np.abs(w - s).max() for w, s in zip(want,
                                                     jax.tree.leaves(start)))
    assert moved > 1e-3
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name,codec,workers,lr,rounds", [
    ("lr", "none", 0, 0.1, 3), ("lr", "bf16", 2, 0.1, 3),
    ("lr", "topk0.1", 2, 0.1, 3), ("resnet", "none", 2, 1e-3, 2),
    ("resnet", "bf16", 0, 1e-3, 2)])
def test_loopback_federation_matches_jax(name, codec, workers, lr, rounds):
    agg, jagg, start = _federations(
        name, dict(comm_round=rounds, lr=lr, ingest_workers=workers),
        wire_codec=codec)
    _assert_same_federation(agg, jagg, start, rounds)
    # The same array bytes crossed the wire (the frames' headers name the
    # leaves each package's way).
    h, jh = agg.final_health, jagg.final_health
    assert h["bytes_rx"] > 0 and jh["bytes_rx"] > 0 and h["members"] == 3
    for key in ("evictions", "codec_refusals", "duplicate_drops"):
        assert h[key] == jh[key] == 0
    prof = agg.ingest_profile
    assert (prof["bytes_per_upload_mean"]
            == jagg.ingest_profile["bytes_per_upload_mean"])
    assert prof["uploads"] == 3 * rounds
    assert ("ingest_pool" in prof) == bool(workers)


@pytest.mark.parametrize("kw", [
    {"aggregator": "coord_median"}, {"aggregator": "trimmed_mean0.34"},
    {"aggregator": "krum1"}, {"aggregator": "geometric_median"},
    {"compress": "topk0.2"}],
    ids=lambda kw: "-".join(kw.values()))
def test_robust_and_compressed_federation_matches_jax(kw):
    """The server's stacked non-mean fold (the cohort side by side, each
    upload beside its weight: the order statistics gate on the weights,
    the geometric median weighs by them) and the legacy ``compress``
    path (top-k of the delta with the silo's error feedback, decoded on
    the server) on ``lr``: both deterministic, so each round and the
    final net within 1e-5 of JAX's."""
    agg, jagg, start = _federations(
        "lr", dict(comm_round=3, lr=0.1), **kw)
    _assert_same_federation(agg, jagg, start, 3)
    assert agg.live_model_buffers == 0
    assert agg.final_health["members"] == 3


# --- fake-clock protocol drills (tests/test_resilience.py) ------------------


class _Pkg:
    def __init__(self, port):
        self.port = port
        self.m = pfd if port else jfd
        self.Message = Message if port else JaxMessage
        self.net = (loopback if port else jax_loopback).LoopbackNetwork
        self.cfg = FedConfig if port else JaxFedConfig

    def server(self, aggregate_k=0, comm_round=3, workers=3, clock=None):
        class A:
            pass

        args = A()
        args.network = self.net(workers + 1)
        cfg = self.cfg(client_num_in_total=workers,
                       client_num_per_round=workers, comm_round=comm_round,
                       frequency_of_the_test=1)
        net0 = {"w": np.zeros(2, np.float32)}
        kw = {"device": "cpu"} if self.port else {}
        agg = self.m.FedAVGAggregator(net0, workers, cfg, **kw)
        srv = self.m.FedAVGServerManager(
            args, agg, cfg, workers + 1, aggregate_k=aggregate_k,
            round_timeout_s=10.0, clock=clock or time.monotonic)
        return srv, agg, args.network

    def upload(self, srv, worker, round_idx, value, epoch=0, n=10):
        m = self.Message(self.m.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, worker, 0)
        m.add(self.Message.MSG_ARG_KEY_MODEL_PARAMS,
              {"w": np.full(2, value, np.float32)})
        m.add(self.Message.MSG_ARG_KEY_NUM_SAMPLES, n)
        m.add("round", round_idx)
        m.add("epoch", epoch)
        srv.handle_message_receive_model_from_client(m)

    def tick(self, srv, round_idx, failed, epoch=0):
        m = self.Message(self.m.MSG_TYPE_SRV_TICK, 0, 0)
        m.add("round", round_idx)
        m.add("failed", failed)
        m.add("epoch", epoch)
        srv._handle_tick(m)

    def beat(self, srv, rank):
        srv._handle_heartbeat(self.Message(self.m.MSG_TYPE_C2S_HEARTBEAT,
                                           rank, 0))


def _observe(srv, agg, network):
    """What a drill leaves: health, membership, the round, the net, and
    every message each rank was sent (type, round, done, resend, w)."""
    inboxes = []
    for rank in range(network.size):
        seen = []
        for m in list(network.inbox(rank).queue):
            if not hasattr(m, "get_type"):
                continue
            w = m.get(Message.MSG_ARG_KEY_MODEL_PARAMS)
            seen.append((m.get_type(), m.get("round"), bool(m.get("done")),
                         bool(m.get("resend")),
                         None if w is None else np.asarray(w["w"]).tolist()))
        inboxes.append(seen)
    net = agg.net["w"]
    return {"health": srv.health(), "members": sorted(srv._members),
            "round": srv.round_idx, "aborted": srv.aborted,
            "stopped": srv._stopped, "straggler": srv.straggler_drops,
            "dupes": srv.duplicate_drops, "epoch_drops": srv.epoch_drops,
            "arrived": sorted(srv._arrived),
            "net": np.asarray(net.numpy() if torch.is_tensor(net)
                              else net).tolist(), "inboxes": inboxes}


def _d_eviction(p):
    srv, agg, net = p.server()
    p.upload(srv, 1, 0, 1.0)
    p.upload(srv, 2, 0, 3.0)
    p.tick(srv, 0, [3])
    return srv, agg, net


def _d_stale_tick(p):
    srv, agg, net = p.server()
    for w in (1, 2, 3):
        p.upload(srv, w, 0, 1.0)
    p.tick(srv, 0, [2])
    return srv, agg, net


def _d_readmit_catchup(p):
    srv, agg, net = p.server()
    p.upload(srv, 1, 0, 1.0)
    p.upload(srv, 2, 0, 1.0)
    p.tick(srv, 0, [3])
    p.upload(srv, 3, 0, 9.0)
    return srv, agg, net


def _d_readmit_beat(p):
    srv, agg, net = p.server()
    p.upload(srv, 1, 0, 1.0)
    p.upload(srv, 2, 0, 1.0)
    p.tick(srv, 0, [3])
    p.beat(srv, 3)
    return srv, agg, net


def _d_duplicate(p):
    srv, agg, net = p.server()
    p.upload(srv, 1, 0, 1.0)
    p.upload(srv, 1, 0, 1.0)
    p.upload(srv, 2, 0, 3.0)
    p.upload(srv, 3, 0, 5.0)
    return srv, agg, net


def _d_epoch(p):
    srv, agg, net = p.server()
    srv.epoch = 2
    p.upload(srv, 1, 0, 7.0, epoch=1)
    p.upload(srv, 1, 0, 1.0, epoch=2)
    return srv, agg, net


def _d_firstk(p):
    srv, agg, net = p.server(aggregate_k=3, workers=4)
    p.tick(srv, 0, [3, 4])
    p.upload(srv, 1, 0, 1.0)
    p.upload(srv, 2, 0, 3.0)
    return srv, agg, net


def _d_abort(p):
    t = [0.0]
    srv, agg, net = p.server(clock=lambda: t[0])
    t[0] = 100.0
    p.tick(srv, 0, [1, 2, 3])
    return srv, agg, net


def _d_hold_open(p):
    t = [0.0]
    srv, agg, net = p.server(clock=lambda: t[0])
    p.tick(srv, 0, [1, 2, 3])
    for w in (1, 2, 3):
        p.beat(srv, w)
    for w in (1, 2, 3):
        p.upload(srv, w, 0, 1.0)
    return srv, agg, net


def _d_terminal(p):
    srv, agg, net = p.server(comm_round=1)
    for w in (1, 2, 3):
        p.upload(srv, w, 0, 1.0)
    return srv, agg, net


def _d_terminal_tick(p):
    srv, agg, net = p.server(comm_round=1, aggregate_k=2)
    p.upload(srv, 1, 0, 1.0)
    p.upload(srv, 2, 0, 1.0)
    p.tick(srv, 1, [3])
    return srv, agg, net


def _d_terminal_dead_fleet(p):
    srv, agg, net = p.server(comm_round=1)
    srv.round_idx = 1

    def dead_send(msg):
        if int(msg.get_receiver_id()) != 0:
            raise ConnectionError("fleet is gone")

    srv.send_message = dead_send
    t = threading.Thread(target=srv.run, daemon=True)
    t.start()
    t.join(timeout=10.0)
    assert not t.is_alive()
    return srv, agg, net


def _d_terminal_beat(p):
    srv, agg, net = p.server(comm_round=1)
    for w in (1, 2, 3):
        p.upload(srv, w, 0, 1.0)
    p.beat(srv, 1)
    return srv, agg, net


def _d_terminal_evicted_beat(p):
    srv, agg, net = p.server(comm_round=1, aggregate_k=2)
    p.upload(srv, 1, 0, 1.0)
    p.upload(srv, 2, 0, 1.0)
    p.tick(srv, 1, [3])
    p.beat(srv, 3)
    return srv, agg, net


DRILLS = {f.__name__[3:]: f for f in (
    _d_eviction, _d_stale_tick, _d_readmit_catchup, _d_readmit_beat,
    _d_duplicate, _d_epoch, _d_firstk, _d_abort, _d_hold_open, _d_terminal,
    _d_terminal_tick, _d_terminal_dead_fleet, _d_terminal_beat,
    _d_terminal_evicted_beat)}


@pytest.mark.parametrize("drill", sorted(DRILLS))
def test_protocol_drill_equals_jax(drill):
    got = _observe(*DRILLS[drill](_Pkg(port=True)))
    want = _observe(*DRILLS[drill](_Pkg(port=False)))
    assert got == want


def test_client_resends_lost_upload_like_jax():
    """A resend-flagged re-assignment of the trained round resends the
    cached upload; an unflagged copy is a transport duplicate; an older
    round's resend is dropped — in both packages."""
    def drive(p):
        class A:
            pass

        args = A()
        args.network = p.net(2)
        cfg = p.cfg(client_num_in_total=1, client_num_per_round=1)
        cm = p.m.FedAVGClientManager(args, 1, 2, train_fed=None,
                                     local_train=None, cfg=cfg)
        cm._train = lambda net, idx: None

        def assign(r, resend=False):
            m = p.Message(p.m.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT, 0, 1)
            m.add("round", r)
            m.add("epoch", 0)
            if resend:
                m.add("resend", True)
            cm._handle_assignment(m)

        assign(2)
        upload = p.Message(p.m.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, 1, 0)
        upload.add("round", 2)
        cm._last_upload = upload
        out = []
        for r, resend in ((2, False), (2, True), (1, True)):
            assign(r, resend)
            out.append((cm.upload_resends, cm.duplicate_drops,
                        len(args.network.inbox(0).queue)))
        return out

    assert drive(_Pkg(True)) == drive(_Pkg(False)) == [
        (0, 1, 0), (1, 1, 1), (1, 2, 1)]


# --- crash-resume, first-k ---------------------------------------------------


def _lr_setup(**cfg_kw):
    x, y, parts, xt, yt, batch = _task(1)
    fed = batching.build_federated_arrays(x, y, parts, batch, device="cpu")
    test = batching.batch_global(xt, yt, 10, device="cpu")
    cfg = FedConfig(batch_size=batch, lr=0.3, **dict(CFG, **cfg_kw))

    def model():
        return create_model("lr", num_classes=4, in_features=192,
                            device="cpu",
                            generator=torch.Generator().manual_seed(0))

    return fed, test, cfg, model


def test_crash_resume_bit_equal_to_uninterrupted(tmp_path):
    """The server dies after round 2 (its checkpoint written); a new
    server restores it under a bumped epoch, the silos adopt the epoch,
    pre-crash uploads are dropped, and the run ends on the uninterrupted
    run's net bit for bit (the int64 pool makes the fold order-free)."""
    fed, test, cfg, model = _lr_setup(comm_round=4, checkpoint_every=1,
                                      ingest_workers=2)
    clean = pfd.FedML_FedAvg_distributed(model(), fed, test, cfg,
                                         **RUN)

    class Crash(Exception):
        pass

    class CrashingServer(pfd.FedAVGServerManager):
        def _complete_round(self):
            super()._complete_round()
            if self.round_idx == 2:
                raise Crash("kill -9")

    ckpt = str(tmp_path / "ckpt")
    size, net0, local_train, eval_fn, args = pfd.build_federation_setup(
        model(), fed, test, cfg, "LOOPBACK", softmax_ce)
    server1 = CrashingServer(args, pfd.FedAVGAggregator(
        net0, size - 1, cfg, eval_fn, test, device="cpu"), cfg, size,
        checkpoint_dir=ckpt)
    clients = [pfd.FedAVGClientManager(args, r, size, fed, local_train, cfg,
                                       idle_timeout_s=60.0)
               for r in range(1, size)]
    crashed = []

    def run1():
        try:
            server1.run()
        except Crash:
            crashed.append(True)

    threads = [threading.Thread(target=run1, daemon=True)] + [
        threading.Thread(target=c.run, daemon=True) for c in clients]
    for t in threads:
        t.start()
    threads[0].join(timeout=60)
    assert crashed
    server1._pool.close()
    server1._ckpt.wait()
    agg2 = pfd.FedAVGAggregator(net0, size - 1, cfg, eval_fn, test,
                                device="cpu")
    server2 = pfd.FedAVGServerManager(args, agg2, cfg, size,
                                      checkpoint_dir=ckpt)
    assert server2.epoch == 1 and server2.round_idx == 2
    t2 = threading.Thread(target=server2.run, daemon=True)
    t2.start()
    t2.join(timeout=60)
    for t in threads[1:]:
        t.join(timeout=30)
    assert not t2.is_alive() and not any(t.is_alive() for t in threads[1:])
    assert server2.round_idx == 4
    for k in clean.net.params:
        assert torch.equal(agg2.net.params[k], clean.net.params[k]), k
    assert [h["loss"] for h in agg2.test_history] == [
        h["loss"] for h in clean.test_history[2:]]


def test_first_k_rounds_complete_with_stragglers():
    fed, test, cfg, model = _lr_setup(comm_round=4)
    agg = pfd.FedML_FedAvg_distributed(model(), fed, test, cfg,
                                       aggregate_k=2, **RUN)
    assert len(agg.test_history) == 4
    h = agg.final_health
    assert h["members"] == 3 and h["evictions"] == 0
    assert all(np.isfinite(v.numpy()).all() for v in agg.net.params.values())
    with pytest.raises(ValueError, match="aggregate_k=4 outside"):
        pfd.FedML_FedAvg_distributed(model(), fed, test, cfg,
                                     aggregate_k=4, **RUN)


def test_chaos_cut_off_silo_is_evicted_and_the_run_ends():
    fed, test, cfg, model = _lr_setup(comm_round=3, round_timeout_s=1.0,
                                      heartbeat_interval_s=0.1)
    chaos = ChaosSpec(seed=0, partitions={(3, 0), (0, 3)})
    t0 = time.monotonic()
    agg = pfd.FedML_FedAvg_distributed(model(), fed, test, cfg, chaos=chaos,
                                       idle_timeout_s=3.0, device="cpu")
    assert time.monotonic() - t0 < 30
    h = agg.final_health
    assert h["evictions"] >= 1 and h["members"] == 2
    assert len(agg.test_history) == 3 and chaos.counts["partitioned"] > 0


def test_robust_aggregator_and_legacy_compress_run():
    """The legacy ``q8`` upload (stochastic rounding drawn from
    ``core.keys``, so not JAX's draws) held against a plain reference:
    each sampled silo's step from the start net, its delta quantized by
    the same compressor under the silo's key (``fold_in(rng, 0xC0)``),
    dequantized, added back and weighted by its sample count."""
    fed, test, cfg, model = _lr_setup(comm_round=1)
    agg = pfd.FedML_FedAvg_distributed(model(), fed, test, cfg,
                                       aggregator="coord_median",
                                       **RUN)
    assert len(agg.test_history) == 1 and agg.live_model_buffers == 0
    agg = pfd.FedML_FedAvg_distributed(model(), fed, test, cfg,
                                       compress="q8", **RUN)
    start = {k: v.detach().clone() for k, v in model().named_parameters()}
    q8 = compression.make_compressor("q8")
    counts = fed.counts.numpy()
    total, wsum = None, 0.0
    for c in sample_clients(0, cfg.client_num_in_total,
                            cfg.client_num_per_round):
        rng = keys.fold_in(keys.fold_in(keys.key(cfg.seed, "cpu"), 0), int(c))
        net, _ = agg.local_train(NetState(dict(start), {}), fed.x[c],
                                 fed.y[c], fed.mask[c], rng)
        delta = {"params": {k: net.params[k] - start[k] for k in start},
                 "model_state": {}}
        payload, _ = q8.encode(delta, None, keys.fold_in(rng, 0xC0))
        got = q8.decode(payload, compression.tree_spec(delta))["params"]
        for k in start:  # within one quantization step of the delta
            step = delta["params"][k].abs().max().item() / 127
            assert (got[k] - delta["params"][k]).abs().max() <= step * 1.0001
        w = float(counts[c])
        up = {k: w * (start[k] + got[k]) for k in start}
        total = up if total is None else {k: total[k] + up[k] for k in up}
        wsum += w
    assert not any(torch.equal(total[k] / wsum, start[k]) for k in start)
    for k in start:
        torch.testing.assert_close(agg.net.params[k], total[k] / wsum,
                                   rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="mutually exclusive"):
        pfd.FedML_FedAvg_distributed(model(), fed, test, cfg,
                                     compress="q8", wire_codec="int8",
                                     **RUN)
    with pytest.raises(ValueError, match="needs the mean aggregator"):
        pfd.FedML_FedAvg_distributed(
            model(), fed, test,
            FedConfig(**{**cfg.__dict__, "ingest_workers": 2}),
            aggregator="krum", **RUN)


# --- the sharded plane, secagg and controllers; what A10d holds -------------


def test_a10b_refusals():
    """What the A10b slice refused runs now: ``agg_shards`` (by argument
    and by config, with a ``directory``), ``cfg.secagg`` and a
    ``controller`` through the entry point, each global bit-equal to the
    clear single-pool run's (the same uploads: the silos' step does not
    depend on how the server folds); ``attach_controller`` binds. A dense
    model under ``adapter_rank`` is still refused by the adapter seam. The
    GRPC, MQTT and TRPC backends still raise, citing ROADMAP.md A10d, and
    the cross-silo CLI refuses them and a pool-less ``--secagg`` as JAX's
    does."""
    from fedml_tpu_torch.ctrl import FederationController
    from fedml_tpu_torch.data.directory import ClientDirectory

    fed, test, cfg, model = _lr_setup(comm_round=2)

    def run(c, **kw):
        return pfd.FedML_FedAvg_distributed(model(), fed, test, c, **RUN,
                                            **kw)

    pooled = FedConfig(**{**cfg.__dict__, "ingest_workers": 1})
    base = run(pooled)
    directory = ClientDirectory(counts=np.full(6, 4), shard_of=np.arange(6))
    for c, kw in (
            (cfg, {"agg_shards": 2}),
            (FedConfig(**{**cfg.__dict__, "agg_shards": 2}),
             {"directory": directory}),
            (FedConfig(**{**pooled.__dict__, "secagg": True,
                          "secagg_t": 1}), {}),
            (pooled, {"controller": FederationController([])})):
        agg = run(c, **kw)
        for k in base.net.params:
            assert torch.equal(agg.net.params[k], base.net.params[k]), kw
        assert agg.final_health.get("shards", 0) == (
            2 if (kw.get("agg_shards") or c.agg_shards) else 0)
    # Adapter federations are ported: a dense model under adapter_rank is
    # refused loudly by the adapter seam, as in JAX.
    bad = FedConfig(**{**cfg.__dict__, "adapter_rank": 4})
    with pytest.raises(ValueError, match="adapter_rank > 0"):
        run(bad)
    for backend in ("GRPC", "MQTT", "TRPC"):
        with pytest.raises(NotImplementedError, match="A10d"):
            pfd.FedML_FedAvg_distributed(model(), fed, test, cfg,
                                         backend=backend, **RUN)
    args = type("A", (), {"network": loopback.LoopbackNetwork(2)})()
    srv = pfd.FedAVGServerManager(args, pfd.FedAVGAggregator(
        {"w": np.zeros(2, np.float32)}, 1, cfg, device="cpu"), cfg, 2)
    ctrl = FederationController([])
    srv.attach_controller(ctrl)
    assert srv._controller is ctrl
    srv.attach_controller(None)
    assert srv._controller is None
    from fedml_tpu_torch.exp import main_cross_silo

    for extra in (["--comm_backend", "GRPC"], ["--comm_backend", "TRPC"]):
        with pytest.raises(NotImplementedError, match="A10d"):
            main_cross_silo.main(["--rank", "0", "--size", "2",
                                  "--device", "cpu"] + extra)
    with pytest.raises(ValueError, match="needs the fixed-point ingest"):
        main_cross_silo.main(["--rank", "0", "--size", "3", "--device",
                              "cpu", "--model", "lr", "--dataset",
                              "synthetic_1_1", "--secagg"])


def test_entry_point_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    fed, test, cfg, model = _lr_setup(comm_round=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pfd.FedML_FedAvg_distributed(model(), fed, test, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pfd.FedAVGAggregator({"w": np.zeros(2, np.float32)}, 1, cfg)


def test_actuation_seam_tunes_the_live_knobs():
    args = type("A", (), {"network": loopback.LoopbackNetwork(4)})()
    cfg = FedConfig(client_num_in_total=3, client_num_per_round=3,
                    ingest_workers=1)
    srv = pfd.FedAVGServerManager(args, pfd.FedAVGAggregator(
        {"w": np.zeros(2, np.float32)}, 3, cfg, device="cpu"), cfg, 4,
        round_timeout_s=5.0)
    from fedml_tpu_torch.ctrl import ActuationRefused

    assert srv.ctrl.names == ("aggregate_k", "done_timeout_s",
                              "ingest_workers", "round_timeout_s")
    assert srv.ctrl.apply("aggregate_k", 2) == 2 and srv._k_effective() == 2
    srv.ctrl.apply("ingest_workers", 3)
    assert srv._pool.workers == 3
    with pytest.raises(ActuationRefused, match="pool_shrink"):
        srv.ctrl.apply("ingest_workers", 2)
    srv.ctrl.request("round_timeout_s", 2.5)
    srv._ctrl_boundary()
    assert srv.round_timeout_s == 2.5 == srv.heartbeat.timeout_s
    srv._pool.close()
