"""The port's sharded aggregation plane
(``fedml_tpu_torch/comm/shardplane.py``) against the JAX package's
``fedml_tpu/comm/shardplane.py``:

- the partial frame: ``encode_partial`` of the same accumulator equal to
  JAX's, leaf for leaf and in its wire bytes (exact integers, so
  tolerance 0), and ``decode_partial`` its inverse;
- the fake-clock protocol fabric of ``tests/test_shardplane.py`` (handlers
  invoked directly) replayed against both packages: M ∈ {1, 2, 4} shard
  rounds over seeded arrival permutations bit-equal to the single pool
  and to JAX's; eviction before a flush (re-routed, bit-equal to a
  federation that never had the shard) and in the middle of one;
  readmission by a beat; ``health()`` — its keys, counters and byte
  rollups — equal to JAX's;
- live loopback federations over ``lr``: the sharded global bit-equal
  to the single pool's at M ∈ {1, 2, 4}, within 1e-5 of JAX's sharded
  global from the same start weights (the sync tier's parity tolerance),
  a killed shard healed through eviction; the refusals in JAX's words."""

import threading
import time

import numpy as np
import pytest
import torch

from fedml_tpu.algos import fedavg_distributed as jfd
from fedml_tpu.algos.config import FedConfig as JaxFedConfig
from fedml_tpu.comm import ingest as jingest
from fedml_tpu.comm import loopback as jlb
from fedml_tpu.comm import shardplane as jsp
from fedml_tpu.comm import wire as jwire
from fedml_tpu.comm.message import Message as JaxMessage
from fedml_tpu_torch.algos import FedConfig
from fedml_tpu_torch.algos import fedavg_distributed as pfd
from fedml_tpu_torch.comm import ingest as pingest
from fedml_tpu_torch.comm import loopback as plb
from fedml_tpu_torch.comm import shardplane as psp
from fedml_tpu_torch.comm import wire as pwire
from fedml_tpu_torch.comm.message import Message
from test_torch_fedavg_distributed import (RUN, _assert_same_federation,
                                           _federations, _lr_setup)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Pkg:
    """One package's plane, so a drill runs against both."""

    def __init__(self, port):
        self.port = port
        self.fd, self.sp, self.lb = (pfd, psp, plb) if port else (jfd, jsp,
                                                                  jlb)
        self.ingest, self.wire = (pingest, pwire) if port else (jingest,
                                                                jwire)
        self.Message = Message if port else JaxMessage
        self.cfg = FedConfig if port else JaxFedConfig
        self.kw = {"device": "cpu"} if port else {}

    def fabric(self, m=2, workers=4, comm_round=3, wire="none", clock=None,
               aggregate_k=0):
        args = type("A", (), {})()
        size = workers + m + 1
        args.network = self.lb.LoopbackNetwork(size, wire=wire)
        cfg = self.cfg(client_num_in_total=workers,
                       client_num_per_round=workers, comm_round=comm_round,
                       frequency_of_the_test=10 ** 6)
        net0 = {"w": np.zeros(2, np.float32)}
        agg = self.fd.FedAVGAggregator(net0, workers, cfg, **self.kw)
        clk = clock or time.monotonic
        srv = self.sp.ShardedFedAVGServerManager(
            args, agg, cfg, size, m, aggregate_k=aggregate_k,
            round_timeout_s=10.0, clock=clk)
        shards = {r: self.sp.AggregatorShardManager(
            args, r, size, cfg, net0, beat_interval_s=0.0, clock=clk)
            for r in range(1, m + 1)}
        mgrs = {0: srv, **shards}
        for mgr in mgrs.values():
            mgr.register_message_receive_handlers()
        return srv, shards, agg, args.network, mgrs

    def pump(self, network, mgrs):
        """Drain the coordinator/shard inboxes until quiescent, through
        the registered handlers (per-channel FIFO kept)."""
        progress = True
        while progress:
            progress = False
            for rank, mgr in mgrs.items():
                q = network.inbox(rank)
                while not q.empty():
                    msg = q.get()
                    if isinstance(msg, (bytes, bytearray)):
                        n = len(msg)
                        msg = self.wire.deserialize_message(msg,
                                                            network.wire)
                        mgr.com_manager.bytes_ledger.count_rx(
                            int(msg.get_sender_id()), n)
                    if not isinstance(msg, self.Message):
                        continue  # a finish() stop sentinel
                    mgr.receive_message(msg.get_type(), msg)
                    progress = True

    def assignments(self, network, srv):
        """Drain every worker inbox: worker → latest stamped shard."""
        routed = {}
        for w in sorted(srv._members_snapshot()):
            q = network.inbox(w)
            while not q.empty():
                msg = q.get()
                if isinstance(msg, (bytes, bytearray)):
                    msg = self.wire.deserialize_message(msg, network.wire)
                if not isinstance(msg, self.Message):
                    continue
                sr = msg.get(self.fd.MSG_ARG_KEY_SHARD_RANK)
                if sr is not None:
                    routed[w] = int(sr)
        return routed

    def upload(self, network, worker, shard, value, n=10, round_idx=0):
        m = self.Message(self.fd.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, worker,
                         shard)
        m.add(self.Message.MSG_ARG_KEY_MODEL_PARAMS,
              {"w": np.asarray(value, np.float32)})
        m.add(self.Message.MSG_ARG_KEY_NUM_SAMPLES, n)
        m.add("round", round_idx)
        m.add("epoch", 0)
        self.lb.LoopbackCommManager(network, worker).send_message(m)

    def net(self, agg):
        w = agg.net["w"]
        return np.asarray(w.numpy() if torch.is_tensor(w) else w)


# --- the partial frame ----------------------------------------------------------


def _accumulator(mod, seed=0, n=5):
    rng = np.random.RandomState(seed)
    acc = mod.PartialAccumulator()
    for _ in range(n):
        acc.add([rng.randn(3, 2).astype(np.float32),
                 rng.randn(4).astype(np.float32)], float(rng.randint(1, 9)))
    return acc


def test_encode_partial_equals_jax_and_roundtrips():
    got = psp.encode_partial(_accumulator(pingest))
    want = jsp.encode_partial(_accumulator(jingest))
    assert {k: v for k, v in got.items() if k != "leaves"} == {
        k: v for k, v in want.items() if k != "leaves"}
    for a, b in zip(got["leaves"], want["leaves"]):
        assert a.dtype == b.dtype == np.int64
        np.testing.assert_array_equal(a, b)
    frames = []
    for pkg, frame in ((Pkg(True), got), (Pkg(False), want)):
        msg = pkg.Message(psp.MSG_TYPE_SHARD2COORD_PARTIAL, 1, 0)
        msg.add(psp.PARTIAL_KEY, frame)
        msg.add("round", 3)
        frames.append(pkg.wire.serialize_message(msg, "tensor"))
    assert frames[0] == frames[1]
    back = psp.decode_partial(pwire.deserialize_message(
        frames[0], "tensor").get(psp.PARTIAL_KEY))
    acc = _accumulator(pingest)
    assert (back.wsum, back.count, back.saturated) == (acc.wsum, acc.count,
                                                       acc.saturated)
    for a, b in zip(back.leaves, acc.leaves):
        np.testing.assert_array_equal(a, b)
    empty = psp.encode_partial(pingest.PartialAccumulator())
    assert empty == jsp.encode_partial(jingest.PartialAccumulator())
    assert psp.decode_partial(empty).leaves is None


# --- the fake-clock fabric against JAX's -----------------------------------------


def _fabric_round(pkg, m, order_seed, workers=6):
    srv, shards, agg, network, mgrs = pkg.fabric(m=m, workers=workers,
                                                 comm_round=1)
    srv.send_init_msg()
    pkg.pump(network, mgrs)
    routed = pkg.assignments(network, srv)
    assert sorted(routed) == sorted(srv._members_snapshot())
    order = np.random.default_rng(order_seed).permutation(sorted(routed))
    for w in order:
        slot = srv._worker_slot(int(w))
        pkg.upload(network, int(w), routed[int(w)],
                   [float(slot + 1), float(-slot)], n=5 + slot)
    pkg.pump(network, mgrs)
    assert srv.round_idx == 1
    out = (pkg.net(agg), routed, srv.health())
    for sh in shards.values():
        sh._pool.close()
    return out


@pytest.mark.parametrize("m", [1, 2, 4])
def test_sharded_fold_bit_equal_to_single_pool_and_jax(m):
    workers = 6
    pool = pingest.IngestPool(1)
    for slot in range(workers):
        leaves = [np.asarray([float(slot + 1), float(-slot)], np.float32)]
        pool.submit(lambda l=leaves, n=5 + slot: (l, float(n)))
    pool.drain()
    ref, _ = pool.finalize_mean({"w": np.zeros(2, np.float32)})
    pool.close()
    for seed in (0, 3, 11):
        got = _fabric_round(Pkg(True), m, seed, workers)
        want = _fabric_round(Pkg(False), m, seed, workers)
        np.testing.assert_array_equal(got[0], np.asarray(ref["w"]))
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:] and got[2]["shards"] == m


def _evict_pre_flush(pkg):
    t = [0.0]
    srv, shards, agg, network, mgrs = pkg.fabric(m=2, workers=4,
                                                 comm_round=1,
                                                 clock=lambda: t[0])
    srv.send_init_msg()
    pkg.pump(network, mgrs)
    routed = pkg.assignments(network, srv)
    via1 = sorted(w for w, s in routed.items() if s == 1)
    via2 = sorted(w for w, s in routed.items() if s == 2)
    assert via1 and via2
    for w in via1:
        pkg.upload(network, w, 1, [float(srv._worker_slot(w) + 1), 0.5],
                   n=4 + srv._worker_slot(w))
    pkg.pump(network, mgrs)
    waiting = srv.round_idx
    t[0] = 99.0
    srv.shard_heartbeat.beat(1)
    srv._post_shard_tick([2])
    pkg.pump(network, mgrs)
    rerouted = pkg.assignments(network, srv)
    for w in via2:
        pkg.upload(network, w, 1, [float(srv._worker_slot(w) + 1), 0.5],
                   n=4 + srv._worker_slot(w))
    pkg.pump(network, mgrs)
    kinds = [e["kind"] for e in srv.flight.snapshot()]
    out = (waiting, srv.round_idx, pkg.net(agg), routed, rerouted,
           srv.health(), "shard_eviction" in kinds)
    for sh in shards.values():
        sh._pool.close()
    return out


def test_shard_eviction_before_a_flush_like_jax():
    """Shard 2 dies before its workers arrive: evicted, its workers
    re-routed to shard 1 with resend-flagged assignments, the round
    committed bit-equal to JAX's and to a fabric that never had the
    shard (the same arrivals at M = 1)."""
    got, want = _evict_pre_flush(Pkg(True)), _evict_pre_flush(Pkg(False))
    np.testing.assert_array_equal(got[2], want[2])
    assert got[:2] == want[:2] == (0, 1)
    assert got[3:] == want[3:]
    assert got[5]["shards"] == 1 and got[5]["shard_evictions"] == 1
    pkg = Pkg(True)
    srv1, shards1, agg1, network1, mgrs1 = pkg.fabric(m=1, workers=4,
                                                      comm_round=1)
    srv1.send_init_msg()
    pkg.pump(network1, mgrs1)
    pkg.assignments(network1, srv1)
    for w in sorted(got[3]):
        slot = srv1._worker_slot(w - 1)
        pkg.upload(network1, w - 1, 1, [float(slot + 1), 0.5], n=4 + slot)
    pkg.pump(network1, mgrs1)
    np.testing.assert_array_equal(got[2], pkg.net(agg1))
    shards1[1]._pool.close()


def _evict_mid_flush(pkg):
    t = [0.0]
    srv, shards, agg, network, mgrs = pkg.fabric(m=2, workers=4,
                                                 comm_round=3, aggregate_k=2,
                                                 clock=lambda: t[0])
    srv.send_init_msg()
    pkg.pump(network, mgrs)
    routed = pkg.assignments(network, srv)
    via1 = sorted(w for w, s in routed.items() if s == 1)
    via2 = sorted(w for w, s in routed.items() if s == 2)
    for w in via1:
        pkg.upload(network, w, 1, [1.0, 2.0], n=10)
    live = {0: mgrs[0], 1: mgrs[1]}  # shard 2 wedged: its FLUSH unread
    pkg.pump(network, live)
    flushing = srv._flushing_round
    t[0] = 99.0
    srv.shard_heartbeat.beat(1)
    srv._post_shard_tick([2])
    pkg.pump(network, live)
    rerouted = pkg.assignments(network, srv)
    out = (flushing, srv.round_idx, pkg.net(agg), srv.health(),
           {rerouted.get(w) for w in via2})
    for sh in shards.values():
        sh._pool.close()
    return out


def test_shard_eviction_mid_flush_like_jax():
    """A shard dying after the flush started: the round commits over the
    survivor's partial, its workers rejoin re-routed — as in JAX."""
    got, want = _evict_mid_flush(Pkg(True)), _evict_mid_flush(Pkg(False))
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[2], [1.0, 2.0], atol=1e-6)
    assert got[:2] == want[:2] == (0, 1)
    assert got[3:] == want[3:] and got[4] == {1}


def _readmit(pkg):
    t = [0.0]
    srv, shards, agg, network, mgrs = pkg.fabric(m=2, workers=4,
                                                 comm_round=5,
                                                 clock=lambda: t[0])
    srv.send_init_msg()
    pkg.pump(network, mgrs)
    pkg.assignments(network, srv)
    t[0] = 99.0
    srv.shard_heartbeat.beat(1)
    srv._post_shard_tick([2])
    pkg.pump(network, mgrs)
    evicted = srv.health()["shards"]
    beat = pkg.Message(psp.MSG_TYPE_SHARD2COORD_BEAT, 2, 0)
    beat.add("epoch", 0)
    srv.receive_message(beat.get_type(), beat)
    pkg.pump(network, mgrs)
    out = (evicted, srv.health(), shards[2].round_idx == srv.round_idx,
           srv._route_shard(1),
           "shard_readmission" in [e["kind"] for e in srv.flight.snapshot()])
    for sh in shards.values():
        sh._pool.close()
    return out


def test_shard_readmission_like_jax():
    got, want = _readmit(Pkg(True)), _readmit(Pkg(False))
    assert got == want
    assert got[0] == 1 and got[1]["shards"] == 2
    assert got[1]["shard_readmissions"] == 1 and got[2:] == (True, 2, True)


def _health_rollup(pkg):
    srv, shards, agg, network, mgrs = pkg.fabric(m=2, workers=4,
                                                 comm_round=1, wire="tensor")
    srv.send_init_msg()
    pkg.pump(network, mgrs)
    routed = pkg.assignments(network, srv)
    for w, s in routed.items():
        pkg.upload(network, w, s, [1.0, 1.0], n=3)
    pkg.pump(network, mgrs)
    after_round = srv.health()
    shard_bytes = dict(srv._shard_bytes)
    frame = pkg.sp.encode_partial(pkg.ingest.PartialAccumulator())
    frame["saturated"] = 4
    stale = pkg.Message(psp.MSG_TYPE_SHARD2COORD_PARTIAL, 1, 0)
    stale.add(psp.PARTIAL_KEY, frame)
    stale.add("round", -5)
    stale.add("epoch", 0)
    stale.add("bytes_rx", 0)
    stale.add("bytes_tx", 0)
    srv.receive_message(stale.get_type(), stale)
    own = srv.com_manager.bytes_ledger.total_rx
    out = (after_round, srv.health(), own, shard_bytes)
    for sh in shards.values():
        sh._pool.close()
    return out


def test_health_keys_and_rollups_equal_jax():
    """``health()``'s keys and values after a round and after a stale
    partial — the fleet-wide saturation gauge, the counters, and the
    shards' byte ledgers (the same frames on the tensor wire) — JAX's.
    The coordinator's own received bytes are not compared: each partial
    carries the shard's dispatch occupancy, a wall-clock float whose
    printed length varies from run to run; in both packages ``bytes_rx``
    adds it to the shards' totals."""
    got, want = _health_rollup(Pkg(True)), _health_rollup(Pkg(False))
    assert list(got[0]) == list(want[0])
    assert got[3] == want[3] and sorted(got[3]) == [1, 2]
    for (h0, h1, _, shard_bytes) in (got, want):
        rx = sum(r for r, _ in shard_bytes.values())
        assert h0["bytes_rx"] > rx > 0 and h1["ingest_saturated"] == 4
    for a, b in ((got[0], want[0]), (got[1], want[1])):
        assert ({k: v for k, v in a.items() if k != "bytes_rx"}
                == {k: v for k, v in b.items() if k != "bytes_rx"})


def test_killed_shard_drops_inflight_traffic():
    """A finished shard ignores uploads, anchors and flushes, and a
    submit that races its finish() reports a drop instead of raising."""
    pkg = Pkg(True)
    srv, shards, agg, network, mgrs = pkg.fabric(m=1, workers=2)
    shard = shards[1]
    shard.finish()
    up = Message(pfd.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, 2, 1)
    up.add(Message.MSG_ARG_KEY_MODEL_PARAMS, {"w": np.ones(2, np.float32)})
    up.add(Message.MSG_ARG_KEY_NUM_SAMPLES, 4.0)
    up.add("round", 0)
    up.add("epoch", 0)
    for m_ in (up, Message(psp.MSG_TYPE_COORD2SHARD_ANCHOR, 0, 1),
               Message(psp.MSG_TYPE_COORD2SHARD_FLUSH, 0, 1)):
        shard.receive_message(m_.get_type(), m_)
    assert shard.accepted == 0
    assert shard._submit_upload(2, 0, up) is False


# --- live federations ------------------------------------------------------------


def test_loopback_sharded_bit_equal_to_single_pool():
    fed, test, cfg, model = _lr_setup(comm_round=2)

    def run(c, m):
        return pfd.FedML_FedAvg_distributed(
            model(), fed, test, c, agg_shards=m, wire_codec="topk0.25+int8",
            loopback_wire="tensor", **RUN)

    base = run(FedConfig(**{**cfg.__dict__, "ingest_workers": 1}), 0)
    for m in (1, 2, 4):
        agg = run(cfg, m)
        for k in base.net.params:
            assert torch.equal(agg.net.params[k], base.net.params[k]), m
        h = agg.final_health
        assert h["shards"] == m and h["shard_evictions"] == 0
        assert h["bytes_rx"] > base.final_health["bytes_rx"]


def test_sharded_global_against_jax():
    """The port's sharded federation (M = 2) and JAX's from the same
    start weights: each round's eval and the final net within 1e-5."""
    agg, jagg, start = _federations("lr", dict(comm_round=3, lr=0.1),
                                    agg_shards=2)
    _assert_same_federation(agg, jagg, start, 3)
    assert agg.final_health["shards"] == jagg.final_health["shards"] == 2


def test_loopback_kill_one_shard_drill():
    """Shard 2 of 2 dies after round 0: evicted (flight-recorded), the
    survivor takes every route, and the run ends at its last round."""
    fed, test, cfg, model = _lr_setup(comm_round=4,
                                      heartbeat_interval_s=0.05)
    size, net0, local_train, eval_fn, args = pfd.build_federation_setup(
        model(), fed, test, cfg, "LOOPBACK", pfd.softmax_ce, extra_ranks=2)
    agg = pfd.FedAVGAggregator(net0, size - 3, cfg, eval_fn, test,
                               device="cpu")
    srv = psp.ShardedFedAVGServerManager(args, agg, cfg, size, 2,
                                         round_timeout_s=8.0,
                                         heartbeat_timeout_s=0.5)
    shards = [psp.AggregatorShardManager(args, r, size, cfg, net0)
              for r in (1, 2)]
    clients = [pfd.FedAVGClientManager(args, r, size, fed, local_train, cfg,
                                       idle_timeout_s=30.0)
               for r in range(3, size)]

    def killer():
        deadline = time.monotonic() + 10.0
        while srv.round_idx < 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        shards[1].finish()

    threads = [threading.Thread(target=f, daemon=True) for f in
               [srv.run] + [s.run for s in shards] + [c.run for c in clients]
               + [killer]]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert srv.round_idx == 4 and not srv.aborted
    assert srv.shard_evictions >= 1 and srv.health()["shards"] == 1
    assert any(e["kind"] == "shard_eviction" for e in srv.flight.snapshot())
    assert all(np.isfinite(h["loss"]) for h in agg.test_history)


def test_refusals_in_jax_words():
    """agg_shards on the simulator's async modes and a coordinator with no
    worker rank left: JAX's messages."""
    from fedml_tpu.sim import FleetSimulator as JaxSim
    from fedml_tpu.sim import FleetSpec as JaxSpec
    from fedml_tpu.sim import make_fleet_trace as jax_trace
    from fedml_tpu_torch.sim import FleetSimulator, FleetSpec, make_fleet_trace

    fed, test, cfg, model = _lr_setup(comm_round=1)
    with pytest.raises(ValueError) as got:
        FleetSimulator(model(), fed, None, cfg,
                       make_fleet_trace(FleetSpec(n_devices=3)),
                       mode="fedbuff", agg_shards=2, device="cpu")
    with pytest.raises(ValueError) as want:
        JaxSim(None, None, None, JaxFedConfig(),
               jax_trace(JaxSpec(n_devices=3)), mode="fedbuff",
               agg_shards=2)
    assert str(got.value) == str(want.value)
    for pkg in (Pkg(True), Pkg(False)):
        args = type("A", (), {"network": pkg.lb.LoopbackNetwork(3)})()
        c = pkg.cfg(client_num_in_total=1, client_num_per_round=1)
        with pytest.raises(ValueError) as err:
            pkg.sp.ShardedFedAVGServerManager(
                args, pkg.fd.FedAVGAggregator({"w": np.zeros(2, np.float32)},
                                              1, c, **pkg.kw), c, 3, 2)
        assert "leaves no worker ranks" in str(err.value)
