"""The port's secure aggregation (``fedml_tpu_torch/comm/secagg.py`` and
the sync tier's protocol in ``algos/fedavg_distributed.py``) against the
JAX package's ``fedml_tpu/comm/secagg.py``:

- bit-equal to JAX for the same secrets, keys, epoch and round (exact
  integer arithmetic, so tolerance 0): ``expand_masks``, ``mask_seed``,
  ``_share_pad``, ``resolve_threshold`` (its refusals in JAX's words),
  ``apply_pair_masks``, the encrypted share matrix, the reveal and the
  dropout correction;
- live loopback federations over ``lr``: the masked global bit-equal to
  the clear pooled global at ingest workers 1 and 2 and shards 1 and 2
  (the clear fold of the same uploads: the silos' step does not depend
  on how the server folds), and refused at workers 0 and shards 0 in
  JAX's words; the dropout drill, whose committed round is bit-equal to
  the survivors' clear fold; the stale-epoch share fence, against JAX's
  server; the masked federation's global against JAX's masked global
  from the same start weights within 1e-5 (the sync tier's parity
  tolerance, ``test_torch_fedavg_distributed.py``);
- the server and client guards in JAX's words."""

import threading

import numpy as np
import pytest
import torch

from fedml_tpu.algos import fedavg_distributed as jfd
from fedml_tpu.algos.config import FedConfig as JaxFedConfig
from fedml_tpu.comm import loopback as jlb
from fedml_tpu.comm import secagg as jsa
from fedml_tpu.comm.message import Message as JaxMessage
from fedml_tpu_torch.algos import FedConfig
from fedml_tpu_torch.algos import fedavg_distributed as pfd
from fedml_tpu_torch.comm import loopback as plb
from fedml_tpu_torch.comm import secagg as psa
from fedml_tpu_torch.comm.ingest import (FixedContribution,
                                         PartialAccumulator,
                                         quantize_weight)
from fedml_tpu_torch.comm.message import Message
from test_torch_fedavg_distributed import (_assert_same_federation,
                                           _federations, _lr_setup)

SHAPES = [(3, 2), (5,)]
#: Every port run on the CPU; a silo quits after 30 s without its server.
RUN = dict(device="cpu", idle_timeout_s=30.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _handshake(mod, n, t=0, epoch=0):
    """One package's setup round: ranks 1..n with injected secrets, pk
    exchange, roster broadcast, the encrypted share rows."""
    ranks = list(range(1, n + 1))
    srv = mod.SecAggServer(ranks, t=t)
    clients = {r: mod.SecAggClient(r, epoch, sk=1000 + 7 * r)
               for r in ranks}
    for r, c in clients.items():
        srv.add_pk(r, c.pk)
    body = srv.roster_payload(ranks)
    for r, c in clients.items():
        srv.add_row(r, c.build_shares(body["pks"], body["t"],
                                      body["universe"]))
    return srv, clients


def _contributions(n, seed=0):
    """n quantized fixed-point contributions (the silo's path: the
    accumulator's int64 grid)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        acc = PartialAccumulator()
        w = float(rng.randint(1, 50))
        acc.add([rng.randn(*s).astype(np.float32) for s in SHAPES], w)
        out.append(([l.copy() for l in acc.leaves], w))
    return out


# --- the protocol's arithmetic against JAX's ---------------------------------


def test_expand_masks_and_mask_seed_equal_jax():
    for seed in (0, 1, 2 ** 63 + 5, 0xFFFFFFFFFFFFFFFF):
        for got, want in zip(psa.expand_masks(seed, SHAPES),
                             jsa.expand_masks(seed, SHAPES)):
            assert got.dtype == want.dtype == np.uint64
            np.testing.assert_array_equal(got, want)
    for key in (3, 2 ** 31 - 2, 123456789):
        for epoch in (0, 4):
            for r in (0, 1, 17):
                assert psa.mask_seed(key, epoch, r) == jsa.mask_seed(
                    key, epoch, r)
                assert (psa._share_pad(key, epoch, 1, r + 2,
                                       psa.DEFAULT_PRIME)
                        == jsa._share_pad(key, epoch, 1, r + 2,
                                          jsa.DEFAULT_PRIME))


@pytest.mark.parametrize("n,requested", [
    (1, 0), (1, 1), (1, 2), (2, 0), (2, 1), (3, 0), (4, 0), (4, 3),
    (4, 4), (5, 0), (9, 2), (9, 0)])
def test_resolve_threshold_equals_jax(n, requested):
    try:
        want = jsa.resolve_threshold(n, requested)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            psa.resolve_threshold(n, requested)
        assert str(got.value) == str(err)
        return
    assert psa.resolve_threshold(n, requested) == want


def test_apply_pair_masks_equals_jax_and_cancels():
    rng = np.random.RandomState(3)
    roster = [1, 2, 4, 5]
    keys = {(i, j): int(rng.randint(1, 2 ** 31 - 1))
            for i in roster for j in roster if i < j}
    clear = _contributions(len(roster), seed=1)
    total = None
    for rank, (leaves, _) in zip(roster, clear):
        pair = {j: keys[min(rank, j), max(rank, j)]
                for j in roster if j != rank}
        got = psa.apply_pair_masks([l.copy() for l in leaves], rank, pair,
                                   roster, 2, 7)
        want = jsa.apply_pair_masks([l.copy() for l in leaves], rank, pair,
                                    roster, 2, 7)
        for a, b, c in zip(got, want, leaves):
            np.testing.assert_array_equal(a, b)
            assert not np.array_equal(a, c)
        u = [l.view(np.uint64) for l in got]
        total = u if total is None else [a + b for a, b in zip(total, u)]
    ref = None
    for leaves, _ in clear:
        u = [l.view(np.uint64) for l in leaves]
        ref = u if ref is None else [a + b for a, b in zip(ref, u)]
    for a, b in zip(total, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,t", [(3, 0), (4, 0), (5, 2), (6, 0)])
def test_share_matrix_reveal_and_correction_equal_jax(n, t):
    """The encrypted share matrix, each survivor's decrypted share, the
    reconstructed secret and the dropout correction: JAX's, bit for
    bit; the corrected total equals the survivors' clear fold."""
    psrv, pcl = _handshake(psa, n, t)
    jsrv, jcl = _handshake(jsa, n, t)
    assert psrv.t == jsrv.t and psrv.rows == jsrv.rows
    assert {r: c.pk for r, c in pcl.items()} == {r: c.pk
                                                 for r, c in jcl.items()}
    victim, ranks = 2, list(range(1, n + 1))
    roster = psrv.stamp_roster(0, ranks)
    assert roster == jsrv.stamp_roster(0, ranks)
    arrived = [r for r in ranks if r != victim]
    clear = _contributions(n, seed=n)
    total = PartialAccumulator()
    for r in arrived:
        masked = pcl[r].mask([l.copy() for l in clear[r - 1][0]], 0, roster)
        jmasked = jcl[r].mask([l.copy() for l in clear[r - 1][0]], 0,
                              roster)
        for a, b in zip(masked, jmasked):
            np.testing.assert_array_equal(a, b)
        total.add_fixed(FixedContribution(masked,
                                          quantize_weight(clear[r - 1][1]),
                                          1, 0))
    for h in arrived:
        cipher = psrv.reveal_request(victim, h)
        assert cipher == jsrv.reveal_request(victim, h)
        share = pcl[h].reveal_share(victim, cipher)
        assert share == jcl[h].reveal_share(victim, cipher)
        done = psrv.add_reveal_share(victim, h, share)
        assert done == jsrv.add_reveal_share(victim, h, share)
        if done:
            break
    assert psrv.revealed == jsrv.revealed == {victim: pcl[victim].sk}
    corr = psrv.correction(victim, 0, 0, arrived, [s for s in SHAPES])
    for a, b in zip(corr, jsrv.correction(victim, 0, 0, arrived, SHAPES)):
        np.testing.assert_array_equal(a, b)
    total.add_fixed(FixedContribution(corr, 0, 0))
    ref = PartialAccumulator()
    for r in arrived:
        ref.add_fixed(FixedContribution(clear[r - 1][0],
                                        quantize_weight(clear[r - 1][1]),
                                        1, 0))
    assert total.wsum == ref.wsum and total.count == ref.count
    for a, b in zip(total.leaves, ref.leaves):
        np.testing.assert_array_equal(a, b)
    assert psrv.compromised(victim) and not psrv.can_participate(victim)


# --- live federations ---------------------------------------------------------


def _secagg_run(masked, workers=0, shards=0, **kw):
    fed, test, cfg, model = _lr_setup(comm_round=2, secagg=masked,
                                      ingest_workers=workers)
    return pfd.FedML_FedAvg_distributed(model(), fed, test, cfg,
                                        agg_shards=shards,
                                        loopback_wire="tensor", **RUN, **kw)


@pytest.mark.parametrize("workers,shards", [(1, 0), (2, 0), (0, 1), (0, 2)],
                         ids=["workers1", "workers2", "shards1", "shards2"])
def test_masked_loopback_bit_equal_to_clear_pooled(workers, shards):
    """The masked federation's global bit-equal to the clear pooled one
    (ingest workers 1), with the int8 wire codec too (the silo quantizes
    its self-decoded frame); no upload carries a clear train loss."""
    base = _secagg_run(False, workers=1)
    agg = _secagg_run(True, workers=workers, shards=shards)
    for k in base.net.params:
        assert torch.equal(agg.net.params[k], base.net.params[k]), k
    h = agg.final_health
    assert h["seed_reveals"] == 0 and h["codec_refusals"] == 0
    assert h.get("shards", 0) == shards
    base = _secagg_run(False, workers=1, wire_codec="int8")
    agg = _secagg_run(True, workers=workers, shards=shards,
                      wire_codec="int8")
    for k in base.net.params:
        assert torch.equal(agg.net.params[k], base.net.params[k]), k


def test_masked_loopback_without_a_fixed_point_path_refused_like_jax():
    fed, test, cfg, model = _lr_setup(comm_round=1, secagg=True)
    with pytest.raises(ValueError) as got:
        pfd.FedML_FedAvg_distributed(model(), fed, test, cfg, **RUN)
    args = type("A", (), {"network": jlb.LoopbackNetwork(4)})()
    jcfg = JaxFedConfig(client_num_in_total=6, client_num_per_round=3,
                        secagg=True)
    with pytest.raises(ValueError) as want:
        jfd.FedAVGServerManager(args, jfd.FedAVGAggregator(
            {"w": np.zeros(2, np.float32)}, 3, jcfg), jcfg, 4)
    assert str(got.value) == str(want.value)


class _ClearSpy:
    """Each silo's clear fixed-point contribution (copied before its
    masks) by (rank, round), and each merged total the server audits
    between cancellation and division, by round."""

    def __init__(self, monkeypatch):
        self.clear, self.totals = {}, {}
        mask = psa.SecAggClient.mask
        check = pfd.FedAVGServerManager._secagg_envelope_check

        def mask_spy(client, leaves, round_idx, roster):
            self.clear[(client.rank, int(round_idx))] = [
                np.array(l, np.int64, copy=True) for l in leaves]
            return mask(client, leaves, round_idx, roster)

        def check_spy(server, total):
            self.totals[server.round_idx] = (
                [np.array(l, np.int64, copy=True) for l in total.leaves],
                total.count)
            return check(server, total)

        monkeypatch.setattr(psa.SecAggClient, "mask", mask_spy)
        monkeypatch.setattr(pfd.FedAVGServerManager,
                            "_secagg_envelope_check", check_spy)

    def fold(self, round_idx, ranks):
        out = None
        for r in ranks:
            u = [l.view(np.uint64) for l in self.clear[(r, round_idx)]]
            out = u if out is None else [a + b for a, b in zip(out, u)]
        return [l.view(np.int64) for l in out]


def test_masked_dropout_reveal_drill_bit_equal_to_survivors(tmp_path,
                                                            monkeypatch):
    """Silo 1 dies in round 1 after its roster was stamped: the watchdog
    evicts it, the survivors reveal t shares of its secret, the orphaned
    masks are corrected away, and round 1's committed total is the
    survivors' clear fold, bit for bit; the victim is released."""
    spy = _ClearSpy(monkeypatch)
    fed, _, cfg, model = _lr_setup(comm_round=2, secagg=True,
                                   ingest_workers=1,
                                   heartbeat_interval_s=0.05)
    cfg = FedConfig(**{**cfg.__dict__, "client_num_per_round": 4})
    size, net0, local_train, eval_fn, args = pfd.build_federation_setup(
        model(), fed, None, cfg, "LOOPBACK", pfd.softmax_ce)
    srv = pfd.FedAVGServerManager(
        args, pfd.FedAVGAggregator(net0, size - 1, cfg, device="cpu"), cfg,
        size, round_timeout_s=1.5, heartbeat_timeout_s=0.4,
        flight_dir=str(tmp_path))

    class Victim(pfd.FedAVGClientManager):
        def _train(self, global_net, client_index):
            if self.round_idx >= 1:
                self.finish()
                return
            super()._train(global_net, client_index)

    clients = [(Victim if r == 1 else pfd.FedAVGClientManager)(
        args, r, size, fed, local_train, cfg, idle_timeout_s=30.0)
        for r in range(1, size)]
    threads = [threading.Thread(target=m.run, daemon=True)
               for m in [srv] + clients]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not srv.aborted and srv.round_idx == 2
    h = srv.health()
    assert h["seed_reveals"] == 1 and h["evictions"] >= 1
    assert srv.secagg.compromised(1) and not srv.secagg.can_participate(1)
    assert srv._h_reveal.snapshot()["count"] == 1
    for r, ranks in ((0, [1, 2, 3, 4]), (1, [2, 3, 4])):
        got, count = spy.totals[r]
        assert count == len(ranks)
        for a, b in zip(got, spy.fold(r, ranks)):
            np.testing.assert_array_equal(a, b)
    kinds = {e["kind"] for e in srv.flight.snapshot()}
    assert {"seed_reveal_request", "seed_reveal", "eviction",
            "secagg_setup", "secagg_correction"} <= kinds


def _stale_share_server(port):
    cls = (pfd, FedConfig, plb, Message) if port else (
        jfd, JaxFedConfig, jlb, JaxMessage)
    mod, Cfg, lb, Msg = cls
    args = type("A", (), {"network": lb.LoopbackNetwork(4)})()
    cfg = Cfg(client_num_in_total=3, client_num_per_round=3, comm_round=2,
              secagg=True, ingest_workers=1)
    kw = {"device": "cpu"} if port else {}
    srv = mod.FedAVGServerManager(args, mod.FedAVGAggregator(
        {"w": np.zeros(4, np.float32)}, 3, cfg, **kw), cfg, 4)
    msg = Msg(mod.MSG_TYPE_C2S_SEED_SHARE, 1, 0)
    msg.add("epoch", srv.epoch + 7)
    msg.add("round", 0)
    msg.add("target", 2)
    msg.add("share", 12345)
    srv._handle_seed_share(msg)
    out = (srv.epoch_drops, srv.seed_reveals, srv.secagg.shares_held(2),
           [e["kind"] for e in srv.flight.snapshot()], srv.health())
    srv._pool.close()
    return out


def test_stale_epoch_seed_share_is_fenced_like_jax():
    got, want = _stale_share_server(True), _stale_share_server(False)
    assert got == want
    assert got[:3] == (1, 0, 0) and "seed_reveal_stale" in got[3]


@pytest.mark.parametrize("guard", ["firstk", "aggregator", "sharded_firstk",
                                   "client_compress"])
def test_server_and_client_guards_in_jax_words(guard):
    def build(port):
        mod, Cfg, lb = (pfd, FedConfig, plb) if port else (jfd, JaxFedConfig,
                                                          jlb)
        args = type("A", (), {"network": lb.LoopbackNetwork(5)})()
        cfg = Cfg(client_num_in_total=4, client_num_per_round=4,
                  comm_round=2, secagg=True, ingest_workers=1)
        kw = {"device": "cpu"} if port else {}
        net = {"w": np.zeros(4, np.float32)}
        if guard == "firstk":
            mod.FedAVGServerManager(args, mod.FedAVGAggregator(
                net, 4, cfg, **kw), cfg, 5, aggregate_k=2)
        elif guard == "aggregator":
            mod.FedAVGServerManager(args, mod.FedAVGAggregator(
                net, 4, cfg, aggregator="coord_median", **kw), cfg, 5)
        elif guard == "sharded_firstk":
            sp = __import__(("fedml_tpu_torch" if port else "fedml_tpu")
                            + ".comm.shardplane", fromlist=["x"])
            sp.ShardedFedAVGServerManager(args, mod.FedAVGAggregator(
                net, 3, cfg, **kw), cfg, 5, 1, aggregate_k=2)
        else:
            mod.FedAVGClientManager(args, 1, 5, None, None, cfg,
                                    compress="topk0.25")

    with pytest.raises(ValueError) as want:
        build(False)
    with pytest.raises(ValueError) as got:
        build(True)
    assert str(got.value) == str(want.value)


def test_masked_global_against_jax():
    """The port's masked federation (ingest workers 2) and JAX's from the
    same start weights: each round's eval and the final net within 1e-5
    (the masks cancel exactly in both, so this is the sync tier's parity
    over the fixed-point fold)."""
    agg, jagg, start = _federations(
        "lr", dict(comm_round=3, lr=0.1, ingest_workers=2, secagg=True))
    _assert_same_federation(agg, jagg, start, 3)
    assert agg.final_health["seed_reveals"] == jagg.final_health[
        "seed_reveals"] == 0
