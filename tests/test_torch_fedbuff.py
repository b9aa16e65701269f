"""The port's buffered tier (``fedml_tpu_torch/algos/fedbuff.py``) and
``main_extra``'s message-passing runners against the JAX package's
``fedml_tpu/algos/fedbuff.py`` and ``fedml_tpu/exp/main_extra.py``:

- loopback federations with ONE worker over ``lr`` and a narrow GroupNorm
  ResNet from JAX's start weights, ``buffer_k`` 2: the global after every
  flush within f32 atol 1e-5 of JAX's;
- the server's fold driven directly with one recorded sequence of deltas
  at staleness 0..2 and one non-finite delta, for ``mean`` (inline and
  through the int64 ingest pool) and each non-mean aggregator: the global
  after every flush within 1e-6 of JAX's (the same f32 operations a
  leaf; the pool's fixed point is exact) and the same ``guard_drops``;
- ports of the JAX package's buffered-tier drills (``test_ingest_pool.py``,
  ``test_wire_codec.py``, ``test_trace.py``) and the corruption drill;
- the FedAsync, FedBuff and BaseFramework CLI runs and refusals of
  ``tests/test_exp_extra.py`` against what the JAX runner outputs."""

import json

import numpy as np
import pytest
import torch

from fedml_tpu.algos import fedbuff as jfb
from fedml_tpu.exp import main_extra as jax_main_extra
from fedml_tpu_torch.algos import FedConfig
from fedml_tpu_torch.algos import fedbuff as pfb
from fedml_tpu_torch.comm import codec as pcodec
from fedml_tpu_torch.comm.resilience import ChaosSpec
from fedml_tpu_torch.core.faults import UpdateCorruptor
from fedml_tpu_torch.exp import main_extra
from test_torch_fedasync import (IDLE_S, NET0, FOLD_ATOL, Harness, _lr,
                                 _lr_fed, assert_same_versions, feed,
                                 jax_start, recorded_uploads, run_tier)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- end-to-end parity ----------------------------------------------------------


@pytest.mark.parametrize("name,lr,flushes", [("lr", 0.1, 3),
                                             ("resnet", 1e-3, 2)])
def test_fedbuff_one_worker_matches_jax_every_flush(name, lr, flushes):
    start = jax_start(name)
    cfg = dict(client_num_in_total=6, client_num_per_round=1, epochs=1,
               comm_round=flushes, lr=lr, frequency_of_the_test=1)
    kw = {"server_kw": {"buffer_k": 2}}
    srv, got = run_tier(True, "buff", name, cfg, start, **kw)
    jsrv, want = run_tier(False, "buff", name, cfg, start, **kw)
    assert_same_versions(got, want, start)
    assert srv.staleness_history == jsrv.staleness_history
    assert len(srv.arrival_log) == 2 * flushes
    assert srv.guard_drops == jsrv.guard_drops == 0


# --- the server's fold, driven directly -----------------------------------------


@pytest.mark.parametrize("aggregator,workers", [
    ("mean", 0), ("mean", 2), ("coord_median", 0), ("trimmed_mean0.34", 0),
    ("krum1", 0), ("geometric_median", 0)])
def test_fedbuff_fold_matches_jax(aggregator, workers):
    """Nine recorded deltas at staleness 0..2, the fifth non-finite, into
    both servers at buffer_k 3: the global after each flush and the
    guard's drops."""
    ups = recorded_uploads(nan_at=4)
    out = []
    for port in (True, False):
        h = Harness(port)
        srv, _ = h.server("buff", workers=3, net0=NET0,
                          cfg_kw={"comm_round": 100,
                                  "ingest_workers": workers},
                          buffer_k=3, aggregator=aggregator, alpha=0.5)
        try:
            out.append((feed(h, srv, ups), srv.health()))
        finally:
            srv.finish()
    (got, h_port), (want, h_jax) = out
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for k in w:
            assert np.isfinite(g[k]).all()
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=FOLD_ATOL)
    assert h_port["guard_drops"] == h_jax["guard_drops"] == 1
    for key in ("version", "buffer_depth", "codec_refusals"):
        assert h_port[key] == h_jax[key]


def test_fedbuff_pooled_corrupt_frame_refused_at_flush():
    """test_ingest_pool.py:117: a corrupt frame consumes its window slot
    at weight 0 and its sender is evict-and-released at the flush
    barrier; the next window still flows."""
    h = Harness(True)
    srv, network = h.server("buff", workers=3,
                            net0={"w": np.zeros(32, np.float32)},
                            cfg_kw={"comm_round": 10,
                                    "frequency_of_the_test": 10 ** 6,
                                    "ingest_workers": 2}, buffer_k=2)
    good, _ = pcodec.make_wire_codec("int8").encode(
        {"w": np.ones(32, np.float32)}, None, 1)
    corrupt = dict(good)
    corrupt["q"] = corrupt["q"][:3]
    try:
        h.upload(srv, 1, good, srv.version, task=0, codec="int8")
        h.upload(srv, 2, corrupt, srv.version, task=0, codec="int8")
        health = srv.health()
        assert health["codec_refusals"] == 1 and health["evictions"] == 1
        assert srv.version == 1
        np.testing.assert_allclose(srv.net["w"].numpy(), np.ones(32),
                                   atol=0.02)
        assert [m for m in network.inbox(2).queue
                if getattr(m, "get", None) and m.get("done")]
        h.upload(srv, 1, good, srv.version, task=1, codec="int8")
        h.upload(srv, 3, good, srv.version, task=0, codec="int8")
        assert srv.version == 2
    finally:
        srv.finish()


def test_non_mean_aggregator_refuses_pool_in_jax_words():
    """test_ingest_pool.py:344: the pool needs the mean aggregator."""
    errs = []
    for port in (True, False):
        with pytest.raises(ValueError, match="ingest_workers.*mean") as e:
            Harness(port).server("buff", cfg_kw={"ingest_workers": 2},
                                 aggregator="coord_median")
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_fedbuff_topk_ef_delta_codec_trains_under_chaos():
    """test_wire_codec.py:299: the sparsifying delta codec end to end,
    decoded per frame, under a dup/delay chaos spec."""
    fed, test = _lr_fed(n_clients=4, seed=2)
    cfg = FedConfig(client_num_in_total=4, client_num_per_round=4,
                    comm_round=8, epochs=1, batch_size=16, lr=0.3,
                    frequency_of_the_test=2, heartbeat_interval_s=0.2)
    srv = pfb.FedML_FedBuff_distributed(
        _lr(), fed, test, cfg, buffer_k=2, wire_codec="topk0.2+int8",
        loopback_wire="tensor",
        chaos=ChaosSpec(seed=4, dup_p=0.1, delay_p=0.1, max_delay_s=0.02),
        done_timeout_s=5.0, idle_timeout_s=10.0, device="cpu")
    assert srv.version >= cfg.comm_round
    accs = [h["accuracy"] for h in srv.test_history]
    assert accs and accs[-1] > 0.5


def test_async_tier_emits_unified_ctrl_stream(tmp_path):
    """test_trace.py:300: one ctrl/ row per aggregation, with staleness
    and the depth the flush consumed; health() is the unified surface."""
    from fedml_tpu_torch.obs import MetricsLogger

    fed, test = _lr_fed(n_clients=4)
    cfg = FedConfig(client_num_in_total=4, client_num_per_round=4,
                    comm_round=4, epochs=1, batch_size=16, lr=0.3,
                    frequency_of_the_test=1000)
    metrics = MetricsLogger.for_run(run_dir=str(tmp_path), stdout=False)
    srv = pfb.FedML_FedBuff_distributed(_lr(), fed, test, cfg, buffer_k=2,
                                        metrics=metrics, device="cpu",
                                        idle_timeout_s=IDLE_S)
    metrics.close()
    rows = [json.loads(l) for l in open(tmp_path / "metrics.jsonl")]
    ctrl = [r for r in rows if "ctrl/version" in r]
    assert len(ctrl) == 4
    for r in ctrl:
        assert "ctrl/staleness" in r and r["ctrl/buffer_depth"] == 2
        assert "ctrl/members" in r and "ctrl/fold_ms_p50" in r
        assert "ts" in r
    assert {"members", "evictions", "reassignments", "duplicate_drops",
            "codec_refusals", "version", "buffer_depth",
            "guard_drops"} <= set(srv.final_health)


@pytest.mark.parametrize("mode", ["sign_flip", "nan"])
def test_corruption_drill_with_coord_median(mode):
    """One Byzantine worker of four (its trained model corrupted before
    the delta is formed) against coord_median over the k-deep buffer:
    the global stays finite; a NaN upload is weight-zeroed and counted,
    and the other three still teach the model. (Under sign_flip the
    accuracy depends on which arrivals share a buffer — thread order —
    in JAX's run as in the port's, so it is not held.)"""
    fed, test = _lr_fed(n_clients=4)
    cfg = FedConfig(client_num_in_total=4, client_num_per_round=4,
                    comm_round=6, epochs=1, batch_size=16, lr=0.3,
                    frequency_of_the_test=3)
    srv = pfb.FedML_FedBuff_distributed(
        _lr(), fed, test, cfg, buffer_k=4, aggregator="coord_median",
        corrupt_ranks=(1,), corruptor=UpdateCorruptor(mode, 10.0, seed=0),
        device="cpu", idle_timeout_s=IDLE_S)
    assert srv.version == cfg.comm_round
    assert all(torch.isfinite(v).all() for v in srv.net.params.values())
    if mode == "nan":
        assert srv.test_history[-1]["accuracy"] > 0.5
    uploads_from_1 = sum(1 for w, _ in srv.arrival_log if w == 1)
    assert uploads_from_1 >= 1
    assert srv.guard_drops == (uploads_from_1 if mode == "nan" else 0)


# --- main_extra's runners -------------------------------------------------------


LR_ARGV = ["--dataset", "synthetic_1_1", "--model", "lr",
           "--client_num_in_total", "6", "--client_num_per_round", "1",
           "--batch_size", "8", "--comm_round", "3", "--epochs", "1",
           "--frequency_of_the_test", "1"]
BASE_ARGV = ["--dataset", "cifar10", "--model", "resnet56",
             "--client_num_in_total", "4", "--client_num_per_round", "4",
             "--batch_size", "8", "--comm_round", "2", "--epochs", "1",
             "--lr", "0.05", "--ci", "1", "--synthetic_samples", "96",
             "--partition_method", "homo"]


def _both(algo, argv):
    """The port's and JAX's runner on the same argv: (port history, JAX
    history)."""
    port = main_extra.main(["--algorithm", algo, "--device", "cpu"] + argv)
    want = jax_main_extra.main(["--algorithm", algo] + argv)
    return port, want


def test_main_base_framework_matches_jax():
    got, want = _both("BaseFramework", BASE_ARGV)
    assert got == want
    assert [h["aggregate"] for h in got] == [4.0, 8.0]


@pytest.mark.parametrize("algo,extra", [
    ("FedAsync", []), ("FedBuff", []),
    ("FedBuff", ["--aggregator", "coord_median", "--buffer_k", "3",
                 "--client_num_per_round", "3", "--corrupt_mode",
                 "sign_flip", "--attack_num_adversaries", "1"])])
def test_main_async_runners_match_jax_output(algo, extra, capsys):
    """The runner's last line: the keys and the version JAX's prints,
    finite loss (the models start from each package's own seeded
    init)."""
    got, want = _both(algo, LR_ARGV + extra)
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()
             if l.startswith("{")]
    assert len(lines) == 2 and set(lines[0]) == set(lines[1])
    assert lines[0]["version"] == lines[1]["version"] == 3
    assert np.isfinite(lines[0]["loss"]) and len(got) == len(want)


@pytest.mark.parametrize("algo,extra,exc", [
    ("FedAsync", ["--dcn_hosts", "2"], SystemExit),
    ("FedBuff", ["--dcn_hosts", "2"], SystemExit),
    ("BaseFramework", ["--group_reduce"], SystemExit),
    ("FedAsync", ["--buffer_k", "3"], SystemExit),
    ("FedAsync", ["--aggregator", "krum1"], SystemExit),
    ("FedAsync", ["--serve"], SystemExit),
    ("FedBuff", ["--serve_requests", "4"], SystemExit),
    ("FedBuff", ["--serve"], SystemExit),
    ("FedBuff", ["--adapter_rank", "2", "--model", "cnn"], SystemExit),
    ("FedBuff", ["--agg_shards", "2"], SystemExit),
    ("FedAsync", ["--secagg"], SystemExit),
    ("BaseFramework", ["--wire_codec", "int8"], SystemExit),
    ("BaseFramework", ["--ingest_workers", "2"], SystemExit),
    ("BaseFramework", ["--controller", "adaptive"], SystemExit),
    ("VFL", ["--fedasync_alpha", "0.5"], SystemExit)])
def test_main_extra_refusals_in_jax_words(algo, extra, exc):
    with pytest.raises(exc) as want:
        jax_main_extra.main(["--algorithm", algo] + BASE_ARGV + extra)
    with pytest.raises(exc) as got:
        main_extra.main(["--algorithm", algo, "--device", "cpu"]
                        + BASE_ARGV + extra)
    assert (str(got.value).replace("fedml_tpu_torch", "fedml_tpu")
            == str(want.value))


def test_main_extra_refuses_the_controller_by_name():
    """``--controller adaptive`` on the FedAsync and FedBuff runners: both
    packages' runners attach ``controller_from_args``'s controller to the
    server and end at ``--comm_round`` versions; the other runners refuse
    the flag in JAX's words (test_main_extra_refusals_in_jax_words)."""
    from fedml_tpu.comm.managers import ServerManager as JaxServerManager
    from fedml_tpu_torch.comm.managers import ServerManager

    for algo in ("FedAsync", "FedBuff"):
        argv = ["--algorithm", algo, "--controller", "adaptive"] + LR_ARGV
        lines = []
        for cls, fn, extra in ((ServerManager, main_extra.main,
                                ["--device", "cpu"]),
                               (JaxServerManager, jax_main_extra.main, [])):
            attached = []
            attach = cls.attach_controller

            def spy(mgr, controller, attach=attach, attached=attached):
                attached.append(controller)
                return attach(mgr, controller)

            cls.attach_controller = spy
            try:
                history = fn(argv + extra)
            finally:
                cls.attach_controller = attach
            assert [type(c).__name__ for c in attached] == [
                "FederationController"]
            assert [p.name for p in attached[0].policies] == [
                "window_schedule", "timeout_autoscale",
                "staleness_admission"]
            lines.append(history)
        assert lines[0][-1]["version"] == lines[1][-1]["version"] == 3
