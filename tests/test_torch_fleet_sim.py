"""The port's fleet simulator (``fedml_tpu_torch/sim``) against the JAX
package's ``fedml_tpu/sim``:

- ``make_fleet_trace`` equal to JAX's, field for field and float for
  float (the same keyed ``RandomState`` draws through the port's copy of
  ``_mix``), over several specs;
- ``VirtualClock`` and ``EventQueue``: the same pop order (time, then
  insertion) and refusals;
- FleetSimulator runs of FedBuff, FedAsync and sync first-k over ``lr``
  from JAX's start weights, every delivery recorded as (virtual s,
  message type, sender, receiver): the event log equal to JAX's, event
  for event, the arrival log, staleness and completion times equal, each
  eval and the final net within 1e-5 of JAX's (the sync tier's parity
  tolerance; ``batch_size`` ≥ the largest client, so the port's shuffle
  keys only reorder a masked mean); two runs of one seed identical;
- the watchdog twins (``tests/test_fleet_sim.py``'s lockstep drills) on
  both packages' simulators: the same evictions posted at the same
  virtual deadlines as the real detector's;
- ``StoreFleetData`` over the port's ``FederatedStore``."""

import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch

from fedml_tpu import sim as jsim
from fedml_tpu.algos.config import FedConfig as JaxFedConfig
from fedml_tpu.data import batching as jb
from fedml_tpu.models.registry import create_model as jax_create_model
from fedml_tpu.trainer.local import model_fns as jax_model_fns
from fedml_tpu_torch import sim as psim
from fedml_tpu_torch.algos import FedConfig
from fedml_tpu_torch.convert import from_jax_params, to_jax_params
from fedml_tpu_torch.data import batching
from fedml_tpu_torch.models import create_model
from test_torch_fedavg_distributed import _task

FED_ATOL = 1e-5

SPECS = [
    dict(n_devices=8, seed=0),
    dict(n_devices=16, seed=7, horizon_s=7200.0, mean_online=0.6,
         diurnal_amplitude=0.5, diurnal_period_s=3600.0, slot_s=90.0),
    dict(n_devices=5, seed=3, compute_jitter=0.0, speed_alpha=1.5,
         arrival_spread_s=600.0),
    dict(n_devices=32, seed=11, horizon_s=20000.0, spike_t0=500.0,
         spike_t1=2500.0, spike_factor=4.0),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kw", SPECS, ids=lambda kw: f"n{kw['n_devices']}"
                         f"-seed{kw['seed']}")
def test_fleet_trace_equals_jax(kw):
    got = psim.make_fleet_trace(psim.FleetSpec(**kw))
    want = jsim.make_fleet_trace(jsim.FleetSpec(**kw))
    assert dataclasses.asdict(got.spec) == dataclasses.asdict(want.spec)
    assert got.arrivals == want.arrivals
    assert got.speeds == want.speeds
    assert got.windows == want.windows
    assert got.describe() == want.describe()
    n = kw["n_devices"]
    for r in range(0, n + 1):
        for task in range(4):
            if r:
                assert got.compute_time(r, task) == want.compute_time(r, task)
        for t in (0.0, 37.5, 1000.0, 3599.0):
            assert got.online_at(r, t) == want.online_at(r, t)
            assert got.next_online(r, t) == want.next_online(r, t)
            assert (got.online_through(r, t, t + 200.0)
                    == want.online_through(r, t, t + 200.0))
            assert got.load_factor(t) == want.load_factor(t)


def test_virtual_clock_and_event_queue_order_like_jax():
    def drive(mod):
        clock = mod.VirtualClock()
        q = mod.EventQueue(clock)
        seen = []
        for t, tag in ((5.0, "a"), (1.0, "b"), (5.0, "c"), (0.0, "d")):
            q.at(t, lambda tag=tag: seen.append((clock.now, tag)))
        q.after(2.0, lambda: (seen.append((clock.now, "e")),
                              q.after(0.0, lambda: seen.append(
                                  (clock.now, "f")))))
        while len(q):
            q.step()
        with pytest.raises(ValueError) as err:
            clock.advance_to(1.0)
        with pytest.raises(IndexError) as empty:
            q.next_time()
        return seen, str(err.value), str(empty.value), clock()

    got, want = drive(psim), drive(jsim)
    assert got == want
    assert [tag for _, tag in got[0]] == ["d", "b", "e", "f", "a", "c"]


class _Deliveries:
    """Every delivery of one package's SIM fabric while active: (virtual
    s, type, sender, receiver)."""

    def __init__(self, mod):
        self.events, self._cls = [], mod.transport.SimNetwork
        self._deliver = self._cls._deliver

    def __enter__(self):
        deliver = self._deliver

        def spy(network, msg, t_sent=0.0, blob=None):
            self.events.append((network.events.clock.now,
                                int(msg.get_type()),
                                int(msg.get_sender_id()),
                                int(msg.get_receiver_id())))
            return deliver(network, msg, t_sent, blob)

        self._cls._deliver = spy
        return self

    def __exit__(self, *exc):
        self._cls._deliver = self._deliver


RUN_SPEC = dict(n_devices=4, seed=5, horizon_s=4000.0, mean_online=0.8,
                base_round_s=25.0, slot_s=150.0)


def _sims(mode, spec=RUN_SPEC, cfg_extra=(), controllers=(None, None), **kw):
    """The same simulation in both packages, each with its controller of
    ``controllers`` attached: (port result, its events, its net as JAX
    leaves) and JAX's."""
    x, y, parts, xt, yt, batch = _task()
    cfg_kw = dict(client_num_in_total=6, client_num_per_round=4,
                  comm_round=6, epochs=1, batch_size=batch, lr=0.1,
                  frequency_of_the_test=1, **dict(cfg_extra))
    jmodel = jax_create_model("lr", num_classes=4)
    start = jax_model_fns(jmodel).init(jax.random.PRNGKey(0),
                                       np.zeros((1, 8, 8, 3), np.float32))
    out = []
    for port in (True, False):
        mod = psim if port else jsim
        if port:
            model = create_model("lr", num_classes=4, in_features=192,
                                 device="cpu")
            params = from_jax_params(jax.tree.map(np.asarray,
                                                  start.params))[0]
            with torch.no_grad():
                for k, v in model.named_parameters():
                    v.copy_(torch.as_tensor(np.asarray(params[k])))
            fed = batching.build_federated_arrays(x, y, parts, batch,
                                                  device="cpu")
            test = batching.batch_global(xt, yt, 10, device="cpu")
            sim = psim.FleetSimulator(
                model, fed, test, FedConfig(**cfg_kw),
                psim.make_fleet_trace(psim.FleetSpec(**spec)), mode=mode,
                controller=controllers[0], device="cpu", **kw)
        else:
            fed = jb.build_federated_arrays(x, y, parts, batch)
            test = jb.batch_global(xt, yt, 10)
            sim = jsim.FleetSimulator(
                jmodel, fed, test, JaxFedConfig(**cfg_kw),
                jsim.make_fleet_trace(jsim.FleetSpec(**spec)), mode=mode,
                controller=controllers[1], **kw)
        with _Deliveries(mod) as log:
            res = sim.run()
        net = sim.aggregator.net if mode == "sync" else sim.server.net
        leaves = (jax.tree.leaves(to_jax_params(
            {k: v.detach().clone() for k, v in net.params.items()}))
            if port else jax.tree.leaves(net.params))
        out.append((res, log.events, [np.asarray(l) for l in leaves]))
    return out


@pytest.mark.parametrize("mode,kw", [
    ("fedbuff", {"buffer_k": 2}), ("fedasync", {}), ("sync",
                                                      {"aggregate_k": 2})])
def test_sim_event_log_and_global_equal_jax(mode, kw):
    (res, events, net), (jres, jevents, jnet) = _sims(mode, **kw)
    assert res.completed and jres.completed
    assert events == jevents and len(events) > 30
    assert res.arrival_log == jres.arrival_log
    assert res.staleness == jres.staleness
    assert res.completion_times == jres.completion_times
    assert res.net_counts == jres.net_counts
    assert res.churn_killed == jres.churn_killed
    assert res.health == jres.health
    assert len(res.test_history) == len(jres.test_history) > 0
    for a, b in zip(res.test_history, jres.test_history):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=0,
                                   atol=FED_ATOL)
    for a, b in zip(net, jnet):
        np.testing.assert_allclose(a, b, rtol=0, atol=FED_ATOL)


def test_sim_two_runs_identical_and_sharded_secagg_equal_jax():
    """Two port runs of one seed are identical event for event and bit
    for bit; the sync mode with secagg and with 2 aggregator shards on
    the churn-free spec gives JAX's event log and the clear pooled run's
    global bit for bit."""
    a = _sims("fedbuff", buffer_k=2)[0]
    b = _sims("fedbuff", buffer_k=2)[0]
    assert a[1] == b[1] and a[0].arrival_log == b[0].arrival_log
    for x, y in zip(a[2], b[2]):
        np.testing.assert_array_equal(x, y)
    calm = dict(RUN_SPEC, mean_online=1.0, arrival_spread_s=0.0,
                horizon_s=10.0 ** 7)

    def run(**kw):
        return _sims("sync", spec=calm, **kw)

    clear = run(cfg_extra={"ingest_workers": 1})
    masked = run(cfg_extra={"ingest_workers": 1, "secagg": True,
                            "secagg_t": 2})
    sharded = run(cfg_extra={"secagg": True, "secagg_t": 2}, agg_shards=2)
    assert masked[0][1] == masked[1][1]
    assert sharded[0][1] == sharded[1][1]
    assert sharded[0][0].health["shards"] == 2
    for got in (masked[0], sharded[0]):
        assert got[0].completed and got[0].health["seed_reveals"] == 0
        for x, y in zip(got[2], clear[0][2]):
            np.testing.assert_array_equal(x, y)


def _lockstep(mod, mode, **kw):
    x, y, parts, xt, yt, batch = _task()
    cfg_kw = dict(client_num_in_total=6, client_num_per_round=4,
                  comm_round=3, epochs=1, batch_size=batch, lr=0.3)
    spec = dict(n_devices=4, seed=5, horizon_s=4000.0, mean_online=0.8,
                base_round_s=25.0, slot_s=150.0)
    if mod is psim:
        sim = psim.FleetSimulator(
            create_model("lr", num_classes=4, in_features=192,
                         device="cpu"),
            batching.build_federated_arrays(x, y, parts, batch,
                                            device="cpu"),
            None, FedConfig(**cfg_kw),
            psim.make_fleet_trace(psim.FleetSpec(**spec)), mode=mode,
            device="cpu", **kw)
    else:
        sim = jsim.FleetSimulator(
            jax_create_model("lr", num_classes=4),
            jb.build_federated_arrays(x, y, parts, batch), None,
            JaxFedConfig(**cfg_kw),
            jsim.make_fleet_trace(jsim.FleetSpec(**spec)), mode=mode, **kw)
    posts = []
    if mode == "sync":
        sim.server._post_tick = (
            lambda r, failed: posts.append((r, tuple(failed))))
    else:
        sim.server._post_tick = lambda failed: posts.append(tuple(failed))
    return sim, posts


def _twin_heartbeat_expiry(mod):
    sim, posts = _lockstep(mod, "sync")
    srv = sim.server
    for r in (1, 2, 3, 4):
        srv.heartbeat.beat(r)
    with srv._lock:
        srv._arrived.update({1, 2, 3})
    sim._sync_watch()
    before = list(posts)
    sim.clock.advance_to(srv.heartbeat.timeout_s + 1.0)
    for r in (1, 2, 3):
        srv.heartbeat.beat(r)
    sim._sync_watch()
    real = tuple(srv.heartbeat.wait_all_or_failed(
        [1, 2, 3, 4], have=srv._arrived_snapshot, poll_s=0.001,
        deadline_s=srv.round_timeout_s))
    return before, posts, real


def _twin_round_deadline(mod):
    sim, posts = _lockstep(mod, "sync")
    srv = sim.server
    srv.heartbeat.timeout_s = 1e9
    for r in (1, 2, 3, 4):
        srv.heartbeat.beat(r)
    with srv._lock:
        srv._arrived.update({1, 2, 3})
    sim._sync_watch()
    before = list(posts)
    real = []
    th = threading.Thread(target=lambda: real.append(tuple(
        srv.heartbeat.wait_all_or_failed(
            [1, 2, 3, 4], have=srv._arrived_snapshot, poll_s=0.002,
            deadline_s=srv.round_timeout_s))))
    th.start()
    sim.clock.advance_to(srv.round_timeout_s + 1.0)
    sim._sync_watch()
    th.join(timeout=10.0)
    assert not th.is_alive()
    return before, posts, real[0]


def _twin_done_deadline(mod):
    sim, posts = _lockstep(mod, "fedbuff", buffer_k=2)
    srv = sim.server
    srv.heartbeat.timeout_s = 1e9
    for r in (1, 2, 3, 4):
        srv.heartbeat.beat(r)
    with srv._lock:
        srv.version = sim.cfg.comm_round
        srv._done_set.update({1, 2, 3})
    sim._async_watch()
    before = list(posts)
    real = []
    th = threading.Thread(target=lambda: real.append(tuple(
        srv.heartbeat.wait_all_or_failed(
            [1, 2, 3, 4], have=srv._done_snapshot, poll_s=0.002,
            deadline_s=srv.done_timeout_s))))
    th.start()
    sim.clock.advance_to(srv.done_timeout_s + 1.0)
    sim._async_watch()
    th.join(timeout=10.0)
    assert not th.is_alive()
    return before, posts, real[0]


@pytest.mark.parametrize("drill,want_posts", [
    (_twin_heartbeat_expiry, [(0, (4,))]),
    (_twin_round_deadline, [(0, (4,))]),
    (_twin_done_deadline, [(4,)])],
    ids=["heartbeat_expiry", "round_deadline", "done_deadline"])
def test_watchdog_twins_lockstep_like_jax(drill, want_posts):
    """The event-driven watchdog twins post the evictions the real
    detector (``wait_all_or_failed`` over the same monitor) decides, at
    the same virtual deadline — in both packages, identically."""
    got, want = drill(psim), drill(jsim)
    assert got == want
    assert got == ([], want_posts, (4,))


def test_store_fleet_data_lazy_view_matches_store():
    from fedml_tpu_torch.data.store import FederatedStore

    rng = np.random.RandomState(0)
    counts = 1 + rng.randint(0, 5, 12)
    edges = np.concatenate([[0], np.cumsum(counts)])
    x = rng.randn(int(counts.sum()), 6).astype(np.float32)
    y = rng.randint(0, 3, len(x)).astype(np.int32)
    parts = {c: np.arange(edges[c], edges[c + 1]) for c in range(12)}
    store = FederatedStore(x, y, parts, batch_size=4, device="cpu")
    data = psim.StoreFleetData(store)
    assert data.x.shape[0] == 12 and data.x.shape[3:] == (6,)
    assert data.device == store.device and torch.is_tensor(data.counts)
    for c in (0, 7, 11, 3):
        ref = store.gather_cohort(np.asarray([c]), steps=data._steps)
        assert torch.equal(data.x[c], ref.x[0])
        assert torch.equal(data.mask[c], ref.mask[0])
        assert int(data.counts[c]) == int(counts[c])
