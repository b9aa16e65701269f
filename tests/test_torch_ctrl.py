"""The port's adaptive controllers (``fedml_tpu_torch/ctrl/policy.py``,
``ctrl/__init__.py``'s ``controller_from_args`` and
``comm/managers.py``'s ``attach_controller``) against the JAX package's
``fedml_tpu/ctrl``:

- each policy's proposals equal to JAX's, step for step, over one seeded
  stream of telemetry snapshots and knob values (pure host arithmetic on
  the same floats, so equality, no tolerance);
- ``read_telemetry`` of the sync, FedAsync and FedBuff servers, driven
  into the same state by direct handler calls, equal to JAX's (keys and
  values);
- ``controller_from_args``: the same policies, safety last, the same
  parameters; the controller's merge, interval and failure containment
  against JAX's; the seam's refusals and ``attach_controller``'s in
  JAX's words;
- controller off: a FleetSimulator run (FedBuff, FedAsync, sync first-k)
  with a controller of no policies bit-equal, event for event, to the
  run without one;
- one controller object through a FleetSimulator run and then a
  loopback FedBuff run, its actuation log on the simulator equal to
  JAX's controller on JAX's simulator over the same trace and weights."""

import numpy as np
import pytest
import torch

from fedml_tpu import ctrl as jctrl
from fedml_tpu.comm.managers import ServerManager as JaxServerManager
from fedml_tpu_torch import ctrl as pctrl
from fedml_tpu_torch import sim as psim
from fedml_tpu_torch.algos import FedConfig
from fedml_tpu_torch.algos.fedbuff import FedML_FedBuff_distributed
from fedml_tpu_torch.comm.managers import ServerManager
from test_torch_fedasync import Harness, _lr, _lr_fed
from test_torch_fedavg_distributed import _Pkg
from test_torch_fleet_sim import _Deliveries, _sims


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stream(seed, n=60):
    """A seeded stream of (telemetry, knobs) snapshots: progress climbs,
    staleness and accuracy wander, evictions step up now and then, some
    keys go missing."""
    rng = np.random.RandomState(seed)
    out, progress, evictions, acc = [], 0.0, 0.0, 0.3
    knobs = {"buffer_k": 4, "max_staleness": 0, "round_timeout_s": 30.0,
             "ingest_workers": 2, "aggregate_k": 3, "alpha": 0.6}
    for _ in range(n):
        progress += float(rng.randint(0, 3))
        evictions += float(rng.rand() < 0.2)
        acc = float(np.clip(acc + rng.randn() * 0.02 + 0.005, 0, 1))
        t = {"progress": progress, "evictions": evictions,
             "staleness_p95": float(rng.randint(0, 12)),
             "staleness_p50": float(rng.randint(0, 4)),
             "accuracy": acc, "loss": 2.0 - acc,
             "occupancy": float(rng.rand())}
        for key in ("staleness_p95", "accuracy", "evictions", "occupancy"):
            if rng.rand() < 0.1:
                t.pop(key)
        k = dict(knobs)
        if rng.rand() < 0.3:
            k.pop("buffer_k")
        out.append((t, k))
        knobs["buffer_k"] = int(rng.randint(1, 9))
        knobs["max_staleness"] = int(rng.choice([0, 4, 8]))
        knobs["round_timeout_s"] = float(rng.choice([30.0, 45.0, 67.5]))
        knobs["ingest_workers"] = int(rng.randint(1, 9))
    return out


@pytest.mark.parametrize("name,kw", [
    ("StalenessAdmissionPolicy", {}),
    ("StalenessAdmissionPolicy", dict(band_lo=1.0, band_hi=3.0, k_max=6,
                                      cap_slack=1, cooldown=2)),
    ("WindowSchedulePolicy", {}),
    ("WindowSchedulePolicy", dict(w_min=2, w_max=5, rate_thresh=0.002,
                                  metric="loss")),
    ("TimeoutAutoscalePolicy", {}),
    ("TimeoutAutoscalePolicy", dict(grow=2.0, timeout_cap=3.0,
                                    calm_steps=2, occ_hi=0.5,
                                    workers_max=4))])
def test_policy_proposals_equal_jax(name, kw):
    for seed in (0, 1, 2):
        got = getattr(pctrl, name)(**kw)
        want = getattr(jctrl, name)(**kw)
        assert got.name == want.name
        for step, (t, k) in enumerate(_stream(seed)):
            assert got.propose(dict(t), dict(k)) == want.propose(
                dict(t), dict(k)), (seed, step)
            if step == 30:
                got.reset()
                want.reset()


@pytest.mark.parametrize("bad", [
    ("StalenessAdmissionPolicy", dict(band_lo=3.0, band_hi=1.0)),
    ("WindowSchedulePolicy", dict(w_min=4, w_max=2)),
    ("TimeoutAutoscalePolicy", dict(grow=1.0)),
    ("FederationController", dict(policies=[], interval=0))])
def test_policy_refusals_in_jax_words(bad):
    name, kw = bad
    with pytest.raises(ValueError) as want:
        getattr(jctrl, name)(**kw)
    with pytest.raises(ValueError) as got:
        getattr(pctrl, name)(**kw)
    assert str(got.value) == str(want.value)


def _sync_state(port):
    p = _Pkg(port)
    srv, agg, net = p.server(comm_round=4)
    p.upload(srv, 1, 0, 1.0)
    p.upload(srv, 2, 0, 3.0)
    p.tick(srv, 0, [3])
    return srv


def _async_state(port, tier):
    h = Harness(port)
    srv, _ = h.server(tier, workers=3, **({"buffer_k": 2}
                                           if tier == "buff" else {}))
    for s in (0, 1, 0, 5, 2):
        srv._stale_recent.append(s)
    srv.evictions = 2
    srv.admission_drops = 1
    srv.test_history.append({"round": 0, "accuracy": 0.25, "loss": 1.5})
    srv.version = 3
    return srv


@pytest.mark.parametrize("tier", ["sync", "async", "buff"])
def test_read_telemetry_equals_jax(tier):
    def state(port):
        return (_sync_state(port) if tier == "sync"
                else _async_state(port, tier))

    got = pctrl.read_telemetry(state(True))
    want = jctrl.read_telemetry(state(False))
    assert got == want
    assert "progress" in got and "evictions" in got


def test_controller_from_args_builds_safety_last_like_jax():
    class A:
        controller = "adaptive"
        controller_interval = 2
        controller_band_lo = 1.0
        controller_band_hi = 3.0

    got, want = pctrl.controller_from_args(A()), jctrl.controller_from_args(
        A())
    assert got.interval == want.interval == 2
    assert ([type(p).__name__ for p in got.policies]
            == [type(p).__name__ for p in want.policies])
    assert [p.name for p in got.policies] == [
        "window_schedule", "timeout_autoscale", "staleness_admission"]
    for a, b in zip(got.policies, want.policies):
        assert {k: v for k, v in vars(a).items() if not k.startswith("_")} \
            == {k: v for k, v in vars(b).items() if not k.startswith("_")}
    A.controller = "none"
    assert pctrl.controller_from_args(A()) is None
    A.controller = "bogus"
    with pytest.raises(SystemExit) as e1:
        pctrl.controller_from_args(A())
    with pytest.raises(SystemExit) as e2:
        jctrl.controller_from_args(A())
    assert str(e1.value) == str(e2.value)


class _Always:
    def __init__(self, name, targets):
        self.name, self.targets = name, dict(targets)

    def reset(self):
        pass

    def propose(self, telemetry, knobs):
        return dict(self.targets)


class _Bomb:
    name = "bomb"

    def reset(self):
        pass

    def propose(self, telemetry, knobs):
        raise RuntimeError("policy bug")


def _controller_drill(port):
    """Merge (later wins, unknown knobs dropped), a refusal logged, the
    interval gate, then three failing steps detaching the controller."""
    mod = pctrl if port else jctrl
    srv, _ = Harness(port).server("buff", workers=2, buffer_k=2)
    ctl = mod.FederationController(
        [_Always("optimist", {"alpha": 0.9, "buffer_k": 1}),
         _Always("safety", {"alpha": 0.2, "nonexistent_knob": 7,
                            "staleness_exp": 99.0})], interval=2)
    srv.attach_controller(ctl)
    applied = []
    for v in (1, 2, 3, 5):
        srv.version = v
        applied.append(ctl.step(srv))
    log = [{k: e[k] for k in ("progress", "knob", "new", "policy",
                               "outcome")} for e in ctl.actuation_log]
    bomb = mod.FederationController([_Bomb()])
    srv.attach_controller(bomb)
    attached = []
    for v in (6, 7, 8, 9):
        srv.version = v
        srv._ctrl_boundary()
        attached.append(srv._controller is bomb)
    snap = srv.registry.snapshot()
    kinds = [e["kind"] for e in srv.flight.snapshot()
             if e["kind"] in ("policy_error", "controller_detached",
                              "actuation", "actuation_refused")]
    return (applied, log, srv.alpha, srv.buffer_k, attached,
            {k: v for k, v in snap.items() if k.startswith("actuation")},
            kinds)


def test_controller_merge_interval_and_containment_like_jax():
    got, want = _controller_drill(True), _controller_drill(False)
    assert got == want
    assert got[0] == [2, 0, 2, 2] and got[4] == [True, True, False, False]


def test_attach_and_seam_refusals_in_jax_words():
    class Bare:
        ctrl = None

    with pytest.raises(ValueError) as want:
        JaxServerManager.attach_controller(Bare(),
                                           jctrl.FederationController([]))
    with pytest.raises(ValueError) as got:
        ServerManager.attach_controller(Bare(),
                                        pctrl.FederationController([]))
    assert str(got.value) == str(want.value)
    for knob, value in (("buffer_k", 0), ("alpha", 2.0), ("nope", 1),
                        ("max_staleness", -1)):
        errs = []
        for port, mod in ((True, pctrl), (False, jctrl)):
            srv, _ = Harness(port).server("buff", workers=2, buffer_k=2)
            with pytest.raises(mod.ActuationRefused) as err:
                srv.ctrl.apply(knob, value)
            errs.append((str(err.value), err.value.reason))
        assert errs[0] == errs[1], knob


@pytest.mark.parametrize("mode,kw", [
    ("fedbuff", {"buffer_k": 2}), ("fedasync", {}),
    ("sync", {"aggregate_k": 2})])
def test_controller_off_is_bit_equal(mode, kw):
    """A controller of no policies attached (its boundary steps read the
    telemetry and apply nothing) leaves the run bit-equal, event for
    event, to the run with none."""
    from test_torch_fedavg_distributed import _task

    x, y, parts, xt, yt, batch = _task()
    from fedml_tpu_torch.data import batching
    from fedml_tpu_torch.models import create_model

    fed = batching.build_federated_arrays(x, y, parts, batch, device="cpu")
    test = batching.batch_global(xt, yt, 10, device="cpu")
    runs = []
    for ctl in (None, pctrl.FederationController([])):
        sim = psim.FleetSimulator(
            create_model("lr", num_classes=4, in_features=192, device="cpu",
                         generator=torch.Generator().manual_seed(0)),
            fed, test, FedConfig(client_num_in_total=6,
                                 client_num_per_round=4, comm_round=6,
                                 batch_size=batch, lr=0.1,
                                 frequency_of_the_test=1),
            psim.make_fleet_trace(psim.FleetSpec(
                n_devices=4, seed=5, horizon_s=4000.0, mean_online=0.8,
                base_round_s=25.0, slot_s=150.0)),
            mode=mode, controller=ctl, device="cpu", **kw)
        with _Deliveries(psim) as log:
            res = sim.run()
        net = sim.aggregator.net if mode == "sync" else sim.server.net
        runs.append((log.events, res.completion_times,
                     [v.clone() for v in net.params.values()]))
    assert runs[0][:2] == runs[1][:2]
    for a, b in zip(runs[0][2], runs[1][2]):
        assert torch.equal(a, b)


class _PokeAlpha:
    """Keys on progress only, so it is deterministic in both worlds."""

    name = "poke_alpha"

    def reset(self):
        self._done = False

    def propose(self, telemetry, knobs):
        if not self._done and telemetry.get("progress", 0) >= 1 \
                and "alpha" in knobs:
            self._done = True
            return {"alpha": 0.37}
        return {}


def test_same_controller_drives_sim_then_loopback():
    """One adaptive controller object through both packages' simulators
    (the same trace and weights): the same actuation log. Then the port's
    object, rebound, drives a real loopback FedBuff run through the same
    seam and leaves the same trail."""
    class A:
        controller = "adaptive"

    pc, jc = pctrl.controller_from_args(A()), jctrl.controller_from_args(A())
    (res, events, net), (jres, jevents, jnet) = _sims(
        "fedbuff", buffer_k=2, controllers=(pc, jc))
    assert pc.actuation_log == jc.actuation_log and pc.actuation_log
    assert events == jevents and res.arrival_log == jres.arrival_log
    for a, b in zip(net, jnet):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)

    ctl = pctrl.FederationController([_PokeAlpha()])
    fed, test = _lr_fed(n_clients=4)
    cfg = FedConfig(client_num_in_total=4, client_num_per_round=4,
                    comm_round=6, epochs=1, batch_size=16, lr=0.3,
                    frequency_of_the_test=4)
    sim = psim.FleetSimulator(
        _lr(), fed, test, cfg, psim.make_fleet_trace(psim.FleetSpec(
            n_devices=4, seed=5, horizon_s=4000.0, mean_online=0.8,
            base_round_s=25.0, slot_s=150.0)),
        mode="fedbuff", buffer_k=2, controller=ctl, device="cpu")
    sim.run()
    assert [e["knob"] for e in ctl.actuation_log] == ["alpha"]
    assert sim.server.alpha == 0.37
    srv = FedML_FedBuff_distributed(_lr(), fed, test, cfg, buffer_k=2,
                                    controller=ctl, device="cpu",
                                    idle_timeout_s=30.0)
    assert [(e["knob"], e["outcome"]) for e in ctl.actuation_log] == [
        ("alpha", "applied")]
    assert srv.alpha == 0.37
    assert srv.registry.snapshot()["actuation_applied"] == 1
    ev = [e for e in srv.flight.snapshot() if e["kind"] == "actuation"]
    assert ev and ev[0]["knob"] == "alpha" and ev[0]["new"] == 0.37

