"""The port's message-passing layer (``fedml_tpu_torch.comm`` and the two
framework templates) against the JAX package's ``fedml_tpu.comm``: the
JSON and tensor-wire encodings byte-equal on the same numpy trees
(bfloat16 leaves included), bfloat16 round trips in a process without
``ml_dtypes``, loopback delivery, ChaosTransport's seeded decisions,
RetryPolicy's seeded jitter, the heartbeat loop, and the base and
decentralized templates' results; the TCP transport's native library
built once and atomically when several processes load it together."""

import importlib.util
import os
import shutil
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from fedml_tpu.algos.base_framework import (
    FedML_Base_distributed as JaxBase)
from fedml_tpu.algos.decentralized_framework import (
    FedML_Decentralized_Demo_distributed as JaxDecentralized)
from fedml_tpu.comm import loopback as jax_loopback
from fedml_tpu.comm import message as jax_message
from fedml_tpu.comm import resilience as jax_resilience
from fedml_tpu.comm import wire as jax_wire
from fedml_tpu.trainer.local import NetState as JaxNetState
from fedml_tpu_torch.algos.base_framework import FedML_Base_distributed
from fedml_tpu_torch.algos.decentralized_framework import (
    FedML_Decentralized_Demo_distributed)
from fedml_tpu_torch.comm import loopback, message, pytree, resilience, wire
from fedml_tpu_torch.core.tree import sorted_leaves
from fedml_tpu_torch.trainer.local import NetState


def _arrays(seed=0):
    rng = np.random.RandomState(seed)
    return {"kernel": rng.randn(7, 3).astype(np.float32),
            "bias": rng.randn(3).astype(np.float32),
            "steps": np.arange(5, dtype=np.int64),
            "mask": rng.rand(4) > 0.5,
            "half": rng.randn(6).astype(np.float16),
            "bf": rng.randn(9).astype(np.float32)}


def _trees(seed=0):
    """(JAX's tree, the port's tree): the same numpy content, bfloat16 as
    an ml_dtypes array there and a torch.bfloat16 tensor here."""
    a = _arrays(seed)
    bf = a.pop("bf")
    jax_tree = {"dense": dict(a), "nested": [a["bias"], (a["steps"], 3.5)],
                "bf16": np.asarray(jnp.asarray(bf, jnp.bfloat16)),
                "scalar": np.float32(2.5), "count": np.int64(7), "tag": "x"}
    port_tree = {"dense": dict(a), "nested": [a["bias"], (a["steps"], 3.5)],
                 "bf16": torch.from_numpy(bf).to(torch.bfloat16),
                 "scalar": np.float32(2.5), "count": np.int64(7), "tag": "x"}
    return jax_tree, port_tree


def _message(pkg, tree):
    m = pkg.Message(type=3, sender_id=2, receiver_id=0)
    m.add(pkg.Message.MSG_ARG_KEY_MODEL_PARAMS, tree)
    m.add(pkg.Message.MSG_ARG_KEY_NUM_SAMPLES, 42)
    m.add("round", 5)
    return m


def test_message_json_byte_equal_to_jax():
    jt, pt = _trees()
    jt["nested"][1] = list(jt["nested"][1])  # JSON has no tuples
    pt["nested"][1] = list(pt["nested"][1])
    want = _message(jax_message, jt).to_json()
    got = _message(message, pt).to_json()
    assert got == want
    # And the port's encoding of JAX's own tree (ml_dtypes leaf).
    assert _message(message, jt).to_json() == want
    back = message.Message.from_json(got).get("model_params")
    assert back["bf16"].dtype == torch.bfloat16
    assert torch.equal(back["bf16"], pt["bf16"])
    np.testing.assert_array_equal(back["dense"]["kernel"],
                                  pt["dense"]["kernel"])
    assert back["dense"]["steps"].dtype == np.int64


@pytest.mark.parametrize("fmt", ["tensor", "json", "pickle"])
def test_wire_frames_byte_equal_to_jax(fmt):
    jt, pt = _trees(1)
    if fmt == "pickle":
        # A pickle frame holds the leaves' own classes: compare numpy trees.
        jt.pop("bf16")
        pt.pop("bf16")
    if fmt == "json":
        jt["nested"][1] = list(jt["nested"][1])
        pt["nested"][1] = list(pt["nested"][1])
    want = jax_wire.serialize_message(_message(jax_message, jt), fmt)
    got = wire.serialize_message(_message(message, pt), fmt)
    assert got == want
    back = wire.deserialize_message(got, fmt).get("model_params")
    for a, b in zip(sorted_leaves(back), sorted_leaves(pt)):
        if isinstance(b, torch.Tensor):
            assert torch.equal(a, b)
        elif isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
            assert np.asarray(a).dtype == b.dtype
        else:
            assert a == b


def test_netstate_frames_byte_equal_to_jax():
    """A NetState payload (params + model_state) frames as JAX's does, a
    bfloat16 params leaf included, and decodes back into a port
    NetState."""
    a = _arrays(2)
    bf = a["bf"]
    jnet = JaxNetState({"Dense_0": {"kernel": a["kernel"],
                                    "bias": a["bias"]},
                        "emb": np.asarray(jnp.asarray(bf, jnp.bfloat16))},
                       {"ema": a["half"]})
    pnet = NetState({"Dense_0": {"kernel": a["kernel"], "bias": a["bias"]},
                     "emb": torch.from_numpy(bf).to(torch.bfloat16)},
                    {"ema": a["half"]})
    want = jax_wire.serialize_message(_message(jax_message, jnet), "tensor")
    got = wire.serialize_message(_message(message, pnet), "tensor")
    assert got == want
    back = wire.deserialize_message(want, "tensor").get("model_params")
    assert isinstance(back, NetState)
    assert torch.equal(back.params["emb"], pnet.params["emb"])
    np.testing.assert_array_equal(back.model_state["ema"], a["half"])


def test_bf16_round_trips_without_ml_dtypes(monkeypatch):
    """The card's machine has no ml_dtypes: with the module unimportable,
    a bfloat16 tensor still crosses the tensor wire, the JSON wire and
    the bf16 codec, bit for bit."""
    from fedml_tpu_torch.comm import codec

    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    with pytest.raises(ImportError):
        import ml_dtypes as _  # noqa: F401
    t = torch.randn(33, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    tree = {"w": t, "x": np.arange(3, dtype=np.float32)}
    for fmt in ("tensor", "json"):
        back = wire.deserialize_message(
            wire.serialize_message(_message(message, tree), fmt),
            fmt).get("model_params")
        assert back["w"].dtype == torch.bfloat16
        assert torch.equal(back["w"], t)
    vals = np.random.RandomState(0).randn(50).astype(np.float32)
    enc = codec.make_wire_codec("bf16")
    payload, _ = enc.encode({"v": vals}, None, seed=1)
    frame = wire.serialize_message(_message(message, payload), "tensor")
    back = wire.deserialize_message(frame, "tensor").get("model_params")
    dec = enc.decode(back, codec.tree_spec({"v": vals}))
    np.testing.assert_array_equal(
        dec["v"], torch.from_numpy(vals).to(torch.bfloat16).float().numpy())


def test_bf16_cast_matches_ml_dtypes_rounding():
    vals = np.random.RandomState(3).randn(4096).astype(np.float32) * 1e3
    vals[:4] = [0.0, -0.0, 1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8]  # ties
    ours = pytree.bf16_bits(pytree.cast(vals, "bfloat16"))
    theirs = vals.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(ours, theirs)


def test_loopback_point_to_point_both_packages():
    for pkg, msg_pkg in ((loopback, message), (jax_loopback, jax_message)):
        network = pkg.LoopbackNetwork(3, wire="tensor")
        got = []

        class Obs:
            def receive_message(self, msg_type, msg):
                got.append((msg_type, msg.get_sender_id(), msg.get("v")))
                if len(got) == 2:
                    receiver.stop_receive_message()

        receiver = pkg.LoopbackCommManager(network, 2)
        receiver.add_observer(Obs())
        t = threading.Thread(target=receiver.handle_receive_message)
        t.start()
        for sender in (0, 1):
            m = msg_pkg.Message(7, sender, 2)
            m.add("v", sender * 10)
            pkg.LoopbackCommManager(network, sender).send_message(m)
        t.join(timeout=10)
        assert not t.is_alive()
        assert got == [(7, 0, 0), (7, 1, 10)]
        assert receiver.bytes_ledger.total_rx > 0


def test_run_workers_raises_while_peers_wait():
    """A worker that fails is reported at once, not after its peers end:
    a peer waiting for the dead worker's message would never end. Both
    packages return the same once every worker ends by itself."""
    release = threading.Event()
    t0 = time.perf_counter()
    try:
        with pytest.raises(RuntimeError, match="worker rank 1 failed") as e:
            loopback.run_workers([lambda: release.wait(60),
                                  lambda: 1 / 0])
    finally:
        release.set()
    assert time.perf_counter() - t0 < 10
    assert isinstance(e.value.__cause__, ZeroDivisionError)
    for pkg in (loopback, jax_loopback):
        got = []
        pkg.run_workers([lambda: got.append(0), lambda: got.append(1)])
        assert sorted(got) == [0, 1]
        with pytest.raises(RuntimeError, match="worker rank 0 failed"):
            pkg.run_workers([lambda: 1 / 0, lambda: got.append(2)])


def _chaos_log(pkg, msg_pkg, seed):
    """Every decision a ChaosTransport makes over one scripted stream:
    deliveries in order, the delays it schedules, and its counters."""
    log = []

    class Inner:
        def send_message(self, m):
            log.append(("send", m.get_type(), m.get_receiver_id(),
                        m.get("round")))

    spec = pkg.ChaosSpec(seed=seed, drop_p=0.2, dup_p=0.2, delay_p=0.3,
                         max_delay_s=0.05, reorder_p=0.15)
    spec.partition(0, 3)

    def after(delay, fn):
        log.append(("after", round(delay, 12)))
        fn()

    chaos = pkg.ChaosTransport(Inner(), spec, rank=0, after=after)
    for r in range(60):
        for receiver in (1, 2, 3, 0):
            m = msg_pkg.Message(2 + r % 3, 0, receiver)
            m.add("round", r // 2)
            chaos.send_message(m)
    spec.heal(0, 3)
    for r in range(5):
        m = msg_pkg.Message(2, 0, 3)
        m.add("round", 100 + r)
        chaos.send_message(m)
    return log, dict(spec.counts)


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_chaos_decisions_equal_jax(seed):
    got = _chaos_log(resilience, message, seed)
    want = _chaos_log(jax_resilience, jax_message, seed)
    assert got == want
    assert got[1]["dropped"] and got[1]["duplicated"] and got[1]["delayed"]
    assert got[1]["reordered"] and got[1]["partitioned"]
    assert resilience._mix(1, 2, 3) == jax_resilience._mix(1, 2, 3)


def test_retry_policy_seeded_jitter_equal_jax():
    def drive(pkg):
        sleeps = []
        policy = pkg.RetryPolicy(max_attempts=6, backoff_s=0.1,
                                 multiplier=1.7, max_backoff_s=0.5,
                                 jitter=0.3, seed=11, sleep=sleeps.append,
                                 clock=lambda: 0.0)
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 4:
                raise ConnectionError("not yet")
            return "ok"

        out = policy.run(flaky, retriable=lambda e: isinstance(
            e, ConnectionError))
        with pytest.raises(pkg.RetryGiveUp):
            policy.run(lambda: (_ for _ in ()).throw(OSError("down")))
        return out, sleeps, policy.retries, policy.giveups, [
            policy.backoff_for(k) for k in range(1, 8)]

    assert drive(resilience) == drive(jax_resilience)
    first = resilience.RetryPolicy.first_contact()
    jfirst = jax_resilience.RetryPolicy.first_contact()
    assert (first.max_attempts, first.total_deadline_s) == (
        jfirst.max_attempts, jfirst.total_deadline_s)


def test_heartbeat_sender_beats_and_idle_quits():
    beats, idle = [], []
    hb = resilience.HeartbeatSender(lambda: beats.append(1), interval_s=0.02,
                                    idle_timeout_s=0.15,
                                    on_idle=lambda: idle.append(1))
    hb.start()
    time.sleep(0.08)
    hb.touch()
    assert len(beats) >= 1
    deadline = time.monotonic() + 2.0
    while not idle and time.monotonic() < deadline:
        time.sleep(0.01)
    assert idle == [1]
    time.sleep(0.05)
    assert idle == [1]


def test_base_framework_equals_jax():
    def local_fn(round_idx, global_result):
        return float(round_idx) * 1.5 + (global_result or 0.0) * 0.25

    got = FedML_Base_distributed(4, 3, local_fn)
    assert got == JaxBase(4, 3, local_fn)
    assert len(got) == 3


def test_decentralized_framework_equals_jax():
    def local_fn(round_idx, current):
        return 1.0 + round_idx if current is None else current * 0.9 + 0.1

    got = FedML_Decentralized_Demo_distributed(5, 6, local_fn,
                                               neighbor_num=2)
    want = JaxDecentralized(5, 6, local_fn, neighbor_num=2)
    assert len(got) == 5 and all(len(h) == 6 for h in got)
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=0,
                               atol=1e-12)


# --- core/faults.py: the churn injector, the round harness, the monitor ------


def test_dropout_injector_masks_equal_jax():
    from fedml_tpu.core import faults as jax_faults
    from fedml_tpu_torch.core import faults

    for p, seed in ((0.3, 0), (0.9, 3), (0.999999, 7)):
        inj = faults.DropoutInjector(p, seed=seed)
        jinj = jax_faults.DropoutInjector(p, seed=seed)
        for r in range(20):
            got = inj.round_mask(r, 8)
            assert got.dtype == np.float32 and got.sum() >= 1.0
            np.testing.assert_array_equal(got, jinj.round_mask(r, 8))
    with pytest.raises(ValueError, match="dropout p must be in"):
        faults.DropoutInjector(1.0)


def test_fault_injected_round_drops_what_jax_drops():
    """The harness on TurboAggregate (the API with host-side dropout), the
    port's and JAX's from the same start: the same clients dropped and
    the round's loss and net within 1e-5 plus the MPC's quantization
    (batch = client size, so the packages' shuffles only reorder a masked
    mean)."""
    from fedml_tpu.algos import FedConfig as JaxFedConfig
    from fedml_tpu.algos import TurboAggregateAPI as JaxTurboAggregateAPI
    from fedml_tpu.core import faults as jax_faults
    from fedml_tpu.data.batching import (
        build_federated_arrays as jax_build_federated_arrays)
    from fedml_tpu.models import create_model as jax_create_model
    from fedml_tpu_torch.algos import FedConfig, TurboAggregateAPI
    from fedml_tpu_torch.convert import to_jax_params
    from fedml_tpu_torch.core import faults
    from fedml_tpu_torch.data import (build_federated_arrays,
                                      partition_homo)
    from fedml_tpu_torch.data.synthetic import make_classification
    from fedml_tpu_torch.models import create_model

    x, y = make_classification(160, n_features=8, n_classes=4)
    parts = partition_homo(160, 4)
    cfg = dict(client_num_in_total=4, client_num_per_round=4, comm_round=2,
               epochs=1, batch_size=40, lr=0.1)  # one batch a client
    api = TurboAggregateAPI(
        create_model("lr", num_classes=4, in_features=8, device="cpu",
                     generator=torch.Generator().manual_seed(0)),
        build_federated_arrays(x, y, parts, 40, device="cpu"), None,
        FedConfig(**cfg), device="cpu")
    japi = JaxTurboAggregateAPI(
        jax_create_model("lr", input_dim=8, num_classes=4),
        jax_build_federated_arrays(x, y, parts, 40), None,
        JaxFedConfig(**cfg))
    japi.net = japi.net.replace(params=to_jax_params(
        dict(api.net.params)))
    inj = faults.DropoutInjector(0.5, seed=1)
    jinj = jax_faults.DropoutInjector(0.5, seed=1)
    for r in range(2):
        got = faults.fault_injected_round(api, r, dropout=inj)
        want = jax_faults.fault_injected_round(japi, r, dropout=jinj)
        assert len(api.dropout_mask) > 0  # seed 1 drops in both rounds
        np.testing.assert_array_equal(api.dropout_mask,
                                      np.asarray(japi.dropout_mask))
        assert got["train_loss"] == pytest.approx(want["train_loss"],
                                                  rel=1e-5)
    got = jax.tree.leaves(to_jax_params(
        dict(api.net.params)))
    for a, b in zip(got, jax.tree.leaves(japi.net.params), strict=True):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=1e-5 + 4 * 0.5 / 2 ** 16)


def test_heartbeat_monitor_equal_jax():
    """``tests/test_faults.py``'s fake-clock drills on both packages'
    monitors: the failed and alive sets and the deadline path."""
    from fedml_tpu.core import faults as jax_faults
    from fedml_tpu_torch.core import faults

    def drill(mod):
        t, seen = [0.0], []
        mon = mod.HeartbeatMonitor([1, 2, 3], timeout_s=10.0,
                                   clock=lambda: t[0])
        seen.append(mon.failed())
        t[0] = 5.0
        mon.beat(1)
        t[0] = 12.0
        seen += [mon.failed(), mon.alive()]
        mon.beat(2)
        mon.forget(1)
        seen.append(mon.failed())
        seen.append(mon.wait_all_or_failed([1, 2, 3], have=lambda: [1, 2],
                                           poll_s=0.01))

        def ticking_have():
            t[0] += 7.0
            mon.beat(2)
            mon.beat(3)
            return [2]

        seen.append(mon.wait_all_or_failed([2, 3], have=ticking_have,
                                           poll_s=0.0, deadline_s=21.0))
        seen.append(mon.failed())
        return seen

    got = drill(faults)
    assert got == drill(jax_faults)
    assert got[1] == [2, 3] and got[-2] == [3]


def _native_copy(tmp_path):
    """A private copy of ``fedml_tpu_torch/native`` (loader and source),
    so a test builds into its own ``_build``."""
    import fedml_tpu_torch.native as native

    pkg = tmp_path / "native"
    pkg.mkdir()
    for name in ("__init__.py", "msgnet.cpp"):
        shutil.copy(os.path.join(os.path.dirname(native.__file__), name),
                    pkg / name)
    return pkg


def _load_native(pkg):
    spec = importlib.util.spec_from_file_location(
        "native_copy", str(pkg / "__init__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_msgnet_build_is_atomic(tmp_path, monkeypatch):
    """g++ writes a file of the process's own; the library's path shows
    only a complete build, and a failed build leaves nothing behind."""
    mod = _load_native(_native_copy(tmp_path))
    out = os.path.join(mod._BUILD, "libmsgnet.so")
    seen = []

    def fake_run(cmd, **kw):
        target = cmd[cmd.index("-o") + 1]
        seen.append((target, os.path.exists(out)))
        with open(target, "wb") as f:
            f.write(b"\x7fELF-complete")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(mod.subprocess, "run", fake_run)
    mod._compile(str(tmp_path / "native" / "msgnet.cpp"), out)
    assert seen == [(f"{out}.{os.getpid()}.tmp", False)]
    assert open(out, "rb").read() == b"\x7fELF-complete"
    assert sorted(os.listdir(mod._BUILD)) == ["libmsgnet.so"]

    def failing_run(cmd, **kw):
        with open(cmd[cmd.index("-o") + 1], "wb") as f:
            f.write(b"\x7fEL")
        return subprocess.CompletedProcess(cmd, 1, "", "error: boom")

    os.remove(out)
    monkeypatch.setattr(mod.subprocess, "run", failing_run)
    with pytest.raises(RuntimeError, match="native build failed"):
        mod._compile(str(tmp_path / "native" / "msgnet.cpp"), out)
    assert os.listdir(mod._BUILD) == []


def test_msgnet_loads_in_three_processes_at_once(tmp_path):
    """The three ranks of a federation start together on a checkout with
    no build: each loads a complete library (one of them builds it)."""
    pkg = _native_copy(tmp_path)
    code = ("import importlib.util, sys\n"
            "spec = importlib.util.spec_from_file_location('n', sys.argv[1])\n"
            "m = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(m)\n"
            "m.load_msgnet().mn_server_create\n"
            "print('loaded')\n")
    procs = [subprocess.Popen([sys.executable, "-c", code,
                               str(pkg / "__init__.py")],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(3)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and out.strip() == "loaded", err[-2000:]
    assert sorted(os.listdir(pkg / "_build")) == [".lock", "libmsgnet.so"]
