"""The port's asynchronous tier (``fedml_tpu_torch/algos/fedasync.py``)
against the JAX package's ``fedml_tpu/algos/fedasync.py``:

- ``staleness_weight`` equal to JAX's over a grid;
- loopback federations with ONE worker (arrivals strictly ordered) over
  ``lr`` and a narrow GroupNorm ResNet, from JAX's start weights through
  the port's converter, every message through the tensor wire: the
  global after every version within f32 atol 1e-5 of JAX's (the sync
  tier's parity tolerance; ``batch_size`` ≥ the largest client, so the
  port's shuffle keys only reorder a masked mean);
- the server's mix driven directly with one recorded sequence of uploads
  at mixed staleness: the global after each version within 1e-6 of JAX's
  (one f32 multiply-add a leaf, the same roundings);
- the worker's uploads: a trained net carried across as numpy, through
  both packages' client managers and codecs, byte-equal frames;
- ports of the JAX package's async-tier drills (``tests/test_fedasync.py``,
  ``test_resilience.py``, ``test_ingest_pool.py``, ``test_wire_codec.py``)
  and the refusals in JAX's words; an adaptive controller on both tiers
  with the actuation log equal to JAX's.

Helpers here are shared with ``test_torch_fedbuff.py``."""

import time

import jax
import numpy as np
import pytest
import torch

from fedml_tpu.algos import fedasync as jfa
from fedml_tpu.algos import fedavg_distributed as jfd
from fedml_tpu.algos import fedbuff as jfb
from fedml_tpu.algos.config import FedConfig as JaxFedConfig
from fedml_tpu.comm import codec as jcodec
from fedml_tpu.comm import loopback as jlb
from fedml_tpu.comm.message import Message as JaxMessage
from fedml_tpu.data import batching as jb
from fedml_tpu.models.registry import create_model as jax_create_model
from fedml_tpu.models.resnet import CifarResNet as JaxCifarResNet
from fedml_tpu.trainer.local import model_fns as jax_model_fns
from fedml_tpu.trainer.local import softmax_ce as jax_ce
from fedml_tpu_torch.algos import FedConfig
from fedml_tpu_torch.algos import fedasync as pfa
from fedml_tpu_torch.algos import fedavg_distributed as pfd
from fedml_tpu_torch.algos import fedbuff as pfb
from fedml_tpu_torch.comm import codec as pcodec
from fedml_tpu_torch.comm import loopback as plb
from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.convert import from_jax_params, to_jax_params
from fedml_tpu_torch.data import batching, partition, synthetic
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models.resnet import CifarResNet
from fedml_tpu_torch.trainer.local import softmax_ce

#: A federation's global against JAX's (the sync tier's parity tolerance).
FED_ATOL = 1e-5
#: The server's fold driven directly: the same f32 operations a leaf.
FOLD_ATOL = 1e-6
WIDTHS = (4, 8, 16)
#: Every port run on the CPU; a worker quits after 30 s without its
#: server, so a server that fails fails the test instead of hanging it.
IDLE_S = 30.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- shared helpers -------------------------------------------------------------


def task(seed=0):
    x, y = synthetic.make_image_classification(60, (8, 8, 3), 4, seed=seed)
    parts = partition.partition_dirichlet(y, 6, 0.5, min_size=4, seed=seed)
    xt, yt = synthetic.make_image_classification(20, (8, 8, 3), 4, seed=seed)
    return x, y, parts, xt, yt, max(len(v) for v in parts.values())


def models(name):
    """(JAX's model, a factory of the port's) for ``lr`` or a narrow
    GroupNorm ResNet of one block a stage."""
    if name == "lr":
        return (jax_create_model("lr", num_classes=4),
                lambda: create_model("lr", num_classes=4, in_features=192,
                                     device="cpu"))
    return (JaxCifarResNet(layers=(1, 1, 1), widths=WIDTHS, num_classes=4),
            lambda: CifarResNet(layers=(1, 1, 1), widths=WIDTHS,
                                num_classes=4,
                                generator=torch.Generator().manual_seed(0)))


def jax_leaves(tree):
    return [np.asarray(l) for l in jax.tree.leaves(tree)]


def port_leaves(net):
    """A port net's params as numpy leaves in JAX's layout and order."""
    return [np.asarray(l) for l in jax.tree.leaves(to_jax_params(
        {k: v.detach().clone() for k, v in net.params.items()}))]


def run_tier(port, tier, name, cfg_kw, start, server_kw=(), client_kw=(),
             controller=None):
    """One loopback federation of ``tier`` ("async" or "buff") in one
    package, as its ``FedML_*_distributed`` builds it, every message
    through the tensor wire, from JAX's start weights, with
    ``controller`` (that package's) attached. Returns (the server, the
    global's leaves after every version)."""
    x, y, parts, xt, yt, batch = task()
    jmodel, pmodel = models(name)
    cfg = (FedConfig if port else JaxFedConfig)(batch_size=batch, **cfg_kw)
    if port:
        fed = batching.build_federated_arrays(x, y, parts, batch,
                                              device="cpu")
        test = batching.batch_global(xt, yt, 10, device="cpu")
        setup = pfd.build_federation_setup(
            pmodel(), fed, test, cfg, "LOOPBACK", softmax_ce,
            loopback_wire="tensor",
            pretrained_params=from_jax_params(start)[0])
        mods, leaves, extra = (pfa, pfb), port_leaves, {"device": "cpu"}
    else:
        fed = jb.build_federated_arrays(x, y, parts, batch)
        test = jb.batch_global(xt, yt, 10)
        setup = jfd.build_federation_setup(
            jmodel, fed, test, cfg, "LOOPBACK", jax_ce,
            loopback_wire="tensor", pretrained_params=start)
        mods, leaves, extra = (jfa, jfb), jax_leaves, {}
    size, net0, local_train, eval_fn, args = setup
    snaps = []
    base = (mods[0].FedAsyncServerManager if tier == "async"
            else mods[1].FedBuffServerManager)

    class Recording(base):
        def _ingest(self, msg, staleness):
            v = self.version
            super()._ingest(msg, staleness)
            if self.version != v:
                snaps.append(leaves(self.net))

    server = Recording(args, net0, cfg, size, eval_fn=eval_fn,
                       test_data=test, **dict(server_kw), **extra)
    if controller is not None:
        server.attach_controller(controller)
    client_cls = (mods[0].FedAsyncClientManager if tier == "async"
                  else mods[1].FedBuffClientManager)
    clients = [client_cls(args, rank, size, fed, local_train, cfg,
                          idle_timeout_s=IDLE_S, **dict(client_kw))
               for rank in range(1, size)]
    (plb if port else jlb).run_workers([server.run] + [c.run for c in clients])
    server.final_health = server.health()
    return server, snaps


def jax_start(name):
    jmodel, _ = models(name)
    net0 = jax.jit(jax_model_fns(jmodel).init)(
        jax.random.PRNGKey(0), np.zeros((1, 8, 8, 3), np.float32))
    return jax.tree.map(np.asarray, net0.params)


def assert_same_versions(got, want, start, atol=FED_ATOL):
    """Each version's global within ``atol`` of JAX's, and the run moved
    the params."""
    assert len(got) == len(want) > 0
    for g_v, w_v in zip(got, want):
        for a, b in zip(g_v, w_v):
            np.testing.assert_allclose(a, b, rtol=0, atol=atol)
    moved = max(np.abs(w - s).max() for w, s in
                zip(want[-1], jax.tree.leaves(start)))
    assert moved > 1e-4


class Harness:
    """One package's server over a bare loopback network, handlers invoked
    directly (the JAX package's fake-clock protocol-test pattern)."""

    def __init__(self, port):
        self.port = port
        self.fa, self.fb = (pfa, pfb) if port else (jfa, jfb)
        self.Message = Message if port else JaxMessage
        self.codec = pcodec if port else jcodec
        self.cfg = FedConfig if port else JaxFedConfig
        self.extra = {"device": "cpu"} if port else {}

    def server(self, tier="async", workers=2, net0=None, cfg_kw=(), **kw):
        class A:
            pass

        args = A()
        args.chaos = None
        args.network = (plb if self.port else jlb).LoopbackNetwork(
            workers + 1)
        cfg = self.cfg(**{**dict(client_num_in_total=workers,
                                 client_num_per_round=workers,
                                 comm_round=5), **dict(cfg_kw)})
        net0 = {"w": np.zeros(2, np.float32)} if net0 is None else net0
        cls = (self.fa.FedAsyncServerManager if tier == "async"
               else self.fb.FedBuffServerManager)
        srv = cls(args, net0, cfg, workers + 1, **kw, **self.extra)
        srv.register_message_receive_handlers()
        return srv, args.network

    def upload(self, srv, worker, params, version, task=None, delta=None,
               codec=None):
        m = self.Message(jfd.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, worker, 0)
        m.add(self.Message.MSG_ARG_KEY_MODEL_PARAMS, params)
        m.add(self.Message.MSG_ARG_KEY_NUM_SAMPLES, 4)
        m.add(self.fa.MSG_ARG_KEY_MODEL_VERSION, version)
        if task is not None:
            m.add(self.fa.MSG_ARG_KEY_TASK_SEQ, task)
        if delta is not None:
            m.add(self.codec.DELTA_KEY, delta)
        if codec is not None:
            m.add(self.codec.CODEC_KEY, codec)
        srv.handle_upload(m)
        return m

    def net_of(self, srv):
        return {k: (v.numpy() if self.port else np.asarray(v))
                for k, v in srv.net.items()}


def recorded_uploads(n=9, workers=3, nan_at=None, seed=0):
    """(worker, staleness, params) of a fixed arrival sequence: leaves
    drawn from a seeded RandomState, staleness 0..2, one non-finite
    upload at ``nan_at``."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        p = {"w": rng.randn(4, 3).astype(np.float32),
             "b": rng.randn(3).astype(np.float32)}
        if i == nan_at:
            p["w"][1, 2] = np.nan
        out.append((1 + i % workers, int(rng.randint(0, 3)), p))
    return out


def feed(h, srv, uploads, **kw):
    """Feed ``uploads`` to ``srv`` (one task sequence a worker, the base
    version ``staleness`` behind the server's); returns the net after
    every version."""
    seq, nets = {}, []
    for worker, stale, p in uploads:
        task = seq[worker] = seq.get(worker, -1) + 1
        v = srv.version
        h.upload(srv, worker, p, max(v - stale, 0), task=task, **kw)
        if srv.version != v:
            nets.append(h.net_of(srv))
    return nets


NET0 = {"w": np.full((4, 3), 0.5, np.float32), "b": np.zeros(3, np.float32)}


# --- staleness weighting --------------------------------------------------------


def test_staleness_weight_matches_jax():
    for alpha in (0.05, 0.6, 1.0):
        for s in range(-2, 9):
            for a in (0.0, 0.5, 1.0, 2.0):
                assert (pfa.staleness_weight(alpha, s, a)
                        == jfa.staleness_weight(alpha, s, a))
    assert pfa.staleness_weight(0.6, 3, a=0.5) == pytest.approx(0.3)
    assert pfa.staleness_weight(0.6, -2) == pytest.approx(0.6)


# --- end-to-end parity ----------------------------------------------------------


@pytest.mark.parametrize("name,lr,versions", [("lr", 0.1, 4),
                                              ("resnet", 1e-3, 2)])
def test_fedasync_one_worker_matches_jax_every_version(name, lr, versions):
    start = jax_start(name)
    cfg = dict(client_num_in_total=6, client_num_per_round=1, epochs=1,
               comm_round=versions, lr=lr, frequency_of_the_test=1)
    srv, got = run_tier(True, "async", name, cfg, start)
    jsrv, want = run_tier(False, "async", name, cfg, start)
    assert_same_versions(got, want, start)
    assert srv.staleness_history == jsrv.staleness_history == [0] * versions
    assert srv.arrival_log == jsrv.arrival_log
    for a, b in zip(srv.test_history, jsrv.test_history):
        assert a["version"] == b["version"]
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=0,
                                   atol=FED_ATOL)
    # The frames' headers name the leaves each package's way, so the byte
    # totals differ; every other counter is equal.
    drop = ("bytes_tx", "bytes_rx")
    assert ({k: v for k, v in srv.final_health.items() if k not in drop}
            == {k: v for k, v in jsrv.final_health.items() if k not in drop})


def test_fedasync_mix_driven_directly_matches_jax():
    """A recorded sequence of full-model uploads at staleness 0..2 mixed
    by both servers: the global after every version, and the staleness
    history."""
    ups = recorded_uploads()
    out = []
    for port in (True, False):
        h = Harness(port)
        srv, _ = h.server("async", workers=3, net0=NET0,
                          cfg_kw={"comm_round": 100}, alpha=0.6,
                          staleness_exp=0.5)
        out.append((feed(h, srv, ups), srv.staleness_history))
    (got, hist), (want, jhist) = out
    assert hist == jhist and len(got) == len(ups) and max(hist) > 0
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=FOLD_ATOL)


# --- the worker's uploads -------------------------------------------------------


def _client_uploads(port, tier, codec, deltas):
    """The upload messages of one client manager fed two assignments
    whose local step returns ``start + delta`` (numpy carried across)."""
    h = Harness(port)
    net = (plb if port else jlb).LoopbackNetwork(2)

    class A:
        pass

    args = A()
    args.chaos, args.network = None, net
    cfg = h.cfg(client_num_in_total=1, client_num_per_round=1, seed=3)

    class Fed:
        pass

    fed = Fed()
    fed.x = fed.y = fed.mask = (torch.zeros(1, 1) if port
                                else np.zeros((1, 1), np.float32))
    fed.counts = torch.tensor([4]) if port else np.array([4])
    fed.device = torch.device("cpu")
    it = iter(deltas)

    def local_train(start, *_):
        d = next(it)
        if port:
            return {k: v + torch.from_numpy(d[k]) for k, v in
                    start.items()}, torch.tensor(0.0)
        return {k: np.asarray(v) + d[k] for k, v in start.items()}, 0.0

    mods = (pfa, pfb) if port else (jfa, jfb)
    cls = (mods[0].FedAsyncClientManager if tier == "async"
           else mods[1].FedBuffClientManager)
    cm = cls(args, 1, 2, fed, local_train, cfg, wire_codec_spec=codec)
    for task in range(len(deltas)):
        m = h.Message(jfd.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT, 0, 1)
        m.add(h.Message.MSG_ARG_KEY_CLIENT_INDEX, 0)
        m.add(h.Message.MSG_ARG_KEY_MODEL_PARAMS,
              {k: v.copy() for k, v in NET_BIG.items()})
        m.add(h.fa.MSG_ARG_KEY_MODEL_VERSION, task)
        m.add(h.fa.MSG_ARG_KEY_TASK_SEQ, task)
        m.add(h.codec.OFFER_KEY, h.codec.codec_offer())
        m.add(h.codec.DELTA_OK_KEY, tier == "buff")
        cm.handle_model(m)
    return [m for m in net.inbox(0).queue if hasattr(m, "get_type")]


NET_BIG = {"w": np.linspace(-1, 1, 64 * 40, dtype=np.float32).reshape(64, 40),
           "b": np.full(40, 0.25, np.float32)}


def frame_equal(a, b):
    """Two frames (a codec payload dict or a tree of leaves) byte-equal."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            frame_equal(a[k], b[k])
    elif isinstance(a, (int, float, str)):
        assert a == b
    elif isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16:
        b = np.asarray(b)
        assert str(b.dtype) == "bfloat16" and tuple(a.shape) == b.shape
        assert a.view(torch.int16).numpy().tobytes() == b.tobytes()
    else:
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("tier,codec", [
    ("async", "none"), ("async", "bf16"), ("async", "int8"),
    ("buff", "none"), ("buff", "bf16"), ("buff", "topk0.01+int8")])
def test_worker_uploads_byte_equal_to_jax(tier, codec):
    """Two uploads of one worker (the second carries top-k's
    error-feedback residual): the same frame bytes and stamps."""
    rng = np.random.RandomState(1)
    deltas = [{k: (0.01 * rng.randn(*v.shape)).astype(np.float32)
               for k, v in NET_BIG.items()} for _ in range(2)]
    got = _client_uploads(True, tier, codec, deltas)
    want = _client_uploads(False, tier, codec, deltas)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for key in (pcodec.CODEC_KEY, pcodec.DELTA_KEY,
                    pfa.MSG_ARG_KEY_TASK_SEQ, pfa.MSG_ARG_KEY_MODEL_VERSION,
                    Message.MSG_ARG_KEY_NUM_SAMPLES):
            assert g.get(key) == w.get(key)
        frame_equal(g.get(Message.MSG_ARG_KEY_MODEL_PARAMS),
                    w.get(Message.MSG_ARG_KEY_MODEL_PARAMS))


# --- ports of the JAX package's drills ------------------------------------------


def _lr_fed(n_clients=6, seed=1):
    x, y = synthetic.make_classification(240, n_features=8, n_classes=4,
                                         seed=seed)
    fed = batching.build_federated_arrays(
        x, y, partition.partition_homo(len(x), n_clients), 16, device="cpu")
    return fed, batching.batch_global(x[:64], y[:64], 16, device="cpu")


def _lr():
    return create_model("lr", num_classes=4, in_features=8, device="cpu",
                        generator=torch.Generator().manual_seed(0))


def test_fedasync_loopback_trains():
    """tests/test_fedasync.py: cfg.comm_round server updates with no
    barrier, every upload mixed at once; learning, the exact number of
    versions, staleness ≥ 1 for the second arrival."""
    fed, test = _lr_fed()
    cfg = FedConfig(client_num_in_total=6, client_num_per_round=3,
                    comm_round=12, epochs=2, batch_size=16, lr=0.3,
                    frequency_of_the_test=3)
    srv = pfa.FedML_FedAsync_distributed(_lr(), fed, test, cfg, alpha=0.8,
                                         device="cpu",
                                         idle_timeout_s=IDLE_S)
    assert srv.version == cfg.comm_round
    assert len(srv.staleness_history) == cfg.comm_round
    assert min(srv.staleness_history) >= 0
    assert max(srv.staleness_history) >= 1
    assert srv.test_history[-1]["accuracy"] > 0.5
    assert srv.adapter_holder is None


@pytest.mark.parametrize("port", [True, False], ids=["port", "jax"])
def test_async_duplicate_upload_is_idempotent(port):
    """test_resilience.py:610: a duplicated upload is mixed once and not
    replied to."""
    h = Harness(port)
    srv, network = h.server("async", workers=1)
    up = h.upload(srv, 1, {"w": np.ones(2, np.float32)}, 0)
    assert srv.version == 1
    n_replies = len(network.inbox(1).queue)
    srv.handle_upload(up)  # duplicate delivery
    assert srv.version == 1 and srv.duplicate_drops == 1
    assert len(network.inbox(1).queue) == n_replies


@pytest.mark.parametrize("port", [True, False], ids=["port", "jax"])
def test_async_init_dead_worker_evicted_not_crashing(port):
    """test_resilience.py:680: a silo dead at startup is evicted, once."""
    h = Harness(port)
    srv, network = h.server("async", workers=2)
    real = srv.send_message

    def flaky(msg):
        if int(msg.get_receiver_id()) == 2:
            raise ConnectionError("dead at startup")
        real(msg)

    srv.send_message = flaky
    srv.send_init_msg()
    assert srv._members == {1} and srv.evictions == 1
    assert len(network.inbox(1).queue) == 1
    srv._send_assignment(2)
    assert srv.evictions == 1


def test_async_client_recovery_resends_instead_of_retraining():
    """test_resilience.py:703: a recovery assignment whose ``expected``
    predates our latest upload resends the cache; one confirming it was
    accepted trains; a plain duplicate is dropped."""
    net = plb.LoopbackNetwork(2)
    args = type("A", (), {"network": net, "chaos": None})()
    cfg = FedConfig(client_num_in_total=2, client_num_per_round=1)

    class Fed:
        x = y = mask = torch.zeros(2, 1, 1)
        counts = torch.tensor([4, 4])
        device = torch.device("cpu")

    cm = pfa.FedAsyncClientManager(
        args, 1, 2, Fed(),
        lambda *a: ({"w": torch.zeros(2)}, torch.tensor(0.0)), cfg)

    def assign(version, recovery=False, expected=-1):
        m = Message(pfd.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT, 0, 1)
        m.add(Message.MSG_ARG_KEY_CLIENT_INDEX, 0)
        m.add(Message.MSG_ARG_KEY_MODEL_PARAMS,
              {"w": np.zeros(2, np.float32)})
        m.add(pfa.MSG_ARG_KEY_MODEL_VERSION, version)
        if recovery:
            m.add("recovery", True)
            m.add("expected", expected)
        cm.handle_model(m)

    assign(0)
    assert cm.steps == 1
    n0 = len(net.inbox(0).queue)
    assign(0)
    assert cm.duplicate_drops == 1 and cm.steps == 1
    assert len(net.inbox(0).queue) == n0
    assign(3, recovery=True, expected=-1)
    assert cm.upload_resends == 1 and cm.steps == 1
    assert len(net.inbox(0).queue) == n0 + 1
    assign(3, recovery=True, expected=0)
    assert cm.steps == 2 and len(net.inbox(0).queue) == n0 + 2


def test_fedasync_dead_worker_cannot_hang_termination():
    """test_resilience.py:866: one worker never runs; the terminal
    watchdog evicts it and the run ends with every version."""
    fed, test = _lr_fed()
    cfg = FedConfig(client_num_in_total=6, client_num_per_round=3,
                    comm_round=6, epochs=1, batch_size=16, lr=0.3,
                    frequency_of_the_test=2, heartbeat_interval_s=0.2)
    size, net0, local_train, eval_fn, args = pfd.build_federation_setup(
        _lr(), fed, test, cfg, "LOOPBACK", softmax_ce)
    server = pfa.FedAsyncServerManager(args, net0, cfg, size,
                                       eval_fn=eval_fn, test_data=test,
                                       done_timeout_s=2.0, device="cpu")
    clients = [pfa.FedAsyncClientManager(args, rank, size, fed, local_train,
                                         cfg, idle_timeout_s=10.0)
               for rank in range(1, size - 1)]  # the last rank is dead
    t0 = time.monotonic()
    plb.run_workers([server.run] + [c.run for c in clients])
    assert time.monotonic() - t0 < 30.0
    assert server.version == cfg.comm_round and server.evictions >= 1


def test_fedasync_pooled_decode_bit_equal_to_inline():
    """test_ingest_pool.py:441: the pool hosts only the decode, so at
    one worker (strict request/response order) any pool size is
    bit-equal to inline."""
    x, y = synthetic.make_classification(160, n_features=12, n_classes=3,
                                         seed=2)
    fed = batching.build_federated_arrays(
        x, y, partition.partition_homo(len(x), 2), 16, device="cpu")

    def go(workers):
        cfg = FedConfig(client_num_in_total=2, client_num_per_round=1,
                        comm_round=4, epochs=1, batch_size=16, lr=0.3,
                        frequency_of_the_test=10 ** 6,
                        ingest_workers=workers)
        return pfa.FedML_FedAsync_distributed(
            create_model("lr", num_classes=3, in_features=12, device="cpu",
                         generator=torch.Generator().manual_seed(0)),
            fed, None, cfg, wire_codec="int8", loopback_wire="tensor",
            device="cpu", idle_timeout_s=IDLE_S)

    s0, s2 = go(0), go(2)
    for k in s0.net.params:
        assert torch.equal(s0.net.params[k], s2.net.params[k])
    assert s2.ingest_profile()["ingest_pool"]["workers"] == 2


def test_async_tier_refuses_sparsifiers_on_full_model_uploads():
    """test_wire_codec.py:671: top-k of full weights would zero most of
    the model — the async client refuses it in JAX's words; bf16 is fine,
    and the FedBuff client takes top-k on its deltas."""
    fed, _ = _lr_fed()
    cfg = FedConfig(client_num_in_total=1, client_num_per_round=1,
                    comm_round=1, epochs=1, batch_size=16)
    size, _, local_train, _, args = pfd.build_federation_setup(
        _lr(), fed, None, cfg, "LOOPBACK", softmax_ce)
    with pytest.raises(ValueError, match="delta") as got:
        pfa.FedAsyncClientManager(args, 1, size, fed, local_train, cfg,
                                  wire_codec_spec="topk0.1")
    jcfg = JaxFedConfig(client_num_in_total=1, client_num_per_round=1)
    jargs = type("A", (), {"network": jlb.LoopbackNetwork(2),
                           "chaos": None})()
    with pytest.raises(ValueError) as want:
        jfa.FedAsyncClientManager(jargs, 1, 2, None, None, jcfg,
                                  wire_codec_spec="topk0.1")
    assert str(got.value) == str(want.value)
    pfa.FedAsyncClientManager(args, 1, size, fed, local_train, cfg,
                              wire_codec_spec="bf16")
    pfb.FedBuffClientManager(args, 1, size, fed, local_train, cfg,
                             wire_codec_spec="topk0.1+int8")


@pytest.mark.parametrize("field", ["agg_shards", "secagg"])
def test_sync_only_capabilities_refused_in_jax_words(field):
    val = 2 if field == "agg_shards" else True
    errs = []
    for port in (True, False):
        h = Harness(port)
        with pytest.raises(ValueError) as err:
            h.server("async", cfg_kw={field: val})
        errs.append(str(err.value))
    assert errs[0] == errs[1]


def test_controller_refused_by_name():
    """The adaptive controller (``controller_from_args``) on both async
    tiers, one worker so arrivals are ordered: each version within
    FED_ATOL of JAX's and the actuation log equal to JAX's, entry for
    entry (FedBuff's window schedule moves ``buffer_k``); the entry
    points take ``controller=`` and attach it."""
    from fedml_tpu import ctrl as jctrl
    from fedml_tpu_torch import ctrl as pctrl

    flags = type("Flags", (), {"controller": "adaptive"})()
    start = jax_start("lr")
    cfg = dict(client_num_in_total=6, client_num_per_round=1, comm_round=8,
               epochs=1, lr=0.1, frequency_of_the_test=1)
    for tier, kw in (("async", {}), ("buff", {"server_kw": {"buffer_k": 2}})):
        pc, jc = (pctrl.controller_from_args(flags),
                  jctrl.controller_from_args(flags))
        _, got = run_tier(True, tier, "lr", cfg, start, controller=pc, **kw)
        _, want = run_tier(False, tier, "lr", cfg, start, controller=jc,
                           **kw)
        assert_same_versions(got, want, start)
        assert pc.actuation_log == jc.actuation_log
        assert pc.actuation_log or tier == "async"
    fed, test = _lr_fed()
    cfg = FedConfig(client_num_in_total=6, client_num_per_round=2,
                    comm_round=2, batch_size=16)
    for run in (pfa.FedML_FedAsync_distributed,
                pfb.FedML_FedBuff_distributed):
        ctl = pctrl.controller_from_args(flags)
        srv = run(_lr(), fed, test, cfg, controller=ctl, device="cpu",
                  idle_timeout_s=IDLE_S)
        assert srv._controller is ctl and srv.version == 2


def test_entry_point_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    fed, test = _lr_fed()
    cfg = FedConfig(client_num_in_total=6, client_num_per_round=2,
                    comm_round=1, batch_size=16)
    for run in (pfa.FedML_FedAsync_distributed,
                pfb.FedML_FedBuff_distributed):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run(_lr(), fed, test, cfg)
