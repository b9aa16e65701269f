"""The port's serve plane (fedml_tpu_torch.serve, models.adapter) against the
JAX package's (fedml_tpu.serve): the batched multi-adapter prefill, the
KV-cached decoder, the adapter store, and the request plane's counters,
spans and shutdown. One flax init supplies the base and global adapters
to both sides; request rows are made with numpy from a seed."""

import json
import socket
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.comm.codec import tree_to_vector_np as jax_vec
from fedml_tpu.models.adapter import PersonalAdapterStore as JaxStore
from fedml_tpu.models.adapter import adapter_model_fns as jax_fns
from fedml_tpu.models.adapter import merge_params as jax_merge
from fedml_tpu.models.registry import create_model as jax_create_model
from fedml_tpu.serve import AdapterDecoder as JaxDecoder
from fedml_tpu.serve import ServeForward as JaxForward
from fedml_tpu.serve import ServeManager as JaxManager
from fedml_tpu_torch.convert import from_jax_params
from fedml_tpu_torch.core.flat import tree_to_vector_np
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.models.adapter import (PersonalAdapterStore,
                                            adapter_model_fns)
from fedml_tpu_torch.obs import trace as obs_trace
from fedml_tpu_torch.serve import (AdapterDecoder, ServeForward,
                                   ServeManager, ServeOverload, ServeRefused,
                                   ServeSocketServer, pick_attention)
from fedml_tpu_torch.serve.plane import ServeRequest

V, T = 61, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several worker processes at once; torch's own
    thread pool per process would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(attn):
    return dict(vocab_size=V, d_model=32, n_heads=2, n_layers=2, max_len=64,
                adapter_rank=2, adapter_scope="all", attn=attn)


def _jax_side(attn):
    model = jax_create_model("transformer_lm", **_kw(attn))
    fns = jax_fns(model)
    net = fns.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    leaves, treedef = jax.tree.flatten(net.params)
    rng = np.random.default_rng(7)
    glob = jax.tree.unflatten(treedef, [
        (rng.normal(0, 0.05, l.shape)).astype(np.float32) for l in leaves])
    return model, fns, glob


def _port_side(attn, base, glob):
    state, adapters = from_jax_params(jax_merge(
        jax.tree.map(np.asarray, base), glob))
    model = create_model("transformer_lm", device="cpu", **_kw(attn))
    fns = adapter_model_fns(model, base_params=state)
    return {"model": model, "fns": fns, "glob": adapters,
            "fwd": ServeForward(fns, adapters, device="cpu"),
            "dec": AdapterDecoder(model, fns, adapters, device="cpu")}


@pytest.fixture(scope="module")
def jstack():
    model, fns, glob = _jax_side("dense")
    return {"model": model, "fns": fns, "glob": glob,
            "fwd": JaxForward(fns, glob),
            "dec": JaxDecoder(model, fns, glob)}


@pytest.fixture(scope="module")
def stack(jstack):
    return _port_side("dense", jstack["fns"].holder["base"], jstack["glob"])


def _vecs(glob, b, seed=5):
    """[b, D] rows: row 0 the global, rows 1.. perturbed."""
    vecs = np.stack([tree_to_vector_np(glob)] * b)
    rng = np.random.default_rng(seed)
    vecs[1:] += rng.normal(0, 0.03, vecs[1:].shape).astype(np.float32)
    return vecs


def _toks(b, t=T, seed=3):
    return np.random.RandomState(seed).randint(0, V, (b, t)).astype(np.int32)


# -- batched forward and decoder against JAX ---------------------------


def test_global_rows_are_the_same_vectors(jstack, stack):
    """The port's flat rows of the global are JAX's, bit for bit."""
    assert np.array_equal(tree_to_vector_np(stack["glob"]),
                          jax_vec(jstack["glob"]))
    assert stack["fwd"].dim == jstack["fwd"].dim


@pytest.mark.parametrize("attn", ["dense", "flash"])
def test_serve_forward_prefill_matches_jax(jstack, attn):
    """Four different personalized rows in one forward: logits within
    atol 1e-4 of JAX's ServeForward.prefill (f32; GEMM blocking differs)."""
    if attn == "dense":
        jfwd, glob, base = jstack["fwd"], jstack["glob"], \
            jstack["fns"].holder["base"]
    else:
        _, fns, glob = _jax_side("flash")
        jfwd, base = JaxForward(fns, glob), fns.holder["base"]
    port = _port_side(attn, base, glob)
    vecs, toks = _vecs(glob, 4), _toks(4)
    want = np.asarray(jfwd.prefill(vecs, toks))
    got = port["fwd"].prefill(vecs, toks)
    assert got.dtype == torch.float32 and got.shape == (4, T, V)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_batched_b1_matches_sequential(stack):
    """B=1 through the batched path (per-row einsum LoRA) equals the
    per-request path (plain matmul LoRA) within atol 1e-6."""
    vecs, toks = _vecs(stack["glob"], 1), _toks(1)
    batched = stack["fwd"].prefill(vecs, toks)
    seq = stack["fwd"].prefill_sequential(vecs, toks)
    torch.testing.assert_close(batched, seq, atol=1e-6, rtol=0)


def test_padding_is_inert(stack):
    """Right-padding the tokens and zero-padding the batch leave the real
    rows' logits unchanged within atol 2e-6 (allclose, not bitwise: CPU
    GEMM blocking and the softmax / P·V reductions regroup their sums
    with T and B; measured 1.2e-6 on logits of magnitude ~3, whose f32
    ulp is 2.4e-7, so 1e-6 sits inside the rounding spread)."""
    fwd = stack["fwd"]
    vecs, toks = _vecs(stack["glob"], 2), _toks(2, t=6)
    full = fwd.prefill(vecs, toks)
    padded_toks = np.zeros((2, T), np.int32)
    padded_toks[:, :6] = toks
    padded = fwd.prefill(vecs, padded_toks)
    torch.testing.assert_close(padded[:, :6], full, atol=2e-6, rtol=0)
    wide_vecs = np.zeros((4, fwd.dim), np.float32)
    wide_vecs[:2] = vecs
    wide_toks = np.zeros((4, T), np.int32)
    wide_toks[:2] = padded_toks
    wide = fwd.prefill(wide_vecs, wide_toks)
    torch.testing.assert_close(wide[:2], padded, atol=2e-6, rtol=0)


def test_decoder_generate_matches_jax_with_right_padding(jstack, stack):
    """Right-padded rows of different true lengths: the port's greedy
    tokens equal JAX's, and the prefill logits at each row's true last
    position are within atol 1e-4."""
    vecs = _vecs(stack["glob"], 3)
    lens = np.array([5, 16, 9], np.int32)
    toks = _toks(3)
    for i, ln in enumerate(lens):
        toks[i, ln:] = 0
    jst = jstack["fwd"].stacked_tree(vecs)
    want_last, _ = jstack["dec"].prefill(jst, toks, lens=lens)
    want_gen = np.asarray(jstack["dec"].generate(jst, toks, 6, lens=lens))
    st = stack["fwd"].stacked_tree(vecs)
    last, cache = stack["dec"].prefill(st, toks, lens=lens)
    assert cache.pos.tolist() == lens.tolist()
    np.testing.assert_allclose(last.numpy(), np.asarray(want_last),
                               atol=1e-4, rtol=0)
    gen = stack["dec"].generate(st, toks, 6, lens=lens)
    assert gen.dtype == torch.int32
    assert np.array_equal(gen.numpy(), want_gen)


def test_decoder_tracks_the_full_forward(stack):
    """Cached prefill + steps follow the full forward: each generated
    token is the argmax of the full forward over the prompt so far."""
    fwd, dec = stack["fwd"], stack["dec"]
    vecs, toks = _vecs(stack["glob"], 2), _toks(2, t=8)
    st = fwd.stacked_tree(vecs)
    last, _ = dec.prefill(st, toks)
    full = fwd.batched(st, toks)
    torch.testing.assert_close(last, full[:, -1], atol=2e-5, rtol=0)
    gen = dec.generate(st, toks, 3).numpy()
    cur = toks.copy()
    for step in range(3):
        nxt = fwd.batched(st, cur)[:, -1].argmax(-1).numpy()
        assert np.array_equal(gen[:, step], nxt)
        cur = np.concatenate([cur, nxt[:, None].astype(np.int32)], 1)


def test_pick_attention_crossover():
    assert pick_attention(2047) == "dense"
    assert pick_attention(2048) == "flash"


def test_entry_points_refuse_the_cpu_unasked(stack, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeForward(stack["fns"], stack["glob"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AdapterDecoder(stack["model"], stack["fns"], stack["glob"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeManager(stack["fwd"], None, stack["glob"])


# -- adapter store -------------------------------------------------------


def test_store_gather_scatter_fallback_and_state_dict(stack, tmp_path):
    for spill in (None, str(tmp_path)):
        store = PersonalAdapterStore(6, stack["glob"], spill_dir=spill)
        assert store.memmapped == (spill is not None)
        glob_vec = tree_to_vector_np(stack["glob"])
        pvec = glob_vec + 0.5
        store.scatter([2, 4], np.stack([pvec, pvec * 2]))
        rows = store.gather([0, 2, 4], stack["glob"])
        assert np.array_equal(rows[0], glob_vec)  # never personalized
        assert np.array_equal(rows[1], pvec)
        assert np.array_equal(rows[2], pvec * 2)
        rows[1] = 0  # private copy
        assert np.array_equal(store.gather([2], stack["glob"])[0], pvec)
        twin = PersonalAdapterStore(6, stack["glob"])
        twin.load_state_dict(store.state_dict())
        assert np.array_equal(twin.gather(range(6), stack["glob"]),
                              store.gather(range(6), stack["glob"]))
        tree = store.tree_of(pvec)
        assert np.array_equal(tree_to_vector_np(tree), pvec)
    with pytest.raises(ValueError, match="does not match"):
        PersonalAdapterStore(3, stack["glob"]).load_state_dict(
            store.state_dict())


def test_store_rows_written_by_jax_decode_alike(jstack, stack):
    """A JAX store's checkpoint loads into the port's store and gathers
    the same rows (same flat order, same fallback)."""
    jstore = JaxStore(5, jstack["glob"])
    rng = np.random.default_rng(2)
    jstore.scatter([1, 3], rng.normal(size=(2, jstore.dim))
                   .astype(np.float32))
    store = PersonalAdapterStore(5, stack["glob"])
    store.load_state_dict(jstore.state_dict())
    assert np.array_equal(store.gather(range(5), stack["glob"]),
                          jstore.gather(np.arange(5), jstack["glob"]))


def test_store_concurrent_gather_never_tears(stack):
    """Gathers racing scatters of CONSTANT rows never see a mixed row."""
    store = PersonalAdapterStore(8, stack["glob"])
    dim = store.dim
    store.scatter(np.arange(8), np.zeros((8, dim), np.float32))
    stop = threading.Event()
    fail = []

    def writer():
        c = 0.0
        while not stop.is_set():
            c += 1.0
            store.scatter(np.arange(8), np.full((8, dim), c, np.float32))

    def reader():
        for _ in range(200):
            rows = store.gather(np.arange(8), stack["glob"])
            if ((rows.max(axis=1) - rows.min(axis=1)) != 0).any():
                fail.append(rows)
                return

    w, r = threading.Thread(target=writer), threading.Thread(target=reader)
    w.start()
    r.start()
    r.join(timeout=60)
    stop.set()
    w.join(timeout=60)
    assert not r.is_alive() and not w.is_alive()
    assert not fail, "gather returned a torn row"


# -- request plane ---------------------------------------------------------


def _manager(stack, **kw):
    kw.setdefault("seq_len", T)
    kw.setdefault("max_batch", 4)
    return ServeManager(stack["fwd"], kw.pop("store", None), stack["glob"],
                        device="cpu", **kw)


def test_serve_batch_results_counters_and_spans(stack):
    store = PersonalAdapterStore(8, stack["glob"])
    store.scatter([2], (tree_to_vector_np(stack["glob"]) + 0.05)[None])
    mgr = _manager(stack, store=store)
    tracer = obs_trace.SpanTracer()
    with obs_trace.using(tracer):
        reqs = [mgr.submit(i, _toks(1, t=4 + i)[0]) for i in range(3)]
        mgr.serve_batch([mgr._q.get_nowait() for _ in range(3)])
    for i, req in enumerate(reqs):
        logits, gen = req.result(5)
        assert logits.shape == (4 + i, V) and gen is None
    glob_logits, _ = reqs[0].result(5)
    assert not np.array_equal(reqs[2].result(5)[0][:4], glob_logits)
    stats = mgr.stats()
    assert stats["serve/admitted"] == 3 and stats["serve/served"] == 3
    assert stats["serve/batch_fill_count"] == 1
    names = {e["name"] for e in tracer.events()}
    assert {"serve.gather", "serve.prefill"} <= names


def test_submit_sheds_refuses_and_counts(stack):
    mgr = _manager(stack, queue_cap=2, decoder=stack["dec"])
    mgr.submit(0, [1, 2])
    mgr.submit(1, [3])
    with pytest.raises(ServeOverload):
        mgr.submit(2, [4])
    with pytest.raises(ServeRefused):
        mgr.submit(0, list(range(T + 5)))
    with pytest.raises(ServeRefused):
        mgr.submit(0, [])
    with pytest.raises(ServeRefused, match="max_new_tokens"):
        mgr.submit(0, [1, 2], max_new_tokens=-1)
    over = stack["dec"].max_len - mgr.seq_len + 1
    with pytest.raises(ServeRefused, match="decoder budget"):
        mgr.submit(0, [1, 2], max_new_tokens=over)
    stats = mgr.stats()
    assert stats["serve/shed"] == 1 and stats["serve/refused"] == 4
    assert stats["serve/admitted"] == 2


def test_micro_batcher_thread_serves_and_decodes(stack):
    with _manager(stack, decoder=stack["dec"], deadline_s=0.005) as mgr:
        reqs = [mgr.submit(i, [1, 2, 3][:1 + i % 3], max_new_tokens=2)
                for i in range(6)]
        for req in reqs:
            logits, gen = req.result(60)
            assert gen.shape == (2,) and gen[0] == int(logits[-1].argmax())
    stats = mgr.stats()
    assert stats["serve/served"] == 6 and stats.get("serve/shed", 0) == 0
    assert stats["serve/latency_ms_count"] == 6


def test_close_drains_stragglers_and_refuses_after(stack):
    mgr = _manager(stack)
    mgr.start()
    mgr.close()
    straggler = ServeRequest(0, np.array([1, 2], np.int32), 0, 0.0)
    mgr._q.put_nowait(straggler)
    mgr.close()
    with pytest.raises(ServeRefused, match="shut down"):
        straggler.result(5)
    with pytest.raises(ServeRefused, match="shut down"):
        mgr.submit(0, [1, 2])


def test_batch_failure_reaches_every_waiter(stack):
    """serve_batch never raises: a failing batch completes each request
    with the error, which its result() raises."""
    mgr = _manager(stack)
    reqs = [mgr.submit(i, [1, 2]) for i in range(2)]
    mgr.fwd = None  # the forward is gone: the batch must fail
    mgr.serve_batch([mgr._q.get_nowait() for _ in range(2)])
    for req in reqs:
        with pytest.raises(ServeRefused, match="batch failed"):
            req.result(5)


def test_set_live_swaps_the_fallback_global(stack):
    """Never-personalized rows serve the live global; set_live swaps it at
    the next batch and bumps the version."""
    store = PersonalAdapterStore(4, stack["glob"])
    mgr = _manager(stack, store=store)
    new_vec = tree_to_vector_np(stack["glob"]) * 0.5
    outs = []
    for version in (None, 3):
        if version is not None:
            mgr.set_live(version, store.tree_of(new_vec))
        req = mgr.submit(1, [1, 2, 3])
        mgr.serve_batch([mgr._q.get_nowait()])
        outs.append(req.result(5)[0])
    assert mgr.live_version == 3
    assert np.array_equal(tree_to_vector_np(mgr.live_adapters()), new_vec)
    want = stack["fwd"].prefill(new_vec[None],
                                np.array([[1, 2, 3] + [0] * (T - 3)]))
    np.testing.assert_allclose(outs[1], want[0, :3].numpy(), atol=2e-6)
    assert not np.allclose(outs[0], outs[1])


def test_shadow_mirror_ce_matches_jax(jstack, stack):
    """The mirrored next-token CE of both arms equals the JAX plane's on
    the same traffic (atol 1e-4), with pad rows masked out."""
    cand_vec = tree_to_vector_np(stack["glob"]) * 0.5
    cand_port = stack["fwd"].stacked_tree(cand_vec[None])
    cand_port = jax.tree.map(lambda x: x[0].numpy(), cand_port)
    jmgr = JaxManager(jstack["fwd"], None, jstack["glob"], seq_len=T,
                      max_batch=4)
    jmgr.set_shadow(1, jstack["fwd"]._row_tree(cand_vec[None], 0))
    mgr = _manager(stack)
    mgr.set_shadow(1, cand_port)
    tracer = obs_trace.SpanTracer()
    for m in (jmgr, mgr):
        for n in (1, 3):
            reqs = [m.submit(i, [1, 2, 3, 4 + i]) for i in range(n)]
            with obs_trace.using(tracer):
                m.serve_batch([m._q.get_nowait() for _ in range(n)])
            for r in reqs:
                r.result(5)
    want, got = jmgr.shadow_scores(), mgr.shadow_scores()
    assert got["tokens"] == want["tokens"] == 4 * 3
    assert got["candidate_version"] == 1
    np.testing.assert_allclose([got["live_ce"], got["cand_ce"]],
                               [want["live_ce"], want["cand_ce"]], atol=1e-4)
    assert "serve.shadow" in {e["name"] for e in tracer.events()}


def test_socket_front_end_roundtrip(stack):
    with _manager(stack, decoder=stack["dec"]) as mgr:
        with ServeSocketServer(mgr, 0) as srv:
            conn = socket.create_connection(("127.0.0.1", srv.port),
                                            timeout=30)
            conn.sendall((json.dumps({"client": 0, "tokens": [1, 2, 3],
                                      "max_new_tokens": 2}) + "\n").encode())
            buf = b""
            while b"\n" not in buf:
                buf += conn.recv(4096)
            conn.close()
    reply = json.loads(buf.split(b"\n")[0])
    assert len(reply["generated"]) == 2
    logits = stack["fwd"].prefill(
        tree_to_vector_np(stack["glob"])[None],
        np.array([[1, 2, 3] + [0] * (T - 3)], np.int32))
    assert reply["next_token"] == int(logits[0, 2].argmax())
