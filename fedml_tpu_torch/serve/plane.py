"""The request plane: bounded admission, micro-batching, shadow mirror
(port of ``fedml_tpu/serve/plane.py``).

``ServeManager`` turns single requests into the batched forward's unit of
work: a bounded queue admits or SHEDS (a full queue refuses loudly), and a
micro-batcher thread closes a batch when ``max_batch`` requests arrived or
``deadline_s`` after the first one, whichever is first. Every batch is
padded to one ``[max_batch, seq_len]`` shape; padding rows and positions
leave real rows unchanged (causal attention, row-independent batch).

The lifecycle is span-traced (``serve.gather`` / ``serve.prefill`` /
``serve.decode`` / ``serve.shadow``) and metered in the metrics registry:
``serve/admitted``, ``serve/shed``, ``serve/refused``, ``serve/served``
counters and ``serve/latency_ms``, ``serve/batch_fill`` histograms.

A batch runs the batched forward for the logits and, when a request asks
for new tokens, the decoder's ``generate`` — which runs its own dense
prefill of the prompt before decoding (the JAX plane does the same). While
a shadow candidate is staged, each batch is mirrored through both globals
and their next-token CE accumulates for the rollout gate.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from fedml_tpu_torch.core.device import resolve_device
from fedml_tpu_torch.core.flat import to_numpy_tree, tree_to_vector_np
from fedml_tpu_torch.obs import trace as obs_trace
from fedml_tpu_torch.obs.registry import MetricsRegistry


class ServeOverload(RuntimeError):
    """Admission refused: the bounded request queue is full (counted in
    ``serve/shed``)."""


class ServeRefused(RuntimeError):
    """Request malformed for this plane (counted in ``serve/refused``):
    wrong token length, bad decode budget, or plane shut down."""


_STOP = object()


class ServeRequest:
    """One admitted request: resolves to its logits slice
    (``[true_len, V]``) and, when ``max_new_tokens > 0``, the greedy
    continuation. ``result()`` blocks until its micro-batch completes and
    raises the batch's error, if any."""

    __slots__ = ("client_id", "tokens", "max_new_tokens", "t_submit",
                 "_done", "_logits", "_generated", "_error")

    def __init__(self, client_id: int, tokens, max_new_tokens: int,
                 t_submit: float):
        self.client_id = int(client_id)
        self.tokens = np.asarray(tokens, np.int32)
        self.max_new_tokens = int(max_new_tokens)
        self.t_submit = float(t_submit)
        self._done = threading.Event()
        self._logits = None
        self._generated = None
        self._error = None

    def result(self, timeout: Optional[float] = None):
        """``(logits [true_len, V], generated [max_new_tokens] | None)``."""
        if not self._done.wait(timeout):
            raise TimeoutError("serve request not completed in time")
        if self._error is not None:
            raise self._error
        return self._logits, self._generated


class ServeManager:
    """Micro-batching front end over one
    :class:`~fedml_tpu_torch.serve.forward.ServeForward` (+ optional
    :class:`~fedml_tpu_torch.serve.forward.AdapterDecoder`).

    ``store`` is the ``PersonalAdapterStore`` rows gather from (``None``:
    every row serves the live global); ``live_adapters`` seeds version 0.
    ``start()`` spawns the batcher thread; tests may drive
    :meth:`serve_batch` synchronously. ``device=None`` means cuda and must
    be the forward's device."""

    def __init__(self, forward, store, live_adapters, *,
                 seq_len: int = 16, max_batch: int = 32,
                 deadline_s: float = 0.005, queue_cap: int = 256,
                 decoder=None, registry=None, clock=None,
                 live_version: int = 0, device=None):
        dev = resolve_device(device)
        if dev.type != forward.device.type:
            raise ValueError(f"the forward runs on {forward.device}, not on "
                             f"{dev}")
        self.fwd = forward
        self.store = store
        self.decoder = decoder
        self.seq_len = int(seq_len)
        self.max_batch = int(max_batch)
        self.deadline_s = float(deadline_s)
        self.registry = registry if registry is not None else MetricsRegistry()
        self._clock = clock if clock is not None else time.monotonic
        self._q: "queue.Queue" = queue.Queue(maxsize=int(queue_cap))
        self._lock = threading.Lock()
        self._live_version = int(live_version)
        self._live = to_numpy_tree(live_adapters)
        self._live_vec = self._vec(self._live)
        self._shadow = None  # (version, adapters, vec) while staged
        # mirrored-traffic CE sums: [live_ce, live_tok, cand_ce, cand_tok]
        self._shadow_sums = np.zeros(4, np.float64)
        self._thread = None
        self._running = False

    # -- version surface (rollout loop) --------------------------------

    def _vec(self, adapters) -> np.ndarray:
        return tree_to_vector_np(adapters)

    @property
    def live_version(self) -> int:
        with self._lock:
            return self._live_version

    def live_adapters(self):
        with self._lock:
            return self._live

    def set_live(self, version: int, adapters) -> None:
        """Swap the global adapters live traffic falls back to, at the next
        batch boundary."""
        adapters = to_numpy_tree(adapters)
        vec = self._vec(adapters)
        with self._lock:
            self._live_version = int(version)
            self._live = adapters
            self._live_vec = vec

    def set_shadow(self, version: Optional[int], adapters=None) -> None:
        """Stage (or clear, with ``version=None``) the shadow candidate;
        resets the mirrored-traffic CE accumulators."""
        staged = None
        if version is not None:
            adapters = to_numpy_tree(adapters)
            staged = (int(version), adapters, self._vec(adapters))
        with self._lock:
            self._shadow = staged
            self._shadow_sums = np.zeros(4, np.float64)

    def shadow_scores(self) -> dict:
        """Mirrored-traffic next-token CE per arm and the token count."""
        with self._lock:
            s = self._shadow_sums.copy()
            version = self._shadow[0] if self._shadow is not None else None
        return {
            "candidate_version": version,
            "tokens": int(s[1]),
            "live_ce": float(s[0] / s[1]) if s[1] else float("nan"),
            "cand_ce": float(s[2] / s[3]) if s[3] else float("nan"),
        }

    # -- admission ------------------------------------------------------

    def submit(self, client_id: int, tokens,
               max_new_tokens: int = 0) -> ServeRequest:
        """Admit one request (non-blocking). Sheds on a full queue,
        refuses malformed input; both are counted."""
        tokens = np.asarray(tokens, np.int32)
        if tokens.ndim != 1 or not 0 < tokens.shape[0] <= self.seq_len:
            self.registry.counter("serve/refused").inc()
            raise ServeRefused(
                f"request tokens must be [1..{self.seq_len}] ints, got "
                f"shape {tokens.shape}")
        n_new = int(max_new_tokens)
        if n_new < 0:
            self.registry.counter("serve/refused").inc()
            raise ServeRefused(f"max_new_tokens must be >= 0, got {n_new}")
        if n_new and self.decoder is not None \
                and self.seq_len + n_new > self.decoder.max_len:
            # Past max_len the decoder's position table and cache end.
            self.registry.counter("serve/refused").inc()
            raise ServeRefused(
                f"max_new_tokens {n_new} exceeds the decoder budget "
                f"(seq_len {self.seq_len} + {n_new} > max_len "
                f"{self.decoder.max_len})")
        req = ServeRequest(client_id, tokens, n_new, self._clock())
        # Admission and shutdown race on _running: flag + enqueue under
        # the lock so no request slips in after close() starts draining.
        with self._lock:
            if not self._running and self._thread is not None:
                self.registry.counter("serve/refused").inc()
                raise ServeRefused("serve plane is shut down")
            try:
                self._q.put_nowait(req)
            except queue.Full:
                self.registry.counter("serve/shed").inc()
                raise ServeOverload(
                    f"request queue full ({self._q.maxsize}): shedding — "
                    "scale replicas or raise queue_cap") from None
        self.registry.counter("serve/admitted").inc()
        return req

    def request(self, client_id: int, tokens, max_new_tokens: int = 0,
                timeout: float = 30.0):
        """Blocking convenience: submit + wait for the batch."""
        return self.submit(client_id, tokens,
                           max_new_tokens).result(timeout)

    # -- micro-batcher ---------------------------------------------------

    def start(self) -> "ServeManager":
        if self._thread is None:
            self._running = True
            self._thread = threading.Thread(target=self._serve_loop,
                                            daemon=True,
                                            name="serve-batcher")
            self._thread.start()
        return self

    def close(self) -> None:
        with self._lock:
            self._running = False
        if self._thread is not None:
            self._q.put(_STOP)
            self._thread.join(timeout=30.0)
        # Drain stragglers (admitted concurrently with shutdown, or queued
        # behind _STOP): complete them with a refusal so no waiter blocks.
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if req is _STOP:
                continue
            self.registry.counter("serve/refused").inc()
            req._error = ServeRefused("serve plane shut down")
            req._done.set()

    def __enter__(self) -> "ServeManager":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def _serve_loop(self) -> None:
        while True:
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                if not self._running:
                    return
                continue
            if first is _STOP:
                return
            batch = [first]
            stop = False
            deadline = self._clock() + self.deadline_s
            while len(batch) < self.max_batch:
                remaining = deadline - self._clock()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=max(remaining, 1e-4))
                except queue.Empty:
                    break
                if nxt is _STOP:
                    stop = True
                    break
                batch.append(nxt)
            self.serve_batch(batch)
            if stop:
                return

    # -- batch execution -------------------------------------------------

    def serve_batch(self, batch) -> None:
        """Serve one micro-batch end to end (also the synchronous test
        entry). Never raises: a failure completes every request with the
        error, which its ``result()`` raises."""
        try:
            self._serve_batch(batch)
        except Exception as err:  # noqa: BLE001 - fanned out to waiters
            for req in batch:
                req._error = ServeRefused(f"batch failed: {err!r}")
                req._done.set()

    def _serve_batch(self, batch) -> None:
        tracer = obs_trace.active()
        n = len(batch)
        with self._lock:
            live = self._live
            live_vec = self._live_vec
            shadow = self._shadow
        tokens = np.zeros((self.max_batch, self.seq_len), np.int32)
        # Pad rows get length 1 (a lone token 0): keeps the decoder's
        # per-row lens-1 indexing in range while the mirror mask still
        # counts them as zero next-token targets. Real rows overwrite.
        lens = np.ones(self.max_batch, np.int32)
        for i, req in enumerate(batch):
            lens[i] = req.tokens.shape[0]
            tokens[i, :lens[i]] = req.tokens
        with tracer.span("serve.gather", cat="serve", batch=n):
            vecs = np.zeros((self.max_batch, self.fwd.dim), np.float32)
            if self.store is not None:
                ids = np.asarray([r.client_id for r in batch], np.int64)
                vecs[:n] = self.store.gather(ids, live)
            else:
                vecs[:n] = live_vec[None]
            stacked = self.fwd.stacked_tree(vecs)
        with tracer.span("serve.prefill", cat="serve", batch=n):
            logits = self.fwd.batched(stacked, tokens).cpu().numpy()
        generated = None
        n_new = max((r.max_new_tokens for r in batch), default=0)
        if n_new and self.decoder is not None:
            with tracer.span("serve.decode", cat="serve", batch=n,
                             new_tokens=n_new):
                generated = self.decoder.generate(
                    stacked, tokens, n_new, lens=lens).cpu().numpy()
        if shadow is not None:
            with tracer.span("serve.shadow", cat="serve", batch=n,
                             candidate=shadow[0]):
                self._mirror(tokens, lens, live_vec, shadow[2])
        now = self._clock()
        fill = self.registry.histogram("serve/batch_fill", lo=1.0)
        lat = self.registry.histogram("serve/latency_ms")
        fill.record(n)
        for i, req in enumerate(batch):
            req._logits = logits[i, :lens[i]]
            if generated is not None and req.max_new_tokens:
                req._generated = generated[i, :req.max_new_tokens]
            req._done.set()
            lat.record(max((now - req.t_submit) * 1e3, 1e-6))
            self.registry.counter("serve/served").inc()

    def _ce_fn(self, stacked, tokens, mask):
        """Summed next-token CE + token count over a mirrored batch."""
        with torch.inference_mode():
            logits = self.fwd.batched(stacked, tokens)
            lp = torch.log_softmax(logits[:, :-1], dim=-1)
            tgt = tokens[:, 1:]
            nll = -torch.gather(lp, -1, tgt[..., None])[..., 0]
            m = mask[:, 1:].to(torch.float32)
            return torch.sum(nll * m), torch.sum(m)

    def _mirror(self, tokens, lens, live_vec, cand_vec) -> None:
        """Run the batch's tokens through BOTH globals and accumulate
        next-token CE (the shadow gate's signal), on the padded
        ``[max_batch, seq_len]`` tokens with a length mask."""
        b = tokens.shape[0]
        dev = self.fwd.device
        mask = np.arange(self.seq_len)[None, :] < lens[:, None]
        toks = torch.as_tensor(tokens.astype(np.int64), device=dev)
        m = torch.as_tensor(mask, device=dev)
        sums = np.zeros(4, np.float64)
        live_tree = self.fwd.stacked_tree(np.tile(live_vec, (b, 1)))
        ce, cnt = self._ce_fn(live_tree, toks, m)
        sums[0], sums[1] = float(ce), float(cnt)
        cand_tree = self.fwd.stacked_tree(np.tile(cand_vec, (b, 1)))
        ce, cnt = self._ce_fn(cand_tree, toks, m)
        sums[2], sums[3] = float(ce), float(cnt)
        with self._lock:
            self._shadow_sums += sums

    # -- health ----------------------------------------------------------

    def stats(self) -> dict:
        """Counter/latency snapshot (flat scalars)."""
        snap = self.registry.snapshot()
        return {k: v for k, v in snap.items() if k.startswith("serve/")}


class ServeSocketServer:
    """Line-delimited-JSON TCP front end over a :class:`ServeManager`: one
    ``{"client": id, "tokens": [...], "max_new_tokens": n}`` request per
    line, one ``{"next_token": ..., "generated": [...]}`` reply per line.
    Single accept thread, one connection at a time."""

    def __init__(self, manager: ServeManager, port: int = 0,
                 host: str = "127.0.0.1"):
        import socket

        self.manager = manager
        self._sock = socket.create_server((host, int(port)))
        self._sock.settimeout(0.1)
        self.port = self._sock.getsockname()[1]
        self._running = False
        self._thread = None

    def start(self) -> "ServeSocketServer":
        if self._thread is None:
            self._running = True
            self._thread = threading.Thread(target=self._accept_loop,
                                            daemon=True,
                                            name="serve-socket")
            self._thread.start()
        return self

    def close(self) -> None:
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        self._sock.close()

    def __enter__(self) -> "ServeSocketServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def _accept_loop(self) -> None:
        import socket

        while self._running:
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            with conn:
                self._handle_conn(conn)

    def _handle_conn(self, conn) -> None:
        import json

        buf = b""
        conn.settimeout(5.0)
        while self._running:
            try:
                chunk = conn.recv(65536)
            except OSError:
                return
            if not chunk:
                return
            buf += chunk
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                if not line.strip():
                    continue
                try:
                    msg = json.loads(line)
                    logits, gen = self.manager.request(
                        int(msg["client"]), msg["tokens"],
                        int(msg.get("max_new_tokens", 0)))
                    reply = {
                        "next_token": int(np.argmax(logits[-1])),
                        "generated": ([] if gen is None
                                      else [int(t) for t in gen]),
                    }
                except (ServeOverload, ServeRefused, KeyError,
                        ValueError) as err:
                    reply = {"error": f"{type(err).__name__}: {err}"}
                conn.sendall((json.dumps(reply) + "\n").encode())
