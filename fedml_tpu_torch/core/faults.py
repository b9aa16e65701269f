"""Fault injection and failure detection (port of
``fedml_tpu/core/faults.py``).

- ``DropoutInjector`` — per-round Bernoulli client dropout (the
  Turbo-Aggregate dropout generalized: returns a weight mask);
- ``UpdateCorruptor`` — update corruption for the robustness drills;
- ``HeartbeatMonitor`` — wall-clock failure detector for the
  message-passing federation (``algos/fedavg_distributed.py``): ranks
  check in, anything silent past ``timeout_s`` is reported failed instead
  of hanging the federation;
- ``fault_injected_round`` — one round of an API with host-side dropout
  under injected churn.

:meth:`UpdateCorruptor.device_fn` is the form the rounds run: pure and
mask-driven over the client-stacked trained params, so the attack drill
rides every round tier, captured rounds included. The ``random`` mode
draws from ``core/keys.py``, not threefry.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from fedml_tpu_torch.core import keys
from fedml_tpu_torch.core.robustness import gaussian_tree
from fedml_tpu_torch.core.tree import tree_leaves, tree_map


def _first_nan(w):
    """``w [C, ...]`` with the first element of each client's entry set to
    NaN (a 0-d entry all NaN)."""
    shape = w.shape[1:]
    first = (torch.arange(math.prod(shape), device=w.device) == 0).view(shape)
    return torch.where(first, torch.full((), float("nan"), dtype=w.dtype,
                                         device=w.device), w)


class DropoutInjector:
    """Bernoulli(p) per-round client dropout; seeded and round-keyed so runs
    reproduce (reference TA dropout is a manual list; this simulates churn)."""

    def __init__(self, p: float, seed: int = 0):
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout p must be in [0, 1), got {p}")
        self.p = p
        self.seed = seed

    def round_mask(self, round_idx: int, n_clients: int) -> np.ndarray:
        """[n] float mask — 0.0 = dropped this round. Guarantees at least
        one survivor: an all-dropped round would be a silent no-op, so one
        client is revived — drawn UNIFORMLY from the same round-keyed RNG
        (still deterministic per (seed, round)). Always reviving client 0
        would be a systematic participation bias at high dropout rates —
        the same bias class FedAvgRobustAPI's eviction fix addressed
        (algos/robust.py): client 0 would train in every all-dropped
        round while its peers never do."""
        rng = np.random.RandomState((self.seed * 1_000_003 + round_idx) % (2**31))
        mask = (rng.rand(n_clients) >= self.p).astype(np.float32)
        if mask.sum() == 0:
            mask[rng.randint(n_clients)] = 1.0
        return mask


class UpdateCorruptor:
    """Faults injected into trained client updates: ``sign_flip`` (model
    replacement ``g - scale·(w - g)``), ``scale`` (``w·scale``), ``nan``
    (the first element of every leaf) and ``random`` (``scale`` x standard
    normals). The rounds run :meth:`device_fn`; the message-passing tiers
    corrupt one worker's update with :meth:`corrupt`, whose ``random``
    mode carries a key chain from ``seed``."""

    MODES = ("sign_flip", "scale", "nan", "random")

    def __init__(self, mode: str = "sign_flip", scale: float = 10.0,
                 seed: int = 0):
        if mode not in self.MODES:
            raise ValueError(f"unknown corruption mode {mode!r}; known "
                             f"{self.MODES}")
        self.mode = mode
        self.scale = scale
        self.seed = seed
        self._draws = 0  # the random mode's position in its key chain

    def corrupt(self, net, global_net=None):
        """One trained update (a ``NetState`` or a param dict of tensors)
        corrupted, params leaf-wise: ``sign_flip`` against ``global_net``
        (or ``-w`` without one)."""
        params = getattr(net, "params", net)
        if self.mode == "sign_flip" and global_net is None:
            new = tree_map(lambda w: -w, params)
        elif self.mode == "sign_flip":
            gp = getattr(global_net, "params", global_net)
            new = tree_map(lambda w, g: g - self.scale * (w - g), params, gp)
        else:  # scale, nan, random: the device form on a stack of one
            rng = keys.fold_in(keys.key(self.seed,
                                        tree_leaves(params)[0].device),
                               self._draws)
            if self.mode == "random":
                self._draws += 1
            new = tree_map(lambda t: t[0], self._corrupted(
                tree_map(lambda t: t[None], params), None, rng[None]))
        if hasattr(net, "params"):
            return type(net)(new, net.model_state)
        return new

    def _corrupted(self, params, global_params, keys_):
        """Every client of the stack corrupted (``[C, ...]`` leaves,
        ``global_params`` broadcast, ``keys_ [C]``)."""
        mode, scale = self.mode, self.scale
        if mode == "sign_flip":
            return tree_map(lambda w, g: g - scale * (w - g), params,
                            global_params)
        if mode == "scale":
            return tree_map(lambda w: w * scale, params)
        if mode == "nan":
            return tree_map(_first_nan, params)
        return gaussian_tree(params, keys_, scale, batch_dims=1)

    def device_fn(self):
        """``(global_net, client_nets, adv, rngs) -> client_nets`` over the
        client-stacked trained models (``[C, ...]`` params): the slots
        where ``adv [C] > 0`` are corrupted, the others kept, selected with
        ``torch.where``; ``rngs [C]`` are the per-client streams of the
        ``random`` mode. No host state is read or changed."""

        def apply(global_net, client_nets, adv, rngs):
            gp = getattr(global_net, "params", global_net)
            cp = getattr(client_nets, "params", client_nets)
            bad = self._corrupted(cp, tree_map(lambda g: g[None], gp), rngs)
            new = tree_map(
                lambda c, b: torch.where((adv > 0).view(
                    (-1,) + (1,) * (c.dim() - 1)), b, c), cp, bad)
            if hasattr(client_nets, "params"):
                return type(client_nets)(new, client_nets.model_state)
            return new

        return apply


class HeartbeatMonitor:
    """Failure detector for the host-side federation: ranks ``beat()``;
    ``failed()`` lists ranks silent for > timeout_s. The reference has no
    equivalent — a dead client hangs its server forever
    (FedAVGAggregator.check_whether_all_receive waits unconditionally).

    Thread-safe: the distributed server manager beats from its receive
    thread while its watchdog thread polls ``failed()`` /
    ``wait_all_or_failed`` (``algos/fedavg_distributed.py``)."""

    def __init__(self, ranks: Sequence[int], timeout_s: float = 30.0,
                 clock=time.monotonic):
        self.timeout_s = timeout_s
        self._clock = clock
        self._lock = threading.Lock()
        now = clock()
        self._last: Dict[int, float] = {r: now for r in ranks}

    def beat(self, rank: int):
        """Unknown ranks are registered on first beat."""
        with self._lock:
            self._last[rank] = self._clock()

    def forget(self, rank: int):
        """Drop a rank from monitoring (evicted from membership); a later
        ``beat`` re-registers it."""
        with self._lock:
            self._last.pop(rank, None)

    def failed(self) -> List[int]:
        now = self._clock()
        with self._lock:
            return sorted(
                r for r, t in self._last.items() if now - t > self.timeout_s
            )

    def alive(self) -> List[int]:
        with self._lock:
            known = set(self._last)
        return sorted(known - set(self.failed()))

    def wait_all_or_failed(self, expected: Sequence[int], have,
                           poll_s: float = 0.05,
                           deadline_s: Optional[float] = None) -> List[int]:
        """Block until ``have()`` covers ``expected`` minus failed ranks;
        returns the failed set. Replaces the reference's unconditional
        check_whether_all_receive spin. Ranks in ``expected`` the monitor
        has never seen count as failed once the timeout elapses (they are
        registered at entry). ``deadline_s`` (default 2x timeout) bounds the
        total wait: anything still missing then is declared failed."""
        expected = set(expected)
        start = self._clock()
        with self._lock:
            for r in expected - set(self._last):
                self._last[r] = start  # start their timeout clocks now
        deadline = deadline_s if deadline_s is not None else 2 * self.timeout_s
        while True:
            failed = set(self.failed())
            present = set(have())
            if present >= (expected - failed):
                return sorted(failed & expected)
            if self._clock() - start > deadline:
                # Deadline: report heartbeat-failed ranks PLUS whatever is
                # still missing (even if its heartbeat looks alive, its
                # result never arrived — the caller must not keep waiting).
                return sorted((failed | (expected - present)) & expected)
            time.sleep(poll_s)


def fault_injected_round(api, round_idx: int,
                         dropout: Optional[DropoutInjector] = None):
    """Harness: run one round of an API that supports host-side dropout
    (TurboAggregate's ``set_dropout``, reference TA_client.py:25) with
    injected per-round client churn. Update corruption is a BUILD-time
    concern — install ``UpdateCorruptor.corrupt`` through the algorithm's
    ``client_transform`` hook (see FedAvgRobustAPI for the pattern) and pair
    it with ``nan_guard`` / robust clipping to test the defenses."""
    if dropout is not None and hasattr(api, "set_dropout"):
        n = api.cfg.client_num_per_round
        mask = dropout.round_mask(round_idx, n)
        api.set_dropout(np.where(mask == 0.0)[0])
    return api.train_one_round(round_idx)
