"""Synthetic data (host-side numpy; port of ``fedml_tpu/data/
synthetic.py``, whose generators draw from ``np.random.RandomState`` and
import no JAX: copied so the port imports nothing of ``fedml_tpu``, each
equal to the JAX package's byte for byte at the same seed and arguments).

``synthetic_alpha_beta`` reproduces the reference's synthetic(α,β) LR task
(fedml_api/data_preprocessing/synthetic_1_1/ — the LEAF synthetic dataset of
Li et al., FedProx): per-client model W_k ~ N(u_k, 1), u_k ~ N(0, α); inputs
x ~ N(v_k, Σ) with v_k ~ N(B_k, 1), B_k ~ N(0, β); Σ diagonal, Σ_jj = j^-1.2.
``make_stackoverflow_shard`` and ``make_stackoverflow_nwp`` are the
StackOverflow-NWP law of the 342k-client store and the million-client
sharded tier."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def make_classification(n_samples: int, n_features: int = 16,
                        n_classes: int = 10, seed: int = 0,
                        noise: float = 0.1) -> Tuple[np.ndarray, np.ndarray]:
    """Features from a standard normal, labels the argmax of a random
    linear map plus noise (f32 features, int32 labels)."""
    rng = np.random.RandomState(seed)
    w = rng.randn(n_features, n_classes)
    x = rng.randn(n_samples, n_features).astype(np.float32)
    logits = x @ w + noise * rng.randn(n_samples, n_classes)
    y = np.argmax(logits, axis=1).astype(np.int32)
    return x, y


def make_image_classification(n_samples: int,
                              hwc: Tuple[int, int, int] = (28, 28, 1),
                              n_classes: int = 10, seed: int = 0
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """Class-conditional Gaussian images (NHWC, f32) and int32 labels."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, n_classes, size=n_samples).astype(np.int32)
    protos = rng.randn(n_classes, *hwc).astype(np.float32)
    x = protos[y] + 0.5 * rng.randn(n_samples, *hwc).astype(np.float32)
    return x, y


def make_segmentation(
    n_samples: int,
    hw: Tuple[int, int] = (32, 32),
    n_classes: int = 4,
    seed: int = 0,
    ignore_index: int = 255,
    ignore_frac: float = 0.05,
) -> Tuple[np.ndarray, np.ndarray]:
    """Synthetic segmentation pairs: images with class-colored blobs, labels
    the blob class map; a small fraction of void pixels (``ignore_index``)
    exercises the ignore path of the fedseg losses/metrics."""
    rng = np.random.RandomState(seed)
    h, w = hw
    x = np.zeros((n_samples, h, w, 3), np.float32)
    y = np.zeros((n_samples, h, w), np.int32)
    protos = rng.randn(n_classes, 3).astype(np.float32)
    for i in range(n_samples):
        # 2-4 random rectangles of random classes over a class-0 background
        for _ in range(rng.randint(2, 5)):
            c = rng.randint(1, n_classes)
            y0, x0 = rng.randint(0, h // 2), rng.randint(0, w // 2)
            y1, x1 = y0 + rng.randint(4, h // 2), x0 + rng.randint(4, w // 2)
            y[i, y0:y1, x0:x1] = c
        x[i] = protos[y[i]] + 0.3 * rng.randn(h, w, 3)
        void = rng.rand(h, w) < ignore_frac
        y[i][void] = ignore_index
    return x, y


def synthetic_alpha_beta(
    alpha: float = 1.0,
    beta: float = 1.0,
    n_clients: int = 30,
    n_features: int = 60,
    n_classes: int = 10,
    seed: int = 0,
    min_samples: int = 10,
    mean_samples: int = 50,
):
    """Returns ``(x, y, client_index_map)`` with power-law client sizes."""
    rng = np.random.RandomState(seed)
    sizes = (rng.lognormal(np.log(mean_samples), 1.0, n_clients)
             ).astype(int) + min_samples
    sigma = np.diag(np.arange(1, n_features + 1, dtype=np.float64) ** -1.2)
    xs, ys, idx_map, pos = [], [], {}, 0
    for k in range(n_clients):
        u_k = rng.normal(0, alpha)
        b_k = rng.normal(0, beta)
        w_k = rng.normal(u_k, 1.0, (n_features, n_classes))
        bias_k = rng.normal(u_k, 1.0, (n_classes,))
        v_k = rng.normal(b_k, 1.0, (n_features,))
        x_k = rng.multivariate_normal(v_k, sigma, sizes[k]).astype(np.float32)
        y_k = np.argmax(x_k @ w_k + bias_k, axis=1).astype(np.int32)
        xs.append(x_k)
        ys.append(y_k)
        idx_map[k] = np.arange(pos, pos + sizes[k])
        pos += sizes[k]
    return np.concatenate(xs), np.concatenate(ys), idx_map


def make_stackoverflow_shard(
    n_clients: int,
    seq_len: int = 20,
    vocab: int = 10004,
    seed: int = 0,
    law: str = "uniform",
    kgroup: int = 8,
    active_tokens: int = 64,
    peak: float = 0.9,
    dialect_seed: int = 0,
    group_offset: int = 0,
    count_scale: int = 1,
):
    """ONE shard's worth of the StackOverflow-NWP law — ``(x, y,
    counts)`` with pareto per-client sentence counts and next-token
    targets over [1, vocab). The single source of the count/token
    distribution: :func:`make_stackoverflow_nwp` builds the flat
    federation from it, and the million-client sharded tier feeds it
    per shard to ``ShardedFederatedStore.from_shard_builder`` — the 342k
    and 1M scale points can never drift apart in law.

    ``law`` picks the TOKEN law (the count law is shared, so the two
    laws emit identical per-client sizes at one ``seed``):

    - ``"uniform"`` (default): i.i.d. tokens over [1, vocab) — the
      throughput/scale shape, no learnable signal.
    - ``"dialect"``: the LEARNABLE personalization law the adapter
      finetune measures against (transformer-consumable next-word
      prediction). All clients share one ``active_tokens``-sized
      vocabulary subset, but client ``c`` follows dialect ``(c +
      group_offset) % kgroup``'s OWN successor permutation over it
      (with prob ``peak``; else a uniform jump within the subset) — the
      same token has ``kgroup`` plausible successors, so a GLOBAL model
      is capped near ``peak/kgroup`` plus whatever in-context dialect
      inference it learns, while a client-personalized model can reach
      ``peak``. Dialect tables draw from ``dialect_seed`` (independent
      of ``seed``), so a held-out split (different ``seed``) shares the
      dialects; ``group_offset`` keeps per-shard builders' dialect
      assignment keyed on GLOBAL client ids.

    ``count_scale`` multiplies the pareto per-client sentence counts
    (same SHAPE, more mass — the personalization drills need enough
    per-client transitions to cover a dialect table); 1 (default) leaves
    the count stream as the uniform law draws it."""
    rng = np.random.RandomState(seed)
    counts = 1 + (rng.pareto(1.5, n_clients) * 4).astype(np.int64).clip(0, 63)
    if count_scale != 1:
        counts = counts * int(count_scale)
    tot = int(counts.sum())
    if law == "uniform":
        x = rng.randint(1, vocab, (tot, seq_len)).astype(np.int32)
        y = np.roll(x, -1, axis=1)
        return x, y, counts
    if law != "dialect":
        raise ValueError(f"unknown token law {law!r}: expected "
                         "uniform | dialect")
    if not 1 <= active_tokens <= vocab - 1:
        raise ValueError(
            f"active_tokens={active_tokens} must fit in [1, vocab) "
            f"(vocab={vocab})")
    trng = np.random.RandomState((dialect_seed * 0x9E3779B1 + 0xD1A7)
                                 % (2 ** 31))
    subset = trng.choice(np.arange(1, vocab, dtype=np.int64),
                         size=active_tokens, replace=False)
    perms = np.stack([trng.permutation(active_tokens)
                      for _ in range(kgroup)])
    seq_group = np.repeat(
        (group_offset + np.arange(n_clients, dtype=np.int64)) % kgroup,
        counts)
    toks = np.empty((tot, seq_len + 1), np.int64)
    cur = rng.randint(0, active_tokens, tot)
    toks[:, 0] = cur
    for t in range(1, seq_len + 1):
        follow = rng.rand(tot) < peak
        jump = rng.randint(0, active_tokens, tot)
        cur = np.where(follow, perms[seq_group, cur], jump)
        toks[:, t] = cur
    seqs = subset[toks]
    x = seqs[:, :seq_len].astype(np.int32)
    y = seqs[:, 1:].astype(np.int32)
    return x, y, counts


def make_stackoverflow_nwp(
    n_clients: int,
    seq_len: int = 20,
    vocab: int = 10004,
    seed: int = 0,
    **law_kw,
):
    """StackOverflow-NWP-shaped synthetic federation at any client count
    (the real set enumerates 342,477 users — reference
    stackoverflow_nwp/data_loader.py): pareto per-client sentence counts,
    next-token targets, tokens drawn from [1, vocab) so pad_id=0 never
    collides. Returns ``(x, y, client_indices)`` for FederatedStore /
    build_federated_arrays. ``law_kw`` forwards the
    token-law knobs (``law="dialect"`` + friends) to
    :func:`make_stackoverflow_shard`."""
    x, y, counts = make_stackoverflow_shard(n_clients, seq_len, vocab, seed,
                                            **law_kw)
    edges = np.concatenate([[0], np.cumsum(counts)])
    parts = {c: np.arange(edges[c], edges[c + 1]) for c in range(n_clients)}
    return x, y, parts


def make_hetero_charlm(n_clients=256, seq_len=80, vocab=90, kgroup=16,
                       seqs_per_client=4, peak=0.98, seed=0):
    """Heterogeneity-boosted char-LM federation: ``kgroup`` DISJOINT
    order-1 Markov chains over the vocab (client c follows table
    c % kgroup), so sampled cohorts pull a shared model toward
    incompatible local optima — the drift regime FedProx's μ targets.

    Returns ``(x, y, parts)`` like the other builders here: [N, T]
    inputs, [N, T] shifted targets, per-client index dict (the JAX
    package's FedProx reference-scale federation).
    """
    rng = np.random.RandomState(seed)
    succ = rng.randint(1, vocab, size=(kgroup, vocab))
    n_seq = n_clients * seqs_per_client
    group = (np.arange(n_seq) // seqs_per_client) % kgroup
    seqs = np.empty((n_seq, seq_len + 1), np.int32)
    state = rng.randint(1, vocab, size=n_seq)
    for t in range(seq_len + 1):
        seqs[:, t] = state
        follow = rng.rand(n_seq) < peak
        state = np.where(follow, succ[group, state],
                         rng.randint(1, vocab, size=n_seq))
    parts = {c: np.arange(c * seqs_per_client, (c + 1) * seqs_per_client)
             for c in range(n_clients)}
    return seqs[:, :seq_len], seqs[:, 1:], parts


def make_femnist_shaped(n_clients=200, n_classes=62, alpha=0.6, per=22,
                        maxper=None, n_test=2000, seed=0):
    """FEMNIST-shaped synthetic federation: 28x28x1 class-conditional
    Gaussian images with separation ``alpha``, lognormal power-law
    client sizes (optionally capped at ``maxper`` to bound the cohort
    step bucket).

    Returns ``(x_train, y_train, parts, x_test, y_test)`` (the JAX
    package's FedOpt reference-scale federation).
    """
    rng = np.random.RandomState(seed)
    counts = np.maximum(4, rng.lognormal(np.log(per), 0.5,
                                         n_clients).astype(int))
    if maxper is not None:
        counts = np.minimum(counts, maxper)
    tot = int(counts.sum())
    y = rng.randint(0, n_classes, size=tot + n_test).astype(np.int32)
    protos = rng.randn(n_classes, 28, 28, 1).astype(np.float32)
    x = alpha * protos[y] + rng.randn(len(y), 28, 28, 1).astype(np.float32)
    edges = np.concatenate([[0], np.cumsum(counts)])
    parts = {c: np.arange(edges[c], edges[c + 1]) for c in range(n_clients)}
    return x[:tot], y[:tot], parts, x[tot:], y[tot:]
