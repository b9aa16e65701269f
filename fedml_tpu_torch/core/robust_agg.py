"""Byzantine-robust server aggregation (port of
``fedml_tpu/core/robust_agg.py``, which documents the defenses and their
sources).

An aggregator is a pure callable ``agg(stacked, weights) -> tree`` over a
client-stacked parameter tree (every leaf ``[C, ...]``) and the ``[C]``
aggregation weights after the round's masks. ``name``, ``is_mean`` and
``group_composable`` ride on the callable; the round keeps its weighted
mean for an ``is_mean`` aggregator. ``mean`` and ``geometric_median`` use
the weight values; the order statistics (``coord_median``,
``trimmed_mean``, ``krum``) use ``weight > 0`` as a participation gate,
so an excluded client does not enter them at all. The round keeps the
previous model when every weight is zero.

Every index these aggregators compute (the median's middle positions,
the trim count, Krum's neighbour and selection counts) stays a device
tensor, used on the device: no host sync, so the aggregator can run
inside a captured CUDA graph (``core/graph.py``).
"""

from __future__ import annotations

import torch

from fedml_tpu_torch.core.tree import tree_leaves, tree_map, tree_weighted_mean


def _mark(fn, name: str, is_mean: bool = False,
          group_composable: bool = False):
    fn.name = name
    fn.is_mean = is_mean
    # Whether the aggregator may run in two stages, within client groups
    # then across the group partials (the JAX package's group_reduce,
    # which the port does not have yet): mean and the coordinate-wise
    # order statistics; not Krum or the geometric median.
    fn.group_composable = group_composable
    return fn


def _colshape(leaf):
    """A ``[C]`` vector's shape to broadcast against a ``[C, ...]`` leaf."""
    return (-1,) + (1,) * (leaf.dim() - 1)


def _masked_sort(p, valid):
    """The leaf in f32, sorted along the client dim, excluded clients at
    +inf (so they sort last)."""
    v = torch.where(valid.view(_colshape(p)), p.float(),
                    torch.full((), float("inf"), device=p.device))
    return torch.sort(v, dim=0).values


def mean():
    """The sample-count-weighted average: the round's fast path."""

    def agg(stacked, weights):
        return tree_weighted_mean(stacked, weights)

    return _mark(agg, "mean", is_mean=True, group_composable=True)


def coord_median():
    """The coordinate-wise median over the participating clients (Yin et
    al. ICML'18); an even count averages the two middle values."""

    def agg(stacked, weights):
        valid = weights > 0
        m = valid.sum()
        lo_i = torch.clamp(torch.div(m - 1, 2, rounding_mode="floor"),
                           min=0).view(1)
        hi_i = torch.clamp(torch.div(m, 2, rounding_mode="floor"),
                           min=0).view(1)

        def med(p):
            s = _masked_sort(p, valid)
            lo = s.index_select(0, lo_i)[0]
            hi = s.index_select(0, hi_i)[0]
            return ((lo + hi) * 0.5).to(p.dtype)

        return tree_map(med, stacked)

    return _mark(agg, "coord_median", group_composable=True)


def trimmed_mean(beta: float = 0.1):
    """The coordinate-wise ``beta``-trimmed mean: drop the
    ``floor(beta·m)`` smallest and largest of the m participating values,
    average the rest; at least one value always survives."""
    if not 0.0 <= beta < 0.5:
        raise ValueError(f"trimmed_mean beta must be in [0, 0.5), got {beta}")

    def agg(stacked, weights):
        valid = weights > 0
        c = weights.shape[0]
        m = valid.sum()
        k = torch.minimum(torch.floor(m.float() * beta).long(),
                          torch.clamp(torch.div(m - 1, 2,
                                                rounding_mode="floor"),
                                      min=0))
        pos = torch.arange(c, device=weights.device)
        keep = (pos >= k) & (pos < m - k)  # sorted positions kept
        denom = torch.clamp(m - 2 * k, min=1).float()

        def tm(p):
            s = torch.where(keep.view(_colshape(p)), _masked_sort(p, valid),
                            torch.zeros((), device=p.device))
            return (s.sum(0) / denom).to(p.dtype)

        return tree_map(tm, stacked)

    return _mark(agg, f"trimmed_mean{beta}", group_composable=True)


def _gram_f32(x):
    """``x @ xᵀ`` in full f32: with TF32 allowed a near-tie in Krum's
    scores could flip its selection, so TF32 is turned off around the
    product, whatever the caller set."""
    if not x.is_cuda:
        return x @ x.T
    flags = torch.backends.cuda.matmul
    allow = flags.allow_tf32
    flags.allow_tf32 = False
    try:
        return x @ x.T
    finally:
        flags.allow_tf32 = allow


def multi_krum(f: int = 1, m: int = 1):
    """Multi-Krum (Blanchard et al. NeurIPS'17): score each participating
    client by the summed squared distances to its ``n_valid - f - 2``
    nearest participating neighbours and average the ``m`` best with
    equal weights. Excluded clients are neither neighbours nor
    selectable."""
    if f < 0 or m < 1:
        raise ValueError(f"multi_krum needs f >= 0 and m >= 1, got ({f}, {m})")

    def agg(stacked, weights):
        valid = weights > 0
        c = weights.shape[0]
        dev = weights.device
        nv = valid.sum()
        x = torch.cat([t.reshape(t.shape[0], -1).float()
                       for t in tree_leaves(stacked)], dim=1)
        # The Gram form: O(C·D + C²), without a [C, C, D] difference
        # tensor; cancellation can leave tiny negatives, clamped.
        sq = (x * x).sum(1)
        d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * _gram_f32(x),
                         min=0.0)
        inf = torch.full((), float("inf"), device=dev)
        pair_ok = (valid[:, None] & valid[None, :]
                   & ~torch.eye(c, dtype=torch.bool, device=dev))
        s = torch.sort(torch.where(pair_ok, d2, inf), dim=1).values
        nn = torch.clamp(nv - f - 2, min=1, max=c - 1)
        take = torch.arange(c, device=dev)[None, :] < nn
        score = torch.where(take, s, torch.zeros((), device=dev)).sum(1)
        # Excluded clients sort strictly after every valid one, even a
        # valid client whose score is +inf (a lone survivor): valid
        # scores are clamped to a large finite value first.
        sort_key = torch.where(valid, torch.clamp(score, max=3e38), inf)
        mm = torch.clamp(torch.clamp(nv, min=1), max=m)
        order = torch.argsort(sort_key, stable=True)  # best first
        sel = (torch.arange(c, device=dev) < mm).float()
        sel_w = torch.zeros_like(score).scatter(0, order, sel)
        return tree_weighted_mean(stacked, sel_w)

    name = f"krum{f}" if m == 1 else f"multi_krum{f}-{m}"
    return _mark(agg, name)


def krum(f: int = 1):
    """Krum: Multi-Krum with m = 1."""
    return multi_krum(f, 1)


def geometric_median(iters: int = 8, eps: float = 1e-8):
    """The smoothed geometric median by ``iters`` fixed Weiszfeld
    iterations from the weighted mean (RFA, Pillutla et al. 2019),
    weighted by the weight values."""
    if iters < 1:
        raise ValueError(f"geometric_median needs iters >= 1, got {iters}")

    def agg(stacked, weights):
        w = torch.clamp(weights.float(), min=0.0)
        z = tree_weighted_mean(stacked, w)
        for _ in range(iters):
            d2 = sum(((p.float() - zz.float()[None]) ** 2)
                     .reshape(p.shape[0], -1).sum(1)
                     for p, zz in zip(tree_leaves(stacked), tree_leaves(z)))
            z = tree_weighted_mean(stacked, w / torch.sqrt(d2 + eps))
        return z

    return _mark(agg, f"geometric_median{iters}")


def make_aggregator(spec):
    """``cfg.aggregator`` → an aggregator. A callable is returned as it is
    (``name``/``is_mean`` defaulted); a string is one of ``mean``,
    ``coord_median``, ``trimmed_mean[<beta>]`` (0.1), ``krum[<f>]`` (1),
    ``multi_krum[<f>[-<m>]]`` (1, 2), ``geometric_median[<iters>]`` (8)."""
    if callable(spec):
        if not hasattr(spec, "is_mean"):
            _mark(spec, getattr(spec, "name", getattr(
                spec, "__name__", "custom")))
        return spec
    s = str(spec).strip()

    def _suffix(prefix):
        return s[len(prefix):]

    try:
        if s == "mean":
            return mean()
        if s == "coord_median":
            return coord_median()
        if s.startswith("trimmed_mean"):
            rest = _suffix("trimmed_mean")
            return trimmed_mean(float(rest) if rest else 0.1)
        if s.startswith("multi_krum"):
            rest = _suffix("multi_krum")
            if not rest:
                return multi_krum(1, 2)
            f, _, m = rest.partition("-")
            return multi_krum(int(f), int(m) if m else 2)
        if s.startswith("krum"):
            rest = _suffix("krum")
            return krum(int(rest) if rest else 1)
        if s.startswith("geometric_median"):
            rest = _suffix("geometric_median")
            return geometric_median(int(rest) if rest else 8)
    except ValueError as e:
        if "aggregator" in str(e) or "must be" in str(e) or "needs" in str(e):
            raise
        raise ValueError(
            f"cfg.aggregator={spec!r}: could not parse the parameter "
            f"suffix ({e})") from None
    raise ValueError(
        f"unknown aggregator {spec!r}; known: mean, coord_median, "
        "trimmed_mean<beta>, krum<f>, multi_krum<f>-<m>, "
        "geometric_median<iters>")
