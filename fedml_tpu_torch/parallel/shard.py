"""Client-parallel FedAvg rounds on one card (port of
``fedml_tpu/parallel/shard.py``'s ``make_vmap_round``,
``make_fused_round_step``, ``make_stateful_client_round`` and
``make_fused_stateful_round_step``).

All sampled clients train together: each local step runs under
``torch.func.vmap`` over the client dim (``LocalTrain.run_clients``), and
the server's sample-weighted average is one f32 reduction per leaf, or a
robust aggregator (``core/robust_agg``) over the client-stacked params.
Client transforms (robust clipping) and the device-side attack drill
(``core/faults.UpdateCorruptor.device_fn``) run on the trained stack
before it is aggregated. The mesh-sharded round is not ported yet
(ROADMAP.md A11).
"""

from __future__ import annotations

import torch
from torch.func import vmap

from fedml_tpu_torch.core import keys
from fedml_tpu_torch.core.tree import (gather_stacked, scatter_stacked,
                                       tree_leaves, tree_map,
                                       tree_weighted_mean)
from fedml_tpu_torch.trainer.local import NetState


def client_rngs(rng, n_local: int, offset: int = 0):
    """Per-client keys by GLOBAL client slot: ``fold_in(rng, offset + i)``."""
    slots = offset + torch.arange(n_local, dtype=torch.int64,
                                  device=rng.device)
    return keys.fold_in(rng, slots)


def client_finite_mask(client_nets):
    """``[C]`` float: 1.0 where every leaf of that client's model (a tree,
    or a ``NetState``: params and trained state) is finite."""
    flags = [torch.isfinite(leaf.reshape(leaf.shape[0], -1)).all(dim=1)
             for leaf in _net_leaves(client_nets)]
    return torch.stack(flags).all(dim=0).float()


def _net_leaves(net):
    if isinstance(net, NetState):
        return tree_leaves(net.params) + tree_leaves(net.model_state)
    return tree_leaves(net)


def _net_map(fn, *nets):
    """``fn`` over the leaves of ``NetState``s of one structure."""
    return NetState(tree_map(fn, *(n.params for n in nets)),
                    tree_map(fn, *(n.model_state for n in nets)))


#: fold_in children of a client's key for the corruptor's and the client
#: transform's streams, disjoint from each other and from the streams its
#: training consumed (as in the JAX package).
_CORRUPT_TAG = 0xC0
_TRANSFORM_TAG = 0x7F


def run_clients_guarded(local_train, client_transform, nan_guard, net, x, y,
                        mask, rngs, corruptor=None, adv=None):
    """Local training of the cohort, then the attack drill, the client
    transform and the NaN guard, in that order (the server's defenses see
    the corrupted updates): returns ``(client_nets, losses [C], finite
    [C])``, with a diverged client's net (params and trained state) and
    loss zeroed (``torch.where``: NaN·0 is still NaN) and ``finite`` 0
    for it (all ones when the guard is off).

    ``corruptor(global_net, client_nets, adv, rngs) -> client_nets``
    corrupts the params of the slots where ``adv [C] > 0``, with
    per-client streams ``fold_in(rng, 0xC0)``. ``client_transform(
    global_net, client_net) -> client_net`` maps one client's trained net
    (params and state); it runs under ``vmap`` over the cohort. A
    transform marked ``wants_rng = True`` (stochastic quantization) is
    called ``(global_net, client_net, rng)`` with the client's stream
    ``fold_in(rng, 0x7F)``."""
    client_nets, losses = local_train.run_clients(net, x, y, mask, rngs)
    if corruptor is not None:
        client_nets = corruptor(net, client_nets, adv,
                                keys.fold_in(rngs, _CORRUPT_TAG))
    if client_transform is not None:
        if getattr(client_transform, "wants_rng", False):
            def one(params, state, rng):
                out = client_transform(net, NetState(params, state), rng)
                return out.params, out.model_state

            client_nets = NetState(*vmap(one)(
                client_nets.params, client_nets.model_state,
                keys.fold_in(rngs, _TRANSFORM_TAG)))
        else:
            def one(params, state):
                out = client_transform(net, NetState(params, state))
                return out.params, out.model_state

            client_nets = NetState(*vmap(one)(client_nets.params,
                                              client_nets.model_state))
    if not nan_guard:
        return client_nets, losses, torch.ones_like(losses)
    finite = client_finite_mask(client_nets)
    ok = finite.bool()
    client_nets = _net_map(
        lambda p: torch.where(ok.reshape((-1,) + (1,) * (p.dim() - 1)), p,
                              torch.zeros((), dtype=p.dtype,
                                          device=p.device)),
        client_nets)
    losses = torch.where(torch.isfinite(losses), losses,
                         torch.zeros_like(losses))
    return client_nets, losses, finite


def _robust_avg(aggregator, client_nets, weights, net):
    """A non-mean aggregator's result over the whole client net (params
    and trained state, as JAX aggregates the ``NetState``), or the previous
    global model when no client carries weight (order statistics over no
    participant would leak their ±inf exclusion sentinels into the
    model)."""
    joint = aggregator({**client_nets.params, **client_nets.model_state},
                       weights)
    avg = NetState({k: joint[k] for k in client_nets.params},
                   {k: joint[k] for k in client_nets.model_state})
    any_ok = (weights > 0).any()
    return _net_map(lambda a, p: torch.where(any_ok, a, p), avg, net)


def _in_layout_of(t, ref):
    """``t`` with ``ref``'s strides. A round returns the params in the
    layout they came in, as a captured round's static buffers keep them:
    a 1x1 conv weight's update comes back with channels-last strides on
    its size-1 dims, and cuDNN picks other convolution algorithms for such
    a weight, so a host loop of rounds would sum in another order than
    the captured rounds from its second round on."""
    if t.stride() == ref.stride():
        return t
    return torch.empty_like(ref).copy_(t)


def make_vmap_round(local_train, client_transform=None,
                    nan_guard: bool = False, aggregator=None,
                    corruptor=None, with_client_losses: bool = False):
    """``round_fn(net, x, y, mask, weights, loss_weights, rng) ->
    (avg_net, mean_loss)`` over client-stacked ``[C, S, B, ...]`` inputs.

    ``weights [C]`` weight the model average, ``loss_weights [C]`` the
    reported loss; padded slots carry 0 in both. The average is over the
    whole client net, params and trained state (BatchNorm's running
    stats), as JAX averages the ``NetState``. ``nan_guard`` zero-weights
    a client whose trained model is not finite, and keeps the previous
    model when every client is excluded.

    ``aggregator`` (``core/robust_agg``): ``None`` or an ``is_mean`` one
    keeps the weighted mean; any other receives the client-stacked net
    (params and state) and the weights after the finite mask.
    ``corruptor`` arms the attack drill: the round then takes a trailing
    ``adv [C]`` operand, the adversary mask. ``with_client_losses`` adds a
    third output, the clients' in-round training losses ``[C]`` (oort's
    utility observable)."""
    if aggregator is not None and getattr(aggregator, "is_mean", False):
        aggregator = None

    def round_core(net, x, y, mask, weights, loss_weights, rng, adv):
        rngs = client_rngs(rng, x.shape[0], 0)
        client_nets, losses, finite = run_clients_guarded(
            local_train, client_transform, nan_guard, net, x, y, mask, rngs,
            corruptor, adv)
        weights = weights * finite
        loss_weights = loss_weights * finite
        if aggregator is None:
            avg = NetState(tree_weighted_mean(client_nets.params, weights),
                           tree_weighted_mean(client_nets.model_state,
                                              weights))
            if nan_guard:
                # Every sampled client diverged: keep the previous global
                # model (a zero-total weighted mean would silently zero the
                # params and the running stats).
                any_ok = weights.sum() > 0
                avg = _net_map(lambda a, p: torch.where(any_ok, a, p), avg,
                               net)
        else:
            avg = _robust_avg(aggregator, client_nets, weights, net)
        avg = _net_map(_in_layout_of, avg, net)
        lw = loss_weights / torch.clamp(loss_weights.sum(), min=1e-12)
        mean_loss = (losses * lw).sum()
        if with_client_losses:
            return avg, mean_loss, losses
        return avg, mean_loss

    if corruptor is not None:
        return round_core

    def round_fn(net, x, y, mask, weights, loss_weights, rng):
        return round_core(net, x, y, mask, weights, loss_weights, rng, None)

    return round_fn


def make_fused_round_step(round_fn, server_update=None):
    """One round as one step: client training and the weighted average
    (``round_fn``), then the algorithm's PURE server update. Its signature
    is the JAX package's: ``step(net, extra, x, y, mask, weights, key,
    *aux) -> ((net', extra'), loss)``, ``weights`` weighting both the
    average and the loss and ``key`` the round's key (a randomized server
    update folds in from it). ``server_update(net, avg, extra, key) ->
    (net', extra')``; ``None`` is plain FedAvg (the new model is the
    average, ``extra`` passes through). The caller captures the step with
    its ``(net, extra)`` carry donated (``core/graph.py``)."""

    def step_fn(net, extra, x, y, mask, weights, key, *aux):
        avg, loss = round_fn(net, x, y, mask, weights, weights, key, *aux)
        if server_update is None:
            return (avg, extra), loss
        return server_update(net, avg, extra, key), loss

    return step_fn


def make_stateful_client_round(body):
    """The round of an algorithm that carries server and client-stacked
    state through it (SCAFFOLD's controls, FedDyn's corrections):
    ``round_fn(net, s_global, s_clients, x, y, mask, weights, rng) ->
    (net', s_global', s_clients', loss)`` over the cohort's gathered
    ``s_clients [C, ...]``, with ``body(net, s_global, s_clients, x, y,
    mask, weights, rngs)`` given the per-client keys of the shared round.
    The mesh form (JAX's ``shard_map`` with psum'd reductions) is not
    ported yet (ROADMAP.md A11)."""

    def round_fn(net, s_global, s_clients, x, y, mask, weights, rng):
        rngs = client_rngs(rng, x.shape[0], 0)
        return body(net, s_global, s_clients, x, y, mask, weights, rngs)

    return round_fn


def make_fused_stateful_round_step(round_fn):
    """One round of a :func:`make_stateful_client_round` round as one
    step: the cohort's state gathered from the client stack, the round,
    and the trained slots scattered back (``core/tree.scatter_stacked``,
    in place). ``step(net, (s_global, s_clients), x, y, mask, weights,
    key, idx, umask) -> ((net', (s_global', s_clients')), loss)``:
    ``s_clients`` the whole ``client_stack``, ``idx [k]`` the cohort and
    ``umask [k]`` 1 where the client trained (an empty or padded slot
    keeps its row). The caller captures it with the carry donated."""

    def step_fn(net, extra, x, y, mask, weights, key, idx, umask):
        s_global, s_clients = extra
        sub = gather_stacked(s_clients, idx)
        new_net, new_global, new_sub, loss = round_fn(
            net, s_global, sub, x, y, mask, weights, key)
        s_clients = scatter_stacked(s_clients, idx, new_sub, umask)
        return (new_net, (new_global, s_clients)), loss

    return step_fn
