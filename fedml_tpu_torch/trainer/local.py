"""Local (on-client) training (port of ``fedml_tpu/trainer/local.py``).

One ``local_train`` call runs ``epochs × steps`` masked SGD steps over a
client's ``[S, B, ...]`` block. Updates are functional (parameter dicts in,
parameter dicts out) so that they compose with ``torch.func``:
``grad_and_value`` over ``functional_call`` for the gradient, and
``vmap`` over the client dim so that one step of the whole cohort is one
launch of each kernel per layer. The optimizers are functional updates on
tensors in optax's formulation, not ``torch.optim``.

As in the reference, the client optimizer is re-created every round
(``optimizer.init`` inside ``local_train``), an all-masked step leaves
params and optimizer state exactly as they were (``torch.where``, never a
Python branch on a tensor), and the reported loss is the sample-weighted
epoch loss averaged over epochs.

Random streams come from ``core.keys`` (a counter hash of (key, index)):
not the JAX threefry bits, but the same structure, so slot ``i``'s shuffle
key depends only on ``(epoch key, i)``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch
import torch.nn.functional as F
from torch.func import functional_call, grad_and_value, vmap

from fedml_tpu_torch.core import keys
from fedml_tpu_torch.core.tree import tree_leaves, tree_map, tree_select


@dataclasses.dataclass
class NetState:
    """Model parameters (``{name: tensor}``) + non-trainable buffers."""

    params: Any
    model_state: Any  # {} when the model has no buffers


class ModelFns(NamedTuple):
    init: Callable  # () -> NetState of the module's own parameters
    apply: Callable  # (net, x, train, rng) -> (logits, model_state)


def model_fns(module) -> ModelFns:
    """Functional interface of an ``nn.Module``: ``apply`` runs it through
    ``functional_call`` on the given parameters."""

    def init(*_) -> NetState:
        return NetState(
            params={k: v.detach().clone()
                    for k, v in module.named_parameters()},
            model_state={k: v.detach().clone()
                         for k, v in module.named_buffers()})

    def apply(net: NetState, x, train=False, rng=None):
        logits = functional_call(module, {**net.params, **net.model_state},
                                 (x,))
        return logits, net.model_state

    return ModelFns(init=init, apply=apply)


class Optimizer(NamedTuple):
    init: Callable  # params -> state
    update: Callable  # (grads, state, params) -> (updates, state)


def _chain(*opts) -> Optimizer:
    def init(params):
        return {str(i): o.init(params) for i, o in enumerate(opts)}

    def update(grads, state, params):
        new = {}
        for i, o in enumerate(opts):
            grads, new[str(i)] = o.update(grads, state[str(i)], params)
        return grads, new

    return Optimizer(init, update)


def _scale(s) -> Optimizer:
    return Optimizer(lambda p: {},
                     lambda g, st, p: (tree_map(lambda t: t * s, g), st))


def _trace(decay) -> Optimizer:
    def update(g, st, p):
        tr = tree_map(lambda t, a: t + decay * a, g, st["trace"])
        return tr, {"trace": tr}

    return Optimizer(lambda p: {"trace": tree_map(torch.zeros_like, p)},
                     update)


def _add_decayed_weights(wd) -> Optimizer:
    return Optimizer(lambda p: {},
                     lambda g, st, p: (tree_map(lambda t, w: t + wd * w, g, p),
                                       st))


def _scale_by_amsgrad(b1=0.9, b2=0.999, eps=1e-8) -> Optimizer:
    """optax's ``scale_by_amsgrad``: the max is taken over the
    BIAS-CORRECTED second moment (torch's ``Adam(amsgrad=True)`` takes it
    over the raw one)."""

    def init(p):
        z = tree_map(torch.zeros_like, p)
        count = torch.zeros((), dtype=torch.int32,
                            device=tree_leaves(p)[0].device)
        return {"count": count, "mu": z, "nu": z, "nu_max": z}

    def update(g, st, p):
        mu = tree_map(lambda t, m: (1 - b1) * t + b1 * m, g, st["mu"])
        nu = tree_map(lambda t, v: (1 - b2) * (t * t) + b2 * v, g, st["nu"])
        count = st["count"] + 1
        c1 = 1 - torch.pow(b1, count.float())
        c2 = 1 - torch.pow(b2, count.float())
        nu_max = tree_map(lambda m, v: torch.maximum(m, v / c2),
                          st["nu_max"], nu)
        upd = tree_map(lambda m, v: (m / c1) / (torch.sqrt(v) + eps),
                       mu, nu_max)
        return upd, {"count": count, "mu": mu, "nu": nu, "nu_max": nu_max}

    return Optimizer(init, update)


def _clip_by_global_norm(max_norm) -> Optimizer:
    def update(g, st, p):
        norm = torch.sqrt(sum((t * t).sum() for t in tree_leaves(g)))
        keep = norm < max_norm
        return tree_map(lambda t: torch.where(keep, t, (t / norm) * max_norm),
                        g), st

    return Optimizer(lambda p: {}, update)


def make_client_optimizer(name: str, lr: float, wd: float = 0.0,
                          grad_clip: float = 0.0) -> Optimizer:
    """``sgd``, ``momentum`` (0.9) or ``adam`` — coupled L2 (decay added to
    the gradient before the preconditioner) + amsgrad, optax's chain
    ``add_decayed_weights(wd) → scale_by_amsgrad() → scale(-lr)``.
    ``grad_clip`` > 0 prepends global-norm clipping."""
    if name == "sgd":
        opt = _scale(-lr)
    elif name == "momentum":
        opt = _chain(_trace(0.9), _scale(-lr))
    elif name == "adam":
        opt = _chain(_add_decayed_weights(wd), _scale_by_amsgrad(),
                     _scale(-lr))
    else:
        raise ValueError(f"unknown client optimizer {name!r}")
    if grad_clip and grad_clip > 0:
        opt = _chain(_clip_by_global_norm(grad_clip), opt)
    return opt


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def softmax_ce(logits, labels):
    """Per-example softmax cross-entropy with integer labels."""
    return F.cross_entropy(logits.float(), labels.long(), reduction="none")


def seq_softmax_ce(logits, labels, pad_id: int = 0):
    """Per-example next-token CE for sequence models: ``logits [B, T, V]``,
    ``labels [B, T]``; the mean over the positions whose label is not
    ``pad_id`` (1 where a row is all padding)."""
    per_tok = F.cross_entropy(logits.flatten(0, -2).float(),
                              labels.flatten().long(),
                              reduction="none").view(labels.shape)
    tok_mask = (labels != pad_id).to(per_tok.dtype)
    denom = torch.clamp(tok_mask.sum(-1), min=1.0)
    return (per_tok * tok_mask).sum(-1) / denom


def epoch_perm(mask, epoch_key):
    """The per-epoch reshuffle of ``[..., S, B]`` packed slots
    (DataLoader(shuffle=True) semantics): REAL samples permuted among
    themselves, padding kept at the tail (keys of padded slots offset by
    2), so trailing steps stay all-masked no-ops. Slot ``i``'s key is
    ``uniform(fold_in(epoch_key, i))`` — independent of the slot count.
    Leading dims of ``mask`` batch over clients with ``epoch_key [...]``.
    Returns ``perm [..., S·B]``."""
    flat = mask.reshape(*mask.shape[:-2], -1)
    slots = torch.arange(flat.shape[-1], dtype=torch.int64,
                         device=mask.device)
    u = keys.uniform(keys.fold_in(epoch_key[..., None], slots))
    return torch.argsort(u + (1.0 - flat) * 2.0, dim=-1, stable=True)


class LocalTrain:
    """``local_train(net, x, y, mask, rng) -> (net', mean_loss)`` for one
    client (``x [S, B, ...]``, ``y``/``mask [S, B]``, ``rng`` a key), and
    :meth:`run_clients` for a whole cohort at once (every operand with a
    leading client dim), which runs each step under ``vmap``."""

    def __init__(self, apply_fn, optimizer: Optimizer, local_epochs: int,
                 loss_fn=softmax_ce, extra_grad_fn=None):
        self.apply_fn, self.optimizer = apply_fn, optimizer
        self.local_epochs, self.loss_fn = local_epochs, loss_fn
        self.extra_grad_fn = extra_grad_fn

    def _grad(self, params, model_state, xb, yb, mb):
        """The gradient and value of the batch's masked mean loss."""

        def masked_loss(p):
            logits, _ = self.apply_fn(NetState(p, model_state), xb,
                                      train=True)
            per = self.loss_fn(logits, yb)
            return (per * mb).sum() / torch.clamp(mb.sum(), min=1.0)

        return grad_and_value(masked_loss)(params)

    def step(self, params, opt_state, model_state, xb, yb, mb, anchor=None):
        """One masked step; an all-masked batch returns its inputs.
        ``extra_grad_fn(params, anchor)`` is added to the gradient before
        the optimizer update (``anchor``: the params the client started
        the round from)."""
        grads, loss = self._grad(params, model_state, xb, yb, mb)
        if self.extra_grad_fn is not None:
            grads = tree_map(torch.add, grads,
                             self.extra_grad_fn(params, anchor))
        updates, new_opt = self.optimizer.update(grads, opt_state, params)
        new_params = apply_updates(params, updates)
        nb = mb.sum()
        nonempty = nb > 0
        return (tree_select(nonempty, new_params, params),
                tree_select(nonempty, new_opt, opt_state), loss, nb)

    def _epochs(self, params, opt_state, model_state, x, y, mask, rng,
                batched: bool, anchor=None, anchor_dim=None):
        """The epoch/step loop shared by one client and the cohort;
        ``anchor`` (batched along ``anchor_dim``) goes to ``extra_grad_fn``
        at every step."""
        n_steps = mask.shape[-2]
        rng_pair = keys.split(rng)
        epoch_keys = keys.split(rng_pair[..., 1], self.local_epochs)
        step = self.step
        if batched:
            x_dim = x.dim() - 3  # client dim of a step's client-inner x
            step = vmap(self.step, in_dims=(
                0, 0, None, x_dim, 0, 0,
                None if anchor is None else anchor_dim))
        epoch_losses = []
        for e in range(self.local_epochs):
            perm = epoch_perm(mask, keys.fold_in(epoch_keys[..., e], 0))
            ex, ey, em = (_take(a, perm, batched) for a in (x, y, mask))
            if batched:
                # Client dim next to the channel dim: the vmapped convs then
                # see channels-last inputs and GroupNorm reads views.
                ex = ex.movedim(0, -2).contiguous()
                ey, em = ey.movedim(0, 1), em.movedim(0, 1)
            losses, ns = [], []
            for s in range(n_steps):
                params, opt_state, loss, nb = step(
                    params, opt_state, model_state, ex[s], ey[s], em[s],
                    anchor)
                losses.append(loss)
                ns.append(nb)
            losses, ns = torch.stack(losses), torch.stack(ns)
            epoch_losses.append((losses * ns).sum(0)
                                / torch.clamp(ns.sum(0), min=1.0))
        return params, torch.stack(epoch_losses).mean(0)

    def __call__(self, net: NetState, x, y, mask, rng):
        opt_state = self.optimizer.init(net.params)
        params, loss = self._epochs(net.params, opt_state, net.model_state,
                                    x, y, mask, rng, batched=False,
                                    anchor=self._anchor(net.params))
        return NetState(params, net.model_state), loss

    def _anchor(self, params):
        return params if self.extra_grad_fn is not None else None

    def run_clients(self, net: NetState, x, y, mask, rngs):
        """The cohort: ``x [C, S, B, ...]``, ``y``/``mask [C, S, B]``,
        ``rngs [C]`` from one global ``net`` → (client nets with ``[C, ...]``
        params, losses ``[C]``)."""
        c = x.shape[0]
        params = tree_map(lambda t: _per_client(t, c), net.params)
        return self._run_cohort(NetState(params, net.model_state), x, y,
                                mask, rngs, self._anchor(net.params), None)

    def run_stacked(self, nets: NetState, x, y, mask, rngs, anchor=None):
        """The cohort from per-client starting nets (``[C, ...]`` params,
        one shared ``model_state``), as :meth:`run_clients` takes it after
        broadcasting the global net; the optimizer state starts fresh.
        ``extra_grad_fn`` is anchored at each client's own start, or at
        ``anchor``, one param tree for the whole cohort (Ditto's global
        params)."""
        if anchor is None or self.extra_grad_fn is None:
            return self._run_cohort(nets, x, y, mask, rngs,
                                    self._anchor(nets.params), 0)
        return self._run_cohort(nets, x, y, mask, rngs, anchor, None)

    def _run_cohort(self, nets: NetState, x, y, mask, rngs, anchor,
                    anchor_dim):
        c = x.shape[0]
        first = tree_map(lambda t: t[0], nets.params)
        opt_state = tree_map(lambda t: _per_client(t, c),
                             self.optimizer.init(first))
        params, losses = self._epochs(nets.params, opt_state,
                                      nets.model_state, x, y, mask, rngs,
                                      batched=True, anchor=anchor,
                                      anchor_dim=anchor_dim)
        return NetState(params, nets.model_state), losses


class CorrectedLocalTrain(LocalTrain):
    """The corrected-SGD trainer of :func:`make_corrected_local_train`:
    :class:`LocalTrain`'s loop (masked step gate, epoch shuffle, the
    cohort's vmapped step with the client dim next to channels) with no
    optimizer; each step is ``step_update(params, grads, aux)``, ``aux``
    a per-client tree that rides the loop's anchor slot."""

    def __init__(self, apply_fn, local_epochs: int, loss_fn, step_update,
                 with_step_count: bool):
        super().__init__(apply_fn, Optimizer(lambda p: {}, None),
                         local_epochs, loss_fn)
        self.step_update, self.with_step_count = step_update, with_step_count

    def step(self, params, opt_state, model_state, xb, yb, mb, aux=None):
        grads, loss = self._grad(params, model_state, xb, yb, mb)
        new_params = self.step_update(params, grads, aux)
        nb = mb.sum()
        return tree_select(nb > 0, new_params, params), opt_state, loss, nb

    def _done(self, net, loss, mask):
        if not self.with_step_count:
            return net, loss
        # Padded trailing batches are no-op steps: K = epochs × the
        # non-empty steps, at least 1.
        k = self.local_epochs * (mask.sum(-1) > 0).float().sum(-1)
        return net, loss, torch.clamp(k, min=1.0)

    def __call__(self, net: NetState, aux, x, y, mask, rng):
        """One client: ``(net', loss)``, and ``K`` with the step count."""
        params, loss = self._epochs(net.params, {}, net.model_state, x, y,
                                    mask, rng, batched=False, anchor=aux)
        return self._done(NetState(params, net.model_state), loss, mask)

    def run_clients(self, net: NetState, aux, x, y, mask, rngs,
                    aux_dim=0):
        """The cohort from one global ``net``: ``aux`` batched along
        ``aux_dim`` (an int, None, or a tree of them matching ``aux``'s
        structure: FedDyn's ``(0, None)``). Returns ``(client nets, losses
        [C])`` and ``K [C]`` with the step count."""
        c = x.shape[0]
        params = tree_map(lambda t: _per_client(t, c), net.params)
        params, losses = self._epochs(params, {}, net.model_state, x, y,
                                      mask, rngs, batched=True, anchor=aux,
                                      anchor_dim=aux_dim)
        return self._done(NetState(params, net.model_state), losses, mask)


def make_corrected_local_train(apply_fn, local_epochs: int, loss_fn,
                               step_update, with_step_count: bool = False
                               ) -> CorrectedLocalTrain:
    """The shared corrected-SGD client trainer of algorithms whose step
    needs per-client inputs that ``extra_grad_fn`` cannot carry
    (SCAFFOLD's control variates, FedDyn's dynamic regularizer): each step
    is ``step_update(params, grads, aux) -> params'``, so the algorithm
    keeps its own arithmetic order. ``local_train(net, aux, x, y, mask,
    rng) -> (net', loss)``, plus the true step count ``K`` when
    ``with_step_count``; ``run_clients`` runs a cohort. JAX's ``remat``
    is not ported yet (ROADMAP.md A3; ``cfg.remat`` is refused)."""
    return CorrectedLocalTrain(apply_fn, local_epochs, loss_fn, step_update,
                               with_step_count)


def _per_client(t, c: int):
    return t.unsqueeze(0).expand(c, *t.shape).clone()


def _take(a, perm, batched: bool):
    """``a [(C,) S, B, ...]`` reordered by ``perm [(C,) S·B]`` along the
    flattened slot axis."""
    lead = 1 if batched else 0
    shape = a.shape
    flat = a.reshape(*shape[:lead], shape[lead] * shape[lead + 1],
                     *shape[lead + 2:])
    if batched:
        rows = torch.arange(shape[0], device=a.device)[:, None]
        out = flat[rows, perm]
    else:
        out = flat.index_select(0, perm)
    return out.reshape(shape)


def make_local_train_fn(apply_fn, optimizer: Optimizer, local_epochs: int,
                        loss_fn=softmax_ce, extra_grad_fn=None,
                        remat: bool = False,
                        dp_clip: float = 0.0,
                        dp_noise_multiplier: float = 0.0) -> LocalTrain:
    """Build ``local_train(net, x, y, mask, rng) -> (net', mean_loss)``,
    always reshuffling each epoch. ``extra_grad_fn(params,
    global_params) -> grads`` is added to every step's gradient before the
    optimizer update, on the same masked-step gate (FedProx's proximal
    term); ``global_params`` are the params the round started from.
    ``remat`` and DP-SGD are not ported yet."""
    for flag, val in (("remat", remat), ("dp_clip", dp_clip),
                      ("dp_noise_multiplier", dp_noise_multiplier)):
        if val:
            raise NotImplementedError(
                f"{flag} is not ported yet (ROADMAP.md A3)")
    return LocalTrain(apply_fn, optimizer, local_epochs, loss_fn,
                      extra_grad_fn)


def make_eval_fn(apply_fn, loss_fn=softmax_ce, pad_id: int = 0):
    """``evaluate(net, x, y, mask) -> {loss, accuracy, num}`` over a
    batched ``[S, B, ...]`` set, without gradients. Sequence tasks
    (``[B, T]`` labels): a sample's accuracy is its mean over the positions
    whose label is not ``pad_id``, consistent with :func:`seq_softmax_ce`."""

    @torch.no_grad()
    def evaluate(net: NetState, x, y, mask):
        tot_loss = tot_correct = tot_n = 0.0
        for xb, yb, mb in zip(x, y, mask):
            logits, _ = apply_fn(net, xb, train=False)
            per = loss_fn(logits, yb)
            correct = (logits.argmax(-1) == yb).float()
            if correct.dim() > 1:  # sequence tasks: mean over non-pad tokens
                tok_mask = (yb != pad_id).float().flatten(1)
                correct = ((correct.flatten(1) * tok_mask).sum(-1)
                           / torch.clamp(tok_mask.sum(-1), min=1.0))
            tot_loss = tot_loss + (per * mb).sum()
            tot_correct = tot_correct + (correct * mb).sum()
            tot_n = tot_n + mb.sum()
        n = torch.clamp(torch.as_tensor(tot_n), min=1.0)
        return {"loss": tot_loss / n, "accuracy": tot_correct / n,
                "num": torch.as_tensor(tot_n)}

    return evaluate
