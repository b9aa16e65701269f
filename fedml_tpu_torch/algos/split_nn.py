"""Split learning (SplitNN): one model cut between the clients and a
server (port of ``fedml_tpu/algos/split_nn.py``; reference
fedml_api/distributed/split_nn/).

Each client owns the BOTTOM of the net and its optimizer, the server the
shared TOP; the clients take turns in a relay ring, one local epoch a
turn, and per minibatch the activations go up and their gradients come
back. On one card that exchange is backpropagation through the cut: each
step takes one backward through bottom and top together
(``grad_and_value`` over both parameter trees), the same arithmetic as
the wire protocol. Both nets step ``add_decayed_weights(5e-4) → sgd(lr,
momentum 0.9)`` (the reference's client.py:18-19, lr from the config).

The top and its momentum are one carry through the whole ring: the order
matters, since the top moves between clients. The bottoms and their
momenta live in client stacks ``[N + 1, ...]`` (``core/tree.py``, the
last row a dustbin). One client's SEGMENT — gather its row, run its S
joint steps in order, scatter the row back — is one captured step whose
client index is a device tensor, replayed N times in ring order 0…N−1 by
``train_one_epoch``. An empty client's write goes to the dustbin. The
class rides no multi-round tier (``ExcludedScanTiers``).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.func import grad_and_value, vmap

from fedml_tpu_torch.algos.capability import (ExcludedScanTiers,
                                              refuse_model_state)
from fedml_tpu_torch.algos.config import FedConfig
from fedml_tpu_torch.core import keys
from fedml_tpu_torch.core.device import resolve_device
from fedml_tpu_torch.core.graph import CapturedStep
from fedml_tpu_torch.core.tree import (client_rows, client_stack,
                                       gather_stacked,
                                       scatter_stacked, tree_map,
                                       tree_select)
from fedml_tpu_torch.data.batching import FederatedArrays
from fedml_tpu_torch.models.resnet_split import stacked_init
from fedml_tpu_torch.trainer.local import (NetState, _add_decayed_weights,
                                           _chain, _scale, _trace,
                                           apply_updates, model_fns,
                                           softmax_ce)


class SplitNNAPI(ExcludedScanTiers):
    """Relay-ring split learning over a packed federated dataset.

    ``client_model``: module whose forward returns the cut activations;
    ``server_model``: module mapping them to logits. One
    ``train_one_epoch`` is one relay cycle (every client one local epoch,
    in ring order); ``cfg.epochs`` cycles make ``train``.
    ``client_nets`` / ``client_opts`` are the client stacks
    (``core.tree.client_rows`` gives their ``[N, ...]`` view)."""

    window_protocol = None
    window_exclusion = (
        "split learning trains ONE model cut across two trust domains "
        "with a sequential relay ring (the server top updates between "
        "clients, order-dependent) — there is no per-round cohort fold "
        "to publish as a (carry_init, server_update, carry_commit) "
        "record")

    def __init__(self, client_model, server_model, train_fed: FederatedArrays,
                 test_global, cfg: FedConfig, loss_fn=softmax_ce,
                 device=None):
        self.device = dev = resolve_device(device)
        if train_fed.device.type != dev.type:
            raise ValueError(f"train_fed lies on {train_fed.device}, the "
                             f"API runs on {dev}")
        self.cfg, self.train_fed, self.test_global = cfg, train_fed, test_global
        self.client_model = client_model.to(dev)
        self.server_model = server_model.to(dev)
        refuse_model_state("SplitNNAPI", self.client_model, self.server_model)
        self.client_fns = model_fns(self.client_model)
        self.server_fns = model_fns(self.server_model)
        self.loss_fn = loss_fn
        self.n_clients = n = int(train_fed.x.shape[0])
        self.opt = _chain(_add_decayed_weights(5e-4), _trace(0.9),
                          _scale(-cfg.lr))

        self.rng = keys.split(keys.key(cfg.seed, dev), 3)[0]
        rows = stacked_init(self.client_model,
                            n, torch.Generator().manual_seed(cfg.seed))
        # Each client its own weights, plus the dustbin row.
        self.client_nets = NetState(
            tree_map(lambda t: torch.cat([t, t[:1]]), rows), {})
        self.client_opts = client_stack(
            self.opt.init(tree_map(lambda t: t[0], rows)), n)
        self.server_net = self.server_fns.init()
        self.server_opt = self.opt.init(self.server_net.params)
        self._ids = torch.arange(n, device=dev)
        self._graphs: Dict[str, CapturedStep] = {}

    def _watched(self):
        fed = self.train_fed
        return [fed.x, fed.y, fed.mask, fed.counts]

    def _joint_step(self, bottom, opt_b, top, opt_t, xb, yb, mb, key):
        """One minibatch through the cut: the masked mean loss, one backward
        through both nets, both optimizer steps; an all-masked batch
        leaves every tree as it was."""
        client_apply, server_apply = (self.client_fns.apply,
                                      self.server_fns.apply)

        def joint_loss(bp, tp):
            acts, _ = client_apply(NetState(bp, {}), xb, train=True, rng=key)
            logits, _ = server_apply(NetState(tp, {}), acts, train=True,
                                     rng=key)
            per = self.loss_fn(logits, yb)
            return (per * mb).sum() / torch.clamp(mb.sum(), min=1.0)

        (gb, gt), loss = grad_and_value(joint_loss, argnums=(0, 1))(bottom,
                                                                   top)
        ub, opt_b2 = self.opt.update(gb, opt_b, bottom)
        ut, opt_t2 = self.opt.update(gt, opt_t, top)
        nb = mb.sum()
        ok = nb > 0
        return (tree_select(ok, apply_updates(bottom, ub), bottom),
                tree_select(ok, opt_b2, opt_b),
                tree_select(ok, apply_updates(top, ut), top),
                tree_select(ok, opt_t2, opt_t), loss, nb)

    def _build_segment(self):
        """``segment((nets, opts, top, opt_t, loss_sum), c, key) -> (carry',
        None)``: client ``c``'s turn (``c`` 0-d int64 on the device), its
        row of the stacks written in place; ``loss_sum`` += its
        sample-weighted loss."""
        fed = self.train_fed

        def segment(carry, c, key):
            nets, opts, top, opt_t, loss_sum = carry
            idx = c[None]
            bottom = tree_map(lambda t: t[0], gather_stacked(nets, idx))
            opt_b = tree_map(lambda t: t[0], gather_stacked(opts, idx))
            x, y, m = (t.index_select(0, idx)[0]
                       for t in (fed.x, fed.y, fed.mask))
            step_keys = keys.split(key, x.shape[0])
            losses, ns = [], []
            for s in range(x.shape[0]):
                bottom, opt_b, top, opt_t, loss, nb = self._joint_step(
                    bottom, opt_b, top, opt_t, x[s], y[s], m[s],
                    step_keys[s])
                losses.append(loss)
                ns.append(nb)
            umask = (fed.counts.index_select(0, idx) > 0).float()
            scatter_stacked(nets, idx, tree_map(lambda t: t[None], bottom),
                            umask)
            scatter_stacked(opts, idx, tree_map(lambda t: t[None], opt_b),
                            umask)
            losses, ns = torch.stack(losses), torch.stack(ns)
            loss = (losses * ns).sum() / torch.clamp(ns.sum(), min=1.0)
            return (nets, opts, top, opt_t, loss_sum + loss), None

        return segment

    def _segment_step(self) -> CapturedStep:
        step = self._graphs.get("segment")
        if step is None:
            step = self._graphs["segment"] = CapturedStep(
                self._build_segment(), self.device, self._watched)
        return step

    def train_one_epoch(self, epoch_idx: int) -> Dict[str, float]:
        """One relay cycle: every client one local epoch, in ring order."""
        pair = keys.split(self.rng)
        self.rng = pair[0]
        client_keys = keys.split(pair[1], self.n_clients)
        step = self._segment_step()
        carry = (self.client_nets.params, self.client_opts,
                 self.server_net.params, self.server_opt,
                 torch.zeros((), device=self.device))
        for c in range(self.n_clients):
            carry, _ = step(carry, self._ids[c], client_keys[c])
        nets, self.client_opts, top, self.server_opt, loss_sum = carry
        self.client_nets = NetState(nets, self.client_nets.model_state)
        self.server_net = NetState(top, self.server_net.model_state)
        return {"epoch": epoch_idx,
                "train_loss": float(loss_sum / self.n_clients)}

    def train(self):
        return [self.train_one_epoch(e) for e in range(self.cfg.epochs)]

    @torch.no_grad()
    def evaluate(self) -> Dict[str, float]:
        """Every client's bottom against the one top on the test set: the
        means over clients of their losses and accuracies."""
        if self.test_global is None:
            return {}
        client_apply, server_apply = (self.client_fns.apply,
                                      self.server_fns.apply)
        bottoms = vmap(lambda p, xb: client_apply(NetState(p, {}), xb)[0],
                       in_dims=(0, None))
        rows = client_rows(self.client_nets.params)
        c = self.n_clients
        tot_loss = torch.zeros(c, device=self.device)
        tot_hit = torch.zeros(c, device=self.device)
        n = torch.zeros((), device=self.device)
        for xb, yb, mb in zip(*self.test_global):
            acts = bottoms(rows, xb)
            logits, _ = server_apply(self.server_net, acts.flatten(0, 1))
            logits = logits.view(c, xb.shape[0], -1)
            per = self.loss_fn(logits.flatten(0, 1),
                               yb.repeat(c)).view(c, -1)
            tot_loss += (per * mb).sum(-1)
            tot_hit += ((logits.argmax(-1) == yb).float() * mb).sum(-1)
            n += mb.sum()
        n = torch.clamp(n, min=1.0)
        return {"loss": float((tot_loss / n).mean()),
                "accuracy": float((tot_hit / n).mean())}
