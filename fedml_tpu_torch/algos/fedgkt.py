"""FedGKT — group knowledge transfer (port of ``fedml_tpu/algos/fedgkt.py``;
He et al. 2020, reference fedml_api/distributed/fedgkt/).

Each round alternates two models:

- the **client phase** trains every client's stump (``[C, ...]`` stacked
  params, all C clients under one ``vmap``, one launch of each kernel per
  layer and step) with CE plus ``have_teacher · KL`` against the server's
  logits of the previous round, a fresh ``sgd(lr, momentum 0.9)`` state a
  round, then sweeps the client data once more (``train=False``) for the
  features and logits the server trains on;
- the **server phase** trains the tail on every client batch in order
  (the flattened client × step axis, ``epochs_server`` times) with CE plus
  KL against the client logits and plain Adam (optax's ``adam``:
  ``scale_by_adam(0.9, 0.999, 1e-8)``, then ``scale(-server_lr)``), then
  relabels every batch with a forward of the trained tail: the next
  round's teacher.

On the card the client phase is one captured step replayed once a round
(``core/graph.py``), and the server phase is two captured steps, one
server step and one relabel step, each replayed C·S times from a host
loop: an eager ResNet-56 step costs the host far more than the card. What
changes between replays lives in device tensors: the Adam count in the
optimizer state, ``have_teacher`` a 0-d f32 argument, the step index (and
the per-step key folded from it) in the carry, the epoch's loss sums in
the carry, read once a phase. The features ``[C, S, B, H, W, 16]`` (f32,
the stump's NHWC memory), the client logits and the server logits are
buffers of the API, written in place by the steps and read by a device
index (``index_select``, one batch a step), so a replay copies no
operand.

Round 0 has no server logits: the KL term is gated by ``have_teacher``
(the reference branches on an empty logits dict). Trained model state
(BatchNorm's running stats, ``norm="bn"``) is threaded as JAX threads it:
each client's stump carries its own stats beside its params (``[C, ...]``
in ``client_nets.model_state``), each training step keeps the stats its
forward left, and the sweep reads them in eval mode; the tail's stats
ride the server step's carry. The class rides no multi-round tier
(``ExcludedScanTiers``: the record's refusals).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch.func import grad_and_value, vmap

from fedml_tpu_torch.algos.capability import ExcludedScanTiers
from fedml_tpu_torch.algos.config import FedConfig
from fedml_tpu_torch.algos.fedopt import _scale_by_adam
from fedml_tpu_torch.core import keys
from fedml_tpu_torch.core.device import resolve_device
from fedml_tpu_torch.core.graph import CapturedStep
from fedml_tpu_torch.core.tree import tree_select
from fedml_tpu_torch.data.batching import FederatedArrays
from fedml_tpu_torch.models.resnet_split import stacked_init
from fedml_tpu_torch.trainer.local import (LocalTrain, NetState, _chain,
                                           _scale, _trace, apply_updates,
                                           model_fns, softmax_ce)


def kl_loss(student_logits, teacher_logits, temperature: float = 1.0):
    """Per-example distillation KL, ``T² · Σ q·(log q − log_softmax(s/T))``
    with ``q = softmax(t/T) + 1e-7`` (reference fedgkt/utils.py:75-94; the
    1e-7 makes the loss of two equal inputs ~1e-6, not 0)."""
    t = temperature
    log_p = F.log_softmax(student_logits.float() / t, dim=-1)
    q = F.softmax(teacher_logits.float() / t, dim=-1) + 1e-7
    return t * t * (q * (torch.log(q) - log_p)).sum(-1)


class _DistillTrain(LocalTrain):
    """The client phase's trainer: :class:`LocalTrain`'s loop (epoch
    shuffle, masked step gate, the cohort under ``vmap``) with the step's
    loss ``CE + have_teacher · KL``. The teacher logits ride the label
    tensor (``[..., 1 + K]``: the label, then the logits), so the epoch
    shuffle moves them with x; ``have_teacher`` rides the anchor slot."""

    def __init__(self, apply_fn, optimizer, local_epochs, temperature):
        super().__init__(apply_fn, optimizer, local_epochs)
        self.temperature = temperature

    def step(self, params, opt_state, model_state, xb, yb, mb, rng=None,
             have_teacher=None):
        def masked_loss(p):
            (logits, _), state = self.apply_fn(NetState(p, model_state), xb,
                                               train=True, rng=rng)
            per = softmax_ce(logits, yb[..., 0]) + have_teacher * kl_loss(
                logits, yb[..., 1:], self.temperature)
            return (per * mb).sum() / torch.clamp(mb.sum(), min=1.0), state

        grads, (loss, new_state) = grad_and_value(masked_loss,
                                                  has_aux=True)(params)
        updates, new_opt = self.optimizer.update(grads, opt_state, params)
        nb = mb.sum()
        nonempty = nb > 0
        return (tree_select(nonempty, apply_updates(params, updates), params),
                tree_select(nonempty, new_opt, opt_state),
                tree_select(nonempty, new_state, model_state), loss, nb)


class FedGKTAPI(ExcludedScanTiers):
    """Alternating client/server distillation.

    ``client_model``: a stump returning ``(logits, features)``
    (``models/resnet_split.ResNetClientStump``); ``server_model``: a tail
    mapping the features to logits. ``device=None`` runs on the card."""

    window_protocol = None
    window_exclusion = (
        "group knowledge transfer alternates TWO models (client stumps "
        "+ server tail) through a feature/logit exchange each round — "
        "the server phase trains on every client's features, so the "
        "round is not a cohort fold with a pure server carry")

    def __init__(self, client_model, server_model, train_fed: FederatedArrays,
                 test_global, cfg: FedConfig, temperature: float = 3.0,
                 epochs_server: int = 1, server_lr: float = 1e-3,
                 device=None):
        self.device = dev = resolve_device(device)
        if train_fed.device.type != dev.type:
            raise ValueError(f"train_fed lies on {train_fed.device}, the "
                             f"API runs on {dev}")
        self.cfg, self.train_fed, self.test_global = cfg, train_fed, test_global
        self.client_model = client_model.to(dev)
        self.server_model = server_model.to(dev)
        self.client_fns = model_fns(self.client_model)
        self.server_fns = model_fns(self.server_model)
        self.temperature, self.epochs_server = temperature, epochs_server
        C, S, B = train_fed.x.shape[:3]
        self.n_clients, self.n_steps, self.batch = C, S, B
        self.n_classes = K = int(client_model.num_classes)

        # The reference's optimizers (GKTServerTrainer.py:31-43): cfg.lr
        # SGD-m for the clients, Adam(server_lr) for the tail (cfg.server_lr
        # is FedOpt's server-SGD rate, 1.0 by default, which would blow
        # Adam up).
        self.client_opt = _chain(_trace(0.9), _scale(-cfg.lr))
        self.server_opt = _chain(_scale_by_adam(0.9, 0.999, 1e-8),
                                 _scale(-server_lr))
        self._trainer = _DistillTrain(self.client_fns.apply, self.client_opt,
                                      cfg.epochs, temperature)

        self.rng = keys.split(keys.key(cfg.seed, dev), 3)[0]
        gen = torch.Generator().manual_seed(cfg.seed)
        # Each client its own draw of the stump, every client's running
        # stats at their init.
        self.client_nets = NetState(
            stacked_init(self.client_model, C, gen),
            {k: b.detach().unsqueeze(0).repeat(C, *([1] * b.dim()))
             for k, b in self.client_model.named_buffers()})
        self.server_net = self.server_fns.init()
        self.server_state = self.server_opt.init(self.server_net.params)

        with torch.no_grad():
            _, feats = self.client_model(train_fed.x[0, 0])
        _, fc, h, w = feats.shape
        # The exchange buffers, written in place by the captured steps.
        self.feats = torch.zeros((C, S, B, h, w, fc), device=dev)
        self.client_logits = torch.zeros((C, S, B, K), device=dev)
        #: Teacher logits from the previous server phase, per client batch.
        self.server_logits = torch.zeros((C, S, B, K), device=dev)
        self.have_teacher = False
        self._flags = torch.tensor([0.0, 1.0], device=dev)
        self._graphs: Dict[str, CapturedStep] = {}

    # --- the captured steps --------------------------------------------------
    def _watched(self):
        fed = self.train_fed
        return [fed.x, fed.y, fed.mask, self.feats, self.client_logits,
                self.server_logits]

    def _captured(self, name: str, build) -> CapturedStep:
        step = self._graphs.get(name)
        if step is None:
            step = self._graphs[name] = CapturedStep(build(), self.device,
                                                     self._watched)
        return step

    def _build_client_phase(self):
        """``phase(nets, have_teacher, key) -> (nets', losses [C])``: every
        client's training from its own stump (``nets``: ``[C, ...]`` params
        and running stats) and the sweep, in eval mode, that writes
        ``feats`` and ``client_logits``."""
        apply, trainer = self.client_fns.apply, self._trainer
        fed, S = self.train_fed, self.n_steps

        def stump(p, state, xb):
            return apply(NetState(p, state), xb, train=False)[0]

        sweep = vmap(stump, in_dims=(0, 0, 3))

        def phase(nets, have_teacher, key):
            y = torch.cat([fed.y.float()[..., None], self.server_logits], -1)
            nets, losses = trainer._run_cohort(
                nets, fed.x, y, fed.mask, keys.split(key, self.n_clients),
                have_teacher, None)
            with torch.no_grad():
                for s in range(S):
                    # The client dim next to the channels, as in training.
                    logits, feats = sweep(
                        nets.params, nets.model_state,
                        fed.x[:, s].movedim(0, -2).contiguous())
                    self.feats[:, s].copy_(feats.permute(0, 1, 3, 4, 2))
                    self.client_logits[:, s].copy_(logits)
            return nets, losses

        return phase

    def _batch(self, idx):
        """The flattened client × step batch ``idx`` (0-d int64 on the
        device): features ``[B, 16, H, W]`` (channels-last), client
        logits, labels and mask."""
        cs = self.n_clients * self.n_steps
        sel = idx[None]

        def take(t):
            return t.reshape((cs,) + t.shape[2:]).index_select(0, sel)[0]

        fed = self.train_fed
        return (take(self.feats).permute(0, 3, 1, 2),
                take(self.client_logits), take(fed.y), take(fed.mask))

    def _build_server_step(self):
        """``step((net, opt_state, acc, idx, step_base)) -> (carry', None)``:
        one Adam step of the tail (params and running stats) on batch
        ``idx`` with CE + KL against the client logits; ``acc`` += (loss ·
        n, n); ``idx`` + 1."""
        apply, opt, T = self.server_fns.apply, self.server_opt, \
            self.temperature

        def step(carry):
            net, opt_state, acc, idx, step_base = carry
            params = net.params
            fb, clb, yb, mb = self._batch(idx)
            sub = keys.fold_in(step_base, idx)

            def masked_loss(p):
                logits, state = apply(NetState(p, net.model_state), fb,
                                      train=True, rng=sub)
                per = softmax_ce(logits, yb) + kl_loss(logits, clb, T)
                return ((per * mb).sum() / torch.clamp(mb.sum(), min=1.0),
                        state)

            grads, (loss, state) = grad_and_value(masked_loss,
                                                  has_aux=True)(params)
            updates, new_opt = opt.update(grads, opt_state, params)
            nb = mb.sum()
            nonempty = nb > 0
            net = NetState(
                tree_select(nonempty, apply_updates(params, updates),
                            params),
                tree_select(nonempty, state, net.model_state))
            opt_state = tree_select(nonempty, new_opt, opt_state)
            acc = acc + torch.stack([loss * nb, nb])
            return (net, opt_state, acc, idx + 1, step_base), None

        return step

    def _build_relabel_step(self):
        """``step((net, idx)) -> ((net, idx + 1), None)``: the trained
        tail's logits (eval mode) of batch ``idx`` into
        ``server_logits``."""
        apply = self.server_fns.apply
        cs = self.n_clients * self.n_steps

        def step(carry):
            net, idx = carry
            fb = self._batch(idx)[0]
            with torch.no_grad():
                logits, _ = apply(net, fb, train=False)
            self.server_logits.view(cs, self.batch, -1).index_copy_(
                0, idx[None], logits[None])
            return (net, idx + 1), None

        return step

    # --- the round ------------------------------------------------------------
    def _step_index(self):
        return torch.zeros((), dtype=torch.int64, device=self.device)

    def _run_client_phase(self, key):
        """The captured client phase: the stumps trained, the features and
        client logits written. Returns the clients' losses ``[C]``."""
        step = self._captured("client", self._build_client_phase)
        self.client_nets, losses = step(
            self.client_nets, self._flags[int(self.have_teacher)], key)
        return losses

    def _run_server_phase(self, key):
        """``epochs_server`` passes of the replayed server step over the C·S
        batches in order; returns the mean of the epochs' sample-weighted
        losses (a device tensor)."""
        step = self._captured("server", self._build_server_step)
        net, opt_state = self.server_net, self.server_state
        epoch_losses = []
        for e in range(self.epochs_server):
            carry = (net, opt_state,
                     torch.zeros(2, device=self.device), self._step_index(),
                     keys.fold_in(key, e))
            for _ in range(self.n_clients * self.n_steps):
                carry, _ = step(carry)
            net, opt_state, acc = carry[:3]
            epoch_losses.append(acc[0] / torch.clamp(acc[1], min=1.0))
        self.server_net = net
        self.server_state = opt_state
        return torch.stack(epoch_losses).mean()

    def _run_relabel(self):
        """The replayed relabel step over the C·S batches: the next round's
        teacher logits in ``server_logits``."""
        step = self._captured("relabel", self._build_relabel_step)
        carry = (self.server_net, self._step_index())
        for _ in range(self.n_clients * self.n_steps):
            carry, _ = step(carry)

    def train_one_round(self, round_idx: int) -> Dict[str, float]:
        trio = keys.split(self.rng, 3)
        self.rng = trio[0]
        closs = self._run_client_phase(trio[1])
        sloss = self._run_server_phase(trio[2])
        self._run_relabel()
        self.have_teacher = True
        return {"round": round_idx, "client_loss": float(closs.mean()),
                "server_loss": float(sloss)}

    def train(self):
        return [self.train_one_round(r) for r in range(self.cfg.comm_round)]

    @torch.no_grad()
    def evaluate(self) -> Dict[str, float]:
        """Every client's stump against the one tail on the test set; the
        mean over clients of their accuracies."""
        if self.test_global is None:
            return {}
        client_apply, server_apply = (self.client_fns.apply,
                                      self.server_fns.apply)
        stumps = vmap(lambda p, st, xb: client_apply(NetState(p, st),
                                                     xb)[0][1],
                      in_dims=(0, 0, None))
        c = self.n_clients
        correct = torch.zeros(c, device=self.device)
        n = torch.zeros((), device=self.device)
        for xb, yb, mb in zip(*self.test_global):
            feats = stumps(self.client_nets.params,
                           self.client_nets.model_state, xb)
            logits, _ = server_apply(self.server_net, feats.flatten(0, 1))
            hit = (logits.view(c, xb.shape[0], -1).argmax(-1) == yb).float()
            correct += (hit * mb).sum(-1)
            n += mb.sum()
        return {"accuracy": float((correct / torch.clamp(n, min=1.0)).mean())}
