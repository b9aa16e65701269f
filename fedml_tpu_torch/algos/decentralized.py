"""Decentralized (serverless) federated optimization: DSGD and PushSum
(port of ``fedml_tpu/algos/decentralized.py``).

Parity:
- fedml_api/standalone/decentralized/ — ``ClientDSGD``
  (client_dsgd.py:6-100: local step then topology-weighted neighbor mixing)
  and ``ClientPushsum`` (client_pushsum.py:7: push-sum gossip with
  column-stochastic weights for directed graphs).
- fedml_api/distributed/decentralized_framework/ — the neighbor
  send/await message loop (decentralized_worker_manager.py:29-39).

All n clients' models are ONE client-stacked tree ``[n, ...]`` on the
card; local training runs the cohort under ``vmap`` (one launch of each
kernel per layer and step for all n), and a whole gossip exchange is one
f32 product ``W @ stack`` per leaf of the whole client net, its params
and its trained state (BatchNorm's running stats mix as JAX mixes the
``NetState``). One round is one captured step with
the stacks ``(nets, push_weights)`` as its carry: ``train_one_round``
replays it, ``train_rounds_pipelined`` replays it without a sync between
rounds, and ``train_rounds_on_device`` replays it once per round with the
host-split keys copied in, bit-equal to the host loop.
"""

from __future__ import annotations

from typing import Dict

import torch

from fedml_tpu_torch.algos.config import FedConfig
from fedml_tpu_torch.algos.capability import refusal
from fedml_tpu_torch.algos.loop import FederatedLoop
from fedml_tpu_torch.core import keys
from fedml_tpu_torch.core.device import resolve_device
from fedml_tpu_torch.core.graph import CapturedStep
from fedml_tpu_torch.core.topology import (BaseTopologyManager,
                                           column_stochastic)
from fedml_tpu_torch.core.tree import tree_map
from fedml_tpu_torch.data.batching import FederatedArrays
from fedml_tpu_torch.parallel.shard import client_rngs
from fedml_tpu_torch.trainer.local import (NetState, make_client_optimizer,
                                           make_eval_fn,
                                           make_local_train_fn_from_cfg,
                                           model_fns, softmax_ce)


def _per_client(omega, p):
    """``omega [n]`` against a client-stacked leaf ``p [n, ...]``."""
    return omega.reshape((-1,) + (1,) * (p.dim() - 1)).to(p.dtype)


def _debias_tree(stacked, omega):
    """PushSum's de-biased iterate x_i = z_i / ω_i over a stacked tree."""
    return tree_map(lambda p: p / _per_client(omega, p), stacked)


def make_gossip_round(local_train, W, mode: str):
    """``round_fn(nets, omega, x, y, mask, rng) -> (nets', omega', loss)``
    over the whole federation: ``nets`` a NetState with ``[n, ...]``
    params and trained state, ``omega [n]`` the push weights, ``W [n, n]``
    f32 the mixing matrix (column-stochastic for ``"pushsum"``). Params
    and state are gossiped (and de-biased) alike, as JAX treats the whole
    ``NetState``."""

    def mix(stacked):
        return tree_map(
            lambda p: torch.matmul(W, p.float().reshape(p.shape[0], -1))
            .reshape(p.shape).to(p.dtype), stacked)

    def net_map(fn, *nets):
        return NetState(tree_map(fn, *(n.params for n in nets)),
                        tree_map(fn, *(n.model_state for n in nets)))

    def round_fn(nets, omega, x, y, mask, rng):
        rngs = client_rngs(rng, x.shape[0], 0)
        if mode == "pushsum":
            # Train at the de-biased iterate x = z/ω, fold the update back
            # into z-space (Δz = ω·Δx), then gossip z and ω with the
            # column-stochastic matrix.
            xs = net_map(lambda p: p / _per_client(omega, p), nets)
            trained, losses = local_train.run_stacked(xs, x, y, mask, rngs)
            z = net_map(
                lambda zl, xl, tl: zl + _per_client(omega, xl) * (tl - xl),
                nets, xs, trained)
            return (NetState(mix(z.params), mix(z.model_state)), W @ omega,
                    losses.mean())
        trained, losses = local_train.run_stacked(nets, x, y, mask, rngs)
        return (NetState(mix(trained.params), mix(trained.model_state)),
                omega, losses.mean())

    return round_fn


class DecentralizedAPI(FederatedLoop):
    """Every client participates every round (there is no server to
    sample); ``mode`` is ``"dsgd"`` (symmetric, row-stochastic) or
    ``"pushsum"`` (directed, column-stochastic with weight de-biasing:
    gradients are taken at the de-biased iterate x_i = z_i/ω_i, the
    reference's ClientPushsum semantics, client_pushsum.py:7-100).

    The carry ``(nets, push_weights)`` is donated to the captured round:
    after a round ``api.nets`` holds the graph's buffers, which the next
    round overwrites in place; clone what must outlive a round.
    ``consensus_net()`` (the uniform client average) is what ``evaluate``
    and ``evaluate_on_clients`` read."""

    window_protocol = "custom"
    window_carry = "client-stacked models + push weights"
    window_exclusion = (
        "full-participation gossip over device-resident client stacks — "
        "no cohort ever streams from a store, so the windowed store tier "
        "does not apply; train_rounds_on_device IS the multi-round scan "
        "fast path here")
    capability_tiers = {"fused": True, "pipelined": True,
                        "windowed": False, "on_device": True}

    def __init__(self, model, train_fed: FederatedArrays, test_global,
                 cfg: FedConfig, topology: BaseTopologyManager,
                 mode: str = "dsgd", loss_fn=softmax_ce, device=None):
        if mode not in ("dsgd", "pushsum"):
            raise ValueError(f"unknown decentralized mode {mode!r}")
        self.device = resolve_device(device)
        if train_fed.device.type != self.device.type:
            raise ValueError(f"train_fed lies on {train_fed.device}, the "
                             f"api runs on {self.device}")
        self.cfg, self.mode = cfg, mode
        self.train_fed, self.test_global = train_fed, test_global
        self.model = model.to(self.device)
        self.fns = model_fns(self.model)
        n = train_fed.num_clients
        W = topology.mixing_matrix()
        if W.shape != (n, n):
            raise ValueError(f"topology is {W.shape}, need ({n}, {n})")
        self.W = torch.as_tensor(
            column_stochastic(W) if mode == "pushsum" else W,
            dtype=torch.float32, device=self.device)
        optimizer = make_client_optimizer(cfg.client_optimizer, cfg.lr,
                                          cfg.wd)
        local_train = make_local_train_fn_from_cfg(self.fns.apply, optimizer,
                                                   cfg, loss_fn)
        self.round_fn = make_gossip_round(local_train, self.W, mode)
        self.eval_fn = make_eval_fn(self.fns.apply, loss_fn)
        self.rng = keys.split(keys.key(cfg.seed, self.device))[0]
        net0 = self.fns.init(torch.Generator().manual_seed(cfg.seed))
        # Every client starts from the same model (as the reference does),
        # each in a row of its own (its params and its running stats): the
        # stack is written in place.
        def rows(tree):
            return tree_map(lambda p: p.unsqueeze(0).repeat(
                n, *([1] * p.dim())), tree)

        self.nets = NetState(rows(net0.params), rows(net0.model_state))
        self.push_weights = torch.ones(n, dtype=torch.float32,
                                       device=self.device)
        self._step = None

    def _debiased(self) -> NetState:
        """PushSum's estimate x_i = z_i / w_i (params and state); DSGD's
        nets as they are."""
        if self.mode == "dsgd":
            return self.nets
        return NetState(_debias_tree(self.nets.params, self.push_weights),
                        _debias_tree(self.nets.model_state,
                                     self.push_weights))

    def consensus_net(self) -> NetState:
        """The uniform average over clients (params and state), the
        quantity decentralized SGD drives to the optimum."""
        net = self._debiased()
        return NetState(tree_map(lambda p: p.mean(0), net.params),
                        tree_map(lambda p: p.mean(0), net.model_state))

    def _eval_net(self):
        return self.consensus_net()

    def _gossip_step(self):
        """One gossip round over the whole resident federation,
        uncaptured: ``((nets, omega), key) -> ((nets', omega'), loss)``."""
        round_fn = self.round_fn

        def step(carry, key):
            f = self.train_fed
            nets, omega, loss = round_fn(*carry, f.x, f.y, f.mask, key)
            return (nets, omega), loss

        return step

    def _watched(self):
        """What the captured round reads in place: the dataset and the
        module's own tensors."""
        f = self.train_fed
        return [f.x, f.y, f.mask, *self.model.parameters(),
                *self.model.buffers()]

    def _round_step(self) -> CapturedStep:
        """The captured gossip round (:meth:`_gossip_step`), the stacks
        its donated carry."""
        if self._step is None:
            self._step = CapturedStep(self._gossip_step(), self.device,
                                      self._watched)
        return self._step

    def _replay(self, key):
        (self.nets, self.push_weights), loss = self._round_step()(
            (self.nets, self.push_weights), key)
        return loss

    def _round_keys(self, n_rounds: int):
        """The host loop's per-round key chain, split ahead."""
        out = []
        for _ in range(n_rounds):
            pair = keys.split(self.rng)
            self.rng = pair[0]
            out.append(pair[1])
        return out

    def train_one_round(self, round_idx: int) -> Dict[str, float]:
        self._require("train_one_round", self.capability().fused)
        loss = self._replay(self._round_keys(1)[0])
        return {"round": round_idx, "train_loss": float(loss)}

    def train_rounds_pipelined(self, n_rounds: int, start_round: int = 0):
        """``n_rounds`` gossip rounds with the per-round loss sync deferred
        to the end: per-round semantics those of :meth:`train_one_round`
        in a loop (the key chain and the round are the same)."""
        self._require("train_rounds_pipelined", self.capability().fused)
        losses = [self._replay(self._round_keys(1)[0]).clone()
                  for _ in range(n_rounds)]
        return torch.stack(losses).tolist() if losses else []

    def train_rounds_on_device(self, n_rounds: int) -> torch.Tensor:
        """``n_rounds`` whole gossip rounds, the keys split on the host
        ahead and copied into the replays, with no host sync between
        rounds; bit-equal to the host loop (full participation leaves the
        key chain as the only host state). Returns the ``[n_rounds]``
        losses as a device tensor. The incoming stacks are donated."""
        self._require("train_rounds_on_device",
                      self.capability().on_device)
        losses = torch.empty(n_rounds, dtype=torch.float32,
                             device=self.device)
        for r, key in enumerate(self._round_keys(n_rounds)):
            losses[r].copy_(self._replay(key))
        return losses

    def train_rounds_windowed(self, n_rounds: int, start_round: int = 0,
                              window: int = 8):
        raise NotImplementedError(refusal(type(self),
                                          "train_rounds_windowed"))
