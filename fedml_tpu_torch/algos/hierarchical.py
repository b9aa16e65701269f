"""Hierarchical FedAvg: clients → groups → global (port of
``fedml_tpu/algos/hierarchical.py``).

Parity: fedml_api/standalone/hierarchical_fl/ — per global round, sampled
clients are grouped; each group runs ``group_comm_round`` inner FedAvg
rounds over its sampled clients (group.py:24-46), then the global model is
the sample-count-weighted average of the group models (trainer.py:43-69).
With full participation, full batch and 1 local epoch, a fixed product of
global × group rounds yields the same model whatever the grouping, to
first order (the reference CI's invariant, CI-script-fedavg.sh:49-56).

- **Sparse global step**: only the groups that sampled clients this round
  train and enter the global reduction.
- **Composable robust aggregation**: with a ``group_composable``
  ``cfg.aggregator`` (coord_median, trimmed_mean<beta>) each group's inner
  rounds aggregate its clients robustly and the global step applies the
  same statistic across the group partials. krum and geometric_median are
  refused at construction.
- **One captured step per group size**: a group's cohort is padded to a
  power-of-two size, and each padded size has its own captured inner round
  (the client gather, the round and its weighted average), replayed
  ``group_comm_round`` times per group. An eager ResNet-56 round costs the
  host ~1.6 s of dispatch on the card, so the group loop replays instead.

The round is a host loop over a data-dependent set of groups: the class
opts out of the carry protocol and rides no multi-round tier. Resident
``FederatedArrays`` only (streaming stores: ROADMAP.md A9).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from fedml_tpu_torch.algos.fedavg import FedAvgAPI
from fedml_tpu_torch.core import keys
from fedml_tpu_torch.core.sampling import pad_to_multiple
from fedml_tpu_torch.core.tree import tree_map, tree_weighted_mean
from fedml_tpu_torch.data.batching import gather_clients
from fedml_tpu_torch.obs import trace as obs_trace
from fedml_tpu_torch.obs.registry import payload_nbytes
from fedml_tpu_torch.trainer.local import NetState


class HierarchicalFedAvgAPI(FedAvgAPI):
    """``group_ids[client] -> group`` assigns every client to a group;
    ``cfg.group_comm_round`` sets the inner loop."""

    composes_group_aggregation = True  # two-stage robust aggregation

    #: Carry capability record: opted out, with the reason every tier
    #: guard quotes.
    window_protocol = None
    window_exclusion = (
        "each round trains a data-dependent number of groups for "
        "group_comm_round inner rounds on host — the per-round work has "
        "no fixed scan shape; the mesh-shard analogue (cfg.group_reduce "
        "on the flat FedAvg family) rides every tier instead")

    def __init__(self, model, train_fed, test_global, cfg,
                 group_ids: Sequence[int], mesh=None, **kwargs):
        super().__init__(model, train_fed, test_global, cfg, mesh=mesh,
                         **kwargs)
        self.group_ids = np.asarray(group_ids)
        if len(self.group_ids) != cfg.client_num_in_total:
            raise ValueError("group_ids must have one entry per client")
        if cfg.group_comm_round < 1:
            raise ValueError(f"group_comm_round must be >= 1, got "
                             f"{cfg.group_comm_round}")
        if getattr(cfg, "group_reduce", False):
            raise NotImplementedError(
                "HierarchicalFedAvgAPI already groups host-side; "
                "cfg.group_reduce (the mesh-shard grouping) would nest a "
                "second grouping inside each group's round — drop one")

    def _group_round(self):
        """The inner round of one group, uncaptured: ``step(net, idx
        [size], gmask [size], key) -> (net', loss)``, the cohort gathered
        on the device and weighted by its true counts times the pad
        mask."""
        round_fn = self.round_fn

        def step(net, idx, gmask, key):
            sub = gather_clients(self.train_fed, idx)
            weights = sub.counts.float() * gmask
            return round_fn(net, sub.x, sub.y, sub.mask, weights, weights,
                            key)

        return step

    def _group_step(self, size: int):
        """The captured inner round for groups padded to ``size``
        clients, one capture per size."""
        return self._captured(f"group{size}", self._group_round)

    def _global_reduce(self, group_nets, group_weights):
        """The sparse global step over the round's participating groups:
        the weighted mean or, with a composable ``cfg.aggregator``, the
        same robust statistic across the group partials, each group one
        vote and ``weight > 0`` its participation gate."""
        # The whole group nets, params and trained state, as JAX reduces
        # the NetState.
        joint = [{**n.params, **n.model_state} for n in group_nets]
        stacked = tree_map(lambda *xs: torch.stack(xs), *joint)
        gw = torch.tensor(group_weights, dtype=torch.float32,
                          device=self.device)
        if self._aggregator.is_mean:
            out = tree_weighted_mean(stacked, gw)
        else:
            agg = self._aggregator(stacked, gw)
            any_ok = (gw > 0).any()
            out = tree_map(lambda a, p: torch.where(any_ok, a, p), agg,
                           {**self.net.params, **self.net.model_state})
        return NetState({k: out[k] for k in self.net.params},
                        {k: out[k] for k in self.net.model_state})

    def train_one_round(self, round_idx: int):
        self._check_resident()
        tr = obs_trace.active()
        traced = tr is not obs_trace.NULL
        idx = np.asarray(self.sample_round(round_idx))
        counts = self.train_fed.counts.cpu().numpy()
        group_nets, group_weights, losses = [], [], []
        ck = obs_trace.corr(round=round_idx)
        for g in np.unique(self.group_ids[idx]):
            g_idx = idx[self.group_ids[idx] == g]
            # A power-of-two cohort: O(log client_num_per_round) captured
            # steps instead of one per distinct group size.
            target = 1
            while target < len(g_idx):
                target *= 2
            g_idx_p, g_mask = pad_to_multiple(g_idx, target)
            step = self._group_step(target)
            idx_d = self._cohort_on_device(g_idx_p)
            mask_d = self._to_device(g_mask)
            net_g = self.net
            # Stage 1: the group's inner rounds and their aggregation.
            # Fenced with a sync only when a tracer is installed.
            with tr.span("reduce.stage1", cat="reduce", corr=ck,
                         group=int(g), clients=int(len(g_idx))):
                for _ in range(self.cfg.group_comm_round):
                    # The flat host loop's key chain, in round order.
                    pair = keys.split(self.rng)
                    self.rng, rnd_rng = pair[0], pair[1]
                    net_g, loss = step(net_g, idx_d, mask_d, rnd_rng)
                # The step's buffers serve the next group of this size.
                net_g = NetState(tree_map(torch.clone, net_g.params),
                                 tree_map(torch.clone, net_g.model_state))
                losses.append(loss.clone())
                if traced:
                    self._fence()
            group_nets.append(net_g)
            group_weights.append(float((counts[g_idx_p] * g_mask).sum()))
        if sum(group_weights) <= 0:
            # Every sampled client empty: no group trained a real step;
            # keep the previous global model (a zero-total reduction
            # would zero or inf-poison the params).
            return {"round": round_idx, "train_loss": 0.0}
        # Stage 2: the sparse global step over the G group partials, the
        # bytes that would cross between groups (G × payload).
        with tr.span("reduce.stage2", cat="reduce", corr=ck,
                     groups=len(group_nets),
                     nbytes=(len(group_nets) * payload_nbytes(self.net)
                             if traced else 0)):
            self.net = self._global_reduce(group_nets, group_weights)
            if traced:
                self._fence()
        w = np.asarray(group_weights) / max(sum(group_weights), 1e-12)
        loss = np.asarray(torch.stack(losses).cpu(), np.float64)
        return {"round": round_idx, "train_loss": float((w * loss).sum())}
