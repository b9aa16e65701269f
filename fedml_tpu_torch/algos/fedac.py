"""Accelerated server updates on the "round" carry protocol: FedAc and
server averaging (port of ``fedml_tpu/algos/fedac.py``).

Both are PURE server-state updates, so they ride every tier of the port
(the fused round, ``train_rounds_pipelined``, ``train_rounds_on_device``)
with their sequences as the carry of the captured step, living on the
device between rounds.

**FedAc** (Yuan & Ma, "Federated Accelerated Stochastic Gradient
Descent", NeurIPS 2020, arXiv:2006.08950), applied at the ROUND level: the
aggregate progress of the local steps, ``Δ = x_md − avg``, plays the role
of the (scaled) gradient at the coupling point ``x_md``, the model the
server broadcast::

    x_ag' = x_md − Δ                       (= avg, the FedAvg point)
    x'    = (1 − 1/α)·x + (1/α)·x_md − γ·Δ
    x_md' = (1/β)·x' + (1 − 1/β)·x_ag'     (the next broadcast)

``γ`` ≥ 1 is the acceleration knob; ``α``/``β`` default to the FedAc-I
couplings ``α = (3γ − 1)/2``, ``β = 2α − 1``. At ``γ = 1`` the recursion
is FedAvg's (α = β = 1 → x_md' = avg, up to the rounding of
``md − (md − avg)``).

**Server averaging** (Guo et al., "Server Averaging for Federated
Learning", arXiv:2103.11619): the broadcast model mixes the round's
average with the running mean of past global models. Pure carry ``(acc,
count, t)``::

    acc' = acc + avg, count' = count + 1      (from round avg_start on)
    net' = (1 − β)·avg + β·acc'/count'

``β = 0`` is FedAvg bit for bit.
"""

from __future__ import annotations

import torch

from fedml_tpu_torch.algos.fedavg import FedAvgAPI
from fedml_tpu_torch.core.tree import tree_leaves, tree_map
from fedml_tpu_torch.trainer.local import NetState


class FedAcAPI(FedAvgAPI):
    """FedAvg + round-level FedAc acceleration. ``gamma`` ≥ 1 scales the
    accelerated sequence's step in units of the round's aggregate local
    progress; ``alpha``/``beta`` override the FedAc-I couplings. All three
    are Python floats baked into the captured step: construct a new api to
    change them."""

    window_carry = "(x, x_ag) acceleration sequences"

    def __init__(self, *args, gamma: float = 2.0, alpha: float = None,
                 beta: float = None, **kw):
        super().__init__(*args, **kw)
        if gamma < 1.0:
            raise ValueError(f"fedac gamma must be >= 1 (1 = FedAvg), "
                             f"got {gamma}")
        self.gamma = float(gamma)
        self.alpha = (float(alpha) if alpha is not None
                      else max((3.0 * self.gamma - 1.0) / 2.0, 1.0))
        self.beta = (float(beta) if beta is not None
                     else max(2.0 * self.alpha - 1.0, 1.0))
        if self.alpha < 1.0 or self.beta < 1.0:
            raise ValueError(
                f"fedac couplings must be >= 1, got alpha={self.alpha}, "
                f"beta={self.beta}")
        # Both sequences start at the init point (x = x_ag = x_md = w0),
        # as buffers of their own: the captured step copies its new carry
        # into the carry's buffers, so a buffer shared with net.params
        # would be written through.
        self._fedac_state = (tree_map(torch.clone, self.net.params),
                             tree_map(torch.clone, self.net.params))

    # --- the pure carry record ---------------------------------------------
    def _window_server_update(self):
        inv_a, inv_b, g = 1.0 / self.alpha, 1.0 / self.beta, self.gamma

        def update(net, avg, extra, key):
            del key  # a deterministic update
            x, _x_ag = extra
            # Δ = x_md − avg; x_md is the round's broadcast point (net).
            new_x = tree_map(
                lambda xl, md, av: (
                    (1.0 - inv_a) * xl.float() + inv_a * md.float()
                    - g * (md.float() - av.float())).to(xl.dtype),
                x, net.params, avg.params)
            new_x_ag = avg.params  # x_ag' = x_md − Δ, exactly the average
            md = tree_map(
                lambda xl, agl: (inv_b * xl.float()
                                 + (1.0 - inv_b) * agl.float()).to(agl.dtype),
                new_x, new_x_ag)
            # Non-trainable state keeps the plain client average, as
            # FedOpt's does.
            return NetState(md, avg.model_state), (new_x, new_x_ag)

        return update

    def _window_carry_init(self):
        return self._fedac_state

    def _window_carry_commit(self, extra) -> None:
        self._fedac_state = extra

    def _server_update(self, old_net, avg_net):
        # The host form: the pure form and the commit (the eager reference
        # of the captured tiers).
        new_net, self._fedac_state = self._window_server_update()(
            old_net, avg_net, self._fedac_state, None)
        return new_net

    # -- checkpoint/resume: the sequences are run state ---------------------
    def checkpoint_extra_state(self):
        return {"fedac_x": self._fedac_state[0],
                "fedac_x_ag": self._fedac_state[1]}

    def load_checkpoint_extra_state(self, extra) -> None:
        self._fedac_state = (extra["fedac_x"], extra["fedac_x_ag"])


class ServerAvgAPI(FedAvgAPI):
    """FedAvg + server averaging: broadcast ``(1 − β)·avg + β·mean(past
    globals)``. ``avg_coef`` is β (0 = plain FedAvg); ``avg_start`` skips
    the first rounds (early models are far from the optimum)."""

    window_carry = "running mean of past globals (acc, count, t)"

    def __init__(self, *args, avg_coef: float = 0.5, avg_start: int = 0,
                 **kw):
        super().__init__(*args, **kw)
        if not 0.0 <= avg_coef < 1.0:
            raise ValueError(
                f"server-averaging avg_coef must be in [0, 1), got "
                f"{avg_coef}")
        self.avg_coef = float(avg_coef)
        self.avg_start = int(avg_start)
        dev = tree_leaves(self.net.params)[0].device
        # The counters are 0-d device tensors: a Python number would be
        # baked into the captured step as a constant.
        self._savg_state = (
            tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     self.net.params),
            torch.zeros((), dtype=torch.float32, device=dev),  # globals
            torch.zeros((), dtype=torch.int32, device=dev),    # rounds seen
        )

    # --- the pure carry record ---------------------------------------------
    def _window_server_update(self):
        beta, start = self.avg_coef, self.avg_start

        def update(net, avg, extra, key):
            del net, key
            acc, count, t = extra
            take = (t >= start).float()
            acc = tree_map(lambda a, p: a + take * p.float(), acc,
                           avg.params)
            count = count + take
            denom = torch.clamp(count, min=1.0)
            have_mean = count > 0
            new_params = tree_map(
                lambda p, a: torch.where(
                    have_mean,
                    (1.0 - beta) * p.float() + beta * (a / denom),
                    p.float()).to(p.dtype),
                avg.params, acc)
            return (NetState(new_params, avg.model_state),
                    (acc, count, t + 1))

        return update

    def _window_carry_init(self):
        return self._savg_state

    def _window_carry_commit(self, extra) -> None:
        self._savg_state = extra

    def _server_update(self, old_net, avg_net):
        new_net, self._savg_state = self._window_server_update()(
            old_net, avg_net, self._savg_state, None)
        return new_net

    # -- checkpoint/resume: the running mean is run state -------------------
    def checkpoint_extra_state(self):
        acc, count, t = self._savg_state
        return {"savg_acc": acc, "savg_count": count, "savg_t": t}

    def load_checkpoint_extra_state(self, extra) -> None:
        self._savg_state = (extra["savg_acc"], extra["savg_count"],
                            extra["savg_t"])
