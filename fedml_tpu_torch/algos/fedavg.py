"""FedAvg — synchronous federated averaging on one card (port of
``fedml_tpu/algos/fedavg.py``'s ``FedAvgAPI``).

Sampled clients are a leading tensor dim; each local step of the whole
cohort runs under ``vmap`` (``parallel.shard.make_vmap_round``), and the
new global model is the sample-weighted client average. Ported: the
single-device case, over a resident ``FederatedArrays`` or a
host-resident ``data.store.FederatedStore`` (reference-scale client
counts: the store puts each round's cohort on the card, prefetched on a
worker thread while the previous round trains), with its knobs:
``client_selection`` (``random``, ``pow_d``: the highest-loss of ``d``
count-weighted candidates, scored by one captured eval; ``oort``: utility
selection from the in-round training losses), ``compress`` (``topk<r>``
and ``q<bits>`` applied to each client's delta inside the round),
``compute_layout`` (``auto``: a channel-padded client step; ``im2col``:
the CNN's stem as a GEMM; ``parallel/layout.py``) and
``client_step_dtype`` (``bf16`` client compute over f32 params), and
four tiers of rounds:

- ``train_one_round`` (and ``train``): one FUSED round — the client
  gather, local training, the average and the server update as one step,
  captured as a CUDA graph and replayed each round (``core/graph.py``;
  JAX: one donated dispatch per round). From a store the step takes the
  prefetched cohort as its args, one graph per step bucket;
- ``train_rounds_pipelined``: the same rounds without a host sync between
  them, the losses fetched once;
- ``train_rounds_windowed`` (and ``train_windowed``, store only): W
  rounds' cohorts gathered as one superbatch, one copy per field, and the
  same captured step replayed W times at the window's bucket, with no
  host sync inside the window (JAX: one ``lax.scan`` over the window);
- ``train_rounds_on_device`` (resident only): one captured round with
  the cohort drawn on the device from the round's key, replayed once per
  round (JAX: one ``lax.scan`` over rounds).

On the CPU (``device="cpu"``) the same steps run eagerly. ``run_round``
+ ``_server_update`` stay as the eager reference procedure. A class whose
round has no fused step (a ``_server_update`` without its pure form;
oort's three-output round) trains through the HOST round of
``train_one_round``: the round captured as its own step (the cohort
gather, the training and the average), then ``_server_update`` on the
host side, then oort's utility update. Which tiers a
subclass rides is its capability record's answer (``algos/capability``);
the hooks the algorithm zoo builds on are ``_build_local_train``,
``_client_transform``, ``_corruptor``, ``_make_vmap_round``, the pure
server update of the carry protocol, ``_round_aux`` (per-round operands
computed on the host, passed to the captured steps as device tensors)
and, for the "custom" protocol, a whole published step
(``_build_fused_step``) over client-stacked state. ``cfg.aggregator``
picks the server reduction (``core/robust_agg``). Meshes and the fields of
:data:`UNPORTED_FIELDS` are not ported yet: asking for any of them
raises, by name.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from fedml_tpu_torch.algos.capability import refusal
from fedml_tpu_torch.algos.config import FedConfig
from fedml_tpu_torch.algos.loop import FederatedLoop, eval_segments
from fedml_tpu_torch.core import keys
from fedml_tpu_torch.core.compression import (_check_bits, dequantize,
                                              quantize_stochastic,
                                              topk_compress, tree_spec,
                                              tree_to_vector, vector_to_tree)
from fedml_tpu_torch.core.device import resolve_device
from fedml_tpu_torch.core.graph import CapturedStep
from fedml_tpu_torch.core.robust_agg import make_aggregator
from fedml_tpu_torch.core.sampling import sample_clients_weighted
from fedml_tpu_torch.data.batching import FederatedArrays, gather_clients
from fedml_tpu_torch.data.store import (CohortPrefetcher, FederatedStore,
                                        WindowPrefetcher)
from fedml_tpu_torch.obs.sanitizer import planned_transfer
from fedml_tpu_torch.parallel.layout import (compute_layout, im2col_layout,
                                             step_dtype_model,
                                             wrap_local_train)
from fedml_tpu_torch.parallel.shard import (make_fused_round_step,
                                            make_vmap_round)
from fedml_tpu_torch.trainer.local import (NetState, make_client_optimizer,
                                           make_eval_fn, make_local_train_fn,
                                           model_fns, softmax_ce)

#: FedConfig fields that the JAX FedAvgAPI reads and the port does not
#: implement yet, each with the ROADMAP.md queue that ports it; a
#: non-default value is refused at construction.
UNPORTED_FIELDS = {
    "remat": "A3", "dp_clip": "A3", "dp_noise_multiplier": "A3",
    "wire_codec": "A10", "ingest_workers": "A10",
    "group_reduce": "A11",
}
#: fold_in child of a round's key that draws its on-device cohort, as in
#: the JAX package's train_rounds_on_device.
_COHORT_TAG = 0x5A


def plan_window_spans(buckets, window: int):
    """Splits a run of rounds (each round's cohort step bucket) into spans
    ``(offset, length, steps-or-None)`` in order: consecutive chunks of
    exactly ``window`` rounds run windowed at the chunk's LARGEST bucket
    (a smaller round's extra pad steps are exact no-ops), the remainder
    (< window rounds) runs through the fused host round (``None``). So
    the captures stay bounded by the distinct window buckets."""
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    spans, n = [], len(buckets)
    lo = 0
    while n - lo >= window:
        spans.append((lo, window, max(buckets[lo:lo + window])))
        lo += window
    if lo < n:
        spans.append((lo, n - lo, None))
    return spans


def refuse_unported(cfg, fields=UNPORTED_FIELDS, who="FedAvgAPI"):
    defaults = {f.name: f.default for f in dataclasses.fields(FedConfig)}
    for name, label in fields.items():
        val = getattr(cfg, name, defaults[name])
        if val != defaults[name]:
            raise NotImplementedError(
                f"cfg.{name}={val!r} is not ported yet to the PyTorch "
                f"{who} (ROADMAP.md {label}); leave it at "
                f"{defaults[name]!r}")


class FedAvgAPI(FederatedLoop):
    """Federated trainer on one card. ``model`` is an ``nn.Module`` whose
    own parameters are the initial global model (``api.net`` is public and
    may be replaced); ``train_fed`` a ``FederatedArrays`` or a
    ``FederatedStore`` on ``device`` (``None`` → cuda); ``test_global``
    an ``(x, y, mask)`` triple from ``data.batching.batch_global`` or
    None. ``pad_id`` marks padding in
    sequence labels (excluded from eval accuracy); it must match the pad
    id of a sequence ``loss_fn`` (``partial(seq_softmax_ce, pad_id=...)``).

    On cuda the rounds replay captured CUDA graphs whose carry is donated:
    after a round, ``api.net`` holds the graph's static buffers, which the
    next round overwrites in place. Clone what must outlive a round; a
    replaced ``api.net`` is copied into the buffers (or captured anew at
    another shape), and a replaced ``api.train_fed`` is captured anew.
    """

    #: Set True by the one subclass that reads cfg.adapter_rank
    #: (FedAdapterAPI); every other trainer class refuses the flag, which
    #: would otherwise silently train the dense model.
    _consumes_adapter_cfg = False

    #: A class whose rounds read client-stacked data outside the cohort
    #: sets this False: a store is then refused at construction.
    supports_streaming = True

    #: How this algorithm rides the round tiers (the JAX package's carry
    #: protocol): "round" means its round is exactly ``run_round`` +
    #: ``_server_update``, with the PURE form of the server update from
    #: :meth:`_window_server_update`; "custom" means the class publishes
    #: its own one-round step (:meth:`_build_fused_step`), which takes the
    #: cohort ``idx`` and its update mask as trailing operands and carries
    #: client-stacked state (SCAFFOLD, FedDyn, Ditto, FedBN). The
    #: capability record is derived from it.
    window_protocol: Optional[str] = "round"

    def __init__(self, model, train_fed: FederatedArrays, test_global,
                 cfg: FedConfig, mesh=None, loss_fn=softmax_ce,
                 pad_id: int = 0, nan_guard: bool = False, device=None):
        if mesh is not None:
            raise NotImplementedError(
                "a client mesh is not ported yet (ROADMAP.md A11); the port "
                "trains every client on one card")
        self.train_fed = train_fed
        self._check_layout()
        if self._streaming and not type(self).supports_streaming:
            raise NotImplementedError(
                f"{type(self).__name__} keeps per-client state device-"
                "resident (or gathers clients on device) and does not "
                "support FederatedStore streaming; use the resident "
                "FederatedArrays layout")
        self._check_step_cfg(cfg)
        refuse_unported(cfg)
        if cfg.adapter_rank and not self._consumes_adapter_cfg:
            raise NotImplementedError(
                f"cfg.adapter_rank={cfg.adapter_rank} configures frozen-base "
                "adapter finetuning; use FedAdapterAPI (algos/fedadapter.py)"
                f" — on {type(self).__name__} the flag would be silently "
                "inert")
        self.device = resolve_device(device)
        fd, dev = train_fed.device, self.device
        if fd.type != dev.type or (fd.index is not None and dev.index
                                   is not None and fd.index != dev.index):
            raise ValueError(f"train_fed lies on {train_fed.device}, the "
                             f"driver runs on {self.device}")
        if cfg.batch_size != train_fed.batch_size:
            raise ValueError(
                f"cfg.batch_size={cfg.batch_size} != packed client batch "
                f"size {train_fed.batch_size}; build_federated_arrays with "
                "the same batch_size as the config")
        self.cfg = cfg
        self._aggregator = make_aggregator(cfg.aggregator)
        if not self._aggregator.is_mean:
            self._check_aggregator(cfg.aggregator)
        if (cfg.corrupt_mode != "none"
                and type(self)._corruptor is FedAvgAPI._corruptor):
            raise NotImplementedError(
                f"cfg.corrupt_mode={cfg.corrupt_mode!r} drives the device-"
                "side corruption drill, which needs adversary wiring "
                "(per-round adversary masks); use FedAvgRobustAPI — on "
                f"{type(self).__name__} the flag would be silently inert")
        self.test_global = test_global
        self.model = model.to(self.device)
        self.fns = self._model_fns(self.model)
        self._loss_fn, self._nan_guard = loss_fn, nan_guard
        self._client_lr = cfg.lr
        #: The captured steps by tier, dropped when the round changes.
        self._graphs: Dict[str, CapturedStep] = {}
        self._setup_client_step(cfg)
        self._build_round(cfg.lr)
        self.eval_fn = make_eval_fn(self.fns.apply, loss_fn, pad_id)
        self.rng = keys.split(keys.key(cfg.seed, self.device))[0]
        self.net = self.fns.init(torch.Generator().manual_seed(cfg.seed))
        self._sample_cache = None
        if cfg.client_selection == "oort":
            rec = self.capability()
            if (rec.custom_round or rec.custom_step
                    or self.window_protocol != "round"):
                # The utility update lives in FedAvgAPI's round; a custom
                # round that skipped it would silently degenerate oort to
                # pure exploration (uniform sampling).
                raise NotImplementedError(
                    f"{type(self).__name__} runs a custom round (capability "
                    "record) and would skip oort's per-round utility "
                    "update; oort serves the FedAvg family's shared round "
                    "only")
            n = cfg.client_num_in_total
            self._oort_utility = np.zeros(n, np.float64)
            self._oort_last = np.full(n, -1, np.int64)

    def _check_step_cfg(self, cfg) -> None:
        """The guards of ``compute_layout`` and ``client_step_dtype``, with
        the JAX package's words: both wrap the shared
        ``_build_local_train``, and a layout's padded leaves would take DP
        noise in their pad block."""
        custom_trainer = (type(self)._build_local_train
                          is not FedAvgAPI._build_local_train)
        layout = cfg.compute_layout or "none"
        if layout != "none":
            if layout not in ("auto", "im2col"):
                raise ValueError(
                    f"cfg.compute_layout={layout!r}: expected 'none', "
                    "'auto' or 'im2col'")
            if custom_trainer:
                raise NotImplementedError(
                    f"{type(self).__name__} builds its own local trainer; "
                    "cfg.compute_layout wraps the shared "
                    "_build_local_train only (the flag would otherwise be "
                    "silently inert)")
            if cfg.dp_noise_multiplier > 0:
                raise NotImplementedError(
                    "cfg.compute_layout cannot compose with DP noise "
                    "(dp_noise_multiplier > 0): the per-parameter noise "
                    "draw shapes follow the physical layout, which breaks "
                    "the padded-vs-logical exactness contract — run DP-SGD "
                    "at the logical layout")
        dtype = cfg.client_step_dtype or "fp32"
        if dtype not in ("fp32", "bf16"):
            raise ValueError(
                f"cfg.client_step_dtype={dtype!r}: expected 'fp32' or "
                "'bf16'")
        if dtype == "bf16" and custom_trainer:
            raise NotImplementedError(
                f"{type(self).__name__} builds its own local trainer; "
                "cfg.client_step_dtype wraps the shared _build_local_train "
                "only (the flag would otherwise be silently inert)")

    def _setup_client_step(self, cfg) -> None:
        """The client step's physical model: the compute layout's twin
        (``_layout``, ``None`` when the policy pads nothing) and the bf16
        step's clone of it (``_step_fns``). Everything above the step keeps
        the logical model."""
        self._layout = self._step_fns = None
        base = self.model
        layout = cfg.compute_layout or "none"
        if layout != "none":
            fed = self.train_fed
            sample = (fed.example_input() if self._streaming
                      else fed.x[0, 0])
            built = (im2col_layout(self.model, sample) if layout == "im2col"
                     else compute_layout(self.model, sample))
            if not built.is_identity:
                self._layout = built
                base = built.physical_model
        if (cfg.client_step_dtype or "fp32") == "bf16":
            self._step_fns = model_fns(step_dtype_model(base,
                                                        torch.bfloat16))
        elif self._layout is not None:
            self._step_fns = model_fns(base)

    def _check_aggregator(self, name) -> None:
        """The guard on a non-mean ``cfg.aggregator``. A class that runs
        the two-stage (within-group, then across-group) aggregation
        declares ``composes_group_aggregation`` on ITSELF (its
        ``__dict__``: a subclass that customizes the round again must not
        inherit the exemption) and takes only a ``group_composable``
        aggregator; any other class whose round, its construction or its
        step is its own is refused, as its aggregation would silently stay
        its own."""
        cls = type(self)
        if cls.__dict__.get("composes_group_aggregation", False):
            if not getattr(self._aggregator, "group_composable", False):
                raise NotImplementedError(
                    f"cfg.aggregator={name!r} does not compose group-wise "
                    "(krum needs pairwise client distances, "
                    "geometric_median a joint fixpoint); "
                    f"{cls.__name__} aggregates within groups then across "
                    "group partials — use a composable aggregator "
                    "(coord_median, trimmed_mean<beta>) here, or the flat "
                    "FedAvg family for the exact full-cohort path")
            return
        rec = self.capability()
        if rec.custom_round or rec.custom_builders or rec.custom_step:
            raise NotImplementedError(
                f"{cls.__name__} customizes the round or its "
                f"aggregation; cfg.aggregator={name!r} only "
                "rides the FedAvg family's shared round (a custom round "
                "would silently keep its own aggregation)")

    def _model_fns(self, model):
        """The functional model interface that the round and the
        evaluation are built on. FedAdapterAPI returns the adapter-level fns here (``init`` →
        the trainable adapter tree, ``apply`` → the frozen base with the
        adapters per call), so the rest of FedAvg runs on the adapter tree
        unchanged."""
        return model_fns(model)

    def _build_round(self, lr: float) -> None:
        cfg = self.cfg
        optimizer = make_client_optimizer(cfg.client_optimizer, lr, cfg.wd,
                                          cfg.grad_clip)
        self.local_train = self._build_local_train(optimizer, self._loss_fn)
        self.round_fn = self._make_vmap_round(
            self.local_train, self._client_transform(), self._nan_guard)

    # --- hooks the algorithms override -------------------------------------
    def _build_local_train(self, optimizer, loss_fn):
        """The local trainer; FedProx adds its proximal gradient here. The
        shared one runs the client step's physical model (a layout's twin,
        a bf16 clone) behind the logical-shape contract."""
        if self._step_fns is None:
            return make_local_train_fn(self.fns.apply, optimizer,
                                       self.cfg.epochs, loss_fn)
        inner = make_local_train_fn(self._step_fns.apply, optimizer,
                                    self.cfg.epochs, loss_fn)
        if self._layout is None:
            return inner
        return wrap_local_train(inner, self._layout)

    def _make_vmap_round(self, local_train, transform, guard):
        """The round builder; FedNova wraps its normalized averaging
        around it. Under oort the round also returns the clients' in-round
        training losses (the utility observable)."""
        return make_vmap_round(
            local_train, client_transform=transform, nan_guard=guard,
            aggregator=self._aggregator, corruptor=self._corruptor(),
            with_client_losses=self.cfg.client_selection == "oort")

    def _client_transform(self):
        """``(global_net, client_net) -> client_net`` applied to each
        trained client before aggregation: the compression of
        ``cfg.compress`` (a class that replaces the hook, robust clipping,
        refuses ``cfg.compress``)."""
        return self._compress_transform()

    def _compress_transform(self):
        """``cfg.compress`` as the transform of each client's delta inside
        the round (simulated communication-constrained FL): ``topk<r>``
        keeps the top ``r`` fraction of the flattened delta's entries by
        magnitude (``torch.topk`` under the round's ``vmap``), the others
        at the global model's values; ``q<bits>``
        quantizes it stochastically (unbiased), on the client's stream
        ``fold_in(rng, 0x7F)`` (the three-argument transform). The trained
        state (BatchNorm's stats) passes as it is."""
        name = self.cfg.compress or "none"
        if name == "none":
            return None
        if name.startswith("topk"):
            try:
                ratio = float(name[len("topk"):])
            except ValueError:
                raise ValueError(
                    f"cfg.compress={name!r}: expected 'topk<ratio>' with a "
                    "numeric ratio, e.g. 'topk0.05'") from None
            if not 0 < ratio <= 1:
                raise ValueError(f"topk ratio must be in (0, 1], got {ratio}")

            def transform(global_net, client_net):
                gvec = tree_to_vector(global_net.params)
                cvec = tree_to_vector(client_net.params)
                k = max(1, int(round(ratio * gvec.shape[0])))
                _, idx, _ = topk_compress(cvec - gvec, k)
                # The client's own values where the delta is kept (JAX adds
                # the kept deltas back to the global vector: the same up to
                # one rounding), so topk1.0 is the plain round exactly.
                kept = gvec.scatter(0, idx, torch.gather(cvec, 0, idx))
                return NetState(vector_to_tree(kept,
                                               tree_spec(global_net.params)),
                                client_net.model_state)

            return transform
        if name.startswith("q"):
            try:
                bits = int(name[1:])
            except ValueError:
                raise ValueError(f"cfg.compress={name!r}: expected "
                                 "'q<bits>', e.g. 'q8'") from None
            _check_bits(bits)  # at construction, not at the first round

            def transform(global_net, client_net, rng):
                gvec = tree_to_vector(global_net.params)
                delta = tree_to_vector(client_net.params) - gvec
                q, scale = quantize_stochastic(delta, bits, rng)
                return NetState(vector_to_tree(gvec + dequantize(q, scale),
                                               tree_spec(global_net.params)),
                                client_net.model_state)

            transform.wants_rng = True
            return transform
        raise ValueError(f"cfg.compress={name!r}: simulator rounds support "
                         "'topk<ratio>' or 'q<bits>'")

    def _corruptor(self):
        """The device-side attack drill (``UpdateCorruptor.device_fn()``),
        or None; a class that arms it supplies the per-round adversary
        mask through ``_round_aux``."""
        return None

    def set_client_lr(self, lr: float) -> None:
        """Rebuild the round for a new client learning rate (the hook of
        the round-level lr schedules); it takes effect from the next round.
        The captured steps are dropped, as JAX drops its jits, so each
        distinct lr costs one capture per tier. A no-op when the lr is
        unchanged."""
        if lr == self._client_lr:
            return
        self._client_lr = lr
        self._graphs.clear()
        self._on_client_lr_change()
        self._build_round(lr)

    def _on_client_lr_change(self) -> None:
        """Called whenever the client lr actually changes. A subclass that
        holds its own lr-dependent steps drops them here."""

    def _require_plain_sgd_round(self, what: str) -> None:
        """The constructor guard of the algorithms whose local step is their
        own (SCAFFOLD, FedDyn: plain SGD plus the correction; FedNAS,
        FedGAN): a config knob that the generic trainer would honor is
        refused, not dropped (the JAX package's guard, over the fields the
        port has; the unported ones are refused earlier, by
        ``refuse_unported``)."""
        cfg = self.cfg
        if cfg.client_optimizer != "sgd":
            raise ValueError(
                f"{what} applies to plain SGD local steps; got "
                f"client_optimizer={cfg.client_optimizer!r}")
        unsupported = {
            "grad_clip": cfg.grad_clip,
            "compress": cfg.compress if cfg.compress != "none" else None,
            # Their trainers are built outside _build_local_train, where
            # the layout and the bf16 step are wired.
            "compute_layout": (cfg.compute_layout
                               if cfg.compute_layout != "none" else None),
            "client_step_dtype": (cfg.client_step_dtype
                                  if cfg.client_step_dtype not in ("fp32",
                                                                   "")
                                  else None),
        }
        bad = [k for k, v in unsupported.items() if v]
        if self._nan_guard:
            bad.append("nan_guard")
        if bad:
            raise ValueError(f"{what} does not support: " + ", ".join(bad))

    def _server_update(self, old_net, avg_net):
        """FedAvg: the new global model is the client average."""
        return avg_net

    def _eval_net(self):
        return self.net

    # --- checkpoint/resume (obs/checkpoint.py save_run / restore_run) ------
    def checkpoint_extra_state(self):
        """Run state beyond the net, the key and the server optimizer
        state: oort's utilities and last-seen rounds (host arrays), else
        none. A class with more overrides both hooks."""
        if self.cfg.client_selection == "oort":
            return {"oort_utility": self._oort_utility,
                    "oort_last": self._oort_last}
        return {}

    def load_checkpoint_extra_state(self, extra) -> None:
        """Takes back what :meth:`checkpoint_extra_state` gave, restored
        (and forgets the memoized cohort: it was drawn from other
        state)."""
        self._sample_cache = None
        if extra and "oort_utility" in extra:
            self._oort_utility = np.array(extra["oort_utility"])
            self._oort_last = np.array(extra["oort_last"])

    # --- the carry protocol ------------------------------------------------
    def _window_server_update(self):
        """The PURE form of :meth:`_server_update` that the fused and
        on-device steps fold in: ``None`` for plain FedAvg (the new model
        is the average, no carry), else ``(net, avg, extra, key) -> (net',
        extra')`` with ``extra`` the carried server state and ``key`` the
        round's key. A subclass that overrides ``_server_update`` must
        override this too, or its capability record refuses every tier:
        inheriting the plain average would silently change its semantics
        inside the captured step."""
        return None

    def _window_carry_init(self):
        """Extra carry entering a captured step (from instance state).
        Plain FedAvg carries nothing."""
        return None

    def _window_carry_commit(self, extra) -> None:
        """Write the carry coming out of a captured step back to instance
        state, so later rounds and evaluation read it."""

    def _build_fused_step(self):
        """The one-round step the tiers capture: ``step(net, extra, x, y,
        mask, weights, key, *aux) -> ((net', extra'), loss)``, ``round_fn``
        with the pure server update folded in. A "custom"-protocol class
        overrides it; its ``aux`` is ``(idx, umask)``: the cohort's client
        indices and 1 where a sampled client has samples (the slots whose
        state it may write back)."""
        if self.window_protocol != "round":
            raise NotImplementedError(
                refusal(type(self), "the fused round step"))
        return make_fused_round_step(self.round_fn,
                                     self._window_server_update())

    def _fence(self) -> None:
        """Waits for the card: an honest end of a traced span (the host
        loops of hierarchical FL and TurboAggregate fence only when a
        tracer is installed)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def _streaming(self) -> bool:
        """True when the cohorts stream from a host ``FederatedStore``."""
        return isinstance(self.train_fed, FederatedStore)

    def _check_layout(self) -> None:
        """``api.train_fed`` (which may be replaced later) is resident
        ``FederatedArrays`` or a ``FederatedStore``."""
        if not isinstance(self.train_fed, (FederatedArrays, FederatedStore)):
            raise TypeError(
                f"train_fed of type {type(self.train_fed).__name__}: the "
                "rounds take resident FederatedArrays or a FederatedStore")

    def _host_counts(self) -> np.ndarray:
        """The clients' sample counts on the host (fetched once per
        resident dataset)."""
        counts = self.train_fed.counts
        if isinstance(counts, np.ndarray):
            return counts
        cached = getattr(self, "_counts_cache", None)
        if cached is None or cached[0] is not counts:
            cached = self._counts_cache = (counts, counts.cpu().numpy())
        return cached[1]

    def _watched(self):
        """What the captured steps read in place: the resident dataset and
        the module's own tensors (FedAdapter's frozen base)."""
        fed = self.train_fed
        data = ([] if self._streaming
                else [fed.x, fed.y, fed.mask, fed.counts])
        return [*data, *self.model.parameters(), *self.model.buffers()]

    def _captured(self, tier: str, build) -> CapturedStep:
        step = self._graphs.get(tier)
        if step is None:
            step = self._graphs[tier] = CapturedStep(build(), self.device,
                                                     self._watched)
        return step

    # --- fused round: one replay per host-loop round -----------------------
    def _gather_step(self):
        """The published step with the client gather in front: ``((net,
        extra), idx, key, *aux) -> ((net', extra'), loss)``. A "custom"
        step gets ``(idx, umask)`` as its aux, ``umask`` computed on the
        device from the gathered counts (JAX's ``_window_update_mask``),
        so a round needs no host sync."""
        step = self._build_fused_step()
        custom = self.window_protocol == "custom"

        def gather_step(carry, idx, key, *aux):
            sub = gather_clients(self.train_fed, idx)
            w = sub.counts.float()
            if custom:
                aux = (idx, (sub.counts > 0).float())
            return step(*carry, sub.x, sub.y, sub.mask, w, key, *aux)

        return gather_step

    def _fused_round_step(self) -> CapturedStep:
        """The cached fused round — client gather, training, aggregation and
        the server update in one captured step (:meth:`_gather_step`); the
        cohort and the round's ``_round_aux`` tensors are step arguments,
        copied in at every replay."""
        return self._captured("fused", self._gather_step)

    def _store_step(self):
        """The published step fed a cohort from the store: ``((net, extra),
        x, y, mask, counts, key, *aux) -> ((net', extra'), loss)``, the
        weights ``counts`` (a "custom" step's aux is ``(idx,)``, its update
        mask computed from ``counts`` on the device). The fused host round
        and the windowed tier replay this one step, captured once per
        step bucket."""
        step = self._build_fused_step()
        custom = self.window_protocol == "custom"

        def store_step(carry, x, y, mask, counts, key, *aux):
            if custom:
                aux = (aux[0], (counts > 0).float())
            return step(*carry, x, y, mask, counts.float(), key, *aux)

        return store_step

    def _stored_round_step(self) -> CapturedStep:
        return self._captured("fused_store", self._store_step)

    def _stream_cohort(self, round_idx: int, idx) -> FederatedArrays:
        """The round's cohort from the host store (prefetched when it
        could be), and, under seeded-random selection, the next round's
        gather and copy started on the prefetcher's worker, to overlap
        this round's training (pow_d and oort depend on the net the round
        produces)."""
        pf = getattr(self, "_cohort_prefetcher", None)
        if pf is None or pf.store is not self.train_fed:
            pf = self._cohort_prefetcher = CohortPrefetcher(self.train_fed)
        sub = pf.get(round_idx, idx)
        # Oort's fallback utility eval reads this instead of a second
        # host gather of the same cohort.
        self._stream_last = (round_idx, np.asarray(idx), sub)
        if (self.cfg.client_selection == "random"
                and round_idx + 1 < self.cfg.comm_round):
            pf.prefetch(round_idx + 1, self.sample_round(round_idx + 1))
        return sub

    def _cohort(self, round_idx: int, idx) -> FederatedArrays:
        """The round's sampled clients: the device gather of the resident
        layout, or the (prefetched) host gather of the store."""
        if self._streaming:
            return self._stream_cohort(round_idx, idx)
        return super()._cohort(round_idx, idx)

    # --- client selection: random, pow_d, oort ---------------------------
    def sample_round(self, round_idx: int):
        """The round's cohort (client indices): the reference's seeded
        draw, Power-of-Choice (``pow_d``, Cho et al. 2020: ``d``
        candidates drawn by data fraction, the current global model
        evaluated on their shards, the ``client_num_per_round`` highest
        losses kept) or Oort (:meth:`_sample_oort`). Memoized per round:
        pow_d and oort depend on the current net, so a class that samples
        again mid-round (Ditto's personal step) must see the cohort the
        round trained."""
        cached = self._sample_cache
        if cached is not None and cached[0] == round_idx:
            return cached[1]
        idx = self._sample_round_uncached(round_idx)
        self._sample_cache = (round_idx, idx)
        return idx

    def _sample_round_uncached(self, round_idx: int):
        cfg = self.cfg
        if cfg.client_selection == "random":
            return super().sample_round(round_idx)
        if cfg.client_selection == "oort":
            return self._sample_oort(round_idx)
        if cfg.client_selection != "pow_d":
            raise ValueError(
                f"unknown client_selection {cfg.client_selection!r}; use "
                "'random', 'pow_d' or 'oort'")
        d = cfg.pow_d_candidates or 2 * cfg.client_num_per_round
        d = min(d, cfg.client_num_in_total)
        m = min(cfg.client_num_per_round, cfg.client_num_in_total)
        if d < m:
            raise ValueError(
                f"pow_d needs at least client_num_per_round candidates "
                f"(d={d} < m={m}); raise --pow_d_candidates")
        directory = getattr(self.train_fed, "directory", None)
        if (directory is not None
                and directory.num_clients == cfg.client_num_in_total):
            candidates = directory.sample_cohort_weighted(round_idx, d)
        else:
            candidates = sample_clients_weighted(
                round_idx, cfg.client_num_in_total, d, self._host_counts())
        losses = (self._cohort_losses_store(candidates) if self._streaming
                  else self._cohort_losses_resident(candidates))
        order = np.argsort(-losses, kind="stable")[:m]
        return candidates[np.sort(order)]

    def _eval_losses_step(self, store: bool):
        """The candidates' eval as one captured step (JAX jits it): ``step(
        net, idx) -> (net, losses [d])`` with the gather inside (resident),
        or ``step(net, x, y, mask) -> (net, losses)`` over a host-gathered
        cohort (store)."""
        def losses_of(net, x, y, mask):
            return net, self._per_client_eval(net, x, y, mask)["loss"]

        if store:
            return losses_of

        def gathered(net, idx):
            sub = gather_clients(self.train_fed, idx)
            return losses_of(net, sub.x, sub.y, sub.mask)

        return gathered

    def _fetch_losses(self, losses) -> np.ndarray:
        with planned_transfer():  # the selection's one fetch
            return losses.double().cpu().numpy()

    def _cohort_losses_resident(self, idx) -> np.ndarray:
        """The current global model's loss on each client of ``idx`` (the
        resident layout): gather and vmapped eval captured as one step.
        Shared by pow_d's candidates and oort's fallback."""
        step = self._captured("cohort_eval",
                              lambda: self._eval_losses_step(False))
        _, losses = step(self._eval_net(), self._cohort_on_device(idx))
        return self._fetch_losses(losses)

    def _cohort_losses_store(self, idx, sub=None) -> np.ndarray:
        """:meth:`_cohort_losses_resident` over a store: the cohort gathered
        on the host (or ``sub``, already gathered), then the captured
        vmapped eval (one graph per step bucket)."""
        if sub is None:
            sub = self.train_fed.gather_cohort(np.asarray(idx))
        step = self._captured("cohort_eval_store",
                              lambda: self._eval_losses_step(True))
        _, losses = step(self._eval_net(), sub.x, sub.y, sub.mask)
        return self._fetch_losses(losses)

    def _sample_oort(self, round_idx: int):
        """Oort's epsilon-greedy utility selection (Lai et al., OSDI'21).
        Exploit: the highest-utility clients seen before, utility = the
        observed in-round training loss x sqrt(n_i) plus
        ``oort_staleness_coef · sqrt(rounds since seen)``. Explore: a
        seeded-uniform draw over the never-seen clients; once they run
        short, over the seen clients outside the exploit set, so the
        epsilon slice keeps exploring. Deterministic given the round index
        and the history."""
        cfg = self.cfg
        n = cfg.client_num_in_total
        k = min(cfg.client_num_per_round, n)
        seen = self._oort_last >= 0
        rs = np.random.RandomState(round_idx)
        n_exploit = min(k - int(np.ceil(cfg.oort_epsilon * k)),
                        int(seen.sum()))
        n_explore = k - n_exploit
        chosen = []
        if n_exploit:
            staleness = np.sqrt(np.maximum(round_idx - self._oort_last, 0))
            score = np.where(
                seen,
                self._oort_utility + cfg.oort_staleness_coef * staleness,
                -np.inf)
            chosen.append(np.argsort(-score, kind="stable")[:n_exploit])
        if n_explore:
            unseen_pool = np.flatnonzero(~seen)
            take_unseen = min(len(unseen_pool), n_explore)
            if take_unseen:
                chosen.append(rs.choice(unseen_pool, take_unseen,
                                        replace=False))
            rest = n_explore - take_unseen
            if rest:
                exploited = (chosen[0] if n_exploit
                             else np.array([], np.int64))
                pool = np.setdiff1d(np.flatnonzero(seen), exploited)
                chosen.append(rs.choice(pool, rest, replace=False))
        return np.sort(np.concatenate(chosen).astype(np.int32))

    def _update_oort_state(self, round_idx: int, idx) -> None:
        """Refresh the trained cohort's utilities from the round's IN-ROUND
        training losses (``_round_client_losses``, the round's third
        output under oort); a round without them (a class whose round is
        built otherwise) falls back to one eval of the new global model on
        the cohort's shards. A non-finite loss counts as 0."""
        idx = np.asarray(idx)
        captured = getattr(self, "_round_client_losses", None)
        if captured is not None:
            self._round_client_losses = None  # one round's observable
            losses = self._fetch_losses(captured)
            losses = np.where(np.isfinite(losses), losses, 0.0)
        elif self._streaming:
            last = getattr(self, "_stream_last", None)
            sub = (last[2] if last is not None and last[0] == round_idx
                   and np.array_equal(last[1], idx) else None)
            losses = self._cohort_losses_store(idx, sub)
        else:
            losses = self._cohort_losses_resident(idx)
        counts = self._host_counts()[idx].astype(np.float64)
        self._oort_utility[idx] = losses * np.sqrt(np.maximum(counts, 1))
        self._oort_last[idx] = round_idx

    def _cohort_on_device(self, idx) -> torch.Tensor:
        """The sampled cohort on the device without waiting for it."""
        if torch.is_tensor(idx):
            return idx.to(self.device, torch.int64)
        return self._to_device(np.asarray(idx, np.int64))

    def _to_device(self, host: np.ndarray) -> torch.Tensor:
        """A host array on the device without waiting for it: through
        pinned memory and a non-blocking copy (the caching host allocator
        keeps the pinned buffer until the copy is done), so the replays
        already queued keep running. Every per-round staging copy of the
        host loop and the windowed tier goes through here (the cohort,
        FedNova's q and γ, the drill's adversary mask, a "custom" step's
        indices), marked as planned for ``obs.sanitizer.sanitized``."""
        t = torch.tensor(host)
        with planned_transfer():
            if self.device.type == "cuda":
                t = t.pin_memory()
            return t.to(self.device, non_blocking=True)

    def _train_round_fused(self, round_idx: int, step=None):
        """One host-loop round through the fused step: ``run_round``'s
        prelude (round key, sampled cohort and the round's aux operands on
        the device, with no sync), one replay, the carry committed back.
        Returns the round's loss, a device tensor that the next round
        overwrites. ``step``: another form of the step, e.g. the
        uncaptured :meth:`_gather_step`, the eager reference of a
        "custom" round (from a store: of :meth:`_store_step`)."""
        self._check_layout()
        streaming = self._streaming
        if step is None:
            step = (self._stored_round_step() if streaming
                    else self._fused_round_step())
        pair = keys.split(self.rng)
        self.rng, rnd_rng = pair[0], pair[1]
        self._last_round_key = rnd_rng
        idx = self.sample_round(round_idx)
        aux = self._round_aux(round_idx, idx)
        carry = (self.net, self._window_carry_init())
        if streaming:
            sub = self._stream_cohort(round_idx, idx)
            if self.window_protocol == "custom":
                aux = (self._cohort_on_device(idx),)
            (self.net, extra), loss = step(carry, sub.x, sub.y, sub.mask,
                                           sub.counts, rnd_rng, *aux)
        else:
            (self.net, extra), loss = step(
                carry, self._cohort_on_device(idx), rnd_rng, *aux)
        self._window_carry_commit(extra)
        return loss

    # --- the host round: the round captured, the server update on the host
    def _host_round_step(self):
        """``round_fn`` with the cohort in front, captured as its own step
        (JAX jits ``run_round``'s round): ``step(net, idx, key, *aux) ->
        (net, out)`` gathering on the device, or ``step(net, x, y, mask,
        counts, key, *aux)`` over a streamed cohort. ``out`` is the round's
        ``(avg, loss[, client losses])``; the carry comes back as given,
        the old net for the server update."""
        round_fn = self.round_fn

        def fed_step(net, x, y, mask, counts, key, *aux):
            w = counts.float()
            return net, round_fn(net, x, y, mask, w, w, key, *aux)

        if self._streaming:
            return fed_step

        def gather_step(net, idx, key, *aux):
            sub = gather_clients(self.train_fed, idx)
            return fed_step(net, sub.x, sub.y, sub.mask, sub.counts, key,
                            *aux)

        return gather_step

    def _train_round_host(self, round_idx: int):
        """One round of JAX's host procedure: ``run_round``'s prelude, the
        captured round (:meth:`_host_round_step`), ``_server_update`` on
        the host side, then oort's utility update. Returns the loss, a
        device tensor that the next round overwrites."""
        self._check_layout()
        streaming = self._streaming
        step = self._captured("host_store" if streaming else "host",
                              self._host_round_step)
        pair = keys.split(self.rng)
        self.rng, rnd_rng = pair[0], pair[1]
        self._last_round_key = rnd_rng
        idx = self.sample_round(round_idx)
        aux = self._round_aux(round_idx, idx)
        if streaming:
            sub = self._stream_cohort(round_idx, idx)
            old, out = step(self.net, sub.x, sub.y, sub.mask, sub.counts,
                            rnd_rng, *aux)
        else:
            old, out = step(self.net, self._cohort_on_device(idx), rnd_rng,
                            *aux)
        avg, loss = self._unpack_round(out)
        self.net = self._server_update(old, avg)
        if self.cfg.client_selection == "oort":
            self._update_oort_state(round_idx, idx)
        return loss

    def _uses_fused_round(self) -> bool:
        """Whether the host loop replays the fused step (else the host
        round): the record's fused step, and not oort's three-output
        round."""
        return (self.capability().fused
                and self.cfg.client_selection != "oort")

    def train_one_round(self, round_idx: int) -> Dict[str, float]:
        if self._uses_fused_round():
            loss = self._train_round_fused(round_idx)
        else:
            rec = self.capability()
            self._require("train_one_round", rec.protocol != "custom"
                          and not rec.custom_round)
            loss = self._train_round_host(round_idx)
        with planned_transfer():  # the synced loop's one fetch a round
            return {"round": round_idx, "train_loss": float(loss)}

    def train_rounds_pipelined(self, n_rounds: int, start_round: int = 0):
        """``n_rounds`` host-loop rounds back to back WITHOUT a host sync
        between them: each round's replay is queued as soon as its cohort
        is on the device, and the losses are fetched once at the end.
        Per-round semantics are those of ``train_one_round`` in a loop
        (test-pinned bit-equal); no evaluation. Oort is refused: its
        utility update needs each round's losses on the host."""
        self._require("train_rounds_pipelined", self.capability().pipelined)
        if self.cfg.client_selection == "oort":
            raise NotImplementedError(
                "oort updates per-client utilities after every round "
                "(train_one_round); the pipelined loop skips that hook — "
                "use the per-round loop")
        if self.cfg.client_selection == "pow_d":
            raise NotImplementedError(
                "pow_d scores its candidates with the current net every "
                "round, a host sync between rounds that the pipelined loop "
                "exists to avoid — use the per-round loop")
        run = (self._train_round_fused if self._uses_fused_round()
               else self._train_round_host)
        losses = [run(r).clone()
                  for r in range(start_round, start_round + n_rounds)]
        with planned_transfer():  # the loop's one host sync, by design
            return torch.stack(losses).tolist() if losses else []

    # --- on-device rounds: one captured round, replayed per round ----------
    def _device_cohort(self, key) -> Optional[torch.Tensor]:
        """The cohort of the round with ``key``, drawn on the device
        (uniform without replacement, the JAX package's ``choice(fold_in(
        key, 0x5A), ...)``); ``None`` at full participation, where the
        gather is the identity and is skipped."""
        n = self.train_fed.num_clients
        k = min(self.cfg.client_num_per_round, n)
        if k == n:
            return None
        return keys.choice(keys.fold_in(key, _COHORT_TAG), n, k)

    def train_rounds_on_device(self, n_rounds: int) -> torch.Tensor:
        """``n_rounds`` whole rounds with the cohort drawn on the device:
        one captured round, replayed once per round with the round's key
        copied in — no host sync and no host sampling between rounds.
        Returns the per-round losses as a ``[n_rounds]`` device tensor.

        The keys are the host loop's own ``keys.split`` chain, so at FULL
        participation this is bit-equal to the host loop (test-pinned);
        with subsampling the cohorts come from the keys, not from the
        reference's ``np.random.seed(round_idx)`` stream, as in JAX. The
        incoming ``api.net`` is donated (see the class docstring). A class
        whose round takes per-round host operands (``_round_aux``) is
        refused by its record."""
        self._require("train_rounds_on_device", self.capability().on_device)
        self._check_layout()
        if self._streaming:
            raise NotImplementedError(
                "train_rounds_on_device needs the whole dataset device-"
                "resident (the scan gathers clients on device each round); "
                "FederatedStore streams cohorts from host — use the host "
                "loop")
        if self.cfg.client_selection != "random":
            raise NotImplementedError(
                "train_rounds_on_device samples uniformly on device; "
                "loss-biased selection (pow_d/oort) needs the host loop")

        def build():
            step = self._build_fused_step()

            def round_step(carry, key):
                fed = self.train_fed
                idx = self._device_cohort(key)
                sub = fed if idx is None else gather_clients(fed, idx)
                w = sub.counts.float()
                return step(*carry, sub.x, sub.y, sub.mask, w, key)

            return round_step

        step = self._captured("on_device", build)
        round_keys = []
        for _ in range(n_rounds):
            pair = keys.split(self.rng)
            self.rng = pair[0]
            round_keys.append(pair[1])
        losses = torch.empty(n_rounds, dtype=torch.float32,
                             device=self.device)
        carry = (self.net, self._window_carry_init())
        for r, key in enumerate(round_keys):
            carry, loss = step(carry, key)
            losses[r].copy_(loss)
        self.net, extra = carry
        self._window_carry_commit(extra)
        return losses

    # --- the windowed tier: W replays per superbatch -----------------------
    def _window_scan_extras(self, start_round: int, idx2d):
        """The per-round trailing operands of a window as ``[W, ...]``
        device tensors, sliced per replay: a "custom" step's cohort
        indices ``[W, k]``; a "round" step's ``_round_aux`` of each round,
        stacked (FedNova's q and γ, the attack drill's adversary mask)."""
        if self.window_protocol == "custom":
            return (self._to_device(np.asarray(idx2d, np.int64)),)
        per_round = [self._round_aux(start_round + t, idx)
                     for t, idx in enumerate(idx2d)]
        return tuple(torch.stack(col) for col in zip(*per_round))

    def _check_windowed_supported(self) -> None:
        """The guard of the windowed tier, on the capability record, with
        the JAX package's reasons."""
        if self.window_protocol not in (None, "round", "custom"):
            raise NotImplementedError(
                f"unknown window_protocol {self.window_protocol!r}; "
                "declare 'round', 'custom', or None")
        cls = type(self)
        if (self.window_protocol == "custom"
                and cls._window_carry_init is not FedAvgAPI._window_carry_init
                and cls._window_carry_commit
                is FedAvgAPI._window_carry_commit):
            raise NotImplementedError(
                f"{cls.__name__} overrides _window_carry_init without "
                "_window_carry_commit; the scanned-out carry would be "
                "silently discarded")
        self._require("train_rounds_windowed", self.capability().windowed)
        self._check_layout()
        if not self._streaming:
            raise NotImplementedError(
                "windowed execution streams window superbatches from a "
                "FederatedStore; the resident layout already has the "
                "stronger train_rounds_on_device scan")
        if self.cfg.client_selection != "random":
            raise NotImplementedError(
                "windowed execution gathers the next W rounds' cohorts in "
                "advance, which only seeded-random selection permits; "
                "pow_d/oort depend on the current net — use the per-round "
                "host loop")

    def train_rounds_windowed(self, n_rounds: int, start_round: int = 0,
                              window: int = 8):
        """``n_rounds`` store-backed rounds, host syncs amortized over
        windows of ``window`` rounds. Seeded-random selection makes every
        upcoming cohort known, so each window's cohorts are gathered as ONE
        ``[W, k, S, B, ...]`` superbatch (``FederatedStore.gather_window``,
        its gather and copy overlapping the previous window's replays on
        ``WindowPrefetcher``'s worker), and the store round's captured step
        (:meth:`_store_step`, the fused host round's own) is replayed once
        per round at the window's bucket, each round's slice copied into
        its args on the device, its key from the host loop's
        ``keys.split`` chain. No host sync inside a window; the carry is
        committed after each window, and the losses fetched once.

        The params and the carry are BIT-EQUAL to the host loop under the
        same seeds (test-pinned): a round trained at the window's larger
        bucket takes extra all-masked steps, which the trainer gates out,
        and its shuffle is prefix-stable in the slot count
        (``trainer.local.epoch_perm``). Remainder rounds (< window) run
        through the fused host round. The captures stay bounded by the
        distinct window buckets; ``api._window_stats`` records the split.
        Returns the per-round losses."""
        self._check_windowed_supported()
        store = self.train_fed
        cohorts = [np.asarray(self.sample_round(start_round + t))
                   for t in range(n_rounds)]
        spans = plan_window_spans([store.cohort_steps(idx)
                                   for idx in cohorts], window)
        scan_spans = [s for s in spans if s[2] is not None]
        windowed = sum(s[1] for s in scan_spans)
        self._window_stats = {"windows": len(scan_spans),
                              "scanned_rounds": windowed,
                              "host_rounds": n_rounds - windowed}
        pf = getattr(self, "_window_prefetcher", None)
        if pf is None or pf.store is not store:
            pf = self._window_prefetcher = WindowPrefetcher(store)

        def span_args(span):
            off, length, steps = span
            return (start_round + off,
                    np.stack([cohorts[off + t] for t in range(length)]),
                    steps)

        if scan_spans:
            pf.prefetch(*span_args(scan_spans[0]))
        losses = []
        for span in spans:
            off, length, steps = span
            if steps is None:
                for t in range(length):
                    losses.append(self._train_round_fused(
                        start_round + off + t).clone())
                continue
            first, idx2d, _ = span_args(span)
            batch = pf.get(first, idx2d, steps)
            later = [s for s in scan_spans if s[0] > off]
            if later:
                pf.prefetch(*span_args(later[0]))
            extras = self._window_scan_extras(first, idx2d)
            step = self._stored_round_step()
            carry = (self.net, self._window_carry_init())
            for t in range(length):
                pair = keys.split(self.rng)
                self.rng, rnd_rng = pair[0], pair[1]
                self._last_round_key = rnd_rng
                carry, loss = step(carry, batch.x[t], batch.y[t],
                                   batch.mask[t], batch.counts[t], rnd_rng,
                                   *(e[t] for e in extras))
                losses.append(loss.clone())
            self.net, extra = carry
            self._window_carry_commit(extra)
        with planned_transfer():  # the loop's one host sync, by design
            return torch.stack(losses).tolist() if losses else []

    def train_windowed(self, window: int = 8):
        """The whole training loop (``train``'s history: eval every
        ``frequency_of_the_test`` rounds and on the last) on the windowed
        tier: the rounds between eval points run through
        :meth:`train_rounds_windowed`, so a window never crosses a round
        the host evaluates after."""
        self._check_windowed_supported()
        history = []
        for lo, hi in eval_segments(self.cfg.comm_round,
                                    self.cfg.frequency_of_the_test):
            seg = self.train_rounds_windowed(hi - lo + 1, start_round=lo,
                                             window=window)
            for i, loss in enumerate(seg):
                history.append({"round": lo + i, "train_loss": loss})
            history[-1].update(self.evaluate())
        return history
