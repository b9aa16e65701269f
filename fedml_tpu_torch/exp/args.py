"""Canonical experiment flags (port of ``fedml_tpu/exp/args.py``).

Mirrors the reference's argparse set 1:1 (fedml_experiments/distributed/
fedavg/main_fedavg.py:46-130) plus fed_launch's scheduler/clipping flags
(fed_launch/main.py:148-165), so reference launch commands port unchanged:

    python -m fedml_tpu_torch.exp.main_fedavg --model resnet56 \
        --dataset cifar10 --partition_method hetero \
        --client_num_in_total 10 ...

The flags and their defaults are the JAX package's, plus one:
``--device`` (``cuda`` by default; ``cpu`` runs on the CPU, as the tests
do), since every entry point of the port takes a device. Flags of paths
the port has not ported yet are refused by name with the ROADMAP.md queue
that ports them (:func:`reject_unported_flags`); the guards that the JAX
runners raise themselves keep their words.
"""

from __future__ import annotations

import argparse

from fedml_tpu_torch.algos.config import FedConfig


def add_args(parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
    p = parser
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default: the card; raises without one) | "
                        "cpu")
    p.add_argument("--model", type=str, default="resnet56")
    p.add_argument("--dataset", type=str, default="cifar10")
    p.add_argument("--data_dir", type=str, default=None)
    p.add_argument("--partition_method", type=str, default="hetero")
    p.add_argument("--partition_alpha", type=float, default=0.5)
    p.add_argument("--client_num_in_total", type=int, default=10)
    p.add_argument("--client_num_per_round", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--client_optimizer", type=str, default="sgd")
    p.add_argument("--backend", type=str, default="collective",
                   help="collective (on-device) | loopback | tcp")
    p.add_argument("--lr", type=float, default=0.03)
    p.add_argument("--wd", type=float, default=1e-4)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--comm_round", type=int, default=10)
    p.add_argument("--is_mobile", type=int, default=0)
    p.add_argument("--frequency_of_the_test", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ci", type=int, default=0)
    # server optimizer family (main_fedopt.py:54-66)
    p.add_argument("--server_optimizer", type=str, default="sgd")
    p.add_argument("--server_lr", type=float, default=1.0)
    p.add_argument("--server_momentum", type=float, default=0.9)
    # fedprox
    p.add_argument("--fedprox_mu", type=float, default=0.1)
    # robust (main_fedavg_robust.py; --attack_freq is the reference's
    # poisoned-worker cadence flag, main_fedavg_robust.py:120)
    p.add_argument("--norm_bound", type=float, default=5.0)
    p.add_argument("--stddev", type=float, default=0.0)
    p.add_argument("--attack_freq", type=int, default=0)
    p.add_argument("--attack_num_adversaries", type=int, default=1)
    # Byzantine-robust aggregation + device-side corruption drill (new
    # capability beyond the reference's clip+noise; docs/ROBUSTNESS.md)
    p.add_argument("--aggregator", type=str, default="mean",
                   help="server aggregation: mean | coord_median | "
                        "trimmed_mean<beta> | krum<f> | "
                        "multi_krum<f>-<m> | geometric_median<iters>")
    p.add_argument("--corrupt_mode", type=str, default="none",
                   choices=["none", "sign_flip", "scale", "nan", "random"],
                   help="device-side update corruption by the adversary "
                        "clients (FedAvgRobust attack drill)")
    p.add_argument("--corrupt_scale", type=float, default=10.0,
                   help="corruption magnitude for sign_flip/scale/random")
    # hierarchical (hierarchical_fl/main.py)
    p.add_argument("--group_comm_round", type=int, default=1)
    p.add_argument("--group_num", type=int, default=2)
    # fed_launch extras (fed_launch/main.py:148-165)
    p.add_argument("--lr_schedule", type=str, default="none",
                   help="none | cosine | step")
    p.add_argument("--lr_decay_rate", type=float, default=0.992)
    p.add_argument("--grad_clip", type=float, default=0.0,
                   help="max grad norm; 0 disables")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize activations in backprop (less HBM)")
    # mesh / sharding (the JAX package's client mesh; not ported, A11)
    p.add_argument("--num_devices", type=int, default=0,
                   help="shard clients over this many devices; 0 = "
                        "single-device vmap")
    # observability (fedml_tpu_torch.obs; the reference hard-wires wandb)
    p.add_argument("--run_dir", type=str, default=None,
                   help="directory for metrics.jsonl + checkpoints")
    p.add_argument("--checkpoint_frequency", type=int, default=0,
                   help="save full run state every N rounds; 0 disables "
                        "(also cfg.checkpoint_every for the distributed "
                        "server's crash-resume checkpoints)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in --run_dir "
                        "(with --checkpoint_frequency the distributed "
                        "server auto-resumes on restart — that is the "
                        "crash-resume contract: rerunning the same "
                        "command continues the run; this flag arms "
                        "restore when checkpointing itself is off, or a "
                        "fresh run needs a clean --run_dir)")
    # Async / buffered serving tiers (algos/fedasync.py, algos/fedbuff.py;
    # docs/ROBUSTNESS.md "Serving under churn"). Read only by the
    # message-passing FedAsync/FedBuff runners — every other main refuses
    # a non-default value via reject_async_tier_flags.
    p.add_argument("--fedasync_alpha", type=float, default=-1.0,
                   help="async mixing rate / fedbuff server step size; "
                        "< 0 keeps the tier default (0.6 async, 1.0 "
                        "fedbuff)")
    p.add_argument("--staleness_exp", type=float, default=0.5,
                   help="polynomial staleness-discount exponent a in "
                        "1/(1+s)^a (fedasync mixing, fedbuff buffer "
                        "weights)")
    p.add_argument("--buffer_k", type=int, default=2,
                   help="fedbuff: aggregate every k accepted arrivals "
                        "(the semi-sync buffer depth)")
    # Distributed control plane (docs/ROBUSTNESS.md "Control plane";
    # read only by the message-passing federations)
    p.add_argument("--round_timeout_s", type=float, default=0.0,
                   help="distributed server: abandon a round after this "
                        "many seconds by evicting the silent ranks and "
                        "aggregating over the survivors (0 = wait forever)")
    p.add_argument("--heartbeat_interval_s", type=float, default=0.0,
                   help="distributed workers: liveness beat cadence while "
                        "training long rounds (0 = uploads only)")
    p.add_argument("--trace", action="store_true",
                   help="federation flight recorder (obs/trace.py): dump "
                        "upload-lifecycle spans as Perfetto-loadable "
                        "Chrome trace JSON + JSONL into --run_dir "
                        "(required), plus the control-plane flight-"
                        "recorder ring on eviction/abort/codec refusal; "
                        "off = strict no-op (docs/OBSERVABILITY.md)")
    p.add_argument("--wandb_project", type=str, default=None)
    p.add_argument("--client_selection", type=str, default="random",
                   choices=["random", "pow_d", "oort"],
                   help="client sampling: uniform (reference parity), "
                        "Power-of-Choice loss-biased selection, or Oort "
                        "epsilon-greedy utility selection")
    p.add_argument("--pow_d_candidates", type=int, default=0,
                   help="pow_d candidate pool size (0 = 2x clients/round)")
    p.add_argument("--oort_epsilon", type=float, default=0.2,
                   help="oort explore fraction per round")
    p.add_argument("--oort_staleness_coef", type=float, default=0.1,
                   help="oort staleness bonus weight")
    p.add_argument("--compress", type=str, default="none",
                   help="update compression. Simulator rounds: none | "
                        "topk<ratio> (on-device, inside the captured "
                        "round). Cross-silo CLI: none | topk<ratio> "
                        "(wire-level with error feedback) | q<bits> "
                        "(stochastic quantization)")
    p.add_argument("--wire_codec", type=str, default="none",
                   help="negotiated wire codec for message-passing "
                        "uploads (cross-silo / FedAsync / FedBuff): none "
                        "| bf16 | fp16 | int8 | topk<ratio> | "
                        "randmask<ratio>, composable as sparsifier+value "
                        "(e.g. topk0.01+int8). Sparsifiers carry "
                        "per-client error feedback; falls back loudly "
                        "against a codec-ignorant peer (comm/codec.py)")
    p.add_argument("--ingest_workers", type=int, default=0,
                   help="parallel server-ingest pool for the message-"
                        "passing tiers (cross-silo / FedAsync / FedBuff, "
                        "comm/ingest.py): N decode+fold worker threads "
                        "pull codec decode and the mean accumulator fold "
                        "off the server's dispatch thread; per-worker "
                        "fixed-point partials merge associative-exactly, "
                        "so any N is bit-equal to N=1. 0 (default) keeps "
                        "the inline fold; mean aggregation only — "
                        "non-mean --aggregator combos refuse loudly")
    p.add_argument("--agg_shards", type=int, default=0,
                   help="sharded aggregation plane for the loopback "
                        "cross-silo runner (comm/shardplane.py): M "
                        "aggregator-shard processes each ingest their "
                        "own client partition (full codec negotiation + "
                        "ingest pool), and the rank-0 coordinator wire-"
                        "merges their int64 fixed-point partials "
                        "BIT-EQUAL to the single-process pool for any "
                        "M. Sync FedAvg + mean aggregation only; 0 "
                        "(default) keeps the single-server ingest path")
    p.add_argument("--secagg", action="store_true",
                   help="dropout-robust secure aggregation "
                        "(comm/secagg.py): pairwise seed-expanded masks "
                        "over the fixed-point int64 uploads cancel "
                        "exactly in the pooled fold, so the server only "
                        "materializes the sum; an eviction triggers a "
                        "t-of-n Shamir seed reveal that subtracts the "
                        "orphaned masks. Sync FedAvg + mean aggregation "
                        "only; needs --ingest_workers > 0 or "
                        "--agg_shards > 0")
    p.add_argument("--secagg_t", type=int, default=0,
                   help="Shamir reveal threshold: survivors needed to "
                        "reconstruct an evicted rank's mask seeds "
                        "(0 = majority of the handshake roster)")
    p.add_argument("--compute_layout", type=str, default="none",
                   help="lane-fill compute layout for the client step: "
                        "none | auto (pad channel dims to the card's "
                        "lane multiples inside the client step; "
                        "logical shapes everywhere else — "
                        "docs/EXECUTION.md MFU playbook) | im2col "
                        "(rephrase the 5x5 stem conv as patches + a 1x1 "
                        "conv — conv lane shaping beyond s2d, "
                        "CNNOriginalFedAvg only)")
    p.add_argument("--client_step_dtype", type=str, default="fp32",
                   help="client-step COMPUTE dtype: fp32 (default) | "
                        "bf16 — layer compute in bfloat16 inside the "
                        "client step; params, gradients, "
                        "optimizer, aggregation and server carry stay "
                        "fp32 (docs/EXECUTION.md MFU playbook)")
    p.add_argument("--group_reduce", action="store_true",
                   help="hierarchical sparse reduction on a client mesh "
                        "(cfg.group_reduce): group-composable "
                        "aggregators aggregate per shard — per HOST on "
                        "a --dcn_hosts pod mesh, ICI-only stage 1 — "
                        "then across the G group partials; "
                        "non-composable aggregators refuse loudly")
    p.add_argument("--dcn_hosts", type=int, default=0,
                   help="shard clients over a DCN×ICI pod mesh: "
                        "num_devices splits as dcn_hosts × "
                        "(num_devices/dcn_hosts) with client groups "
                        "pinned per host (hierarchical group reduction, "
                        "docs/PLATFORMS.md Multi-host; single-process "
                        "runs force the factorization). 0 = flat mesh")
    p.add_argument("--eval_on_clients", action="store_true",
                   help="per-client eval of the global model each eval "
                        "round (reference _local_test_on_all_clients "
                        "cadence; adds worst-client metrics)")
    p.add_argument("--ditto_lam", type=float, default=0.1,
                   help="Ditto proximal strength λ (personal ↔ global "
                        "trade-off; --algorithm Ditto)")
    p.add_argument("--feddyn_alpha", type=float, default=0.01,
                   help="FedDyn dynamic-regularization strength "
                        "(--algorithm FedDyn)")
    p.add_argument("--qffl_q", type=float, default=1.0,
                   help="q-FedAvg fairness exponent (0 = equal-weight "
                        "FedAvg; --algorithm QFedAvg)")
    p.add_argument("--fedac_gamma", type=float, default=2.0,
                   help="FedAc acceleration γ in units of the round's "
                        "local progress (1 = FedAvg; --algorithm FedAc)")
    p.add_argument("--server_avg_coef", type=float, default=0.5,
                   help="server-averaging mix β toward the running mean "
                        "of past globals (0 = FedAvg; --algorithm "
                        "ServerAvg)")
    p.add_argument("--adapter_rank", type=int, default=0,
                   help="frozen-base adapter finetuning (FedAdapter / "
                        "the async tiers' adapter-delta uploads): rank "
                        "of the LoRA pairs injected next to the "
                        "transformer's scoped dense projections; 0 "
                        "(default) trains the dense model. Drivers that "
                        "never read it refuse loudly "
                        "(reject_adapter_flags)")
    p.add_argument("--adapter_scope", type=str, default="attn",
                   choices=["attn", "mlp", "all"],
                   help="which projections get adapter pairs: attention "
                        "qkv+out, the MLP pair, or both")
    p.add_argument("--dp_clip", type=float, default=0.0,
                   help="example-level DP-SGD: per-example grad L2 clip "
                        "(0 disables DP)")
    p.add_argument("--dp_noise_multiplier", type=float, default=0.0,
                   help="DP-SGD Gaussian noise std = multiplier * dp_clip")
    p.add_argument("--sweep_pipe", type=str, default=None,
                   help="named pipe to post a completion line to when the "
                        "run finishes (sweep orchestrator handshake, "
                        "reference fedavg/utils.py:19-27)")
    p.add_argument("--synthetic_samples", type=int, default=0,
                   help="override the synthetic-fallback dataset size "
                        "(zero-egress runs); 0 = loader default")
    # MQTT bridge (reference mqtt_comm_manager.py connects to an external
    # broker; used only with --backend MQTT)
    p.add_argument("--mqtt_host", type=str, default="127.0.0.1")
    p.add_argument("--mqtt_port", type=int, default=1883)
    # Multi-tenant adapter serving plane (fedml_tpu_torch.serve;
    # docs/SERVING.md).
    # Only main_extra's FedBuff runner serves — every other driver refuses
    # these loudly (reject_serve_flags).
    p.add_argument("--serve", action="store_true",
                   help="stand up the multi-tenant adapter serving plane "
                        "next to the FedBuff training fleet: batched "
                        "per-request LoRA inference over one frozen-base "
                        "dispatch (requires --adapter_rank > 0 and the "
                        "transformer_lm model)")
    p.add_argument("--serve_port", type=int, default=0,
                   help="TCP port for the line-delimited-JSON serve front "
                        "end (0 = no socket; in-process traffic only)")
    p.add_argument("--serve_max_batch", type=int, default=32,
                   help="micro-batcher batch size: a batch closes when "
                        "this many requests arrived or the deadline "
                        "expired, whichever is first")
    p.add_argument("--serve_deadline_ms", type=float, default=5.0,
                   help="micro-batcher window: max milliseconds the first "
                        "request of a batch waits for co-batching traffic")
    p.add_argument("--serve_requests", type=int, default=0,
                   help="smoke traffic: issue this many in-process serve "
                        "requests DURING training and report latency "
                        "percentiles in the output (0 = none)")
    # Adaptive federation control (the JAX package's ctrl; docs/ROBUSTNESS.md
    # "Adaptive control"). Only main_extra's FedAsync/FedBuff runners
    # attach a controller — every other driver refuses these loudly
    # (reject_controller_flags).
    p.add_argument("--controller", type=str, default="none",
                   choices=["none", "adaptive"],
                   help="telemetry-driven federation controller: retunes "
                        "the server's knobs (buffer_k, admission cap, "
                        "timeouts) at safe boundaries from live staleness/"
                        "eviction/accuracy telemetry; 'none' leaves every "
                        "knob static")
    p.add_argument("--controller_interval", type=int, default=1,
                   help="control-step cadence in protocol progress units "
                        "(model versions / rounds) between controller "
                        "steps")
    p.add_argument("--controller_band_lo", type=float, default=2.0,
                   help="staleness-p95 guard band floor: below it the "
                        "admission policy relaxes back toward baseline")
    p.add_argument("--controller_band_hi", type=float, default=6.0,
                   help="staleness-p95 guard band ceiling: above it the "
                        "admission policy backs buffer_k off and arms the "
                        "staleness admission cap")
    return p


def reject_fedavg_family_flags(args, algorithm: str) -> None:
    """Refuse FedAvg-family-only flags for algorithms that never read
    them. ``FedAvgAPI.__init__`` guards its OWN subclasses against a
    silently-dropped ``--aggregator``/``--corrupt_mode``, but the
    specialty mains (FedGAN/GKT/NAS/SplitNN/VFL/decentralized/async…)
    construct classes outside that family — without this driver-level
    check the user would believe a Byzantine defense or attack drill is
    active while nothing reads the flag (docs/ROBUSTNESS.md)."""
    bad = []
    if getattr(args, "aggregator", "mean") != "mean":
        bad.append(f"--aggregator {args.aggregator}")
    if getattr(args, "corrupt_mode", "none") != "none":
        bad.append(f"--corrupt_mode {args.corrupt_mode}")
    if bad:
        raise SystemExit(
            f"{algorithm} does not support {', '.join(bad)}: robust "
            "aggregation and the corruption drill ride the FedAvg "
            "family's shared rounds only (the flag would be silently "
            "inert here)")


def reject_async_tier_flags(args, algorithm: str, *,
                            allow_mixing: bool = False) -> None:
    """Refuse the async/buffered-tier knobs for runners that never read
    them (same convention as :func:`reject_fedavg_family_flags`): a
    churn drill whose ``--staleness_exp`` silently does nothing is worse
    than one that refuses. ``allow_mixing`` lets FedAsync — which shares
    ``--fedasync_alpha``/``--staleness_exp`` with FedBuff but has no
    buffer — still refuse a stray ``--buffer_k``."""
    bad = []
    if not allow_mixing:
        if getattr(args, "fedasync_alpha", -1.0) >= 0:
            bad.append(f"--fedasync_alpha {args.fedasync_alpha}")
        if getattr(args, "staleness_exp", 0.5) != 0.5:
            bad.append(f"--staleness_exp {args.staleness_exp}")
    if getattr(args, "buffer_k", 2) != 2:
        bad.append(f"--buffer_k {args.buffer_k}")
    if bad:
        raise SystemExit(
            f"{algorithm} does not support {', '.join(bad)}: staleness "
            "weighting and the arrival buffer belong to the async/"
            "buffered message-passing tiers (FedAsync/FedBuff in "
            "main_extra) — the flag would be silently inert here")


def reject_pod_plane_flags(args, algorithm: str) -> None:
    """Refuse the pod-compute-plane knobs for runners that never read
    them (the PR 4 flag-rejection convention): the bf16 client step and
    the DCN×ICI group reduction ride the FedAvg family's shared round
    builders (exp/run.py); a specialty loop that silently trains fp32
    under ``--client_step_dtype bf16``, or flat under ``--group_reduce``,
    would report the baseline as the optimized arm."""
    bad = []
    if getattr(args, "client_step_dtype", "fp32") not in ("fp32", ""):
        bad.append(f"--client_step_dtype {args.client_step_dtype}")
    if getattr(args, "group_reduce", False):
        bad.append("--group_reduce")
    if getattr(args, "dcn_hosts", 0):
        bad.append(f"--dcn_hosts {args.dcn_hosts}")
    if bad:
        raise SystemExit(
            f"{algorithm} does not support {', '.join(bad)}: the pod "
            "compute plane (bf16 client step, DCN×ICI group reduction) "
            "rides the FedAvg family's shared rounds only (the flag "
            "would be silently inert here)")


def reject_adapter_flags(args, algorithm: str) -> None:
    """Refuse the frozen-base adapter knobs for drivers that never read
    them (the PR 4/14 flag-rejection convention): ``--adapter_rank`` /
    ``--adapter_scope`` configure the LoRA finetune (``FedAdapter`` in
    exp/run.py; the FedAsync/FedBuff runners' adapter-delta uploads via
    ``cfg.adapter_rank``). A specialty driver that silently trained the
    DENSE arm under them would report the wrong experiment — the exact
    baseline-as-treated-arm drift this convention exists to refuse."""
    bad = []
    if getattr(args, "adapter_rank", 0):
        bad.append(f"--adapter_rank {args.adapter_rank}")
    if getattr(args, "adapter_scope", "attn") != "attn":
        bad.append(f"--adapter_scope {args.adapter_scope}")
    if bad:
        raise SystemExit(
            f"{algorithm} does not support {', '.join(bad)}: frozen-base "
            "adapter finetuning rides FedAdapter (exp/run.py) and the "
            "FedAsync/FedBuff adapter-delta uploads only — the flag "
            "would silently train the dense arm here")


def reject_serve_flags(args, algorithm: str) -> None:
    """Refuse the serving-plane knobs for drivers that never stand up a
    plane (the PR 4/14 flag-rejection convention): only main_extra's
    FedBuff runner serves (``fedml_tpu_torch.serve``; docs/SERVING.md). A run
    whose ``--serve_requests`` silently does nothing would report a
    training-only run as a serving benchmark — the flag must refuse,
    not no-op."""
    bad = []
    if getattr(args, "serve", False):
        bad.append("--serve")
    if getattr(args, "serve_port", 0):
        bad.append(f"--serve_port {args.serve_port}")
    if getattr(args, "serve_max_batch", 32) != 32:
        bad.append(f"--serve_max_batch {args.serve_max_batch}")
    if getattr(args, "serve_deadline_ms", 5.0) != 5.0:
        bad.append(f"--serve_deadline_ms {args.serve_deadline_ms}")
    if getattr(args, "serve_requests", 0):
        bad.append(f"--serve_requests {args.serve_requests}")
    if bad:
        raise SystemExit(
            f"{algorithm} does not support {', '.join(bad)}: the "
            "multi-tenant adapter serving plane rides main_extra's "
            "FedBuff runner only (fedml_tpu_torch.serve) — the flag would "
            "be "
            "silently inert here")


def reject_controller_flags(args, algorithm: str) -> None:
    """Refuse the adaptive-controller knobs for drivers with no actuation
    seam to attach a controller to (the PR 4 flag-rejection convention):
    only main_extra's FedAsync/FedBuff runners wire
    ``controller_from_args`` through to the server manager. A churn run
    whose ``--controller adaptive`` silently did nothing would report
    static behavior as the self-tuning arm — the flag must refuse, not
    no-op."""
    bad = []
    if getattr(args, "controller", "none") != "none":
        bad.append(f"--controller {args.controller}")
    if getattr(args, "controller_interval", 1) != 1:
        bad.append(f"--controller_interval {args.controller_interval}")
    if getattr(args, "controller_band_lo", 2.0) != 2.0:
        bad.append(f"--controller_band_lo {args.controller_band_lo}")
    if getattr(args, "controller_band_hi", 6.0) != 6.0:
        bad.append(f"--controller_band_hi {args.controller_band_hi}")
    if bad:
        raise SystemExit(
            f"{algorithm} does not support {', '.join(bad)}: the adaptive "
            "federation controller (fedml_tpu.ctrl) attaches to the "
            "FedAsync/FedBuff server managers in main_extra only — the "
            "flag would be silently inert here")


def reject_ingest_pool_flag(args, algorithm: str) -> None:
    """Refuse ``--ingest_workers`` for runners with no message-passing
    server dispatch thread to parallelize (the PR 4/6 flag-rejection
    convention): a serving drill whose pool flag silently does nothing
    would report the baseline as the optimized arm. The cross-silo CLI
    and main_extra's FedAsync/FedBuff are the tiers that read it; the
    non-mean ``--aggregator`` combination is refused by the server
    managers themselves (the robust stack-then-reduce path is
    inherently serialized)."""
    if getattr(args, "ingest_workers", 0):
        raise SystemExit(
            f"{algorithm} does not support --ingest_workers "
            f"{args.ingest_workers}: the parallel ingest pool unblocks a "
            "message-passing server's dispatch thread (cross-silo / "
            "FedAsync / FedBuff, comm/ingest.py) — the flag would be "
            "silently inert here")


def reject_agg_shards_flag(args, algorithm: str) -> None:
    """Refuse ``--agg_shards`` wherever the sharded aggregation plane
    cannot run (same convention as :func:`reject_ingest_pool_flag`):
    the simulator tiers have no server processes to shard, and the
    async tiers' server managers additionally refuse ``cfg.agg_shards``
    themselves (their mix is order-dependent, algos/fedasync.py)."""
    if getattr(args, "agg_shards", 0):
        raise SystemExit(
            f"{algorithm} does not support --agg_shards "
            f"{args.agg_shards}: the sharded aggregation plane stands up "
            "M aggregator-shard processes for the synchronous message-"
            "passing federation (comm/shardplane.py) — the flag would "
            "be silently inert here")


def reject_secagg_flags(args, algorithm: str) -> None:
    """Refuse the secure-aggregation knobs wherever the masked protocol
    cannot run (the PR 4 flag-rejection convention): secagg needs the
    synchronous message-passing federation's roster-complete rounds and
    the fixed-point ingest pool (comm/secagg.py rides comm/ingest.py).
    A drill whose ``--secagg`` silently does nothing would report a
    CLEAR-upload run as a privacy experiment — the worst possible
    silent-inert flag; it must refuse. The async tiers' server managers
    additionally refuse ``cfg.secagg`` themselves (algos/fedasync.py:
    no roster-complete cohort sum for the masks to cancel in)."""
    bad = []
    if getattr(args, "secagg", False):
        bad.append("--secagg")
    if getattr(args, "secagg_t", 0):
        bad.append(f"--secagg_t {args.secagg_t}")
    if bad:
        raise SystemExit(
            f"{algorithm} does not support {', '.join(bad)}: secure "
            "aggregation rides the sync cross-silo tier's fixed-point "
            "ingest pool and roster-complete rounds (comm/secagg.py) — "
            "a silently-inert privacy flag would report clear uploads "
            "as a masked run")


#: Flags of paths the port does not have yet, each with its default and
#: the ROADMAP.md queue that ports it: the client mesh and its group
#: reduction (A11), the message-passing tiers' wire codec and ingest pool
#: (A10).
UNPORTED_FLAGS = {
    "num_devices": (0, "A11"), "dcn_hosts": (0, "A11"),
    "group_reduce": (False, "A11"),
    "wire_codec": ("none", "A10"), "ingest_workers": (0, "A10"),
}
def reject_unported_flags(args, who: str = "the PyTorch CLI") -> None:
    """Refuse, by name, each flag of :data:`UNPORTED_FLAGS` set away from
    its default, citing the ROADMAP.md queue that ports it (the CLI's
    ``refuse_unported``)."""
    for name, (default, label) in UNPORTED_FLAGS.items():
        val = getattr(args, name, default)
        if val != default:
            raise NotImplementedError(
                f"--{name} {val!r} is not ported yet to {who} (ROADMAP.md "
                f"{label}); leave it at {default!r}")


def trace_dir_from(args) -> "str | None":
    """Resolve ``--trace`` into the runners' ``trace_dir``: the run
    directory when tracing is on (refusing loudly without one — trace
    artifacts need somewhere to land), else ``None`` (the strict no-op
    path)."""
    if not getattr(args, "trace", False):
        return None
    if not getattr(args, "run_dir", None):
        raise SystemExit(
            "--trace needs --run_dir: the Chrome trace JSON, span JSONL "
            "and flight-recorder dump land there (docs/OBSERVABILITY.md)")
    return args.run_dir


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="fedml_tpu_torch experiment")
    add_args(parser)
    return parser.parse_args(argv)


def config_from_args(args: argparse.Namespace) -> FedConfig:
    return FedConfig(
        client_num_in_total=args.client_num_in_total,
        client_num_per_round=args.client_num_per_round,
        comm_round=args.comm_round,
        epochs=args.epochs,
        batch_size=args.batch_size,
        client_optimizer=args.client_optimizer,
        lr=args.lr,
        wd=args.wd,
        frequency_of_the_test=args.frequency_of_the_test,
        seed=args.seed,
        server_optimizer=args.server_optimizer,
        server_lr=args.server_lr,
        server_momentum=args.server_momentum,
        fedprox_mu=args.fedprox_mu,
        robust_norm_bound=args.norm_bound,
        robust_stddev=args.stddev,
        attack_freq=args.attack_freq,
        attack_num_adversaries=args.attack_num_adversaries,
        aggregator=args.aggregator,
        corrupt_mode=args.corrupt_mode,
        corrupt_scale=args.corrupt_scale,
        group_comm_round=args.group_comm_round,
        lr_schedule=args.lr_schedule,
        lr_decay_rate=args.lr_decay_rate,
        grad_clip=args.grad_clip,
        remat=args.remat,
        dp_clip=args.dp_clip,
        dp_noise_multiplier=args.dp_noise_multiplier,
        compute_layout=args.compute_layout,
        client_step_dtype=args.client_step_dtype,
        adapter_rank=int(getattr(args, "adapter_rank", 0) or 0),
        adapter_scope=getattr(args, "adapter_scope", "attn"),
        group_reduce=bool(getattr(args, "group_reduce", False)),
        client_selection=args.client_selection,
        pow_d_candidates=args.pow_d_candidates,
        oort_epsilon=args.oort_epsilon,
        oort_staleness_coef=args.oort_staleness_coef,
        compress=args.compress,
        wire_codec=args.wire_codec,
        checkpoint_every=args.checkpoint_frequency,
        round_timeout_s=args.round_timeout_s,
        heartbeat_interval_s=args.heartbeat_interval_s,
        ingest_workers=args.ingest_workers,
        agg_shards=int(getattr(args, "agg_shards", 0) or 0),
        secagg=bool(getattr(args, "secagg", False)),
        secagg_t=int(getattr(args, "secagg_t", 0) or 0),
        trace=args.trace,
    )
