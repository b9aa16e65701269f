"""Generalized experiment runner — the fed_launch equivalent
(fedml_experiments/distributed/fed_launch/main.py; port of
``fedml_tpu/exp/run.py``): one entry, an ``--algorithm`` switch,
round-level LR schedules and grad clipping.

Each per-algorithm ``main_<algo>.py`` is a thin wrapper over ``run(args)``;
the run lands on ``--device`` (``cuda`` by default, raising without a
card). ``python -m fedml_tpu_torch.exp.run --algorithm FedOpt ...`` runs
the launcher; the last line of its standard output is the JSON of the
last round's metrics.
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import sys

from fedml_tpu_torch.exp.args import parse_args
from fedml_tpu_torch.exp.setup import setup_standard


def round_lr(base_lr: float, schedule: str, round_idx: int, total_rounds: int,
             decay_rate: float = 0.992, buckets: int = 16) -> float:
    """Per-round client LR. Values are quantized to ``buckets`` distinct
    levels so ``set_client_lr`` recaptures at most ``buckets`` times per
    run."""
    if schedule == "none":
        return base_lr
    if schedule == "cosine":
        frac = round_idx / max(total_rounds - 1, 1)
        scale = 0.5 * (1 + math.cos(math.pi * frac))
    elif schedule == "step":
        scale = decay_rate ** round_idx
    else:
        raise ValueError(f"unknown lr_schedule {schedule!r}")
    q = max(round(scale * buckets), 1) / buckets
    return base_lr * q


SEQ_DATASETS = {"shakespeare", "fed_shakespeare", "stackoverflow_nwp"}


def make_api(algorithm: str, args, model, arrays, test, cfg, mesh,
             class_num: int | None = None):
    from fedml_tpu_torch import algos
    from fedml_tpu_torch.trainer.local import seq_softmax_ce

    common = dict(mesh=mesh) if mesh is not None else {}
    common["device"] = getattr(args, "device", None)
    if args.dataset in SEQ_DATASETS:
        # Sequence tasks: per-position CE with pad positions masked out.
        # TFF datasets pad with id 0; LEAF shakespeare has no pad (id 0 is a
        # real char) and marks unknown chars -1 instead.
        pad_id = -1 if args.dataset == "shakespeare" else 0
        from functools import partial

        common["loss_fn"] = partial(seq_softmax_ce, pad_id=pad_id)
        common["pad_id"] = pad_id
    table = {
        "FedAvg": algos.FedAvgAPI,
        "FedAdapter": algos.FedAdapterAPI,
        "FedAc": algos.FedAcAPI,
        "ServerAvg": algos.ServerAvgAPI,
        "FedOpt": algos.FedOptAPI,
        "FedProx": algos.FedProxAPI,
        "FedNova": algos.FedNovaAPI,
        "FedAvgRobust": algos.FedAvgRobustAPI,
        "TurboAggregate": algos.TurboAggregateAPI,
        "Ditto": algos.DittoAPI,
        "QFedAvg": algos.QFedAvgAPI,
        "Scaffold": algos.ScaffoldAPI,
        "FedDyn": algos.FedDynAPI,
        "FedBN": algos.FedBNAPI,
    }
    if algorithm == "Ditto":
        common["lam"] = args.ditto_lam
    elif algorithm == "QFedAvg":
        common["q"] = args.qffl_q
    elif algorithm == "FedDyn":
        common["alpha"] = args.feddyn_alpha
    elif algorithm == "FedAdapter":
        if not int(getattr(args, "adapter_rank", 0) or 0):
            raise SystemExit(
                "FedAdapter needs --adapter_rank > 0 (the rank of the "
                "LoRA pairs injected into the transformer; 0 would "
                "silently train nothing)")
        if args.model != "transformer_lm":
            raise SystemExit(
                f"FedAdapter needs --model transformer_lm (got "
                f"{args.model!r}): adapter injection lives in "
                "models/transformer.py")
        if args.dataset not in SEQ_DATASETS:
            raise SystemExit(
                f"FedAdapter finetunes a token LM; --dataset "
                f"{args.dataset!r} is not a sequence dataset "
                f"(expected one of {sorted(SEQ_DATASETS)})")
    elif algorithm == "FedAc":
        common["gamma"] = getattr(args, "fedac_gamma", 2.0)
    elif algorithm == "ServerAvg":
        common["avg_coef"] = getattr(args, "server_avg_coef", 0.5)
    if algorithm in table:
        return table[algorithm](model, arrays, test, cfg, **common)
    if algorithm == "FedSeg":
        if class_num is None:
            raise ValueError("FedSeg needs class_num (the dataset's classes)")
        if args.dataset in SEQ_DATASETS:
            raise ValueError(
                "FedSeg is a segmentation task; it cannot run on sequence "
                f"dataset {args.dataset!r}")
        return algos.FedSegAPI(model, arrays, test, cfg,
                               num_classes=class_num, **common)
    if algorithm == "HierarchicalFL":
        import numpy as np

        # Round-robin group assignment over --group_num groups.
        group_ids = np.arange(cfg.client_num_in_total) % max(args.group_num, 1)
        return algos.HierarchicalFedAvgAPI(
            model, arrays, test, cfg, group_ids=group_ids, **common
        )
    raise ValueError(
        f"unknown algorithm {algorithm!r}; known: "
        f"{sorted(table) + ['FedSeg', 'HierarchicalFL']}"
    )


def run(args, algorithm: str = "FedAvg"):
    logging.basicConfig(
        level=logging.INFO,
        format=f"[{algorithm} %(asctime)s] %(message)s",
    )
    if args.backend != "collective":
        raise NotImplementedError(
            f"--backend {args.backend!r}: the exp runner drives the "
            "on-device collective simulator; for message-passing cross-silo "
            "runs use fedml_tpu.algos.fedavg_distributed with a comm "
            "backend from fedml_tpu.comm (not ported yet, ROADMAP.md A10)")
    # The synchronous simulator tiers have no arrival buffer or
    # staleness stream — those knobs belong to main_extra's
    # FedAsync/FedBuff runners and must refuse, not no-op. Same for the
    # parallel ingest pool: the simulator aggregates inside the captured
    # round, there is no server dispatch thread to unblock.
    from fedml_tpu_torch.exp.args import (reject_adapter_flags,
                                    reject_agg_shards_flag,
                                    reject_async_tier_flags,
                                    reject_controller_flags,
                                    reject_ingest_pool_flag,
                                    reject_secagg_flags,
                                    reject_serve_flags,
                                    reject_unported_flags)

    reject_async_tier_flags(args, algorithm)
    # The client mesh (A11), the wire codec and the ingest pool (A10):
    # not ported yet, refused with their queue.
    reject_unported_flags(args)
    reject_ingest_pool_flag(args, algorithm)
    reject_agg_shards_flag(args, algorithm)
    # The adaptive controller actuates a message-passing server manager's
    # knob seam between rounds — the captured simulator round has no
    # manager, no seam, and no safe boundary to step from.
    reject_controller_flags(args, algorithm)
    # Secure aggregation rides the message-passing tier's fixed-point
    # ingest pool — the captured simulator round materializes every client
    # update in the clear by construction, so the flag must refuse.
    reject_secagg_flags(args, algorithm)
    # No simulator tier serves: the serving plane rides main_extra's
    # FedBuff runner only (fedml_tpu.serve).
    reject_serve_flags(args, algorithm)
    # The FedAvg-family knobs are LIVE on this tier, read through cfg
    # rather than args: --aggregator/--corrupt_mode by FedAvgAPI's
    # pluggable reduce + corruption drill, --client_step_dtype by the
    # shared round builder.
    if algorithm != "FedAdapter":
        # Frozen-base adapter knobs configure FedAdapter only on this
        # tier — on any other algorithm they would silently train the
        # DENSE arm (the PR 4/14 convention; the FedAvgAPI constructor
        # backstops cfg.adapter_rank the same way).
        reject_adapter_flags(args, algorithm)
    fed, arrays, test, model, cfg, mesh = setup_standard(args)
    api = make_api(algorithm, args, model, arrays, test, cfg, mesh,
                   class_num=fed.class_num)

    # Per-client TEST shards (the reference's test_data_local_dict leg),
    # built once when the per-client eval cadence is on and the loader
    # kept local test arrays.
    test_fed_arrays = None
    if getattr(args, "eval_on_clients", False):
        from fedml_tpu_torch.data.loaders import to_federated_arrays as _tfa

        test_fed_arrays = _tfa(fed, args.batch_size, split="test",
                               device=api.device)

    from fedml_tpu_torch.exp.args import trace_dir_from
    from fedml_tpu_torch.obs import MetricsLogger, RoundTimer
    from fedml_tpu_torch.obs import trace as obs_trace

    logger = MetricsLogger.for_run(
        run_dir=args.run_dir, stdout=True,
        wandb_project=getattr(args, "wandb_project", None),
        config=vars(args),
    )
    timer = RoundTimer()
    ckpt_mgr = None
    start_round = 0
    history = []
    # --trace on the simulator tier: per-round train/eval spans (the
    # message-passing tiers trace the full upload lifecycle; here the
    # round IS the unit of work) dumped to run_dir as Chrome trace JSON.
    tracing = contextlib.ExitStack()
    tracer = tracing.enter_context(obs_trace.tracing_to(trace_dir_from(args)))
    try:
        if args.run_dir and (args.checkpoint_frequency or args.resume):
            import os

            from fedml_tpu_torch.obs import (CheckpointManager, restore_run,
                                             save_run)

            ckpt_mgr = CheckpointManager(os.path.join(args.run_dir, "ckpt"))
            if args.resume:
                start_round = restore_run(ckpt_mgr, api)
                if start_round:
                    logging.info("resumed from checkpoint at round %d",
                                 start_round)

        for r in range(start_round, cfg.comm_round):
            if hasattr(api, "set_client_lr"):
                api.set_client_lr(
                    round_lr(args.lr, cfg.lr_schedule, r, cfg.comm_round,
                             cfg.lr_decay_rate)
                )
            timer.mark()
            with timer.phase("round"), tracer.span(
                    "round", cat="round", corr=obs_trace.corr(round=r)):
                metrics = api.train_one_round(r)
                timer.fence(api.net)
            # Reference cadence: every frequency_of_the_test rounds + final
            # round; --ci evaluates the final round only (the flag's purpose
            # is to cut eval cost, FedAVGAggregator.py:127-132).
            do_eval = (r == cfg.comm_round - 1) or (
                not args.ci and r % cfg.frequency_of_the_test == 0
            )
            if do_eval:
                with timer.phase("eval"):
                    metrics.update(api.evaluate())
                    if getattr(args, "eval_on_clients", False):
                        metrics.update(api.evaluate_on_clients())
                        if test_fed_arrays is not None:
                            metrics.update(api.evaluate_on_clients(
                                test_fed_arrays, prefix="clients_test"))
                        # Same flag gates the personalized fleet eval —
                        # both are full per-client passes whose cost
                        # scales with N. Skip when evaluate() already
                        # produced the personal keys (FedBN's headline
                        # eval IS the personalized pass).
                        if (hasattr(api, "evaluate_personalized")
                                and "personal_accuracy" not in metrics):
                            metrics.update(api.evaluate_personalized())
            metrics.update(timer.flat_metrics())
            logger.log(metrics, step=r)
            history.append(metrics)
            if ckpt_mgr is not None and args.checkpoint_frequency and (
                (r + 1) % args.checkpoint_frequency == 0
                or r == cfg.comm_round - 1
            ):
                save_run(ckpt_mgr, api, r)
    finally:
        # Flush/close sinks, the checkpoint manager and the tracer (its
        # dump runs on close) even on mid-run failure (OOM, NaN guard,
        # KeyboardInterrupt).
        tracing.close()
        if ckpt_mgr is not None:
            ckpt_mgr.close()
        logger.close()
    if getattr(args, "sweep_pipe", None):
        from fedml_tpu_torch.utils import \
            post_complete_message_to_sweep_process

        post_complete_message_to_sweep_process(vars(args),
                                               pipe_path=args.sweep_pipe)
    return api, history


def main(argv=None, algorithm: str = "FedAvg"):
    args = parse_args(argv)
    _, history = run(args, algorithm)
    # Empty history = resumed a run that had already completed.
    print(json.dumps(history[-1] if history
                     else {"status": "already_complete"}))
    return history


if __name__ == "__main__":
    # fed_launch style: --algorithm as the first-class switch.
    import argparse

    from fedml_tpu_torch.exp.args import add_args

    parser = argparse.ArgumentParser()
    parser.add_argument("--algorithm", type=str, default="FedAvg")
    add_args(parser)
    ns = parser.parse_args()
    _, hist = run(ns, ns.algorithm)
    print(json.dumps(hist[-1] if hist else {"status": "already_complete"}))
