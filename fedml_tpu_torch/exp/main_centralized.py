"""Centralized baseline CLI — the reference's accuracy anchor
(fedml_experiments/centralized/main.py, 382 LoC; port of
``fedml_tpu/exp/main_centralized.py``).

Trains the pooled (non-federated) dataset conventionally over the same
model/dataset registries as the federated mains, on one card
(``--device``); the JAX package's ``--num_devices`` mesh is not ported
yet (ROADMAP.md A11) and is refused. ``--comm_round`` counts outer passes
of ``--epochs`` epochs each, so total epochs = comm_round x epochs (the
reference's single ``--epochs`` loop with eval cadence folded in).
``--dp_clip``/``--dp_noise_multiplier`` train DP-SGD and ``--remat``
rematerializes, through the trainer's config.

Usage:
  python -m fedml_tpu_torch.exp.main_centralized --dataset cifar10 \
      --model resnet56 --batch_size 64 --lr 0.001 --epochs 5 \
      --comm_round 20
"""

from __future__ import annotations

import json
import logging
import sys


def run_centralized(args):
    from functools import partial

    from fedml_tpu_torch.algos.centralized import CentralizedTrainer
    from fedml_tpu_torch.exp.args import (config_from_args,
                                    reject_adapter_flags,
                                    reject_agg_shards_flag,
                                    reject_async_tier_flags,
                                    reject_controller_flags,
                                    reject_fedavg_family_flags,
                                    reject_ingest_pool_flag,
                                    reject_pod_plane_flags,
                                    reject_secagg_flags,
                                    reject_serve_flags,
                                    reject_unported_flags)
    from fedml_tpu_torch.exp.run import SEQ_DATASETS

    # The pooled baseline has no client step and no client axis — every
    # pod compute-plane knob (bf16 client step, DCN group reduce, the
    # mesh factorization) would be silently inert here, skewing any A/B
    # that uses this anchor.
    reject_pod_plane_flags(args, "the centralized baseline")
    reject_unported_flags(args, "the PyTorch centralized baseline")
    # The frozen-base adapter finetune is a FEDERATED wire/perf story;
    # the pooled baseline trains every param — --adapter_rank here
    # would report an "adapter" anchor that actually trained dense.
    reject_adapter_flags(args, "the centralized baseline")
    # No aggregation step at all: the fedavg-family knobs (trimmed-mean
    # aggregator, corruption injection), the async tier, the ingest
    # pool, and the shard plane are all server-side machinery this
    # baseline does not instantiate. Refuse rather than silently train
    # a pooled run labeled with federation knobs.
    reject_fedavg_family_flags(args, "the centralized baseline")
    reject_async_tier_flags(args, "the centralized baseline")
    reject_ingest_pool_flag(args, "the centralized baseline")
    reject_agg_shards_flag(args, "the centralized baseline")
    # No uploads to mask either: the pooled baseline never federates.
    reject_secagg_flags(args, "the centralized baseline")
    # ...and no serving plane: serving rides main_extra's FedBuff runner.
    reject_serve_flags(args, "the centralized baseline")
    # ...and no server manager for a controller to actuate: the pooled
    # loop has no knobs, no telemetry stream, no safe boundaries.
    reject_controller_flags(args, "the centralized baseline")
    from fedml_tpu_torch.exp.setup import (
        build_mesh,
        create_model_for,
        global_test_batches,
        global_train_batches,
        load_data,
    )
    from fedml_tpu_torch.trainer.local import seq_softmax_ce, softmax_ce

    device = getattr(args, "device", None)
    fed = load_data(args)
    train = global_train_batches(fed, args.batch_size, device)
    test = global_test_batches(fed, args.batch_size, device)
    model = create_model_for(args, fed)
    cfg = config_from_args(args)
    mesh = build_mesh(args.num_devices)

    if args.dataset in SEQ_DATASETS:
        pad_id = -1 if args.dataset == "shakespeare" else 0
        loss_fn = partial(seq_softmax_ce, pad_id=pad_id)
    else:
        loss_fn = softmax_ce

    if train is None:
        raise ValueError(
            f"dataset {args.dataset!r} produced no pooled train split "
            "(train_data_global is empty); the centralized baseline needs "
            "one")
    trainer = CentralizedTrainer(model, cfg, loss_fn=loss_fn, mesh=mesh,
                                 device=device)
    history = []
    for r in range(cfg.comm_round):
        metrics = {"round": r, "train_loss": trainer.train(*train)}
        if (test is not None
                and (r % cfg.frequency_of_the_test == 0
                     or r == cfg.comm_round - 1)):
            metrics.update(trainer.evaluate(*test))
        logging.info("%s", json.dumps(metrics))
        history.append(metrics)
    print(json.dumps(history[-1]))
    return trainer, history


def main(argv=None):
    from fedml_tpu_torch.exp.args import parse_args

    logging.basicConfig(level=logging.INFO,
                        format="[Centralized %(asctime)s] %(message)s")
    args = parse_args(sys.argv[1:] if argv is None else argv)
    return run_centralized(args)


if __name__ == "__main__":
    main()
