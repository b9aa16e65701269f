"""Experiment mains for the non-FedAvg-family algorithms (port of
``fedml_tpu/exp/main_extra.py``) — the L4 entries the reference keeps
under ``fedml_experiments/distributed/{fedgan,fedgkt,fednas,split_nn,
classical_vertical_fl,base,decentralized_demo}`` and
``fedml_experiments/standalone/decentralized``.

Each ``run_<algo>`` wires args → data → models → API with the reference's
defaults, on ``--device``; the module is executable:

    python -m fedml_tpu_torch.exp.main_extra --algorithm FedGAN \
        --comm_round 5 ...
    python -m fedml_tpu_torch.exp.main_extra --algorithm FedBuff \
        --model transformer_lm --dataset shakespeare --adapter_rank 8 \
        --serve --serve_requests 32 ...

FedAsync and FedBuff run over the loopback message-passing tiers
(``algos/fedasync.py``, ``algos/fedbuff.py``); FedBuff stands up the
serving plane on its trained global with ``--serve``; both take the
adaptive controller (``--controller adaptive``, ``ctrl/policy.py``). The
synchronous federation plane's CLI is ``exp/main_cross_silo.py``.
"""

from __future__ import annotations

import argparse
import json
import logging

import numpy as np
import torch

from fedml_tpu_torch.data.loaders import to_federated_arrays
from fedml_tpu_torch.exp.args import (add_args, config_from_args,
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
from fedml_tpu_torch.exp.setup import (create_model_for, global_test_batches,
                                       load_data)


def _setup(args):
    device = getattr(args, "device", None)
    fed = load_data(args)
    arrays = to_federated_arrays(fed, args.batch_size, device=device)
    test = global_test_batches(fed, args.batch_size, device)
    cfg = config_from_args(args)
    cfg.client_num_in_total = fed.client_num
    cfg.client_num_per_round = min(cfg.client_num_per_round, fed.client_num)
    return fed, arrays, test, cfg


def _model(args, name, **kw):
    from fedml_tpu_torch.models import create_model

    return create_model(name, device=getattr(args, "device", None),
                        generator=torch.Generator().manual_seed(args.seed),
                        **kw)


def run_fedgan(args):
    """main_fedgan.py parity: federated GAN on image data."""
    from fedml_tpu_torch.algos import FedGanAPI

    _, arrays, _, cfg = _setup(args)
    api = FedGanAPI(_model(args, "mnist_gan"), arrays, cfg,
                    device=args.device)
    return _loop(api, cfg)


def run_fedgkt(args):
    """main_fedgkt.py parity: small client CNN + big server net
    distillation."""
    from fedml_tpu_torch.algos import FedGKTAPI

    fed, arrays, test, cfg = _setup(args)
    # --ci shrinks the model pair (the reference's CI flag exists to cut
    # compute the same way, FedAVGAggregator.py:127-132).
    server_name = "resnet20_server" if args.ci else "resnet56_server"
    client = _model(args, "resnet5_56", num_classes=fed.class_num)
    server = _model(args, server_name, num_classes=fed.class_num)
    api = FedGKTAPI(client, server, arrays, test, cfg, device=args.device)
    return _loop(api, cfg)


def run_fednas(args):
    """main_fednas.py parity: federated DARTS search."""
    from fedml_tpu_torch.algos import FedNASAPI

    fed, arrays, test, cfg = _setup(args)
    model = _model(args, "darts", num_classes=fed.class_num, c=8, layers=4)
    api = FedNASAPI(model, arrays, test, cfg, device=args.device)
    hist = _loop(api, cfg)
    logging.info("searched genotype: %s", api.genotype())
    return hist


def run_split_nn(args):
    """main_split_nn.py parity: relay-ring split learning. SplitNN is
    epoch-structured (one relay cycle per epoch), so --epochs drives it."""
    from fedml_tpu_torch.algos import SplitNNAPI

    fed, arrays, test, cfg = _setup(args)
    server_name = "resnet20_server" if args.ci else "resnet56_server"
    client = _model(args, "resnet_split_bottom")
    server = _model(args, server_name, num_classes=fed.class_num)
    api = SplitNNAPI(client, server, arrays, test, cfg, device=args.device)
    history = []
    for e in range(cfg.epochs):
        metrics = api.train_one_epoch(e)
        if e == cfg.epochs - 1:
            metrics.update(api.evaluate())
        logging.info(json.dumps(metrics))
        history.append(metrics)
    return history


def run_vfl(args):
    """main_vfl.py parity: two-party vertical FL on NUS-WIDE-shaped
    data."""
    from fedml_tpu_torch.algos import VflAPI
    from fedml_tpu_torch.data.loaders import load_two_party_nus_wide

    (xa, xb, y), (xat, xbt, yt) = load_two_party_nus_wide(
        data_dir=args.data_dir, n_samples=max(args.batch_size * 20, 500))
    api = VflAPI([xa.shape[1], xb.shape[1]], lr=args.lr, seed=args.seed,
                 device=args.device)
    history = []
    for epoch in range(args.comm_round):
        losses = api.fit([xa, xb], y, epochs=1, batch_size=args.batch_size)
        metrics = {"round": epoch, "train_loss": float(np.mean(losses))}
        if epoch == args.comm_round - 1:
            metrics.update(api.evaluate([xat, xbt], yt))
        logging.info(json.dumps(metrics))
        history.append(metrics)
    return history


def run_decentralized(args):
    """main_dol.py / decentralized_demo parity: gossip DSGD or PushSum."""
    from fedml_tpu_torch.algos import DecentralizedAPI
    from fedml_tpu_torch.core.topology import SymmetricTopologyManager

    fed, arrays, test, cfg = _setup(args)
    topo = SymmetricTopologyManager(fed.client_num, neighbor_num=2)
    x0 = fed.train_data_global[0][0]
    model = _model(args, "lr", num_classes=fed.class_num,
                   in_features=int(np.prod(np.asarray(x0).shape[1:])))
    api = DecentralizedAPI(model, arrays, test, cfg, topo,
                           mode=getattr(args, "dol_mode", "dsgd"),
                           device=args.device)
    return _loop(api, cfg)


def _async_loss_kwargs(args):
    """Sequence-dataset loss for the async runners (run.py's make_api
    wiring, which these CLI paths bypass): without it a transformer_lm +
    shakespeare worker dies on the classification CE's label shape and
    the federation waits for its uploads."""
    from fedml_tpu_torch.exp.run import SEQ_DATASETS

    if args.dataset not in SEQ_DATASETS:
        return {}
    from functools import partial

    from fedml_tpu_torch.trainer.local import seq_softmax_ce

    pad_id = -1 if args.dataset == "shakespeare" else 0
    return {"loss_fn": partial(seq_softmax_ce, pad_id=pad_id)}


def _async_obs_kwargs(args):
    """Shared --run_dir/--trace wiring for the async-tier runners: a
    metrics.jsonl ctrl/ stream per model version (the sync server's
    schema) and the flight recorder / span tracer. Returns ``(kwargs,
    metrics_logger_or_None)`` — the caller closes the logger after the
    run."""
    from fedml_tpu_torch.exp.args import trace_dir_from

    metrics = None
    if getattr(args, "run_dir", None):
        from fedml_tpu_torch.obs import MetricsLogger

        metrics = MetricsLogger.for_run(run_dir=args.run_dir, stdout=False)
    return {"metrics": metrics, "trace_dir": trace_dir_from(args)}, metrics


def run_fedasync(args):
    """Asynchronous FL (no barrier; staleness-weighted mixing) over the
    loopback message-passing backend — fedasync.py."""
    from fedml_tpu_torch.algos.fedasync import FedML_FedAsync_distributed
    from fedml_tpu_torch.ctrl import controller_from_args

    fed, arrays, test, cfg = _setup(args)
    model = create_model_for(args, fed)
    obs_kw, metrics = _async_obs_kwargs(args)
    try:
        srv = FedML_FedAsync_distributed(
            model, arrays, test, cfg,
            alpha=(0.6 if args.fedasync_alpha < 0 else args.fedasync_alpha),
            staleness_exp=args.staleness_exp, wire_codec=args.wire_codec,
            controller=controller_from_args(args),
            device=args.device, **_async_loss_kwargs(args), **obs_kw)
    finally:
        if metrics is not None:
            metrics.close()
    logging.info("fedasync staleness history: %s", srv.staleness_history)
    return srv.test_history or [{"version": srv.version}]


def run_fedbuff(args):
    """Buffered semi-sync FL (aggregate every ``--buffer_k`` arrivals with
    polynomial staleness discounting) — fedbuff.py. Composes with
    ``--aggregator`` (robust buffer reduction) and ``--corrupt_mode`` (the
    first ``--attack_num_adversaries`` worker ranks turn Byzantine)."""
    from fedml_tpu_torch.algos.fedbuff import FedML_FedBuff_distributed
    from fedml_tpu_torch.core.faults import UpdateCorruptor
    from fedml_tpu_torch.ctrl import controller_from_args

    fed, arrays, test, cfg = _setup(args)
    model = create_model_for(args, fed)
    corruptor = None
    corrupt_ranks = ()
    if args.corrupt_mode != "none":
        corruptor = UpdateCorruptor(args.corrupt_mode, args.corrupt_scale,
                                    seed=cfg.seed)
        corrupt_ranks = tuple(range(1, 1 + args.attack_num_adversaries))
    obs_kw, metrics = _async_obs_kwargs(args)
    try:
        srv = FedML_FedBuff_distributed(
            model, arrays, test, cfg,
            alpha=(1.0 if args.fedasync_alpha < 0 else args.fedasync_alpha),
            staleness_exp=args.staleness_exp, buffer_k=args.buffer_k,
            aggregator=args.aggregator, wire_codec=args.wire_codec,
            corrupt_ranks=corrupt_ranks, corruptor=corruptor,
            controller=controller_from_args(args),
            device=args.device, **_async_loss_kwargs(args), **obs_kw)
    finally:
        if metrics is not None:
            metrics.close()
    logging.info("fedbuff staleness history: %s (guard_drops=%d)",
                 srv.staleness_history, srv.guard_drops)
    history = srv.test_history or [{"version": srv.version}]
    if getattr(args, "serve", False):
        history[-1] = dict(history[-1], **_serve_fedbuff_global(args, model,
                                                               srv))
    return history


def _serve_fedbuff_global(args, model, srv):
    """Stand up the multi-tenant serving plane (fedml_tpu_torch.serve) on
    the trained FedBuff global: batched LoRA inference over the run's
    frozen base, ``--serve_requests`` smoke traffic through the
    micro-batcher, optional ``--serve_port`` JSON socket. Returns flat
    serve_* scalars for the output line."""
    from fedml_tpu_torch.comm import pytree
    from fedml_tpu_torch.models.adapter import adapter_model_fns
    from fedml_tpu_torch.serve import (AdapterDecoder, ServeForward,
                                       ServeManager, ServeSocketServer)

    holder = getattr(srv, "adapter_holder", None)
    if not holder or "base" not in holder:
        raise SystemExit(
            "--serve needs the frozen-base adapter run: pass "
            "--adapter_rank > 0 with --model transformer_lm (the serving "
            "plane batches per-request LoRA deltas over one frozen base)")
    fns = adapter_model_fns(holder["base"])
    glob = pytree.host_tree(srv.net.params)
    fwd = ServeForward(fns, glob, device=args.device)
    dec = AdapterDecoder(model, fns, glob, device=args.device)
    seq_len = min(int(getattr(model, "max_len", 32)), 32)
    vocab = int(getattr(model, "vocab_size", 64))
    mgr = ServeManager(fwd, None, glob, seq_len=seq_len,
                       max_batch=args.serve_max_batch,
                       deadline_s=args.serve_deadline_ms / 1e3,
                       decoder=dec, device=args.device).start()
    sock = None
    try:
        if args.serve_port:
            sock = ServeSocketServer(mgr, args.serve_port).start()
            logging.info("serve socket listening on 127.0.0.1:%d", sock.port)
        rng = np.random.default_rng(0)
        pending = []
        for i in range(int(args.serve_requests)):
            toks = rng.integers(0, vocab,
                                size=int(rng.integers(1, seq_len + 1)))
            pending.append(mgr.submit(i, toks.astype(np.int32),
                                      max_new_tokens=2))
            if len(pending) >= 64:
                for r in pending:
                    r.result(120)
                pending.clear()
        for r in pending:
            r.result(120)
        stats = mgr.stats()
    finally:
        if sock is not None:
            sock.close()
        mgr.close()
    return {k.replace("/", "_"): v for k, v in stats.items()
            if isinstance(v, (int, float))}


def run_base_framework(args):
    """main_base.py parity: the didactic scalar-sum message-passing demo
    over the loopback backend (local result = rank + round)."""
    from fedml_tpu_torch.algos.base_framework import FedML_Base_distributed

    worker_num = max(2, args.client_num_per_round)
    results = FedML_Base_distributed(
        worker_num, args.comm_round,
        local_fn=lambda round_idx, _global: float(round_idx + 1))
    logging.info("base framework per-round aggregates: %s", results)
    return [{"round": i, "aggregate": float(r)}
            for i, r in enumerate(results)]


def _loop(api, cfg):
    history = []
    for r in range(cfg.comm_round):
        metrics = api.train_one_round(r)
        if hasattr(api, "evaluate") and (
            r % cfg.frequency_of_the_test == 0 or r == cfg.comm_round - 1
        ):
            metrics.update(api.evaluate())
        logging.info(json.dumps({k: v for k, v in metrics.items()
                                 if isinstance(v, (int, float))}))
        history.append(metrics)
    return history


RUNNERS = {
    "FedAsync": run_fedasync,
    "FedBuff": run_fedbuff,
    "FedGAN": run_fedgan,
    "FedGKT": run_fedgkt,
    "FedNAS": run_fednas,
    "SplitNN": run_split_nn,
    "VFL": run_vfl,
    "Decentralized": run_decentralized,
    "BaseFramework": run_base_framework,
}
#: The JAX package's runners that the port has no counterpart for: none
#: since the asynchronous tiers came.
UNPORTED_RUNNERS = ()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--algorithm", type=str, required=True,
                        choices=sorted(RUNNERS))
    parser.add_argument("--dol_mode", type=str, default="dsgd",
                        help="Decentralized only: dsgd | pushsum")
    add_args(parser)
    args = parser.parse_args(argv)
    # The JAX runner's refusals, in its order and words. FedBuff composes
    # with the robust aggregator + corruption drill; every other specialty
    # algorithm refuses those flags. The async-tier knobs are read by
    # FedAsync/FedBuff only; only FedBuff serves.
    if args.algorithm != "FedBuff":
        reject_fedavg_family_flags(args, args.algorithm)
        reject_async_tier_flags(args, args.algorithm,
                                allow_mixing=args.algorithm == "FedAsync")
        reject_serve_flags(args, args.algorithm)
    elif not getattr(args, "serve", False):
        reject_serve_flags(args, f"{args.algorithm} without --serve")
    elif not getattr(args, "adapter_rank", 0):
        raise SystemExit(
            "--serve needs --adapter_rank > 0 (and --model "
            "transformer_lm): the serving plane batches per-request "
            "LoRA deltas over one frozen base (fedml_tpu.serve)")
    if (args.algorithm not in ("FedAsync", "FedBuff")
            and getattr(args, "wire_codec", "none") != "none"):
        raise SystemExit(
            f"{args.algorithm} does not support --wire_codec "
            f"{args.wire_codec}: the negotiated wire codec rides the "
            "message-passing upload path (FedAsync/FedBuff here, or the "
            "cross-silo CLI) — the flag would be silently inert")
    if args.algorithm not in ("FedAsync", "FedBuff"):
        reject_ingest_pool_flag(args, args.algorithm)
        reject_controller_flags(args, args.algorithm)
    reject_agg_shards_flag(args, args.algorithm)
    reject_secagg_flags(args, args.algorithm)
    if args.algorithm in ("FedAsync", "FedBuff"):
        if getattr(args, "dcn_hosts", 0):
            raise SystemExit(
                f"{args.algorithm} does not support --dcn_hosts "
                f"{args.dcn_hosts}: the async tiers shard by rank, not "
                "over a device mesh (the flag would be silently inert)")
        # The async tiers run the frozen-base adapter finetune, but only a
        # transformer model has injection sites.
        if (getattr(args, "adapter_rank", 0)
                and args.model != "transformer_lm"):
            raise SystemExit(
                f"--adapter_rank {args.adapter_rank} needs --model "
                f"transformer_lm (got {args.model!r}): adapter "
                "injection lives in models/transformer.py")
    else:
        reject_pod_plane_flags(args, args.algorithm)
        reject_adapter_flags(args, args.algorithm)
    reject_unported_flags(args)
    logging.basicConfig(level=logging.INFO,
                        format=f"[{args.algorithm} %(asctime)s] %(message)s")
    history = RUNNERS[args.algorithm](args)
    print(json.dumps({k: v for k, v in history[-1].items()
                      if isinstance(v, (int, float))}))
    return history


if __name__ == "__main__":
    main()
