"""Experiment mains for the non-FedAvg-family algorithms (port of
``fedml_tpu/exp/main_extra.py``) — the L4 entries the reference keeps
under ``fedml_experiments/distributed/{fedgan,fedgkt,fednas,split_nn,
classical_vertical_fl,decentralized_demo}`` and
``fedml_experiments/standalone/decentralized``.

Each ``run_<algo>`` wires args → data → models → API with the reference's
defaults, on ``--device``; the module is executable:

    python -m fedml_tpu_torch.exp.main_extra --algorithm FedGAN \
        --comm_round 5 ...

The JAX package's message-passing runners (FedAsync, FedBuff with its
serving plane, the BaseFramework demo) are not ported yet (ROADMAP.md
A10): asking for one is refused by name.
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
from fedml_tpu_torch.exp.setup import global_test_batches, load_data


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
    "FedGAN": run_fedgan,
    "FedGKT": run_fedgkt,
    "FedNAS": run_fednas,
    "SplitNN": run_split_nn,
    "VFL": run_vfl,
    "Decentralized": run_decentralized,
}
#: The JAX package's runners over its message-passing tiers.
UNPORTED_RUNNERS = ("FedAsync", "FedBuff", "BaseFramework")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--algorithm", type=str, required=True,
                        choices=sorted(RUNNERS) + list(UNPORTED_RUNNERS))
    parser.add_argument("--dol_mode", type=str, default="dsgd",
                        help="Decentralized only: dsgd | pushsum")
    add_args(parser)
    args = parser.parse_args(argv)
    if args.algorithm in UNPORTED_RUNNERS:
        raise NotImplementedError(
            f"--algorithm {args.algorithm} runs over the JAX package's "
            "message-passing tiers, which are not ported yet to the "
            "PyTorch CLI (ROADMAP.md A10)")
    # Every specialty algorithm here refuses the FedAvg-family, async,
    # serving, ingest, controller, shard-plane, secagg, pod-plane and
    # adapter flags, as the JAX runner refuses them for these loops.
    reject_fedavg_family_flags(args, args.algorithm)
    reject_async_tier_flags(args, args.algorithm)
    reject_serve_flags(args, args.algorithm)
    if getattr(args, "wire_codec", "none") != "none":
        raise SystemExit(
            f"{args.algorithm} does not support --wire_codec "
            f"{args.wire_codec}: the negotiated wire codec rides the "
            "message-passing upload path (FedAsync/FedBuff here, or the "
            "cross-silo CLI) — the flag would be silently inert")
    reject_ingest_pool_flag(args, args.algorithm)
    reject_controller_flags(args, args.algorithm)
    reject_agg_shards_flag(args, args.algorithm)
    reject_secagg_flags(args, args.algorithm)
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
