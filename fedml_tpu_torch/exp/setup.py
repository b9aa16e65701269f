"""Experiment wiring: args → data → model → algorithm API (port of
``fedml_tpu/exp/setup.py``).

The reference's mains each re-implement ``load_data``/``create_model``
switches (main_fedavg.py:133-390); here they are shared functions. The
(model, dataset) → constructor-kwargs mapping reproduces
main_fedavg.py:354-390. Everything lands on ``args.device`` (``cuda`` by
default); the model's weights are drawn from ``args.seed``.
"""

from __future__ import annotations

import numpy as np
import torch

from fedml_tpu_torch.data.batching import batch_global
from fedml_tpu_torch.data.loaders import (FederatedDataset,
                                          load_data as _load_data,
                                          to_federated_arrays)
from fedml_tpu_torch.models import create_model


def load_data(args) -> FederatedDataset:
    from fedml_tpu_torch.data.loaders import _CIFAR_FAMILY

    kw = {}
    n_synth = getattr(args, "synthetic_samples", 0)
    if n_synth:
        if args.dataset not in _CIFAR_FAMILY:
            import logging

            logging.getLogger(__name__).warning(
                "--synthetic_samples is only honored by the CIFAR-family "
                "loaders; ignored for %s", args.dataset)
        else:
            kw["synthetic_samples"] = n_synth
    return _load_data(
        args.dataset,
        data_dir=args.data_dir,
        partition_method=args.partition_method,
        partition_alpha=args.partition_alpha,
        client_num_in_total=args.client_num_in_total,
        batch_size=args.batch_size,
        **kw,
    )


def create_model_for(args, fed: FederatedDataset):
    """main_fedavg.py:354-390's (model, dataset) switch: lr for
    mnist/stackoverflow_lr, cnn for femnist, resnet18_gn for fed_cifar100,
    rnn for the shakespeares, rnn_stackoverflow for nwp, resnet56/mobilenet
    for the cross-silo CV datasets; on ``args.device``, weights from a
    generator seeded with ``args.seed``. Any other registered name gets
    only ``num_classes``, as in JAX: ``mobilenet`` is α 1 with GroupNorm,
    ``mobilenet_v3`` LARGE, ``efficientnet`` b0 with ``small_input``, and
    an unknown name (``vgg``) raises the registry's ``KeyError``."""
    name = args.model
    ds, ncls = args.dataset, fed.class_num
    kw = dict(device=getattr(args, "device", None),
              generator=torch.Generator().manual_seed(args.seed))
    x0 = fed.train_data_global[0][0]
    if name == "lr":
        in_dim = int(np.prod(x0.shape[1:]))
        return create_model("lr", num_classes=ncls, in_features=in_dim, **kw)
    if name == "rnn":
        return create_model("rnn", vocab_size=ncls, **kw)
    if name == "cnn":
        return create_model("cnn", num_classes=ncls,
                            only_digits=(ds == "mnist"), **kw)
    if name == "transformer_lm":
        # The adapter-finetune model: vocab from the dataset, max_len from
        # the loaded sequences, LoRA pairs injected when --adapter_rank is
        # on (rank 0 leaves the param tree identical to the dense one).
        return create_model(
            "transformer_lm", vocab_size=ncls,
            max_len=max(int(np.asarray(x0).shape[-1]), 32),
            adapter_rank=int(getattr(args, "adapter_rank", 0) or 0),
            adapter_scope=getattr(args, "adapter_scope", "attn"), **kw)
    return create_model(name, num_classes=ncls, **kw)


def _pooled_batches(batches, batch_size: int, device=None):
    if not batches:
        return None
    xs = np.concatenate([b[0] for b in batches])
    ys = np.concatenate([b[1] for b in batches])
    return batch_global(xs, ys, batch_size, device=device)


def global_test_batches(fed: FederatedDataset, batch_size: int,
                        device=None):
    """Concatenate the global test batches into the ``(x, y, mask)`` eval
    layout on ``device`` (``None`` → cuda)."""
    return _pooled_batches(fed.test_data_global, batch_size, device)


def global_train_batches(fed: FederatedDataset, batch_size: int,
                         device=None):
    """Pooled TRAIN set in the same layout — what the centralized baseline
    trains on (the reference pools the non-IID dataset the same way,
    fedml_api/centralized/centralized_trainer.py)."""
    return _pooled_batches(fed.train_data_global, batch_size, device)


def build_mesh(num_devices: int, dcn_hosts: int = 0):
    """The JAX package's client mesh over ``num_devices`` chips: not
    ported yet (ROADMAP.md A11), so 0 devices → None and any mesh is
    refused."""
    if num_devices or dcn_hosts:
        raise NotImplementedError(
            f"a client mesh (--num_devices {num_devices}, --dcn_hosts "
            f"{dcn_hosts}) is not ported yet (ROADMAP.md A11); the port "
            "trains every client on one card")
    return None


def setup_standard(args, need_test: bool = True, need_mesh: bool = True):
    """(fed, arrays, test_global, model, cfg, mesh) for the FedAvg-family
    mains, on ``args.device``. ``need_test=False`` skips concatenating
    the global test set; ``need_mesh=False`` skips the mesh (always None
    in the port)."""
    from fedml_tpu_torch.exp.args import config_from_args

    device = getattr(args, "device", None)
    fed = load_data(args)
    arrays = to_federated_arrays(fed, args.batch_size, device=device)
    test = (global_test_batches(fed, args.batch_size, device)
            if need_test else None)
    model = create_model_for(args, fed)
    cfg = config_from_args(args)
    # Clamp sampling like the reference (client_sampling takes min,
    # FedAVGAggregator.py:92).
    cfg.client_num_per_round = min(cfg.client_num_per_round, fed.client_num)
    cfg.client_num_in_total = fed.client_num
    mesh = (build_mesh(args.num_devices, getattr(args, "dcn_hosts", 0))
            if need_mesh else None)
    return fed, arrays, test, model, cfg, mesh
