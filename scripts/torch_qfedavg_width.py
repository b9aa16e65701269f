#!/usr/bin/env python3
"""q-FedAvg at ResNet-56 width: the JAX package's ``QFedAvgAPI`` and the
PyTorch port's, side by side on the CPU, from one start.

    JAX_PLATFORMS=cpu python scripts/torch_qfedavg_width.py [--rounds 4]

Both packages train ``resnet56`` (GroupNorm, f32, 10 classes) on the same
seeded CIFAR-shaped noise: 4 clients x 16 samples, every client every
round, one full-batch step per local epoch (so the shuffle, whose bits
differ between the packages, cannot change a step), 4 local epochs, lr
0.1 (L = 10), q 1. The port starts from JAX's params, carried across.
FedAvg runs beside it from the same start in both packages. Each round
prints, per package, the round's training loss and the update's norm, and
the largest relative distance between the two packages' params. The
question it answers: does the JAX reference's q-FedAvg also keep its loss
where FedAvg's falls, or is that a fault of the port?
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir))

import jax  # noqa: E402
import numpy as np
import torch

from fedml_tpu.algos.config import FedConfig as JaxFedConfig
from fedml_tpu.algos.fedavg import FedAvgAPI as JaxFedAvgAPI
from fedml_tpu.algos.qfedavg import QFedAvgAPI as JaxQFedAvgAPI
from fedml_tpu.data import batching as jax_batching
from fedml_tpu.models.registry import create_model as jax_create_model
from fedml_tpu_torch.algos import FedAvgAPI, FedConfig, QFedAvgAPI
from fedml_tpu_torch.convert import from_jax_params, to_jax_params
from fedml_tpu_torch.data import build_federated_arrays
from fedml_tpu_torch.models import create_model
from fedml_tpu_torch.trainer.local import NetState

CLIENTS, PER_CLIENT, EPOCHS, LR, Q = 4, 16, 4, 0.1, 1.0


def _flat(tree):
    return np.concatenate([np.asarray(a, np.float64).ravel()
                           for a in jax.tree.leaves(tree)])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(4)
    rng = np.random.RandomState(0)
    x = rng.randn(CLIENTS * PER_CLIENT, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 10, len(x)).astype(np.int32)
    parts = {c: np.arange(c * PER_CLIENT, (c + 1) * PER_CLIENT)
             for c in range(CLIENTS)}
    cfg = dict(client_num_in_total=CLIENTS, client_num_per_round=CLIENTS,
               comm_round=args.rounds, epochs=EPOCHS, batch_size=PER_CLIENT,
               lr=LR, frequency_of_the_test=1000)
    jfed = jax_batching.build_federated_arrays(x, y, parts, PER_CLIENT)
    tfed = build_federated_arrays(x, y, parts, PER_CLIENT, device="cpu")
    print(f"resnet56 GN f32, {CLIENTS} clients x {PER_CLIENT} samples 32x32,"
          f" {EPOCHS} full-batch local steps, lr {LR} (L {1 / LR:g}), "
          f"q {Q}", flush=True)
    for name, jcls, cls, kw in (("q-FedAvg", JaxQFedAvgAPI, QFedAvgAPI,
                                 dict(q=Q)),
                                ("FedAvg", JaxFedAvgAPI, FedAvgAPI, {})):
        japi = jcls(jax_create_model("resnet56", num_classes=10), jfed, None,
                    JaxFedConfig(**cfg), **kw)
        api = cls(create_model("resnet56", num_classes=10, device="cpu"),
                  tfed, None, FedConfig(**cfg), device="cpu", **kw)
        api.net = NetState(from_jax_params(
            jax.tree.map(np.asarray, japi.net.params))[0], {})
        start = _flat(japi.net.params)
        jprev, tprev = start, start
        for r in range(args.rounds):
            t0 = time.perf_counter()
            jl = japi.train_one_round(r)["train_loss"]
            tl = api.train_one_round(r)["train_loss"]
            jw = _flat(japi.net.params)
            tw = _flat(to_jax_params(api.net.params))
            rel = np.abs(tw - jw).max() / np.abs(jw).max()
            print(f"{name} round {r}: train_loss JAX {jl:.6f} port {tl:.6f};"
                  f" |update| JAX {np.linalg.norm(jw - jprev):.6e} port "
                  f"{np.linalg.norm(tw - tprev):.6e}; max|port - JAX| / "
                  f"max|JAX| {rel:.3e}; {time.perf_counter() - t0:.1f} s",
                  flush=True)
            jprev, tprev = jw, tw
        print(f"{name}: |params - start| after {args.rounds} rounds JAX "
              f"{np.linalg.norm(jprev - start):.6e} port "
              f"{np.linalg.norm(tprev - start):.6e}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
