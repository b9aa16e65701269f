"""Experiments / CLI layer of the port (the reference's
``fedml_experiments``; port of ``fedml_tpu/exp``).

North-star entry (launches with the reference's flags unchanged, on the
card unless ``--device cpu``):

    python -m fedml_tpu_torch.exp.main_fedavg --model resnet56 \
        --dataset cifar10 --partition_method hetero --partition_alpha 0.5 \
        --client_num_in_total 10 --client_num_per_round 10 \
        --batch_size 64 --lr 0.03 --epochs 5 --comm_round 100

Generalized launcher with an ``--algorithm`` switch (fed_launch parity):

    python -m fedml_tpu_torch.exp.run --algorithm FedOpt \
        --server_optimizer adam ...
"""

from fedml_tpu_torch.exp.args import add_args, config_from_args, parse_args
from fedml_tpu_torch.exp.run import round_lr, run
from fedml_tpu_torch.exp.setup import (create_model_for, global_test_batches,
                                       load_data, setup_standard)

__all__ = [
    "add_args",
    "config_from_args",
    "parse_args",
    "run",
    "round_lr",
    "create_model_for",
    "global_test_batches",
    "load_data",
    "setup_standard",
]
