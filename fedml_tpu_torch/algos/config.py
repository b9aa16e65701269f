"""Run configuration shared by the federated algorithms (port of
``fedml_tpu/algos/config.py``: the same fields and defaults, named after
the reference's argparse flags, fedml_experiments/distributed/fedavg/
main_fedavg.py:46-130). ``fedml_tpu/algos/config.py`` documents what each
field does; a driver of the port refuses, by name, every field it reads
that is set away from its default and not ported yet."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class FedConfig:
    client_num_in_total: int = 10
    client_num_per_round: int = 10
    comm_round: int = 10
    epochs: int = 1
    batch_size: int = 32
    client_optimizer: str = "sgd"
    lr: float = 0.03
    wd: float = 0.0
    frequency_of_the_test: int = 5
    seed: int = 0
    server_optimizer: str = "sgd"
    server_lr: float = 1.0
    server_momentum: float = 0.9
    fedprox_mu: float = 0.1
    robust_norm_bound: float = 5.0
    robust_stddev: float = 0.0
    attack_freq: int = 0
    attack_num_adversaries: int = 1
    aggregator: str = "mean"
    group_reduce: bool = False
    corrupt_mode: str = "none"
    corrupt_scale: float = 10.0
    group_comm_round: int = 1
    lr_schedule: str = "none"
    lr_decay_rate: float = 0.992
    grad_clip: float = 0.0
    remat: bool = False
    client_selection: str = "random"
    pow_d_candidates: int = 0
    oort_epsilon: float = 0.2
    oort_staleness_coef: float = 0.1
    compress: str = "none"
    wire_codec: str = "none"
    compute_layout: str = "none"
    client_step_dtype: str = "fp32"
    adapter_rank: int = 0
    adapter_scope: str = "attn"
    dp_clip: float = 0.0
    dp_noise_multiplier: float = 0.0
    checkpoint_every: int = 0
    round_timeout_s: float = 0.0
    heartbeat_interval_s: float = 0.0
    ingest_workers: int = 0
    agg_shards: int = 0
    secagg: bool = False
    secagg_t: int = 0
    trace: bool = False