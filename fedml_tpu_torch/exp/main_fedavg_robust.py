"""Robust FedAvg entry (fedml_experiments/distributed/fedavg_robust/
main_fedavg_robust.py): norm-clipping defense ``--norm_bound`` and weak-DP
noise ``--stddev``. Port of
``fedml_tpu/exp/main_fedavg_robust.py``."""

from fedml_tpu_torch.exp.run import main

if __name__ == "__main__":
    main(algorithm="FedAvgRobust")
