"""FedOpt entry (fedml_experiments/distributed/fedopt/main_fedopt.py):
FedAvg + server optimizer on the pseudo-gradient; choose with
``--server_optimizer {sgd,adam,yogi,adagrad} --server_lr ...``. Port of
``fedml_tpu/exp/main_fedopt.py``."""

from fedml_tpu_torch.exp.run import main

if __name__ == "__main__":
    main(algorithm="FedOpt")
