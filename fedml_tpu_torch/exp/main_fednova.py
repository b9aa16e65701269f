"""FedNova entry (fedml_experiments/standalone/fednova/main.py):
normalized averaging over heterogeneous local step counts. Port of
``fedml_tpu/exp/main_fednova.py``."""

from fedml_tpu_torch.exp.run import main

if __name__ == "__main__":
    main(algorithm="FedNova")
