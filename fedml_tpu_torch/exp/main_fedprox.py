"""FedProx entry — with the proximal μ term the reference's fedprox
snapshot silently dropped (SURVEY.md §2.3); set ``--fedprox_mu``. Port of
``fedml_tpu/exp/main_fedprox.py``."""

from fedml_tpu_torch.exp.run import main

if __name__ == "__main__":
    main(algorithm="FedProx")
