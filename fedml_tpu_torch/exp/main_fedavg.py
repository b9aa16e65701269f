"""Standalone FedAvg entry — the north-star CLI
(fedml_experiments/distributed/fedavg/main_fedavg.py:392-491; port of
``fedml_tpu/exp/main_fedavg.py``). The cohort trains on one card, every
sampled client at once under ``vmap``:

    python -m fedml_tpu_torch.exp.main_fedavg --model resnet56 \
        --dataset cifar10 --partition_method hetero --partition_alpha 0.5 \
        --client_num_in_total 10 --client_num_per_round 10 \
        --batch_size 64 --lr 0.03 --epochs 5 --comm_round 100

``--device cpu`` runs it on the CPU."""

from fedml_tpu_torch.exp.run import main

if __name__ == "__main__":
    main(algorithm="FedAvg")
