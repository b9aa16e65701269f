"""Federated algorithms of the port on one card: FedAvg, FedAdapter
(FedAvg over the LoRA adapters of a frozen-base transformer), and the
algorithms that ride FedAvg's round: FedOpt, FedProx, FedNova and
FedAvgRobust; plus the centralized baseline."""

from fedml_tpu_torch.algos.centralized import CentralizedTrainer
from fedml_tpu_torch.algos.config import FedConfig
from fedml_tpu_torch.algos.fedadapter import FedAdapterAPI
from fedml_tpu_torch.algos.fedavg import FedAvgAPI
from fedml_tpu_torch.algos.fednova import FedNovaAPI
from fedml_tpu_torch.algos.fedopt import FedOptAPI
from fedml_tpu_torch.algos.fedprox import FedProxAPI
from fedml_tpu_torch.algos.robust import FedAvgRobustAPI

__all__ = ["CentralizedTrainer", "FedAdapterAPI", "FedAvgAPI",
           "FedAvgRobustAPI", "FedConfig", "FedNovaAPI", "FedOptAPI",
           "FedProxAPI"]
