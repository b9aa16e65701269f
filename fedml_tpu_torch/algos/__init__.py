"""Federated algorithms of the port on one card: FedAvg, FedAdapter
(FedAvg over the LoRA adapters of a frozen-base transformer), the
algorithms that ride FedAvg's round (FedOpt, FedProx, FedNova and
FedAvgRobust), those that carry client-stacked state through a custom
step (SCAFFOLD, FedDyn, Ditto and FedBN), and the centralized
baseline."""

from fedml_tpu_torch.algos.centralized import CentralizedTrainer
from fedml_tpu_torch.algos.config import FedConfig
from fedml_tpu_torch.algos.ditto import DittoAPI
from fedml_tpu_torch.algos.fedadapter import FedAdapterAPI
from fedml_tpu_torch.algos.fedavg import FedAvgAPI
from fedml_tpu_torch.algos.fedbn import FedBNAPI
from fedml_tpu_torch.algos.feddyn import FedDynAPI
from fedml_tpu_torch.algos.fednova import FedNovaAPI
from fedml_tpu_torch.algos.fedopt import FedOptAPI
from fedml_tpu_torch.algos.fedprox import FedProxAPI
from fedml_tpu_torch.algos.robust import FedAvgRobustAPI
from fedml_tpu_torch.algos.scaffold import ScaffoldAPI

__all__ = ["CentralizedTrainer", "DittoAPI", "FedAdapterAPI", "FedAvgAPI",
           "FedAvgRobustAPI", "FedBNAPI", "FedConfig", "FedDynAPI",
           "FedNovaAPI", "FedOptAPI", "FedProxAPI", "ScaffoldAPI"]
