"""Federated algorithms of the port: FedAvg on one card."""

from fedml_tpu_torch.algos.config import FedConfig
from fedml_tpu_torch.algos.fedavg import FedAvgAPI

__all__ = ["FedAvgAPI", "FedConfig"]
