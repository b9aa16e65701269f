"""Federated algorithms of the port on one card: FedAvg, and FedAdapter
(FedAvg over the LoRA adapters of a frozen-base transformer)."""

from fedml_tpu_torch.algos.config import FedConfig
from fedml_tpu_torch.algos.fedadapter import FedAdapterAPI
from fedml_tpu_torch.algos.fedavg import FedAvgAPI

__all__ = ["FedAdapterAPI", "FedAvgAPI", "FedConfig"]
