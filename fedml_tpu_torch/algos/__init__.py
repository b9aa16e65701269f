"""Federated algorithms of the port on one card: FedAvg, FedAdapter
(FedAvg over the LoRA adapters of a frozen-base transformer), the
algorithms that ride FedAvg's round (FedOpt, FedProx, FedNova,
FedAvgRobust, FedAc, ServerAvg and q-FedAvg), those that carry
client-stacked state through a custom step (SCAFFOLD, FedDyn, Ditto and
FedBN), those with their own host loop over FedAvg's round (hierarchical
FL, TurboAggregate's secure aggregation), serverless gossip (DSGD and
PushSum), the standalone loops of the model-split family (FedGKT, split
learning, vertical FL), the simulator zoo's own local steps on FedAvg's
round (FedNAS's bilevel search, FedSeg's segmentation losses, FedGAN's
adversarial step), the centralized baseline, and the message-passing
federation's asynchronous tiers (FedAsync, FedBuff; the synchronous
tier is ``algos/fedavg_distributed.py``)."""

from fedml_tpu_torch.algos.centralized import CentralizedTrainer
from fedml_tpu_torch.algos.config import FedConfig
from fedml_tpu_torch.algos.decentralized import DecentralizedAPI
from fedml_tpu_torch.algos.ditto import DittoAPI
from fedml_tpu_torch.algos.fedac import FedAcAPI, ServerAvgAPI
from fedml_tpu_torch.algos.fedadapter import FedAdapterAPI
from fedml_tpu_torch.algos.fedasync import FedML_FedAsync_distributed
from fedml_tpu_torch.algos.fedavg import FedAvgAPI
from fedml_tpu_torch.algos.fedbn import FedBNAPI
from fedml_tpu_torch.algos.fedbuff import FedML_FedBuff_distributed
from fedml_tpu_torch.algos.fedgan import FedGanAPI
from fedml_tpu_torch.algos.fedgkt import FedGKTAPI
from fedml_tpu_torch.algos.feddyn import FedDynAPI
from fedml_tpu_torch.algos.fednas import FedNASAPI
from fedml_tpu_torch.algos.fednova import FedNovaAPI
from fedml_tpu_torch.algos.fedopt import FedOptAPI
from fedml_tpu_torch.algos.fedprox import FedProxAPI
from fedml_tpu_torch.algos.fedseg import FedSegAPI
from fedml_tpu_torch.algos.hierarchical import HierarchicalFedAvgAPI
from fedml_tpu_torch.algos.qfedavg import QFedAvgAPI
from fedml_tpu_torch.algos.robust import FedAvgRobustAPI
from fedml_tpu_torch.algos.scaffold import ScaffoldAPI
from fedml_tpu_torch.algos.split_nn import SplitNNAPI
from fedml_tpu_torch.algos.turboaggregate import TurboAggregateAPI
from fedml_tpu_torch.algos.vertical_fl import VflAPI

__all__ = ["CentralizedTrainer", "DecentralizedAPI", "DittoAPI",
           "FedAcAPI", "FedAdapterAPI", "FedAvgAPI", "FedAvgRobustAPI",
           "FedBNAPI", "FedConfig", "FedDynAPI", "FedGanAPI", "FedGKTAPI",
           "FedML_FedAsync_distributed", "FedML_FedBuff_distributed",
           "FedNASAPI", "FedNovaAPI", "FedOptAPI", "FedProxAPI",
           "FedSegAPI", "HierarchicalFedAvgAPI", "QFedAvgAPI",
           "ScaffoldAPI", "ServerAvgAPI", "SplitNNAPI", "TurboAggregateAPI",
           "VflAPI"]
