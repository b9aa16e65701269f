"""Federated data of the port: numpy partitioners and synthetic sets, the
rectangular ``[C, S, B, ...]`` + mask layout as tensors on a device, and
(in ``data.store`` and ``data.directory``) the host-resident stores that
stream cohorts to it."""

from fedml_tpu_torch.data.batching import (FederatedArrays, WindowBatch,
                                           batch_global,
                                           build_federated_arrays,
                                           gather_clients)
from fedml_tpu_torch.data.partition import (partition_dirichlet,
                                            partition_homo)
from fedml_tpu_torch.data.synthetic import (make_classification,
                                            make_image_classification)

__all__ = ["FederatedArrays", "WindowBatch", "batch_global",
           "build_federated_arrays", "gather_clients", "make_classification",
           "make_image_classification",
           "partition_dirichlet", "partition_homo"]
