"""Federated data of the port: numpy partitioners and synthetic sets, and
the rectangular ``[C, S, B, ...]`` + mask layout as tensors on a device."""

from fedml_tpu_torch.data.batching import (FederatedArrays, batch_global,
                                           build_federated_arrays,
                                           gather_clients)
from fedml_tpu_torch.data.partition import (partition_dirichlet,
                                            partition_homo)
from fedml_tpu_torch.data.synthetic import (make_classification,
                                            make_image_classification)

__all__ = ["FederatedArrays", "batch_global", "build_federated_arrays",
           "gather_clients", "make_classification",
           "make_image_classification",
           "partition_dirichlet", "partition_homo"]
