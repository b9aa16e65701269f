"""Federated data of the port: numpy partitioners and synthetic sets, the
rectangular ``[C, S, B, ...]`` + mask layout as tensors on a device,
(in ``data.store`` and ``data.directory``) the host-resident stores that
stream cohorts to it, and (in ``data.loaders``, ``data.text`` and
``data.augment``) the dataset loaders of the experiment CLI."""

from fedml_tpu_torch.data.batching import (FederatedArrays, WindowBatch,
                                           batch_global,
                                           build_federated_arrays,
                                           gather_clients)
from fedml_tpu_torch.data.partition import (partition_dirichlet,
                                            partition_homo,
                                            partition_power_law,
                                            record_data_stats)
from fedml_tpu_torch.data.synthetic import (make_classification,
                                            make_femnist_shaped,
                                            make_hetero_charlm,
                                            make_image_classification,
                                            make_segmentation,
                                            make_stackoverflow_nwp,
                                            make_stackoverflow_shard,
                                            synthetic_alpha_beta)

__all__ = ["FederatedArrays", "WindowBatch", "batch_global",
           "build_federated_arrays", "gather_clients", "make_classification",
           "make_femnist_shaped", "make_hetero_charlm",
           "make_image_classification", "make_segmentation",
           "make_stackoverflow_nwp", "make_stackoverflow_shard",
           "partition_dirichlet", "partition_homo", "partition_power_law",
           "record_data_stats", "synthetic_alpha_beta"]
