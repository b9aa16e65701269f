"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``), each beside its
plain PyTorch twin."""

from fedml_tpu_torch.ops.flash_attention import (flash_attention,
                                                 flash_attention_plain)

__all__ = ["flash_attention", "flash_attention_plain"]
