"""The port's models: the frozen-base transformer LM with per-call LoRA
adapters, the CIFAR GroupNorm ResNets, the split ResNet pair of FedGKT and
split learning, logistic regression, the vertical-FL party models, the
DARTS search and genotype networks of FedNAS, FedSeg's UNet and FedGAN's
MNIST GAN, created through :func:`create_model`."""

from fedml_tpu_torch.models.registry import (create_model, register_model,
                                             resolve_dtype)

__all__ = ["create_model", "register_model", "resolve_dtype"]
