"""The port's models: the frozen-base transformer LM with per-call LoRA
adapters, the CIFAR ResNets (GroupNorm or BatchNorm) and the ImageNet-style
``resnet*_gn``, the split ResNet pair of FedGKT and split learning,
logistic regression, the FedAvg CNNs, the Shakespeare and StackOverflow
LSTMs, the vertical-FL party models, the DARTS search and genotype networks
of FedNAS, FedSeg's UNet, FedGAN's MNIST GAN and the ViT classifier,
created through :func:`create_model`; ``torch_convert`` loads reference
torch CIFAR-ResNet checkpoints, and ``save_params`` / ``load_params``
(``pretrained``) write and read a model's weights in the JAX package's
``.npz`` layout."""

from fedml_tpu_torch.models.pretrained import load_params, save_params
from fedml_tpu_torch.models.registry import (create_model, register_model,
                                             resolve_dtype)

__all__ = ["create_model", "load_params", "register_model", "resolve_dtype",
           "save_params"]
