"""Name → constructor registry for the port's models (port of
``fedml_tpu/models/registry.py``)."""

from __future__ import annotations

from typing import Callable, Dict

import torch

_REGISTRY: Dict[str, Callable] = {}


def resolve_dtype(dtype):
    """'bf16'/'bfloat16' → ``torch.bfloat16``; None and torch dtypes pass
    through. The compute-dtype convention of every factory."""
    if dtype in ("bf16", "bfloat16"):
        return torch.bfloat16
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    raise ValueError(f"unknown dtype {dtype!r}: expected bf16 or a "
                     "torch dtype")


def register_model(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def create_model(name: str, **kwargs):
    """Build a registered model. ``device=None`` puts it on ``cuda`` (and
    raises without one); the tests pass ``device="cpu"``."""
    if name not in _REGISTRY:
        # Import side-effect registration; import errors propagate.
        import fedml_tpu_torch.models.cnn  # noqa: F401
        import fedml_tpu_torch.models.darts  # noqa: F401
        import fedml_tpu_torch.models.efficientnet  # noqa: F401
        import fedml_tpu_torch.models.gan  # noqa: F401
        import fedml_tpu_torch.models.lr  # noqa: F401
        import fedml_tpu_torch.models.mobilenet  # noqa: F401
        import fedml_tpu_torch.models.mobilenet_v3  # noqa: F401
        import fedml_tpu_torch.models.resnet  # noqa: F401
        import fedml_tpu_torch.models.resnet_split  # noqa: F401
        import fedml_tpu_torch.models.rnn  # noqa: F401
        import fedml_tpu_torch.models.transformer  # noqa: F401
        import fedml_tpu_torch.models.unet  # noqa: F401
        import fedml_tpu_torch.models.vfl  # noqa: F401
        import fedml_tpu_torch.models.vgg  # noqa: F401
        import fedml_tpu_torch.models.vit  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)
