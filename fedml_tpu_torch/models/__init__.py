"""The port's models: the frozen-base transformer LM with per-call LoRA
adapters, created through :func:`create_model`."""

from fedml_tpu_torch.models.registry import (create_model, register_model,
                                             resolve_dtype)

__all__ = ["create_model", "register_model", "resolve_dtype"]
