"""Multi-tenant adapter serving on the card (port of ``fedml_tpu/serve``):
one batched frozen-base forward for many personalized adapters
(serve.forward) behind a micro-batching request plane (serve.plane).
The rollout loop (``serve/rollout.py``) is not ported yet."""

from fedml_tpu_torch.serve.forward import (FLASH_CROSSOVER_T, AdapterDecoder,
                                           ServeForward, pick_attention)
from fedml_tpu_torch.serve.plane import (ServeManager, ServeOverload,
                                         ServeRefused, ServeRequest,
                                         ServeSocketServer)

__all__ = [
    "FLASH_CROSSOVER_T",
    "AdapterDecoder",
    "ServeForward",
    "ServeManager",
    "ServeOverload",
    "ServeRefused",
    "ServeRequest",
    "ServeSocketServer",
    "pick_attention",
]
