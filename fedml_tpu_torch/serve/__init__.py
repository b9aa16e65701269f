"""Multi-tenant adapter serving on the card (port of ``fedml_tpu/serve``):
one batched frozen-base forward for many personalized adapters
(serve.forward) behind a micro-batching request plane (serve.plane), and
the shadow-gated rollout of new global adapters (serve.rollout)."""

from fedml_tpu_torch.serve.forward import (FLASH_CROSSOVER_T, AdapterDecoder,
                                           ServeForward, pick_attention)
from fedml_tpu_torch.serve.plane import (ServeManager, ServeOverload,
                                         ServeRefused, ServeRequest,
                                         ServeSocketServer)
from fedml_tpu_torch.serve.rollout import RolloutCoordinator, StaleEpochError

__all__ = [
    "FLASH_CROSSOVER_T",
    "AdapterDecoder",
    "RolloutCoordinator",
    "ServeForward",
    "ServeManager",
    "ServeOverload",
    "ServeRefused",
    "ServeRequest",
    "ServeSocketServer",
    "StaleEpochError",
    "pick_attention",
]
