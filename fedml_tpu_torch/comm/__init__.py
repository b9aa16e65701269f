"""Host-side communication layer (port of ``fedml_tpu/comm``; the
reference's ``fedml_core/distributed``).

The simulators aggregate clients on one card (``fedml_tpu_torch.algos``);
this package exists for true cross-silo federation, where clients are
separate OS processes or hosts. It mirrors the reference's architecture —
a ``Message`` envelope, a pluggable ``BaseCommunicationManager``, observer
dispatch, and ``ClientManager`` / ``ServerManager`` process bases — with
two backends:

- ``loopback`` — in-memory threaded router for tests and single-host
  multi-worker runs (optionally round-tripping every message through a
  real wire format);
- ``tcp`` — native C++ length-prefixed socket transport
  (``fedml_tpu_torch/native/msgnet.cpp``), the cross-silo role the
  reference fills with gRPC.

The wire (``wire.py``), the negotiated codecs (``codec.py``) and the
parallel ingest pool (``ingest.py``) are numpy on the host, as in the JAX
package; they walk a tree's leaves in ``jax.tree``'s order
(``core/tree.sorted_flatten``), so frames and fixed-point folds are the
JAX package's byte for byte, and ``pytree.py`` holds a tree's leaves on
the host (bfloat16 as CPU ``torch.bfloat16`` tensors). Secure
aggregation (``secagg.py``) and the sharded aggregation plane
(``shardplane.py``, imported on use: it imports the model stack) fold on
the host too; the fleet simulator's ``SIM`` fabric lives in
``fedml_tpu_torch.sim``. The gRPC, MQTT and TRPC backends are not ported
yet (ROADMAP.md A10d).

Cross-cutting resilience (``resilience.py``): one ``RetryPolicy`` shared
by the transports' ``send_message``, and ``ChaosTransport`` — a seeded
deterministic fault injector (drop/delay/duplicate/reorder/partition)
over any backend.
"""

from fedml_tpu_torch.comm.message import Message
from fedml_tpu_torch.comm.base import BaseCommunicationManager, Observer
from fedml_tpu_torch.comm.codec import (
    CodecError,
    WireCodec,
    codec_offer,
    make_wire_codec,
    negotiate,
)
from fedml_tpu_torch.comm.loopback import LoopbackNetwork, LoopbackCommManager
from fedml_tpu_torch.comm.managers import ClientManager, ServerManager
from fedml_tpu_torch.comm.resilience import (
    ChaosSpec,
    ChaosTransport,
    HeartbeatSender,
    RetryGiveUp,
    RetryPolicy,
)
from fedml_tpu_torch.comm.wire import ByteLedger

__all__ = [
    "Message",
    "BaseCommunicationManager",
    "Observer",
    "ByteLedger",
    "CodecError",
    "WireCodec",
    "codec_offer",
    "make_wire_codec",
    "negotiate",
    "LoopbackNetwork",
    "LoopbackCommManager",
    "ClientManager",
    "ServerManager",
    "ChaosSpec",
    "ChaosTransport",
    "HeartbeatSender",
    "RetryGiveUp",
    "RetryPolicy",
]
