"""Observability of the port: the metrics registry, the span tracer and
run checkpoints."""

from fedml_tpu_torch.obs import trace
from fedml_tpu_torch.obs.checkpoint import (CheckpointManager, RunState,
                                            allocate_epoch,
                                            restore_federation, restore_run,
                                            save_federation, save_run)
from fedml_tpu_torch.obs.registry import (Counter, Gauge, Histogram,
                                          MetricsRegistry)
from fedml_tpu_torch.obs.trace import NullTracer, SpanTracer

__all__ = ["CheckpointManager", "Counter", "Gauge", "Histogram",
           "MetricsRegistry", "NullTracer", "RunState", "SpanTracer",
           "allocate_epoch", "restore_federation", "restore_run",
           "save_federation", "save_run", "trace"]
