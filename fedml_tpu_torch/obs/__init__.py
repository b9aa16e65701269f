"""Observability of the port: the metrics registry and the span tracer."""

from fedml_tpu_torch.obs import trace
from fedml_tpu_torch.obs.registry import (Counter, Gauge, Histogram,
                                          MetricsRegistry)
from fedml_tpu_torch.obs.trace import NullTracer, SpanTracer

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "NullTracer",
           "SpanTracer", "trace"]
