"""Observability of the port: metrics sinks, round timing and profiling,
span tracing and the flight recorder, the metrics registry, run
checkpoints, model cost and the runtime sanitizer."""

from fedml_tpu_torch.obs.logger import (JsonlSink, MetricsLogger, StdoutSink,
                                        WandbSink)
# NOTE: ``obs.trace`` is the span-tracer MODULE; the profiler context
# manager stays importable as ``obs.timing.trace``, as in the JAX package.
from fedml_tpu_torch.obs import trace
from fedml_tpu_torch.obs.timing import RoundTimer
from fedml_tpu_torch.obs.trace import (FlightRecorder, NullTracer,
                                       SpanTracer, tracing_to)
from fedml_tpu_torch.obs.registry import (Counter, Gauge, Histogram,
                                          MetricsRegistry)
from fedml_tpu_torch.obs.checkpoint import (CheckpointManager, RunState,
                                            allocate_epoch,
                                            restore_federation, restore_run,
                                            save_federation, save_run)
from fedml_tpu_torch.obs.flops import count_params, flops_str, model_cost
from fedml_tpu_torch.obs.sanitizer import (DonationAudit, SanitizerError,
                                           SanitizerReport, compile_count,
                                           donation_audit, planned_transfer,
                                           sanitized)

__all__ = ["CheckpointManager", "Counter", "DonationAudit", "FlightRecorder",
           "Gauge", "Histogram", "JsonlSink", "MetricsLogger",
           "MetricsRegistry", "NullTracer", "RoundTimer", "RunState",
           "SanitizerError", "SanitizerReport", "SpanTracer", "StdoutSink",
           "WandbSink", "allocate_epoch", "compile_count", "count_params",
           "donation_audit", "flops_str", "model_cost", "planned_transfer",
           "restore_federation", "restore_run", "sanitized",
           "save_federation", "save_run", "trace", "tracing_to"]
