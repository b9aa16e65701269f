"""Metrics logging (port of ``fedml_tpu/obs/logger.py``, which is
stdlib-only; copied so the port imports nothing of ``fedml_tpu``): the
reference's W&B-everywhere pattern (FedAVGAggregator.py:140-161,
wandb.init at main_fedavg.py:430-443) behind a pluggable sink so runs
work with no external service.

``MetricsLogger.log(metrics, step)`` fans out to sinks:
- ``JsonlSink`` — one JSON object per line (the offline default; doubles as
  the machine-readable run record the reference keeps in wandb-summary.json)
- ``StdoutSink`` — human-readable via ``logging``
- ``WandbSink`` — real W&B when the package + a login exist (import-gated)
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, List, Optional


class JsonlSink:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")

    def log(self, metrics: Dict, step: int):
        self._f.write(json.dumps({"step": step, **metrics}) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


class StdoutSink:
    def __init__(self, name: str = "fedml_tpu_torch"):
        self._log = logging.getLogger(name)

    def log(self, metrics: Dict, step: int):
        self._log.info("step=%d %s", step, json.dumps(metrics))

    def close(self):
        pass


class WandbSink:
    """Real Weights & Biases, constructed only if importable (the reference
    hard-depends on wandb; we degrade gracefully)."""

    def __init__(self, project: str, config: Optional[Dict] = None, **kw):
        import wandb  # gated; raises ImportError when absent

        self._run = wandb.init(project=project, config=config, **kw)
        self._wandb = wandb

    def log(self, metrics: Dict, step: int):
        # ``step`` rides the wandb axis, not the metric dict (the full
        # entry now includes it for the file sinks).
        self._wandb.log({k: v for k, v in metrics.items() if k != "step"},
                        step=step)

    def close(self):
        self._run.finish()


class MetricsLogger:
    """Fan-out logger + in-memory history (so callers can assert on curves
    the way the reference's CI reads wandb-summary.json)."""

    def __init__(self, sinks=()):
        self.sinks = list(sinks)
        self.history: List[Dict] = []

    @classmethod
    def for_run(cls, run_dir: Optional[str] = None, stdout: bool = True,
                wandb_project: Optional[str] = None, config: Optional[Dict] = None):
        sinks = []
        if run_dir:
            sinks.append(JsonlSink(os.path.join(run_dir, "metrics.jsonl")))
        if stdout:
            sinks.append(StdoutSink())
        if wandb_project:
            try:
                sinks.append(WandbSink(wandb_project, config))
            except Exception:
                logging.getLogger(__name__).warning(
                    "wandb unavailable; continuing without it")
        return cls(sinks)

    def log(self, metrics: Dict, step: int, prefix: Optional[str] = None):
        """``prefix`` namespaces the keys (``"ctrl"`` → ``ctrl/evictions``)
        so structured subsystem streams — e.g. the distributed control
        plane's per-round health counters (evictions, readmissions,
        duplicate/epoch drops, send retries) — coexist with the training
        curves in one history/sink without key collisions."""
        if prefix:
            metrics = {f"{prefix}/{k}": v for k, v in metrics.items()}
        entry = {"step": step, "ts": time.time(), **metrics}
        self.history.append(entry)
        # Sinks receive the FULL entry, ``ts`` included: metrics.jsonl
        # rows from different processes (server + silo ranks appending to
        # one run_dir) are only orderable by wall clock, and the old
        # metrics-only fan-out silently dropped it.
        for s in self.sinks:
            s.log(entry, step)

    def summary(self) -> Dict:
        """Last value per key — the wandb-summary.json equivalent the
        reference's equivalence CI asserts on (CI-script-fedavg.sh:40-45)."""
        out: Dict = {}
        for e in self.history:
            out.update(e)
        return out

    def close(self):
        for s in self.sinks:
            s.close()
