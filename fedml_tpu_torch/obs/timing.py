"""Round timing and profiling (port of ``fedml_tpu/obs/timing.py``).

- :class:`RoundTimer`: per-phase wall-clock, with :meth:`RoundTimer.fence`
  waiting for the device work that produced a tree's tensors, so that a
  phase measures that work and not only its enqueue (CUDA launches return
  before the card finishes, as JAX's dispatch does);
- :func:`trace`: a context manager around ``torch.profiler.profile`` (CPU
  and, on a card, CUDA activities) that writes a Chrome trace into a
  directory, as JAX's wraps ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import time
from typing import Dict, List

import torch

from fedml_tpu_torch.obs.sanitizer import planned_transfer

log = logging.getLogger(__name__)

# One warning per failure site per process: a profiler that cannot start
# is worth saying exactly once, not once per round, and never worth
# crashing the run over.
_WARNED: set = set()


def _warn_once(key: str, msg: str, *args) -> None:
    if key not in _WARNED:
        _WARNED.add(key)
        log.warning(msg, *args)


# The profiler keeps only the device activities whose timestamps, moved
# onto the host's clock, fall inside its window. On an H100 that move put
# a FedAvg round's kernels about 20 ms late in one of 12 unpadded traces
# and about 20 ms early in another, and the kernels at that end of the
# body were dropped from the trace; short sessions lost kernels outright.
# ``trace`` holds the window open this long, the card idle, on each side
# of the body (20 padded traces of the round then held every kernel).
TRACE_PAD_S = 0.1


def _pad_window(cuda: bool) -> None:
    """Waits for the card's queued work, then ``TRACE_PAD_S`` more, inside
    the profiler's window (a planned wait: ``obs.sanitizer`` lets it pass).
    Only on a card already in use: a CPU-only trace gets no pad."""
    if cuda and torch.cuda.is_initialized():
        with planned_transfer():
            torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)


def _cuda_devices(tree, out: set) -> set:
    """The CUDA devices of the tensors in ``tree`` (dicts, sequences,
    dataclasses; other leaves ignored)."""
    if torch.is_tensor(tree):
        if tree.device.type == "cuda":
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, out)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _cuda_devices(getattr(tree, f.name), out)
    return out


class RoundTimer:
    """Usage::

        t = RoundTimer()
        with t.phase("local_train"):
            out = round_fn(...)
            t.fence(out)          # wait for the device inside the phase
        t.summary()  # {"local_train": {"mean_s": ..., "total_s": ..., "n": ...}}
    """

    def __init__(self):
        self._acc: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self._acc.setdefault(name, []).append(time.perf_counter() - t0)

    def fence(self, tree):
        """Waits for the work queued so far on the current stream of each
        CUDA device that holds a tensor of ``tree`` (the port's
        ``jax.block_until_ready``): an event recorded there and waited on,
        a deliberate wait that ``obs.sanitizer.sanitized`` lets pass.
        Returns at once for CPU tensors."""
        for dev in _cuda_devices(tree, set()):
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            with planned_transfer():
                ev.synchronize()

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for k, v in self._acc.items():
            out[k] = {
                "mean_s": sum(v) / len(v),
                "total_s": sum(v),
                "n": len(v),
                "last_s": v[-1],
            }
        return out

    def mark(self):
        """Snapshot phase counts; ``flat_metrics`` then reports only phases
        that recorded since the mark (so a round that ran no eval does not
        re-log the previous eval's duration)."""
        self._mark = {k: len(v) for k, v in self._acc.items()}

    def flat_metrics(self) -> Dict[str, float]:
        """{"time/<phase>_s": last} for phases recorded since ``mark()``
        (all phases if ``mark`` was never called)."""
        mark = getattr(self, "_mark", {})
        return {
            f"time/{k}_s": v[-1]
            for k, v in self._acc.items()
            if len(v) > mark.get(k, 0)
        }


@contextlib.contextmanager
def trace(log_dir: str):
    """Profiles the body with ``torch.profiler`` (CPU activity, and CUDA
    activity when a card is present) and writes its Chrome trace to
    ``log_dir/trace_<pid>_<ns>.json`` (Perfetto / ``chrome://tracing``;
    kernels appear by name). On a card the window reaches ``TRACE_PAD_S``
    past each end of the body, so that no kernel of the body falls out of
    it. Runs the body untraced, with one warning per process, when the
    profiler cannot start, and warns once when the trace cannot be
    written."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    prof = None
    try:
        prof = profile(activities=activities)
        prof.__enter__()
    except Exception as e:  # noqa: BLE001 — degrade to no-op, visibly
        prof = None
        _warn_once("start_trace",
                   "torch profiler start_trace failed (%s: %s) — running "
                   "WITHOUT a trace; no artifacts will land in %r",
                   type(e).__name__, e, log_dir)
    try:
        if prof is not None:
            _pad_window(cuda)
        yield
    finally:
        if prof is not None:
            try:
                _pad_window(cuda)
                prof.__exit__(None, None, None)
                os.makedirs(log_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(
                    log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
            except Exception as e:  # noqa: BLE001 — artifacts may be partial
                _warn_once("stop_trace",
                           "torch profiler stop_trace failed (%s: %s) — "
                           "trace artifacts in %r may be incomplete",
                           type(e).__name__, e, log_dir)
