"""Shared utilities (port of ``fedml_tpu/utils.py``, which is stdlib-only;
copied so the port imports nothing of ``fedml_tpu``; reference
fedml_api/utils parity).

- ``raise_error``: contextmanager logging the traceback before re-raising
  (context.py:9-18 ``raise_MPI_error`` — but without the Abort: callers
  decide lifecycle; use HeartbeatMonitor / nan_guard for containment);
- ``get_lock``: contextmanager around a ``threading.Lock`` (context.py:30);
- ``logging_config``: per-rank logging format (utils/logger.py:7,
  main_fedavg.py:411-415);
- ``rss_mb``: the process's current host RSS in MB;
- ``post_complete_message_to_sweep_process``: fifo signal used by sweep
  drivers (fedavg/utils.py:19-27).
"""

from __future__ import annotations

import contextlib
import logging
import os
import traceback


@contextlib.contextmanager
def raise_error(logger: logging.Logger | None = None):
    try:
        yield
    except Exception:
        (logger or logging.getLogger(__name__)).error(traceback.format_exc())
        raise


@contextlib.contextmanager
def get_lock(lock):
    lock.acquire()
    try:
        yield lock
    finally:
        lock.release()


def logging_config(process_id: int = 0, level=logging.INFO):
    """Per-rank prefixed logging (reference main_fedavg.py:411-415)."""
    logging.basicConfig(
        level=level,
        format=(
            f"[rank {process_id}] %(asctime)s %(levelname)s "
            "%(filename)s:%(lineno)d %(message)s"
        ),
        force=True,
    )


def rss_mb() -> float:
    """CURRENT host RSS in MB (/proc/self/statm — Linux; falls back to
    the getrusage peak elsewhere). Current, not ru_maxrss: the process
    peak is monotone, so point-in-time memory claims (the sharded
    store's flat-RSS story, the store drives' host-memory axis) need
    live samples."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 1e6
    except Exception:
        # Non-Linux fallback: ru_maxrss is the MONOTONE process peak
        # (point-in-time claims degenerate toward ratio 1.0 here —
        # Linux is the measured platform), and macOS reports bytes
        # where Linux uses KB.
        import resource
        import sys

        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return peak / (1024.0 ** 2 if sys.platform == "darwin" else 1024.0)


def post_complete_message_to_sweep_process(args, pipe_path: str = "./tmp/fedml"):
    """Write a completion line to a fifo so a sweep driver can advance
    (reference fedavg/utils.py:19-27). No-op if the fifo cannot be created."""
    try:
        os.makedirs(os.path.dirname(pipe_path), exist_ok=True)
        if not os.path.exists(pipe_path):
            os.mkfifo(pipe_path)
        fd = os.open(pipe_path, os.O_WRONLY | os.O_NONBLOCK)
        try:
            os.write(fd, f"training is finished! \n{args}\n".encode())
        finally:
            os.close(fd)
    except OSError:
        logging.getLogger(__name__).debug("no sweep fifo reader; skipping")
