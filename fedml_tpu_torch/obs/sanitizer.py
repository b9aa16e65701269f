"""Runtime sanitizer (port of ``fedml_tpu/obs/sanitizer.py``): the two
runtime symptoms of a steady-state round loop gone wrong, caught cheaply
enough to leave on in tests and benchmarks. JAX's contracts, mapped to
the port's own machinery:

- **unplanned transfers become implicit host syncs.** ``sanitized()`` arms
  ``torch.cuda.set_sync_debug_mode``, so a synchronizing CUDA call (a
  ``.item()``, a ``.tolist()``, a blocking copy between host and card) in
  the region raises ``RuntimeError`` (``"error"``) or warns (``"warn"``)
  where it happens. JAX's guard levels map as ``"disallow"`` →
  ``"error"``, ``"log"`` → ``"warn"``, ``"allow"`` → ``"default"``.
  Deliberate fetches (the losses at the end of a pipelined loop) and
  staging copies are marked with ``planned_transfer()``, which sets
  ``"default"`` for its body. The pinned ``non_blocking`` copies of the
  store's prefetch workers do not sync, so they pass unmarked.
- **recompiles become CUDA-graph captures.** :func:`compile_count` reads
  the process-wide count of captures that ``core/graph.py`` keeps
  (``CapturedStep.captures``); in strict mode a region that captured more
  than ``max_compiles`` graphs raises :class:`SanitizerError` on exit.

Unlike JAX's transfer guard, which is thread-local, the sync debug mode is
process-wide: a sync that another thread issues inside the region is
charged to it too, and ``planned_transfer()`` lifts the guard for every
thread while one thread is inside it (nested and concurrent marks are
counted, and the outermost restores the region's level). On a machine
without a card the sync trap is inert; the capture count still holds.
"""

from __future__ import annotations

import gc
import threading
from contextlib import contextmanager
from dataclasses import InitVar, dataclass, field

import torch

from fedml_tpu_torch.core.graph import CapturedStep, _leaves

#: JAX's transfer-guard levels → ``torch.cuda.set_sync_debug_mode``'s.
SYNC_MODES = {"disallow": "error", "log": "warn", "allow": "default"}


class SanitizerError(AssertionError):
    """Steady-state contract violated (captures in a sanitized region)."""


class _SyncGuard:
    """The process-wide sync debug mode, with nesting: the levels that
    ``sanitized`` regions set, and the count of ``planned_transfer`` blocks
    open (in any thread), which hold it at ``"default"``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._planned = 0
        self._outer = 0

    @staticmethod
    def armed() -> bool:
        return torch.cuda.is_available()

    def enter_region(self, level: str):
        """Sets ``level`` (a ``set_sync_debug_mode`` name) and returns what
        to restore. Inside an open ``planned_transfer`` the level waits in
        ``_outer`` until the last one closes."""
        with self._lock:
            if self._planned:
                prev, self._outer = self._outer, level
                return prev
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(level)
            return prev

    def exit_region(self, prev) -> None:
        with self._lock:
            if self._planned:
                self._outer = prev
            else:
                torch.cuda.set_sync_debug_mode(prev)

    def enter_planned(self) -> None:
        # Outside any region the mode is "default" (0) already and is not
        # set: no switch is touched where nothing is sanitized.
        with self._lock:
            if self._planned == 0:
                self._outer = torch.cuda.get_sync_debug_mode()
                if self._outer != 0:
                    torch.cuda.set_sync_debug_mode("default")
            self._planned += 1

    def exit_planned(self) -> None:
        with self._lock:
            self._planned -= 1
            if self._planned == 0 and self._outer != 0:
                torch.cuda.set_sync_debug_mode(self._outer)


_GUARD = _SyncGuard()


def compile_count() -> int:
    """Monotonic count of CUDA graphs captured in this process (the port's
    count of XLA compilations)."""
    return CapturedStep.captures


@dataclass
class SanitizerReport:
    """What the sanitized region observed. ``compiles`` (graph captures)
    is filled in on exit; inside the region it reads the running delta."""

    transfer: str = "disallow"
    max_compiles: int = 0
    compiles: int = 0
    _start: int = field(default=0, repr=False)
    _closed: bool = field(default=False, repr=False)

    def compiles_so_far(self) -> int:
        if self._closed:
            return self.compiles
        return compile_count() - self._start

    def assert_clean(self) -> None:
        n = self.compiles_so_far()
        if n > self.max_compiles:
            raise SanitizerError(
                f"sanitized region captured {n} CUDA graph(s) (allowed: "
                f"{self.max_compiles}): the steady-state loop is capturing "
                "anew — look for step-bucket churn (a cohort or window at a "
                "step count the warm-up never ran), a carry or argument "
                "whose shape or dtype drifts, or a watched tensor (the "
                "dataset, a frozen base) replaced, which drops every graph")


@contextmanager
def sanitized(transfer: str = "disallow", max_compiles: int = 0,
              strict: bool = True):
    """Run the body as a steady-state region: implicit host syncs raise
    where they happen (``transfer="disallow"``; ``"log"`` warns,
    ``"allow"`` lets them pass), and on exit the region must not have
    captured more than ``max_compiles`` CUDA graphs (``SanitizerError``
    when ``strict``; inspect the yielded report when not). Warm the loop
    up OUTSIDE the region first: capturing each step bucket once is
    planned, capturing again afterwards is the bug. The previous sync
    mode is restored on exit, also when the body raises."""
    if transfer not in SYNC_MODES:
        raise ValueError(f"transfer={transfer!r}: expected one of "
                         f"{sorted(SYNC_MODES)}")
    report = SanitizerReport(transfer=transfer, max_compiles=max_compiles,
                             _start=compile_count())
    armed = _GUARD.armed()
    prev = _GUARD.enter_region(SYNC_MODES[transfer]) if armed else None
    try:
        yield report
    finally:
        if armed:
            _GUARD.exit_region(prev)
    report.compiles = compile_count() - report._start
    report._closed = True
    if strict:
        report.assert_clean()


@contextmanager
def planned_transfer():
    """Mark a deliberate host↔device copy or fetch inside a ``sanitized()``
    region (the loss fetch at the end of a loop, a round's staging
    copies): the sync debug mode is ``"default"`` for the body (for every
    thread, the mode being process-wide) and the region's level after
    it. A no-op without a card."""
    if not _GUARD.armed():
        yield
        return
    _GUARD.enter_planned()
    try:
        yield
    finally:
        _GUARD.exit_planned()


@dataclass
class DonationAudit:
    """Counts LIVE copies of model-sized buffers on the model's device, in
    units of one whole model: the runtime check that a round loop does not
    pile up copies of the model (an undonated carry, a stray reference).

    Mechanism: the template's leaf signatures (shape, dtype) are matched
    against every live tensor on the template's device that the garbage
    collector tracks (``gc.get_objects()`` after a collection), each
    counted once per
    storage, offset and shape, so several Python handles on one buffer
    count once. ``sample()`` after each round records the running peak.

    The port's steady state is not JAX's 1.0: a round replays a captured
    CUDA graph whose static carry (``core/graph.py``) is ``api.net`` itself,
    while the ``nn.Module`` the api was built from keeps its own
    parameters, and a class may keep more (FedOpt's server moments). Pin a
    loop against its own baseline sampled after warm-up, as the tests do.

    Matching is by signature, so an unrelated live tensor that shares a
    leaf's signature counts too: treat ``copies()`` as an upper bound. The
    graph pools' internal buffers hold no Python tensor and are not
    counted."""

    template: InitVar[object]
    peak: float = 0.0

    def __post_init__(self, template):
        # Signatures only: holding the template would keep a replaced net
        # alive and count it.
        leaves = _leaves(template)
        self._sigs = frozenset((tuple(t.shape), t.dtype) for t in leaves)
        self._device = leaves[0].device if leaves else torch.device("cpu")
        self._bytes_one = float(sum(
            t.numel() * t.element_size() for t in leaves)) or 1.0

    def copies(self) -> float:
        """Live bytes matching the template's leaf signatures, in units of
        one whole model copy."""
        seen = set()
        live = 0.0
        gc.collect()  # what only a reference cycle kept is not live
        for obj in gc.get_objects():
            # (type, not isinstance: a deprecated module attribute warns
            # on ``__class__``)
            if not issubclass(type(obj), torch.Tensor):
                continue
            try:
                if obj.device != self._device or obj.is_meta:
                    continue
                sig = (tuple(obj.shape), obj.dtype)
                if sig not in self._sigs:
                    continue
                key = (obj.untyped_storage().data_ptr(),
                       obj.storage_offset(), sig)
            except RuntimeError:  # a tensor without storage (a functorch
                continue  # wrapper, a fake tensor)
            if key not in seen:
                seen.add(key)
                live += obj.numel() * obj.element_size()
        return live / self._bytes_one

    def sample(self) -> float:
        n = self.copies()
        self.peak = max(self.peak, n)
        return n


@contextmanager
def donation_audit(template):
    """Audit a steady-state round loop for model-buffer copies: yields a
    :class:`DonationAudit` built from ``template`` (the model's
    ``NetState`` or params tree); call ``sample()`` after each round and
    assert ``peak`` against the baseline sampled after warm-up."""
    audit = DonationAudit(template)
    del template  # this frame must not keep a replaced net alive
    yield audit
