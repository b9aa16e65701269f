"""Captured round steps: the port's counterpart of ``jax.jit(step,
donate_argnums=(0, 1))`` (``fedml_tpu/algos/fedavg.py``
``_fused_round_step`` and ``train_rounds_on_device``).

:class:`CapturedStep` runs ``step(carry, *args) -> (carry', out)``, where
every operand is a tree (dicts, tuples, lists, dataclasses, ``None``) of
tensors. On a CUDA device it

- warms the step up once on a side stream (cuDNN picks its algorithms
  and workspaces there; the outputs are dropped);
- captures one call into a ``torch.cuda.CUDAGraph`` over static copies of
  the carry and of the args, with the new carry copied back into the
  carry's static buffers at the end of the captured step: the port's
  donation (a leaf that the step updated in place, as the client stacks
  of the "custom" protocol are, is its own buffer and is not copied);
- and replays the graph on every call, after copying the caller's carry
  and args into the static buffers. A carry leaf that IS its static
  buffer, as the previous call returned it, is not copied.

The returned carry is the static buffers and ``out`` the graph's own
output, so the next replay overwrites both, as JAX consumes donated
buffers: clone what must outlive it. One graph is kept per spec (the
structure, shapes and dtypes of the carry and the args), as JAX keeps one
executable per shape: a streamed cohort changes its step bucket from
round to round, and each bucket is captured once and replayed after. The
cache holds at most :data:`MAX_GRAPHS` graphs (the least recently used
goes: power-of-two buckets from 1 to 128 steps);
each graph has its own memory pool. Every graph is dropped when a tensor
of ``watch()`` (what the step reads in place: the dataset, a frozen base)
is another tensor than at capture. Unreachable objects are collected
before a capture and the cyclic collector is paused during it (a dropped
graph freed mid-capture would invalidate the capture). A capture or
replay that fails raises :class:`GraphCaptureError`; the step never runs
eagerly instead.

A capture holds :data:`capture_lock`, which other threads take around
the device work they issue beside the rounds (the store prefetchers'
pinned allocations and host-to-device copies): a CUDA call from another
thread in the middle of a capture in the default ``"global"`` mode would
fail the capture or the call, so a capture waits out such work and the
work waits out a capture.
On the CPU the step runs eagerly: the tests ask for that with
``device="cpu"``.

Kernel wrappers count their launches in Python, when they are called: a
capture calls them once and a replay not at all. So each wrapper registers
its counters here (:func:`launch_counter`); a capture measures by how much
it moved them, restores them, and every replay adds that much again, so a
counter keeps counting the launches that ran. ``CapturedStep.captures``
and ``CapturedStep.replays`` count the helper's own work.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import threading
import time

import torch

#: ``(owner, attribute)`` of every launch counter: the kernel wrappers'.
_COUNTERS = []

#: Taken by every capture and by device work that another thread issues
#: beside the captured steps (the store prefetchers' copies).
capture_lock = threading.RLock()

#: Graphs a ``CapturedStep`` keeps, one per spec.
MAX_GRAPHS = 8


def launch_counter(owner, *names) -> None:
    """Registers ``owner.<name>`` for each name as a launch counter, set to
    0: a replay adds to it what the captured call added."""
    for name in names:
        setattr(owner, name, 0)
        _COUNTERS.append((owner, name))


def _counts():
    return [getattr(owner, name) for owner, name in _COUNTERS]


def _set_counts(values) -> None:
    for (owner, name), value in zip(_COUNTERS, values):
        setattr(owner, name, value)


def _map(fn, tree):
    if torch.is_tensor(tree):
        return fn(tree)
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    raise TypeError(f"a captured step's operands are trees of tensors, got "
                    f"{type(tree).__name__}")


def _leaves(tree):
    out = []
    _map(out.append, tree)
    return out


def _spec(tree):
    """What a capture depends on: the tree's structure and its leaves'
    shapes, dtypes and devices (compared with ``==``)."""
    return _map(lambda t: (tuple(t.shape), t.dtype, t.device), tree)


class GraphCaptureError(RuntimeError):
    """A step could not be captured or replayed as a CUDA graph."""


class _Graph:
    """One captured spec: the graph, its static carry, args and output,
    what the capture added to the launch counters, and its cost."""

    __slots__ = ("graph", "carry", "args", "out", "delta", "capture_ms",
                 "reserved", "replays")


class CapturedStep:
    """``step(carry, *args) -> (carry', out)`` captured once per spec and
    replayed on ``device`` (eager on the CPU). ``watch()`` returns the
    tensors that the step reads in place."""

    captures = 0
    replays = 0

    def __init__(self, step, device, watch):
        self.step, self.device, self.watch = step, torch.device(device), watch
        self.capture_ms = None  # host ms of the last warm-up + capture
        self._graphs = collections.OrderedDict()
        self._watched = None

    def _drop(self) -> None:
        self._graphs.clear()
        self._watched = None

    def graph_stats(self):
        """One dict per cached graph: its args' shapes, the capture's host
        ms, the bytes the device's caching allocator reserved over the
        warm-up and capture (the graph's pool and static buffers) and its
        replays."""
        return [{"args": [tuple(t.shape) for t in _leaves(g.args)],
                 "capture_ms": g.capture_ms, "reserved": g.reserved,
                 "replays": g.replays} for g in self._graphs.values()]

    def __call__(self, carry, *args):
        if self.device.type != "cuda":
            return self.step(carry, *args)
        watched = [(t.data_ptr(), tuple(t.shape), t.dtype)
                   for t in self.watch()]
        if watched != self._watched:
            self._drop()
            self._watched = watched
        key = repr((_spec(carry), _spec(args)))
        g = self._graphs.get(key)
        if g is None:
            g = self._capture(carry, args, key)
        else:
            self._graphs.move_to_end(key)
            for dst, src in zip(_leaves(g.carry) + _leaves(g.args),
                                _leaves(carry) + _leaves(args)):
                if src is not dst:
                    dst.copy_(src)
        try:
            g.graph.replay()
        except RuntimeError as exc:
            raise GraphCaptureError(
                f"replay of the captured step failed: {exc}") from exc
        CapturedStep.replays += 1
        g.replays += 1
        if any(g.delta):
            _set_counts([c + d for c, d in zip(_counts(), g.delta)])
        return g.carry, g.out

    def _capture(self, carry, args, key) -> _Graph:
        # A capture is the port's compile: its own device syncs are
        # planned, and ``obs.sanitizer`` counts the capture instead. (A
        # local import: the sanitizer imports this module.)
        from fedml_tpu_torch.obs.sanitizer import planned_transfer

        while len(self._graphs) >= MAX_GRAPHS:
            self._graphs.popitem(last=False)
        with capture_lock, planned_transfer():
            return self._capture_locked(carry, args, key)

    def _capture_locked(self, carry, args, key) -> _Graph:
        t0 = time.perf_counter()
        reserved0 = torch.cuda.memory_reserved(self.device)
        s_carry = _map(torch.clone, carry)
        s_args = _map(torch.clone, args)
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self.step(s_carry, *s_args)
            # A step may update its donated carry in place (the client
            # stacks' scatter): the capture starts from the carry as given.
            for dst, src in zip(_leaves(s_carry), _leaves(carry)):
                dst.copy_(src)
        current.wait_stream(side)
        before = _counts()
        graph = torch.cuda.CUDAGraph()
        # An unreachable CUDA graph (a dropped api's step) that the cyclic
        # collector frees while this one is captured destroys its
        # executable mid-capture, which invalidates the capture: collect
        # before, never during it.
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            # The outer stream context restores the caller's stream even
            # when the capture's own exit raises.
            with torch.cuda.stream(side), torch.cuda.graph(graph,
                                                           stream=side):
                new_carry, out = self.step(s_carry, *s_args)
                if _spec(new_carry) != _spec(s_carry):
                    raise GraphCaptureError(
                        "the step returned a carry of another structure, "
                        "shape or dtype than it was given; it cannot be "
                        "captured with its carry donated")
                for dst, src in zip(_leaves(s_carry), _leaves(new_carry)):
                    if src is not dst:
                        dst.copy_(src)
        except GraphCaptureError:
            raise
        except RuntimeError as exc:
            raise GraphCaptureError(
                f"capturing the step as a CUDA graph failed (a host sync, "
                f"a synchronous copy or an allocation the capture forbids "
                f"inside the step?); the step does not run eagerly on "
                f"{self.device}: {exc}") from exc
        finally:
            if collecting:
                gc.enable()
            after = _counts()
            _set_counts(before)
        torch.cuda.synchronize(self.device)
        g = _Graph()
        g.graph, g.carry, g.args, g.out = graph, s_carry, s_args, out
        g.delta = [a - b for a, b in zip(after, before)]
        g.capture_ms = self.capture_ms = (time.perf_counter() - t0) * 1e3
        g.reserved = torch.cuda.memory_reserved(self.device) - reserved0
        g.replays = 0
        self._graphs[key] = g
        CapturedStep.captures += 1
        return g
