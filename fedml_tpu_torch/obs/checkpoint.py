"""Checkpoint / resume of a federated run (port of
``fedml_tpu/obs/checkpoint.py``).

Any ``FederatedLoop`` run checkpoints its whole state — the global net,
the server optimizer state, the round key, the round index and the
algorithm's own run state through the ``checkpoint_extra_state`` hooks —
and resumes bit-exactly.

The format is the port's own (the JAX package writes orbax):
``<dir>/<step>/state.pt``, one flat ``{path: tensor}`` dict written by
``torch.save`` and read by ``torch.load(weights_only=True)``, so loading a
file runs no code. ``torch.save`` keeps every dtype the trees hold (bf16
params, the int64 round key), which an ``.npz`` without pickle cannot.
Paths join the tree's dict keys, sequence indices and dataclass fields
with ``/``; ``None`` leaves hold no entry.

- ``save`` copies every leaf to the host BEFORE it returns: after a
  replayed round, ``api.net``, the server optimizer state and the client
  stacks are a captured graph's static buffers, which the next replay
  overwrites in place. With ``wait=False`` the write then runs on a
  background thread, joined by ``wait()`` (and by the next save).
- A step is written under a temporary directory and committed by
  ``os.replace``, so a crash never leaves half a step; committing a step
  that exists raises ``ValueError`` ("already exists").
- ``max_to_keep`` rotates the oldest committed steps out.
- ``restore(like=)`` checks every key, shape and dtype against the
  template, in both directions, and raises naming the key; the leaves
  come back on the template leaves' devices, as numpy where the template
  holds numpy.

The round key is the port's counter-hash key (``core/keys.py``), a 0-d
int64 tensor, and round-trips as it is.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

_FILE = "state.pt"


@dataclasses.dataclass
class RunState:
    """Everything needed to resume a federated run."""

    round_idx: int
    net: Any                      # NetState
    rng: Any                      # the round key, a 0-d int64 tensor
    server_opt_state: Any = None  # FedOpt family; None for plain FedAvg
    extra: Any = None             # the class's run state, through the
                                  # checkpoint_extra_state hooks

    def to_pytree(self) -> Dict:
        return {"round_idx": np.asarray(self.round_idx, np.int64),
                "net": self.net, "rng": self.rng,
                "server_opt_state": self.server_opt_state,
                "extra": self.extra}


def _children(tree):
    """``(key, child)`` pairs of an inner node, or None for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), v) for k, v in tree.items()]
    if isinstance(tree, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name))
                for f in dataclasses.fields(tree)]
    return None


def _is_leaf(x) -> bool:
    return torch.is_tensor(x) or isinstance(x, (np.ndarray, np.generic))


def _walk(tree, prefix=""):
    """``(path, leaf)`` of every tensor or numpy leaf, in tree order."""
    if tree is None:
        return
    if _is_leaf(tree):
        yield prefix, tree
        return
    kids = _children(tree)
    if kids is None:
        raise TypeError(f"checkpoint trees hold tensors, numpy arrays, "
                        f"dicts, sequences and dataclasses; {prefix!r} is "
                        f"a {type(tree).__name__}")
    for key, child in kids:
        yield from _walk(child, f"{prefix}/{key}" if prefix else key)


def _to_host(leaf) -> torch.Tensor:
    """A private host copy of a leaf (a numpy leaf as a tensor)."""
    if torch.is_tensor(leaf):
        return leaf.detach().to("cpu", copy=True)
    return torch.from_numpy(np.array(leaf, copy=True))


def _torch_dtype(leaf) -> torch.dtype:
    if torch.is_tensor(leaf):
        return leaf.dtype
    return torch.from_numpy(np.empty(0, np.asarray(leaf).dtype)).dtype


def _rebuild(like, flat: Dict[str, torch.Tensor], where: str):
    """``like``'s structure with its leaves read from ``flat``: each key,
    shape and dtype must match, and every entry of ``flat`` be used."""
    used = set()

    def build(node, prefix):
        if node is None:
            return None
        if _is_leaf(node):
            if prefix not in flat:
                raise KeyError(f"checkpoint {where} has no entry {prefix!r} "
                               "that the template holds")
            got = flat[prefix]
            shape = tuple(np.shape(node))
            if tuple(got.shape) != shape:
                raise ValueError(f"{prefix!r}: checkpoint shape "
                                 f"{tuple(got.shape)} != template shape "
                                 f"{shape}")
            if got.dtype != _torch_dtype(node):
                raise ValueError(f"{prefix!r}: checkpoint dtype {got.dtype} "
                                 f"!= template dtype {_torch_dtype(node)}")
            used.add(prefix)
            if torch.is_tensor(node):
                return got.to(node.device)
            return got.numpy()
        vals = [build(c, f"{prefix}/{k}" if prefix else k)
                for k, c in _children(node)]
        if isinstance(node, dict):
            return dict(zip(node, vals))
        if isinstance(node, (tuple, list)):
            if hasattr(node, "_fields"):  # a NamedTuple
                return type(node)(*vals)
            return type(node)(vals)
        return dataclasses.replace(node, **{
            f.name: v for f, v in zip(dataclasses.fields(node), vals)})

    out = build(like, "")
    leftover = sorted(set(flat) - used)
    if leftover:
        raise ValueError(f"checkpoint {where} has {len(leftover)} entries "
                         f"the template does not hold (first: "
                         f"{leftover[:3]})")
    return out


def _unflatten(flat: Dict[str, torch.Tensor]) -> Dict:
    out: Dict = {}
    for path, leaf in flat.items():
        node = out
        *head, last = path.split("/")
        for key in head:
            node = node.setdefault(key, {})
        node[last] = leaf
    return out


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class CheckpointManager:
    """``save(step, tree)`` / ``latest()`` / ``restore(step, like=)`` over
    ``<directory>/<step>/`` (see the module docstring); at most
    ``max_to_keep`` committed steps are kept (None keeps all)."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = 3):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._lock = threading.Lock()
        self._pending = set()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _step_dir(self, step: int) -> str:
        return os.path.join(self._dir, str(int(step)))

    def save(self, step: int, tree, wait: bool = True) -> None:
        """Snapshots ``tree`` to the host, then writes it as ``step``
        (on a background thread with ``wait=False``)."""
        step = int(step)
        flat = {}
        for path, leaf in _walk(tree):
            if path in flat:
                raise ValueError(f"two leaves of the tree share the path "
                                 f"{path!r}")
            flat[path] = _to_host(leaf)
        with self._lock:
            if step in self._pending or os.path.exists(self._step_dir(step)):
                raise ValueError(f"checkpoint step {step} already exists in "
                                 f"{self._dir}")
            self._pending.add(step)
        try:
            self.wait()  # one write in flight at a time
        except BaseException:
            with self._lock:
                self._pending.discard(step)
            raise
        if wait:
            self._write(step, flat)
            return
        self._thread = threading.Thread(target=self._write_bg,
                                        args=(step, flat), daemon=True,
                                        name=f"checkpoint-{step}")
        self._thread.start()

    def _write_bg(self, step: int, flat) -> None:
        try:
            self._write(step, flat)
        except BaseException as err:  # noqa: BLE001 - raised by wait()
            self._error = err

    def _write(self, step: int, flat) -> None:
        tmp = tempfile.mkdtemp(prefix=f".{step}.", dir=self._dir)
        try:
            with open(os.path.join(tmp, _FILE), "wb") as f:
                torch.save(flat, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._step_dir(step))
            _fsync_dir(self._dir)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        finally:
            with self._lock:
                self._pending.discard(step)
        self._rotate()

    def _rotate(self) -> None:
        if self.max_to_keep is None:
            return
        for step in self.steps()[:-self.max_to_keep or None]:
            shutil.rmtree(self._step_dir(step), ignore_errors=True)

    def wait(self) -> None:
        """Blocks until the in-flight write (if any) has committed; raises
        its error."""
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join()
        err, self._error = self._error, None
        if err is not None:
            raise err

    def steps(self):
        """Committed steps, ascending."""
        return sorted(int(name) for name in os.listdir(self._dir)
                      if name.isdigit()
                      and os.path.isfile(os.path.join(self._dir, name,
                                                      _FILE)))

    def latest(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, like=None):
        """The tree of ``step`` (default: the latest; None when there is no
        step), with ``like``'s structure, devices and types when given,
        else as nested dicts of host tensors."""
        self.wait()
        step = self.latest() if step is None else int(step)
        if step is None:
            return None
        path = os.path.join(self._step_dir(step), _FILE)
        flat = torch.load(path, map_location="cpu", weights_only=True)
        if like is None:
            return _unflatten(flat)
        return _rebuild(like, flat, path)

    def close(self) -> None:
        self.wait()


def save_federation(mgr: CheckpointManager, net, round_idx: int, epoch: int,
                    wait: bool = False) -> None:
    """Checkpoints the message-passing federation's server state: the
    global net, the NEXT round to run and the server epoch. A step that is
    already durable is skipped: a restarted server replaying its restored
    round would otherwise collide with the crashed instance's own save."""
    if round_idx in mgr.steps():
        return
    try:
        mgr.save(round_idx, {"round_idx": np.asarray(round_idx, np.int64),
                             "epoch": np.asarray(epoch, np.int64),
                             "net": net}, wait=wait)
    except ValueError as err:
        # steps() can be stale: an in-flight save of this step commits
        # between the check and ours. Either way the step is durable.
        if "already exists" not in str(err):
            raise


def allocate_epoch(mgr: CheckpointManager, restored_epoch: int = -1) -> int:
    """A strictly monotonic server epoch for a (re)starting federation
    server: ``max(restored_epoch, sidecar) + 1``, where the ``EPOCH``
    sidecar in the checkpoint directory records the last epoch ever handed
    out, persisted synchronously (write, fsync, rename) before it is
    returned. Two crashes inside one checkpoint window restore the same
    stored epoch; the sidecar keeps them from reusing one."""
    path = os.path.join(mgr._dir, "EPOCH")
    prev = -1
    try:
        with open(path) as f:
            prev = int(f.read().strip())
    except (OSError, ValueError):
        pass
    epoch = max(int(restored_epoch), prev) + 1
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(str(epoch))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return epoch


def restore_federation(mgr: CheckpointManager, like_net) -> Optional[Dict]:
    """The latest federation checkpoint as ``{"round_idx", "epoch",
    "net"}``, or None. A restarted server runs under a fresh epoch from
    :func:`allocate_epoch`, not the stored one plus one."""
    restored = mgr.restore(like={"round_idx": np.asarray(0, np.int64),
                                 "epoch": np.asarray(0, np.int64),
                                 "net": like_net})
    if restored is None:
        return None
    return {"round_idx": int(restored["round_idx"]),
            "epoch": int(restored["epoch"]), "net": restored["net"]}


def _run_state(api, round_idx: int) -> RunState:
    extra_fn = getattr(api, "checkpoint_extra_state", None)
    return RunState(round_idx=round_idx, net=api.net, rng=api.rng,
                    server_opt_state=getattr(api, "server_opt_state", None),
                    extra=extra_fn() if extra_fn is not None else None)


def save_run(mgr: CheckpointManager, api, round_idx: int,
             wait: bool = True) -> None:
    """Checkpoints a ``FederatedLoop`` API after ``round_idx`` completed
    rounds. Run state beyond (net, rng, server optimizer) comes from the
    API's ``checkpoint_extra_state()`` and goes back through
    ``load_checkpoint_extra_state``. The snapshot is taken before this
    returns, whatever ``wait``."""
    mgr.save(round_idx, _run_state(api, round_idx).to_pytree(), wait=wait)


def restore_run(mgr: CheckpointManager, api) -> int:
    """Restores the latest checkpoint into ``api`` (whose current state is
    the template) and returns the next round to run (0 without a
    checkpoint). The restored tensors are new: a captured round copies
    them into its static buffers at its next replay."""
    restored = mgr.restore(like=_run_state(api, 0).to_pytree())
    if restored is None:
        return 0
    api.net = restored["net"]
    api.rng = restored["rng"]
    if restored["server_opt_state"] is not None and hasattr(
            api, "server_opt_state"):
        api.server_opt_state = restored["server_opt_state"]
    if restored["extra"] is not None:
        api.load_checkpoint_extra_state(restored["extra"])
    return int(restored["round_idx"]) + 1
