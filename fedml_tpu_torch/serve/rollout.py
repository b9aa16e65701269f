"""Versioned adapter rollout: publish → shadow → promote | rollback (port
of ``fedml_tpu/serve/rollout.py``).

The training fleet keeps producing new global adapters; the serving plane
must pick them up without trusting them. ``RolloutCoordinator`` is the
gate:

- :meth:`RolloutCoordinator.publish` stages a candidate behind an EPOCH
  FENCE: a snapshot published under an epoch at or below the last
  accepted one is a previous incarnation's in-flight publish and raises
  :class:`StaleEpochError`.
- While staged, the plane mirrors live traffic through both the live
  global and the candidate (``serve/plane.py``, ``serve.shadow`` spans)
  and accumulates next-token CE per arm.
- :meth:`RolloutCoordinator.try_promote` promotes only when the candidate
  saw enough shadow tokens, its CE is finite and it does not regress the
  live CE beyond ``regression_tol``; the displaced version becomes the
  one-step rollback target.
- :meth:`RolloutCoordinator.rollback` restores that version BIT-EQUAL:
  the adapter vector round-trips through the checkpoint as raw float32.

Every transition persists a fixed-shape payload through
``obs/checkpoint.py``'s :class:`CheckpointManager` before it takes effect
on the plane, so a coordinator restarted from its directory resumes on the
fenced epoch with the same live, candidate and rollback state.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from fedml_tpu_torch.core.flat import vector_to_tree_np
from fedml_tpu_torch.obs.checkpoint import CheckpointManager


class StaleEpochError(RuntimeError):
    """Publish fenced off: the snapshot's epoch is not newer than the last
    accepted one."""


class RolloutCoordinator:
    """Shadow-gated version control of a
    :class:`~fedml_tpu_torch.serve.plane.ServeManager`'s live global.

    ``directory`` (optional) persists every transition; on construction a
    state found there is restored INTO the manager: restart-resume is the
    constructor. ``regression_tol`` is relative (the candidate's CE may
    exceed the live CE by at most ``live_ce * regression_tol``);
    ``min_shadow_tokens`` keeps a lucky few mirrored tokens from promoting
    anything."""

    def __init__(self, manager, *, directory: Optional[str] = None,
                 regression_tol: float = 0.02,
                 min_shadow_tokens: int = 32):
        self.manager = manager
        self.regression_tol = float(regression_tol)
        self.min_shadow_tokens = int(min_shadow_tokens)
        self.dim = int(manager.fwd.dim)
        self._mgr = None
        self._seq = 0  # checkpoint step allocator (monotonic)
        self.fence_epoch = -1
        self.live_version = int(manager.live_version)
        self._live_vec = manager._vec(manager.live_adapters())
        self.prev_version: Optional[int] = None
        self._prev_vec = np.zeros(self.dim, np.float32)
        self.cand_version: Optional[int] = None
        self._cand_vec = np.zeros(self.dim, np.float32)
        if directory is not None:
            self._mgr = CheckpointManager(directory, max_to_keep=3)
            self._restore()

    # -- persistence -----------------------------------------------------

    def _payload(self) -> dict:
        """Fixed-shape snapshot: absent versions ride as ``-1`` and zero
        vectors, so every incarnation can ``restore(like=)`` every step."""
        return {
            "seq": np.asarray(self._seq, np.int64),
            "fence_epoch": np.asarray(self.fence_epoch, np.int64),
            "live_version": np.asarray(self.live_version, np.int64),
            "live_vec": np.asarray(self._live_vec, np.float32),
            "prev_version": np.asarray(
                -1 if self.prev_version is None else self.prev_version,
                np.int64),
            "prev_vec": np.asarray(self._prev_vec, np.float32),
            "cand_version": np.asarray(
                -1 if self.cand_version is None else self.cand_version,
                np.int64),
            "cand_vec": np.asarray(self._cand_vec, np.float32),
        }

    def _persist(self) -> None:
        """Durable, then visible: the snapshot commits before the
        transition lands on the plane."""
        if self._mgr is None:
            return
        self._seq += 1
        self._mgr.save(self._seq, self._payload())

    def _restore(self) -> None:
        restored = self._mgr.restore(like=self._payload())
        if restored is None:
            return
        self._seq = int(restored["seq"])
        self.fence_epoch = int(restored["fence_epoch"])
        self.live_version = int(restored["live_version"])
        self._live_vec = restored["live_vec"]
        pv = int(restored["prev_version"])
        self.prev_version = None if pv < 0 else pv
        self._prev_vec = restored["prev_vec"]
        cv = int(restored["cand_version"])
        self.cand_version = None if cv < 0 else cv
        self._cand_vec = restored["cand_vec"]
        self.manager.set_live(self.live_version, self._tree(self._live_vec))
        if self.cand_version is not None:
            # Resume mid-promotion: the candidate is staged again and its
            # CE evidence restarts from zero (the dead incarnation's
            # mirrored traffic is not trusted across a restart).
            self.manager.set_shadow(self.cand_version,
                                    self._tree(self._cand_vec))
        else:
            self.manager.set_shadow(None)

    def _tree(self, vec: np.ndarray):
        return vector_to_tree_np(np.asarray(vec, np.float32),
                                 self.manager.fwd.spec)

    # -- transitions -----------------------------------------------------

    def publish(self, adapters, *, epoch: int) -> int:
        """Stages ``adapters`` (a training-fleet snapshot taken under server
        ``epoch``) as the shadow candidate, replacing any staged one;
        returns the candidate's version."""
        epoch = int(epoch)
        if epoch <= self.fence_epoch:
            raise StaleEpochError(
                f"publish under epoch {epoch} refused: fence is at "
                f"{self.fence_epoch} — a newer coordinator incarnation "
                "already accepted a snapshot from this epoch or later")
        self.fence_epoch = epoch
        version = max(self.live_version,
                      self.cand_version if self.cand_version is not None
                      else -1) + 1
        self.cand_version = version
        self._cand_vec = self.manager._vec(adapters)
        self._persist()
        self.manager.set_shadow(version, self._tree(self._cand_vec))
        return version

    def try_promote(self) -> dict:
        """Promotes the staged candidate iff the shadow gate passes; returns
        the verdict (``promoted``, ``reason`` and the scores it was judged
        on). A blocked candidate stays staged: more mirrored traffic may
        still clear it; :meth:`discard` drops it."""
        if self.cand_version is None:
            return {"promoted": False, "reason": "no_candidate"}
        scores = self.manager.shadow_scores()
        verdict = dict(scores, promoted=False,
                       candidate_version=self.cand_version)
        if scores["tokens"] < self.min_shadow_tokens:
            verdict["reason"] = (
                f"insufficient_shadow_traffic ({scores['tokens']} < "
                f"{self.min_shadow_tokens} tokens)")
            return verdict
        if not np.isfinite(scores["cand_ce"]):
            verdict["reason"] = "candidate_ce_not_finite"
            return verdict
        limit = scores["live_ce"] * (1.0 + self.regression_tol)
        if np.isfinite(scores["live_ce"]) and scores["cand_ce"] > limit:
            verdict["reason"] = (
                f"regression (cand_ce {scores['cand_ce']:.4f} > "
                f"{limit:.4f})")
            return verdict
        self.prev_version = self.live_version
        self._prev_vec = self._live_vec
        self.live_version = self.cand_version
        self._live_vec = self._cand_vec
        self.cand_version = None
        self._cand_vec = np.zeros(self.dim, np.float32)
        self._persist()
        self.manager.set_shadow(None)
        self.manager.set_live(self.live_version, self._tree(self._live_vec))
        verdict.update(promoted=True, reason="ok",
                       live_version=self.live_version)
        return verdict

    def discard(self) -> None:
        """Drops the staged candidate without promoting it."""
        if self.cand_version is None:
            return
        self.cand_version = None
        self._cand_vec = np.zeros(self.dim, np.float32)
        self._persist()
        self.manager.set_shadow(None)

    def rollback(self) -> int:
        """One-step rollback: the displaced version goes live again,
        bit-equal; the version rolled back from becomes the new rollback
        target. Raises RuntimeError when nothing was ever promoted over."""
        if self.prev_version is None:
            raise RuntimeError(
                "no previous version to roll back to: nothing was ever "
                "promoted over")
        self.prev_version, self.live_version = (self.live_version,
                                                self.prev_version)
        self._prev_vec, self._live_vec = self._live_vec, self._prev_vec
        self._persist()
        self.manager.set_live(self.live_version, self._tree(self._live_vec))
        return self.live_version

    def close(self) -> None:
        if self._mgr is not None:
            self._mgr.close()
