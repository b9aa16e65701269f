"""Differential-privacy accounting (zCDP) for the DP mechanisms (port of
``fedml_tpu/core/privacy.py``; pure Python, the same values).

New capability relative to the reference, whose only DP surface is
uncalibrated server-side Gaussian noise ("weak DP",
fedml_core/robustness/robust_aggregation.py:49-53) with no accounting.
Two mechanisms in this framework release noised quantities:

- example-level DP-SGD on clients (``make_local_train_fn(dp_clip=...,
  dp_noise_multiplier=z)``, ``trainer/local.py``): each optimizer step
  releases ``sum(clipped per-example grads) + N(0, (z*C)^2)`` — L2
  sensitivity to one example is ``C``, so each step is a Gaussian
  mechanism with noise multiplier ``z``;
- client-level DP-FedAvg at the server (norm-clipped client deltas +
  Gaussian noise, ``core/robustness.py``): sensitivity to one client is
  the clip bound, noise multiplier = ``stddev / norm_bound``.

Accounting uses zero-concentrated DP (Bun & Steinke 2016): the Gaussian
mechanism with noise multiplier ``z`` satisfies ``rho = 1/(2 z^2)``-zCDP,
zCDP composes additively, and ``rho``-zCDP implies
``(rho + 2*sqrt(rho * ln(1/delta)), delta)``-DP. These bounds are tight
enough for reporting and entirely closed-form (no numerical RDP-order
search); they do NOT include subsampling amplification, so the reported
epsilon is a conservative upper bound when clients/batches are sampled.
"""

from __future__ import annotations

import math


def zcdp_of_gaussian(noise_multiplier: float) -> float:
    """rho of one Gaussian-mechanism release with std = z * sensitivity."""
    if noise_multiplier <= 0:
        return math.inf
    return 0.5 / (noise_multiplier ** 2)


def zcdp_to_eps(rho: float, delta: float) -> float:
    """Convert rho-zCDP to (eps, delta)-DP."""
    if not 0 < delta < 1:
        raise ValueError(f"delta must be in (0, 1), got {delta}")
    if math.isinf(rho):
        return math.inf
    return rho + 2.0 * math.sqrt(rho * math.log(1.0 / delta))


class PrivacyAccountant:
    """Additive zCDP composition over a run.

    >>> acct = PrivacyAccountant()
    >>> acct.step(noise_multiplier=1.1, steps=rounds * steps_per_round)
    >>> acct.epsilon(delta=1e-5)
    """

    def __init__(self):
        self.rho = 0.0

    def step(self, noise_multiplier: float,
             steps: int = 1) -> "PrivacyAccountant":
        self.rho += steps * zcdp_of_gaussian(noise_multiplier)
        return self

    def epsilon(self, delta: float) -> float:
        return zcdp_to_eps(self.rho, delta)


def dp_sgd_epsilon(noise_multiplier: float, epochs: int, steps_per_epoch: int,
                   rounds: int, delta: float) -> float:
    """Closed-form epsilon for a full DP-SGD federated run: every local
    optimizer step on a client is one Gaussian release against that
    client's data (``rounds * epochs * steps_per_epoch`` compositions)."""
    acct = PrivacyAccountant()
    acct.step(noise_multiplier, steps=rounds * epochs * steps_per_epoch)
    return acct.epsilon(delta)
