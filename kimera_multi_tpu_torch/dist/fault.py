"""Failure detection and elastic recovery (the JAX package's
dist/fault.py).

The reference's resilience layer lives in dpgo_ros: status heartbeats,
`checkTimeout()` -> RECOVER / HARD_TERMINATE, and leader deactivation of
dead robots via SET_ACTIVE_ROBOTS. In the bulk-synchronous design the
equivalents are host-side round deadlines plus an active-robot mask that
freezes a robot's block inside the round: its blocks are still gathered,
held constant, so the remaining robots keep a consistent frame.

Fault injection for tests = deactivating a robot for N rounds.
"""

from __future__ import annotations

import time
from typing import Callable

import torch


def deactivate(active: torch.Tensor, robot: int) -> torch.Tensor:
    """SET_ACTIVE_ROBOTS: freeze one robot's block (a new mask)."""
    out = active.clone()
    out[robot] = False
    return out


def reactivate(active: torch.Tensor, robot: int) -> torch.Tensor:
    out = active.clone()
    out[robot] = True
    return out


class RoundWatchdog:
    """Host-side analogue of dpgo_ros `checkTimeout()`: if a round exceeds
    `timeout_s`, `on_timeout` fires (typically deactivating the slow
    participant or aborting the instance). With recovery disabled the run
    hard-terminates (raises)."""

    def __init__(self, timeout_s: float, enable_recovery: bool = True,
                 on_timeout: Callable[[], None] | None = None):
        self.timeout_s = timeout_s
        self.enable_recovery = enable_recovery
        self.on_timeout = on_timeout
        self._last = time.monotonic()
        self.timeouts = 0

    def tick(self) -> None:
        now = time.monotonic()
        if now - self._last > self.timeout_s:
            self.timeouts += 1
            if self.enable_recovery and self.on_timeout is not None:
                self.on_timeout()
            elif not self.enable_recovery:
                raise TimeoutError(
                    f"round exceeded {self.timeout_s}s (hard terminate)")
        self._last = now
