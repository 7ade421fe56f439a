"""Fault tolerance for the single-card trainer: straggler detection and a
restarting loop (the port's copy of the JAX package's
``train/fault_tolerance.py``; its multi-host heartbeat monitor waits for
the distributed slice, ROADMAP item 5).

  * StepWatchdog      — EWMA + k·σ step-time anomaly detector; flags
                        stragglers (the data pipeline exposes skip_ahead()).
  * run_with_restarts — crash-looping runner: on failure, restore the latest
                        valid checkpoint and continue; bounded retries.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass
class StepWatchdog:
    """Flags steps slower than mean + k·σ (EWMA estimates)."""
    k: float = 3.0
    alpha: float = 0.1                 # EWMA decay
    warmup: int = 5
    mean: float = 0.0
    var: float = 0.0
    n: int = 0
    stragglers: list = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        """Returns True if this step is a straggler."""
        self.n += 1
        if self.n <= self.warmup:
            # prime the estimators
            self.mean = dt if self.n == 1 else \
                self.mean + (dt - self.mean) / self.n
            self.var = self.var + (dt - self.mean) ** 2 / max(self.n, 1)
            return False
        std = math.sqrt(max(self.var, 1e-12))
        is_straggler = dt > self.mean + self.k * std
        if is_straggler:
            self.stragglers.append((step, dt))
        else:
            # only track healthy steps so stragglers don't poison the stats
            d = dt - self.mean
            self.mean += self.alpha * d
            self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        return is_straggler


def run_with_restarts(make_state, train_loop, *, max_failures: int = 3,
                      on_restart: Optional[Callable] = None):
    """Crash-looping runner.

    make_state() -> state (fresh or restored inside train_loop);
    train_loop(state, failure_count) runs until completion or raises.
    """
    failures = 0
    while True:
        try:
            state = make_state()
            return train_loop(state, failures)
        except KeyboardInterrupt:
            raise
        except Exception:
            failures += 1
            if failures > max_failures:
                raise
            if on_restart is not None:
                on_restart(failures)
